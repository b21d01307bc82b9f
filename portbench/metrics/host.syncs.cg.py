"""``host.syncs`` under the name the CG cell reports it by: there the end-to-end
metric is ``device_ms``.  The solve opens no ``step`` span, so the
program's counters are divided by the traced segment's own steps
(``portbench/program.py``)."""
from portbench.run import reader_beside

read = reader_beside(__file__, "host.syncs").read
