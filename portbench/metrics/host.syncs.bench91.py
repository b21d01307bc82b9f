"""``host.syncs`` under the name the ``bench91`` cell reports it by: there the
end-to-end metric is ``device_ms``, and the host-bound step time is a
per-layer metric, ``step_ms.bench91``."""
from portbench.run import reader_beside

read = reader_beside(__file__, "host.syncs").read
