"""``step_ms`` under the name the CG cell reports it by: there the end-to-end
metric is ``device_ms``, and the host-bound solve time is a per-layer
metric, ``step_ms.cg``."""
from portbench.run import reader_beside

read = reader_beside(__file__, "step_ms").read
