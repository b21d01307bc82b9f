"""``device.idle`` under the name the MEMS cell reports it by: there the
end-to-end metric is ``device_ms``, and the host-bound step time is a
per-layer metric, ``step_ms.mems``."""
from portbench.run import reader_beside

read = reader_beside(__file__, "device.idle").read
