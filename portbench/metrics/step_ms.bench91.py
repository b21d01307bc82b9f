"""step_ms.bench91: the host-clock ms of one step of the published droplet
step, the program's ``step`` spans (``models.droplet.make_step``) over a
whole segment with its tracing on (``portbench/program.py``); none where
the program opens no ``step`` span.  In the ``bench91`` cell the end-to-end
metric is ``device_ms``, and the host-bound step time is a per-layer
metric."""
from portbench.run import reader_beside

read = reader_beside(__file__, "step_ms.mems").read
