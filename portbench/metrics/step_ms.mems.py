"""step_ms.mems: the host-clock ms of one MEMS step, the program's ``step``
spans (``models.mems.make_step``) over a whole segment with its tracing on
(``portbench/program.py``); none where the program opens no ``step`` span.
In the MEMS cell the end-to-end metric is ``device_ms``, and the host-bound
step time is a per-layer metric."""
from portbench.program import reading


def read(run):
    r = reading(run)
    if not r or "step" not in r["spans"]:
        return None
    calls, ms = r["spans"]["step"]
    return ms / calls
