"""pma.substep_ms: the mean host-clock ms of one PMA sub-step, the
program's ``pma.substep`` spans inside ``meshmove.pma.loop_pma``, over
whole segments with its tracing on (``portbench/program.py``)."""
from portbench.program import reading


def read(run):
    r = reading(run)
    return r["pma.substep_ms"] if r else None
