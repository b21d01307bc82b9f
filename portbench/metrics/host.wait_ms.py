"""host.wait_ms: the host-clock ms a step spent inside the program's
blocking reads of the device (its ``host.wait_ns`` counter), over whole
segments with its tracing on (``portbench/program.py``)."""
from portbench.program import reading


def read(run):
    r = reading(run)
    return r["host.wait_ms"] if r else None
