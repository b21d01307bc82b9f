"""newton.self_ms: Newton's own ms a step: the program's ``newton.solve``
spans less the part of each that its ``krylov.cycle`` children cover
(residual evaluations, Jacobian set-up, line search, forcing), over whole
segments with its tracing on (``portbench/program.py``)."""
from portbench.program import reading


def read(run):
    r = reading(run)
    return r["newton.self_ms"] if r else None
