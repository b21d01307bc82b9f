"""pma.solve_ms: the host-clock ms an eager PMA sub-step spends in
the spectral PMA solve, the program's ``pma.solve`` spans
(``meshmove.pma.pma_dqdt``) over their calls, over a whole segment with
its tracing on (``portbench/program.py``); none where the program opens
no such span (the fused sub-step opens none)."""
from portbench.program import reading


def read(run):
    r = reading(run)
    if not r or "pma.solve" not in r["spans"]:
        return None
    calls, ms = r["spans"]["pma.solve"]
    return ms / calls
