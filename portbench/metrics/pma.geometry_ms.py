"""pma.geometry_ms: the host-clock ms an eager PMA sub-step spends in
the mesh geometry of the potential, the program's ``pma.geometry`` spans
(``meshmove.pma.pma_dqdt``) over their calls, over a whole segment with
its tracing on (``portbench/program.py``); none where the program opens
no such span (the fused sub-step opens none)."""
from portbench.program import reading


def read(run):
    r = reading(run)
    if not r or "pma.geometry" not in r["spans"]:
        return None
    calls, ms = r["spans"]["pma.geometry"]
    return ms / calls
