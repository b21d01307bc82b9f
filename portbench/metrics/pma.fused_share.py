"""pma.fused_share: the share of the PMA sub-steps that took the fused
kernels of ``ops.pma_substep``: the calls of the program's ``pma.fused``
span over those of its ``pma.substep`` span, over whole segments with its
tracing on (``portbench/program.py``); 0.0 where the spans hold no
``pma.fused``, as in a program without the kernels."""
from portbench.program import reading


def read(run):
    r = reading(run)
    if not r or "pma.substep" not in r["spans"]:
        return None
    return r["spans"].get("pma.fused", [0])[0] / r["spans"]["pma.substep"][0]
