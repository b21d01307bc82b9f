"""pma.share.bench91: the share of the step inside the PMA sub-loop, the
program's ``pma.loop`` spans over its ``step`` spans, host clock, over a
whole segment with its tracing on (``portbench/program.py``); none where
the program opens neither."""
from portbench.program import reading


def read(run):
    r = reading(run)
    if not r or "pma.loop" not in r["spans"] or "step" not in r["spans"]:
        return None
    return r["spans"]["pma.loop"][1] / r["spans"]["step"][1]
