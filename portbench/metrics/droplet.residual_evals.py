"""droplet.residual_evals: the CN residual evaluations of a droplet step's
JFNK solve (Newton's own and one each finite-difference matvec), the
program's counter ``droplet.residual_evals`` over a whole segment with its
tracing on (``portbench/program.py``); none where the program keeps no
such counter."""
from portbench.program import reading


def read(run):
    r = reading(run)
    return r["counters"].get("droplet.residual_evals") if r else None
