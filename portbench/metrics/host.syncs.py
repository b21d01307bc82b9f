"""host.syncs: the program's blocking reads of the device a step
(``utils.trace.to_host``: ``.item()``, ``.tolist()``, ``.cpu().numpy()``),
counted by the program's ``host.syncs`` counter over whole segments with
its tracing on (``portbench/program.py``)."""
from portbench.program import reading


def read(run):
    r = reading(run)
    return r["host.syncs"] if r else None
