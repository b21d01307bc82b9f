"""mems.mesh_ms: the host-clock ms a step of the MEMS step's mesh half
(monitor, smoothing, the spectral PMA solve), the program's ``mems.mesh``
spans over a whole segment with its tracing on (``portbench/program.py``);
none where the program opens no such span."""
from portbench.program import reading


def read(run):
    r = reading(run)
    if not r or "mems.mesh" not in r["spans"]:
        return None
    return r["spans"]["mems.mesh"][1] / r["steps"]
