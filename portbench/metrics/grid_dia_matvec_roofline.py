"""grid_dia_matvec_roofline: the tiled SpMV kernel's share of its bytes
bound, in %: the bytes one call needs (``peaks.grid_dia_matvec_bytes``:
the needed part of each stored coefficient field, x read once, y written
once) at the card's published memory rate, over the device time per call
of the trace's ``grid_dia_matvec_tiled_kernel``."""
from portbench import peaks

KERNEL = "grid_dia_matvec_tiled_kernel"


def read(run):
    if not run.trace or "shifts" not in run.meta:
        return None
    calls, secs = 0, 0.0
    for name, (n, s) in run.trace["kernels"].items():
        if KERNEL in name:
            calls, secs = calls + n, secs + s
    if not calls or not secs:
        return None
    need = peaks.grid_dia_matvec_bytes(run.meta["grid"], run.meta["shifts"],
                                       run.meta["itemsize"])
    return 100.0 * need / peaks.hbm_bytes_per_s(run.device_kind) / (secs / calls)
