"""droplet_jvp_roofline: the droplet_jvp kernel's share of its bytes
bound, in %: the bytes one call needs (10 float32 fields of the grid,
``peaks.droplet_jvp_bytes``) at the card's published memory rate, over the
device time per call of the trace's ``jvp_fused`` kernels."""
from portbench import peaks

KERNEL = "jvp_fused"


def read(run):
    if not run.trace:
        return None
    calls, secs = 0, 0.0
    for name, (n, s) in run.trace["kernels"].items():
        if KERNEL in name:
            calls, secs = calls + n, secs + s
    if not calls or not secs:
        return None
    bound_s = peaks.droplet_jvp_bytes(run.meta["points"]) / peaks.hbm_bytes_per_s(run.device_kind)
    return 100.0 * bound_s / (secs / calls)
