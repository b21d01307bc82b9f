"""sh_operator.us: device microseconds per call of the ``sh_operator``
kernels (``sh_strip_kernel``, ``sh_tile_kernel``) in the trace, float32
and float64 together.  No roofline share: at 2048^2 their working set
(32 MB f32, 64 MB f64) sits around the 50 MB L2, where a bytes bound of
device memory does not hold."""

KERNELS = ("sh_strip_kernel", "sh_tile_kernel")


def read(run):
    if not run.trace:
        return None
    calls, secs = 0, 0.0
    for name, (n, s) in run.trace["kernels"].items():
        if any(k in name for k in KERNELS):
            calls, secs = calls + n, secs + s
    return secs / calls * 1e6 if calls else None
