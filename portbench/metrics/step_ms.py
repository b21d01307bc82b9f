"""step_ms: the window's wall time over the steps completed in it; host
clock, every step closed by a synchronise."""


def read(run):
    return run.window_s * 1e3 / run.steps if run.steps else None
