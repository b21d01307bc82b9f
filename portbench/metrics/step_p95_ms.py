"""step_p95_ms: the 95th percentile (nearest rank) of the host-clock times
of all the window's steps, each closed by a synchronise."""
import math


def read(run):
    if not run.step_s:
        return None
    times = sorted(run.step_s)
    return times[math.ceil(0.95 * len(times)) - 1] * 1e3
