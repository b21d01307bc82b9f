"""device.idle: 1 - (union of the device intervals in the trace) / (the
traced steps' wall time): an upper bound, since the profiler can drop
intervals."""


def read(run):
    if not run.trace or not run.trace["busy_s"]:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["wall_s"]
