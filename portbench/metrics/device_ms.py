"""device_ms: the device's busy time a step: the union of the device
intervals in a device-only trace of one whole segment, run again from the
prepared state after the window, over the segment's steps (the profiler
can drop intervals, so a lower bound)."""


def read(run):
    if not run.device or not run.device["busy_s"]:
        return None
    return run.device["busy_s"] * 1e3 / run.device["steps"]
