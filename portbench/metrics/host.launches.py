"""host.launches: CUDA kernel-launch runtime calls in the trace of one
whole segment, per step: the eager host loops' dispatch."""


def read(run):
    if not run.trace or not run.trace["steps"]:
        return None
    return run.trace["launches"] / run.trace["steps"]
