"""krylov.ms: ms a step inside the inner Krylov solver: CUDA-event spans,
wrapped by the benchmark, around ``newton._lgmres_cycle`` (JFNK steps) or
the ``gmres`` call of the linearised step, summed over the window."""


def read(run):
    span = run.spans.get("krylov")
    return span[1] / run.steps if span and span[0] and run.steps else None
