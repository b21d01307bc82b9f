"""cg.iters: CG iterations a solve (``CGResult.iters``, reported by the
step as ``krylov_iters``) over the window's whole segments, so that where
the window happened to close does not move it; none where the steps
report none."""


def read(run):
    whole = run.steps - run.steps % run.segment_steps
    iters = [i["krylov_iters"] for i in run.infos[:whole or run.steps] if "krylov_iters" in i]
    return sum(iters) / len(iters) if iters else None
