"""flux.kernel_share: the share of the flux-divergence calls
(``ops/stencils``'s ``flux_div_x``, ``flux_div_y``: the curvilinear
Laplacian's conservative ``(a v')'``) during which the launch count of the
hand-written kernel of ``csrc/flux_div.cu`` rose, so a call that lost its
launch reads below 1: the program's counter ``flux.kernel`` over its counter
``flux.calls``, over a whole segment with its tracing on
(``portbench/program.py``); 0.0 where the counters hold no ``flux.kernel``,
none where they hold no ``flux.calls``, as in a program without them."""
from portbench.program import reading


def read(run):
    r = reading(run)
    calls = r["counters"].get("flux.calls") if r else None
    if not calls:
        return None
    return r["counters"].get("flux.kernel", 0) / calls
