"""stencil.kernel_share: the share of the stencil calls (``ops/stencils``'s
``d1_x``, ``d1_y``, ``d2_x``, ``d2_y``) during which the launch count of
the hand-written kernel of ``csrc/fd_stencil.cu`` rose, so a call that lost
its launch reads below 1: the program's counter ``stencil.kernel``
over its counter ``stencil.calls``, over a whole segment with its tracing on
(``portbench/program.py``); 0.0 where the counters hold no
``stencil.kernel``, none where they hold no ``stencil.calls``, as in a
program without them."""
from portbench.program import reading


def read(run):
    r = reading(run)
    calls = r["counters"].get("stencil.calls") if r else None
    if not calls:
        return None
    return r["counters"].get("stencil.kernel", 0) / calls
