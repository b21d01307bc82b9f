"""The pipeline-shape experiment on the card (counterpart of the JAX
package's ``tools/pallas_pipeline_experiment.py``): a copy through a
``slots``-deep ring with ``depth`` tiles' loads in flight, the 8 periodic
rows above and below each tile loaded and discarded with ``halos`` — how
stage count, prefetch depth and halo loads set the copy's ceiling.
"""
from __future__ import annotations

from ..ops import stream_ladder as sl


def make_pipeline(n_rows, n_cols, bm, dtype, slots=2, depth=1, halos=True):
    """u -> u through the ring (``ops/stream_ladder.staged_copy``), on CUDA
    tensors by the kernel, on CPU tensors by its plain version.  The ring
    is sized to a block's shared memory by ``stream_tiling``: the TPU
    kernel's scoped VMEM limit has no counterpart."""
    sl.check_knobs(n_rows, n_cols, bm, slots, depth, dtype=dtype, halos=halos)

    def call(u):
        sl.check_field("make_pipeline u", u, (n_rows, n_cols), dtype)
        return sl.staged_copy(u, bm, slots, depth, halos)

    return call
