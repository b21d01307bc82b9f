"""The grid-pipelined copy on the card (counterpart of ``grid_copy`` in the
JAX package's ``tools/pallas_grid_experiment.py``): the copy the TPU's
compiler pipelines itself, one ``(bm, n)`` block loading while the one
before it is stored.  ``grid_lap`` is still to be ported.
"""
from __future__ import annotations

import torch

from ..ops import stream_ladder as sl


def grid_copy(n, bm):
    """u -> u for an ``(n, n)`` f32 field in ``bm``-row tiles, two slots
    and one tile's loads in flight (the grid pipeline's double buffer), no
    halos (``ops/stream_ladder.staged_copy``)."""
    sl.check_knobs(n, n, bm, 2, 1, dtype=torch.float32)

    def call(u):
        sl.check_field("grid_copy u", u, (n, n), torch.float32)
        return sl.staged_copy(u, bm, 2, 1, False)

    return call
