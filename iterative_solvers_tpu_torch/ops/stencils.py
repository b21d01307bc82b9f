"""Matrix-free 4th-order finite-difference stencils
(port of ``iterative_solvers_tpu/ops/stencils.py``).

All operators act on ``(..., ny, nx)`` fields; ``*_x`` differentiates along
the last axis (ksi), ``*_y`` along the second-to-last (eta).  Coefficients
are the reference's:

- interior d1 (4th order centred):  ``[1, -8, 0, 8, -1] / 12h``
- interior d2 (4th order centred):  ``[-1, 16, -30, 16, -1] / 12h^2``
- one-sided edge rows as below.

Every function returns a fresh tensor and never writes into its input.
"""
from __future__ import annotations

from functools import lru_cache

import torch


# One-sided edge rows, applied to the first/last 5 (d1) or 6 (d2) entries.
# d1: /(12h).  d2: /(12h^2); rows 0/-1 assume a known Neumann value at the
# wall (the 25/(6h) g correction is the caller's — see
# ops.curvilinear.mesh_geometry).
_EDGE_ROWS = {
    "d1_lo": [[-25.0, 48.0, -36.0, 16.0, -3.0],
              [-3.0, -10.0, 18.0, -6.0, 1.0]],
    "d1_hi": [[-1.0, 6.0, -18.0, 10.0, 3.0],
              [3.0, -16.0, 36.0, -48.0, 25.0]],
    "d2_lo": [[-415.0 / 6.0, 96.0, -36.0, 32.0 / 3.0, -1.5, 0.0],
              [10.0, -15.0, -4.0, 14.0, -6.0, 1.0]],
    "d2_hi": [[1.0, -6.0, 14.0, -4.0, -15.0, 10.0],
              [0.0, -1.5, 32.0 / 3.0, -36.0, 96.0, -415.0 / 6.0]],
}


@lru_cache(maxsize=64)
def _edge_coefs(name: str, dtype: torch.dtype, device: torch.device):
    """An edge-row table on ``device``, copied there once (a copy per call
    would put a host-to-device transfer in every stencil)."""
    return torch.tensor(_EDGE_ROWS[name], dtype=dtype, device=device)


def _edge_rows(u, name: str):
    """The one-sided edge entries ``name`` (e.g. ``"d1_lo"``) along the last
    axis: each a fixed linear combination of the edge strip's values."""
    c = _edge_coefs(name, u.dtype, u.device)
    w = c.shape[1]
    strip = u[..., :w] if name.endswith("_lo") else u[..., -w:]
    return strip @ c.T


def d1_x(u, dx: float):
    """4th-order first derivative along the last axis (ksi direction)."""
    s = 1.0 / (12.0 * dx)
    interior = u[..., :-4] - 8.0 * u[..., 1:-3] + 8.0 * u[..., 3:-1] - u[..., 4:]
    lo = _edge_rows(u, "d1_lo")
    hi = _edge_rows(u, "d1_hi")
    return torch.cat([lo, interior, hi], dim=-1) * s


def d1_y(u, dy: float):
    """4th-order first derivative along the eta (row) axis."""
    return d1_x(u.transpose(-1, -2), dy).transpose(-1, -2)


def d2_x(u, dx: float):
    """4th-order second derivative along the last axis (ksi direction)."""
    s = 1.0 / (12.0 * dx * dx)
    interior = (-u[..., :-4] + 16.0 * u[..., 1:-3] - 30.0 * u[..., 2:-2]
                + 16.0 * u[..., 3:-1] - u[..., 4:])
    lo = _edge_rows(u, "d2_lo")
    hi = _edge_rows(u, "d2_hi")
    return torch.cat([lo, interior, hi], dim=-1) * s


def d2_y(u, dy: float):
    """4th-order second derivative along the eta (row) axis."""
    return d2_x(u.transpose(-1, -2), dy).transpose(-1, -2)


def dxy(u, dx: float, dy: float):
    """Mixed derivative d^2 u / (dksi deta): d1 along x, then along y."""
    return d1_y(d1_x(u, dx), dy)
