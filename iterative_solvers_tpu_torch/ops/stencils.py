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
    # 2nd-order upwind differences, /(2h): the last two forward rows and
    # the first two backward rows
    "d1f_hi": [[0.0, -2.0, 2.0],
               [1.0, -4.0, 3.0]],
    "d1b_lo": [[-3.0, 4.0, -1.0],
               [-2.0, 2.0, 0.0]],
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


def d1_x_forward(u, dx: float):
    """2nd-order forward difference along x: [-3,4,-1]/2h at j..j+2."""
    s = 1.0 / (2.0 * dx)
    interior = -3.0 * u[..., :-2] + 4.0 * u[..., 1:-1] - u[..., 2:]
    return torch.cat([interior, _edge_rows(u, "d1f_hi")], dim=-1) * s


def d1_x_backward(u, dx: float):
    """2nd-order backward difference along x: [1,-4,3]/2h at j-2..j."""
    s = 1.0 / (2.0 * dx)
    interior = u[..., :-2] - 4.0 * u[..., 1:-1] + 3.0 * u[..., 2:]
    return torch.cat([_edge_rows(u, "d1b_lo"), interior], dim=-1) * s


def d1_y_forward(u, dy: float):
    return d1_x_forward(u.transpose(-1, -2), dy).transpose(-1, -2)


def d1_y_backward(u, dy: float):
    return d1_x_backward(u.transpose(-1, -2), dy).transpose(-1, -2)


# -- periodic operators ------------------------------------------------------

def lap_periodic(u, h: float):
    """5-point Laplacian with both axes periodic (plain version of the
    ``lap_periodic`` kernel, ``ops/periodic_stencil.py``)."""
    inv_h2 = 1.0 / (h * h)
    return (torch.roll(u, 1, dims=-1) + torch.roll(u, -1, dims=-1)
            + torch.roll(u, 1, dims=-2) + torch.roll(u, -1, dims=-2)
            - 4.0 * u) * inv_h2


def lap_dirichlet_5pt(u, h: float):
    """5-point Laplacian with homogeneous Dirichlet values outside the grid
    (``u`` holds the interior unknowns only)."""
    inv_h2 = 1.0 / (h * h)
    up = torch.nn.functional.pad(u, (1, 1, 1, 1))
    return (up[..., :-2, 1:-1] + up[..., 2:, 1:-1] + up[..., 1:-1, :-2]
            + up[..., 1:-1, 2:] - 4.0 * u) * inv_h2


def sh_linear_operator(u, h: float, r: float):
    """Swift–Hohenberg linear operator ``L = -Lap^2 - 2 Lap + (r-1) I``,
    periodic (plain version of the ``sh_operator`` kernel)."""
    lap_u = lap_periodic(u, h)
    return -lap_periodic(lap_u, h) - 2.0 * lap_u + (r - 1.0) * u
