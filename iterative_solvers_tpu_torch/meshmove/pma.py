"""Parabolic Monge–Ampère spectral mesh solver
(port of ``iterative_solvers_tpu/meshmove/pma.py``).

    dQ/dt = [alpha (I - gamma lap_ksi)]^{-1} sqrt(mon |J|)

applied spectrally: forward 2-D DCT, pointwise divide by ``1 - gamma Leig``,
inverse DCT.  :func:`loop_pma` runs the explicit sub-steps as a host loop
over device tensors (no host sync inside).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from ..core.grid import Grid2D
from ..ops import curvilinear
from ..ops.dct import dct2, idct2
from .monitor import smooth_and_regularise


@dataclasses.dataclass(frozen=True)
class PMAParams:
    """Mesh-adaptivity knobs."""

    alpha: float = 0.01        # mesh adaption speed
    gamma: float = 0.1         # smoothing extent
    mackenzie_c: float = 1.0   # Mackenzie constant (0.15 for the droplet)
    smoothing_iters: int = 4
    spectral_dtype: str | None = None   # e.g. "float32": DCT solve in f32
    monitor_cap: float | None = None    # bounded mesh compression (fine grids)
    mesh_dtype: str | None = None
    # e.g. "float32": run the whole PMA sub-iteration in that dtype, with
    # the increment accumulated separately (see loop_pma).  None keeps the
    # state dtype.


@lru_cache(maxsize=16)
def pma_leig(grid: Grid2D) -> np.ndarray:
    """The reference's eigenvalue array for the (I - gamma lap) DCT solve:
    ``(2 cos(pi i/(ny-1)) - 2) + (2 cos(pi j/(nx-1)) - 2)`` over
    ``dksi * deta`` (both axes divided by the mixed spacing product, as the
    reference does)."""
    ey = 2.0 * np.cos(np.pi * np.arange(grid.ny) / (grid.ny - 1)) - 2.0
    ex = 2.0 * np.cos(np.pi * np.arange(grid.nx) / (grid.nx - 1)) - 2.0
    return (ey[:, None] + ex[None, :]) / (grid.dx * grid.dy)


@lru_cache(maxsize=16)
def _leig_tensor(grid: Grid2D, dtype: torch.dtype, device: torch.device):
    return torch.as_tensor(pma_leig(grid)).to(device=device, dtype=dtype)


def _dtype(name: str | None):
    return None if name is None else getattr(torch, name)


def solve_pma(mon, jac, grid: Grid2D, params: PMAParams):
    """dQ/dt from a smoothed monitor and the mesh Jacobian."""
    q_rhs = torch.sqrt(mon * torch.abs(jac)) / params.alpha
    out_dtype = q_rhs.dtype
    if params.spectral_dtype is not None:
        q_rhs = q_rhs.to(_dtype(params.spectral_dtype))
    leig = _leig_tensor(grid, q_rhs.dtype, q_rhs.device)
    dqdt = idct2(dct2(q_rhs) / (1.0 - params.gamma * leig))
    return dqdt.to(out_dtype)


def pma_dqdt(q, u, grid: Grid2D, params: PMAParams,
             monitor_source: Callable, geometry_fn: Callable | None = None):
    """Geometry -> monitor source -> smoothing -> spectral solve.
    ``geometry_fn=curvilinear.mesh_geometry_dev`` reads ``q`` as the
    deviation potential."""
    geom = (geometry_fn or curvilinear.mesh_geometry)(q, grid)
    src = monitor_source(u, geom, grid)
    mon = smooth_and_regularise(
        src, geom.jac, grid.dx, grid.dy,
        smoothing_iters=params.smoothing_iters,
        mackenzie_c=params.mackenzie_c,
        cap=params.monitor_cap,
    )
    return solve_pma(mon, geom.jac, grid, params)


def loop_pma(q, u, dt: float, loops: int, grid: Grid2D, params: PMAParams,
             monitor_source: Callable, geometry_fn: Callable | None = None):
    """``loops`` explicit PMA sub-steps.

    With ``params.mesh_dtype`` set, the sub-loop runs in that dtype and
    carries the accumulated *increment* (``q0 + acc``), not the updated
    potential: one update ``dt * dqdt`` is ~1e-9 of ``q``, below the f32
    ULP, so casting ``q`` itself would quantise the updates away.
    """
    if params.mesh_dtype is None:
        for _ in range(loops):
            q = q + dt * pma_dqdt(q, u, grid, params, monitor_source,
                                  geometry_fn)
        return q

    md = _dtype(params.mesh_dtype)
    q0 = q.to(md)
    um = u.to(md)
    acc = torch.zeros_like(q0)
    for _ in range(loops):
        acc = acc + dt * pma_dqdt(q0 + acc, um, grid, params,
                                  monitor_source, geometry_fn)
    return q + acc.to(q.dtype)
