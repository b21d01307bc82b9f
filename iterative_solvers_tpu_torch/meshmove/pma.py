"""Parabolic Monge–Ampère spectral mesh solver
(port of ``iterative_solvers_tpu/meshmove/pma.py``).

    dQ/dt = [alpha (I - gamma lap_ksi)]^{-1} sqrt(mon |J|)

applied spectrally: forward 2-D DCT, pointwise divide by ``1 - gamma Leig``,
inverse DCT.  :func:`loop_pma` runs the explicit sub-steps as a host loop
over device tensors (no host sync inside); on the card, in f32, on the
deviation potential with a monitor source that declares its kernel form,
each sub-step is the hand-written kernels of ``ops.pma_substep``.
:func:`solve_shifted_neumann` is the iterative alternative to the spectral
solve (Chebyshev or CG on the stencil operator), :func:`mesh_steady_state`
iterates to a steady mesh.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from ..core.grid import Grid2D
from ..ops import curvilinear, pma_substep
from ..ops.dct import dct2, idct2
from ..utils.trace import span, to_host
from .monitor import smooth_and_regularise


@dataclasses.dataclass(frozen=True)
class PMAParams:
    """Mesh-adaptivity knobs."""

    alpha: float = 0.01        # mesh adaption speed
    gamma: float = 0.1         # smoothing extent
    mackenzie_c: float = 1.0   # Mackenzie constant (0.15 for the droplet)
    smoothing_iters: int = 4
    spectral_dtype: str | None = None   # e.g. "float32": DCT solve in f32
    spectral_precision: str = "highest"
    # "highest" or "high": both run the DCT matmuls in full f32 here (see
    # ops.dct.dct2, which raises for anything lower).
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
    prec = params.spectral_precision  # dct2 raises below "high"
    dqdt = idct2(dct2(q_rhs, precision=prec) / (1.0 - params.gamma * leig),
                 precision=prec)
    return dqdt.to(out_dtype)


def neumann_laplacian(v, grid: Grid2D):
    """3-point computational-space Laplacian with the half-sample-symmetric
    (DCT-II) Neumann closure, over the reference's mixed ``dx*dy`` spacing:
    the stencil form of the operator the spectral solve inverts (consistent
    ``pi k / N`` frequencies, where :func:`pma_leig` keeps the reference's
    ``pi k / (N-1)``)."""
    lap_y = torch.cat([v[1:2] - v[:1], v[:-2] + v[2:] - 2.0 * v[1:-1],
                       v[-2:-1] - v[-1:]], dim=0)
    lap_x = torch.cat([v[:, 1:2] - v[:, :1],
                       v[:, :-2] + v[:, 2:] - 2.0 * v[:, 1:-1],
                       v[:, -2:-1] - v[:, -1:]], dim=1)
    return (lap_y + lap_x) / (grid.dx * grid.dy)


def shifted_neumann_eig_bounds(grid: Grid2D, gamma: float):
    """Exact extreme eigenvalues of ``I - gamma * neumann_laplacian``."""
    ey = 2.0 - 2.0 * np.cos(np.pi * (grid.ny - 1) / grid.ny)
    ex = 2.0 - 2.0 * np.cos(np.pi * (grid.nx - 1) / grid.nx)
    return 1.0, 1.0 + gamma * (ey + ex) / (grid.dx * grid.dy)


def solve_shifted_neumann(rhs, grid: Grid2D, params: PMAParams, *,
                          method: str = "chebyshev", tol: float = 1e-8,
                          lap: Callable | None = None, maxiter: int = 2000,
                          group=None):
    """Iteratively solve ``(I - gamma lap_neumann) x = rhs``.

    ``method="chebyshev"``: a Chebyshev iteration with the exact eigenvalue
    bounds and a count fixed from the convergence factor (no inner
    products, no host sync).  ``method="cg"``: conjugate gradients
    (:func:`..solvers.cg.cg`).  ``lap`` overrides the Laplacian application;
    with a sharded ``rhs`` block (``dist.droplet``) it is the halo-lifted
    one and ``group`` sums CG's inner products over the ranks.
    """
    gamma = params.gamma
    lap_fn = lap if lap is not None else (lambda v: neumann_laplacian(v, grid))

    def op(v):
        return v - gamma * lap_fn(v)

    lam_min, lam_max = shifted_neumann_eig_bounds(grid, gamma)
    if method == "cg":
        from ..solvers.cg import cg

        return cg(op, rhs, tol=tol, maxiter=maxiter, group=group).x
    if method != "chebyshev":
        raise ValueError(f"method must be 'chebyshev' or 'cg', got {method!r}")

    # Saad, "Iterative Methods for Sparse Linear Systems", alg. 12.1, with
    # the count from rho = (sqrt(kappa) - 1) / (sqrt(kappa) + 1)
    kappa = lam_max / lam_min
    conv = (np.sqrt(kappa) - 1.0) / (np.sqrt(kappa) + 1.0)
    iters = min(maxiter,
                max(3, int(np.ceil(np.log(tol / 2.0) / np.log(conv)))))

    def scalar(c):
        return torch.tensor(c, dtype=rhs.dtype, device=rhs.device)

    theta = scalar((lam_max + lam_min) / 2.0)
    delta = scalar((lam_max - lam_min) / 2.0)
    sigma = theta / delta
    x, r, dvec, rho_prev = torch.zeros_like(rhs), rhs, rhs / theta, 1.0 / sigma
    for _ in range(iters):
        x = x + dvec
        r = r - op(dvec)
        rho = 1.0 / (2.0 * sigma - rho_prev)
        dvec = rho * rho_prev * dvec + (2.0 * rho / delta) * r
        rho_prev = rho
    return x


def pma_dqdt(q, u, grid: Grid2D, params: PMAParams,
             monitor_source: Callable, geometry_fn: Callable | None = None):
    """Geometry -> monitor source -> smoothing -> spectral solve, each phase
    in a span of its own (``pma.geometry``, ``pma.monitor``, ``pma.solve``).
    ``geometry_fn=curvilinear.mesh_geometry_dev`` reads ``q`` as the
    deviation potential."""
    with span("pma.geometry"):
        geom = (geometry_fn or curvilinear.mesh_geometry)(q, grid)
    with span("pma.monitor"):
        src = monitor_source(u, geom, grid)
        mon = smooth_and_regularise(
            src, geom.jac, grid.dx, grid.dy,
            smoothing_iters=params.smoothing_iters,
            mackenzie_c=params.mackenzie_c,
            cap=params.monitor_cap,
        )
    with span("pma.solve"):
        return solve_pma(mon, geom.jac, grid, params)


def _fused_form(s, u, grid: Grid2D, params: PMAParams, monitor_source: Callable,
                geometry_fn: Callable | None) -> bool:
    """Whether the sub-loop on the state ``s`` (the potential, or the base
    the increment is added to) and the film ``u`` is what the fused kernels of
    ``ops.pma_substep`` compute: f32 fields that require no gradient (the
    kernels have no derivative rule), an f32 spectral solve without a
    monitor cap, at least one smoothing pass, ``ny, nx >= 8``, and the
    geometry and monitor source whose ``pma_kernel`` forms they compute."""
    return (s.dtype == torch.float32 and u.dtype == torch.float32
            and not (s.requires_grad or u.requires_grad)
            and params.spectral_dtype in (None, "float32")
            and params.monitor_cap is None and params.smoothing_iters >= 1
            and min(grid.shape) >= 8
            and getattr(geometry_fn, "pma_kernel", None) == pma_substep.GEOMETRY
            and getattr(monitor_source, "pma_kernel", None) == pma_substep.MONITOR)


def _fused(s, u, grid: Grid2D, params: PMAParams, monitor_source: Callable,
           geometry_fn: Callable | None) -> bool:
    """:func:`_fused_form` on CUDA tensors: the sub-loop takes the kernels."""
    return (s.is_cuda and u.is_cuda
            and _fused_form(s, u, grid, params, monitor_source, geometry_fn))


def _loop_fused(base, s, u, dt: float, loops: int, grid: Grid2D,
                params: PMAParams):
    """``loops`` sub-steps by the fused kernels on ``phi = base + s``
    (``base`` None: ``phi = s``); returns the new ``s``.  The film's
    gradient and the spectral denominator are made once."""
    s, u = s.contiguous(), u.contiguous()
    base = None if base is None else base.contiguous()
    u_ksi, u_eta = pma_substep.film_gradient(u, grid)
    den = 1.0 - params.gamma * _leig_tensor(grid, s.dtype, s.device)
    for _ in range(loops):
        with span("pma.substep"), span("pma.fused"):
            s = pma_substep.substep(base, s, u, u_ksi, u_eta, den, grid, dt=dt,
                                    smoothing_iters=params.smoothing_iters,
                                    mackenzie_c=params.mackenzie_c,
                                    alpha=params.alpha,
                                    precision=params.spectral_precision)
    return s


def loop_pma(q, u, dt: float, loops: int, grid: Grid2D, params: PMAParams,
             monitor_source: Callable, geometry_fn: Callable | None = None):
    """``loops`` explicit PMA sub-steps.

    With ``params.mesh_dtype`` set, the sub-loop runs in that dtype and
    carries the accumulated *increment* (``q0 + acc``), not the updated
    potential: one update ``dt * dqdt`` is ~1e-9 of ``q``, below the f32
    ULP, so casting ``q`` itself would quantise the updates away.

    Where :func:`_fused` holds, each sub-step runs the fused kernels (a
    ``pma.fused`` span inside its ``pma.substep`` span): the same numbers
    as the eager chain but for the order of the Mackenzie sum.
    """
    with span("pma.loop"):
        if params.mesh_dtype is None:
            if _fused(q, u, grid, params, monitor_source, geometry_fn):
                return _loop_fused(None, q, u, dt, loops, grid, params)
            for _ in range(loops):
                with span("pma.substep"):
                    q = q + dt * pma_dqdt(q, u, grid, params, monitor_source,
                                          geometry_fn)
            return q

        md = _dtype(params.mesh_dtype)
        q0 = q.to(md)
        um = u.to(md)
        acc = torch.zeros_like(q0)
        if _fused(q0, um, grid, params, monitor_source, geometry_fn):
            acc = _loop_fused(q0, acc, um, dt, loops, grid, params)
        else:
            for _ in range(loops):
                with span("pma.substep"):
                    acc = acc + dt * pma_dqdt(q0 + acc, um, grid, params,
                                              monitor_source, geometry_fn)
        return q + acc.to(q.dtype)


def mesh_steady_state(q, u, dt: float, grid: Grid2D, params: PMAParams,
                      monitor_source: Callable, atol: float,
                      max_iters: int = 10000):
    """Iterate the PMA to a steady mesh (the reference's ``check_mesh``):
    stop when the largest node displacement of a sub-step is below
    ``atol``.  One host sync a sub-step.  Returns ``(q, iterations,
    converged)``."""
    geom = curvilinear.mesh_geometry(q, grid)
    x_old, y_old = geom.x, geom.y
    i, diff = 0, float("inf")
    while diff >= atol and i < max_iters:
        q = q + dt * pma_dqdt(q, u, grid, params, monitor_source)
        geom = curvilinear.mesh_geometry(q, grid)
        diff = to_host(torch.max(torch.sqrt((geom.x - x_old) ** 2
                                            + (geom.y - y_old) ** 2)))
        x_old, y_old = geom.x, geom.y
        i += 1
    return q, i, diff < atol
