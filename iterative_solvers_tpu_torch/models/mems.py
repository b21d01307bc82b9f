"""MEMS / touchdown workload on an adaptive moving mesh
(port of ``iterative_solvers_tpu/models/mems.py``).

The reference's PMA2_nk.py (operator-split Crank–Nicolson JFNK) and PMA.py's
coupled method-of-lines variant:

    du/dt = -(-lap)^p u * beta^2 - lambda/(1+u)^2 + lambda eps^(m-2)/(1+u)^m

on the moving mesh (p = 1 Laplacian, or p = 2 biharmonic as a double
application of the curvilinear Laplacian), with homogeneous boundary
values, the ``1/(1+u)^6`` monitor (epsilon = 0), the adaptive near-touchdown
step ``dt = k min (1+u)^3`` (:func:`compute_g`) and an explicit PMA mesh
update per physical step.

:func:`make_step` reads ``min (1+u)^3`` on the host once a step (the dt of
the step is a Python float, as the JAX step's is an f64 scalar), and with
the tracing of ``utils.trace`` on records a ``step`` span, a ``mems.mesh``
span around the mesh half (monitor, smoothing, PMA solve) and the counter
``mems.residual_evals`` (every residual evaluation of the step's JFNK
solve, the finite-difference matvecs included);
:func:`evolve` is a host loop over it and :func:`evolve_coupled` hands the
coupled ``(u, Q)`` system to :class:`..solvers.bdf.BDF`, on a CUDA device
with the right-hand side replayed as one CUDA graph
(:func:`graphed_coupled_rhs`).  On a CUDA device each of the path's
4th-order stencils (``ops/stencils``: 8 a residual evaluation, 6 for the
geometry) is one launch of the hand-written ``fd_stencil`` kernel; the rest
is eager, and at 51 x 51 every step is bound by the host's dispatch of
small eager operations.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core.grid import Grid2D
from ..meshmove.monitor import smooth_and_regularise
from ..meshmove.pma import PMAParams, solve_pma
from ..ops import curvilinear, stencils
from ..ops.curvilinear import MeshGeometry
from ..solvers.newton import NewtonKrylov
from ..utils.trace import count, span, to_host


@dataclasses.dataclass(frozen=True)
class MEMSConfig:
    """Reference globals PMA2_nk.py:22-40."""

    n: int = 51
    p: int = 2               # 1: Laplacian, 2: biharmonic
    m: int = 3               # 3: Van der Waals, 4: Casimir
    alpha: float = 0.1
    gamma: float = 0.1
    epsilon: float = 0.0
    beta: float = 0.15
    lambd: float = 1.0
    smoothing_iters: int = 4
    k: float = 1e-4          # base time step
    tf: float = 0.3

    @property
    def grid(self) -> Grid2D:
        return Grid2D(nx=self.n, ny=self.n, xl=-1, xr=1, yb=-1, yt=1)

    @property
    def pma(self) -> PMAParams:
        return PMAParams(alpha=self.alpha, gamma=self.gamma, mackenzie_c=1.0,
                         smoothing_iters=self.smoothing_iters)


def _ipow(x, k: int):
    """``x ** k`` for an integer ``k >= 1`` by binary exponentiation, the
    products in the order JAX's ``integer_pow`` takes (so ``(1+u) ** 6``
    rounds as the JAX package's does)."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


@lru_cache(maxsize=16)
def _boundary_mask(grid: Grid2D, device: torch.device) -> torch.Tensor:
    """``grid.mask_boundary`` as a bool tensor on ``device``, copied once."""
    return torch.as_tensor(grid.mask_boundary, device=device)


def lap_xy_raw(v, geom: MeshGeometry, grid: Grid2D):
    """Curvilinear Laplacian with raw first derivatives (the PMA2_nk
    residual's convention: no boundary zeroing of v_ksi / v_eta)."""
    v_ksi = stencils.d1_x(v, grid.dx)
    v_eta = stencils.d1_y(v, grid.dy)
    vxx, vyy = curvilinear.laplace(v, v_ksi, v_eta, geom, grid)
    return vxx + vyy


def rhs_pde(u, geom: MeshGeometry, cfg: MEMSConfig):
    """du/dt without the (disabled) Lagrangian mesh-advection term
    (PMA2_nk.py:405-419); zero on the boundary."""
    grid = cfg.grid
    up1 = 1.0 + u
    rhs = -cfg.lambd / _ipow(up1, 2) + cfg.lambd * (
        cfg.epsilon ** (cfg.m - 2)
    ) / _ipow(up1, cfg.m)
    lap_u = lap_xy_raw(u, geom, grid)
    if cfg.p == 1:
        rhs = rhs + cfg.beta * cfg.beta * lap_u
    else:
        rhs = rhs - cfg.beta * cfg.beta * lap_xy_raw(lap_u, geom, grid)
    return torch.where(_boundary_mask(grid, u.device), 0.0, rhs)


def lagrangian_term(u, q_dt, geom: MeshGeometry, cfg: MEMSConfig):
    """Upwinded mesh-advection term grad_x{u} . grad_ksi{Q_t}
    (PMA2_nk.py:421-444: implemented there and never enabled), with the
    correctly scaled upwind differences of ``ops.stencils``."""
    grid = cfg.grid
    a = stencils.d1_x(q_dt, grid.dx)
    b = stencils.d1_y(q_dt, grid.dy)
    uf_x = stencils.d1_x_forward(u, grid.dx)
    ub_x = stencils.d1_x_backward(u, grid.dx)
    uf_y = stencils.d1_y_forward(u, grid.dy)
    ub_y = stencils.d1_y_backward(u, grid.dy)
    j = geom.jac
    am, ap = torch.clamp(a, max=0), torch.clamp(a, min=0)
    bm, bp = torch.clamp(b, max=0), torch.clamp(b, min=0)
    ret = am * (bp * (geom.yy * ub_x - geom.xy * uf_y) / j
                + bm * (geom.yy * ub_x - geom.xy * ub_y) / j) \
        + ap * (bp * (geom.yy * uf_x - geom.xy * uf_y) / j
                + bm * (geom.yy * uf_x - geom.xy * ub_y) / j)
    ret = ret + am * (bp * (-geom.xy * ub_x + geom.xx * uf_y) / j
                      + bm * (-geom.xy * ub_x + geom.xx * ub_y) / j) \
        + ap * (bp * (-geom.xy * uf_x + geom.xx * uf_y) / j
                + bm * (-geom.xy * uf_x + geom.xx * ub_y) / j)
    return ret


def monitor_source(u, geom: MeshGeometry, grid: Grid2D, cfg: MEMSConfig):
    """The monitor selection of PMA2_nk.py:345-367."""
    if cfg.epsilon == 0:
        return 1.0 / _ipow(1.0 + u, 6)
    v_ksi = stencils.d1_x(u, grid.dx)
    v_eta = stencils.d1_y(u, grid.dy)
    if cfg.p == 1:
        ux, uy = curvilinear.grad_xy(v_ksi, v_eta, geom)
        return 1.0 + ux * ux + uy * uy
    uxx, uyy = curvilinear.laplace(u, v_ksi, v_eta, geom, grid)
    lap = torch.abs(uxx + uyy)
    return lap * lap


def compute_g(u, cfg: MEMSConfig):
    """Adaptive step factor: min (1+u)^3 near touchdown (PMA2_nk.py:446), a
    0-d tensor on ``u``'s device."""
    if cfg.epsilon == 0:
        return torch.min(_ipow(1.0 + u, 3))
    return torch.ones((), dtype=u.dtype, device=u.device)


def cn_residual(u, u_old, cn_term, dt, geom: MeshGeometry, cfg: MEMSConfig):
    """Crank–Nicolson residual (PMA2_nk.py:121-159):
    F(u) = (u - u_old)/dt - (rhs(u) + rhs(u_old))/2, with rhs zeroed on the
    boundary (the geometry is frozen at the old mesh during the solve)."""
    return (u - u_old) / dt - (rhs_pde(u, geom, cfg) + cn_term) / 2.0


class MEMSStepResult(NamedTuple):
    u: torch.Tensor
    q: torch.Tensor
    dt: float
    newton_iters: int
    converged: bool


def make_step(cfg: MEMSConfig, solver: NewtonKrylov | None = None,
              device="cuda"):
    """One operator-split step (PMA2_nk.py:80-106): geometry -> adaptive dt
    -> PMA dQ/dt -> CN/JFNK update of u -> explicit mesh update.  Returns
    ``step(u, q) -> MEMSStepResult`` on ``device`` (default CUDA; raises if
    CUDA is absent and ``device="cpu"`` was not passed)."""
    dev = resolve_device(device)
    if solver is None:
        solver = NewtonKrylov()
    grid = cfg.grid

    def step(u, q):
        with span("step"):
            u = torch.as_tensor(u, device=dev)
            q = torch.as_tensor(q, device=dev)
            geom = curvilinear.mesh_geometry(q, grid)
            dt = to_host(compute_g(u, cfg), "item") * cfg.k
            with span("mems.mesh"):
                src = monitor_source(u, geom, grid, cfg)
                mon = smooth_and_regularise(src, geom.jac, grid.dx, grid.dy,
                                            cfg.smoothing_iters, 1.0)
                q_dt = solve_pma(mon, geom.jac, grid, cfg.pma)
            cn_term = rhs_pde(u, geom, cfg)

            def residual(v):
                # Newton's own evaluations and every finite-difference matvec
                count("mems.residual_evals")
                return cn_residual(v, u_old=u, cn_term=cn_term, dt=dt, geom=geom,
                                   cfg=cfg)

            res = solver.solve(residual, u)
            q_new = q + dt * q_dt
            return MEMSStepResult(u=res.x, q=q_new, dt=dt,
                                  newton_iters=res.iters, converged=res.converged)

    return step


def initial_state(cfg: MEMSConfig, dtype=torch.float64, device="cuda"):
    """u = 0, Q = (ksi^2 + eta^2)/2 (PMA2_nk.py:68-71), on ``device``."""
    dev = resolve_device(device)
    grid = cfg.grid
    q = 0.5 * (grid.xx_op(dtype, dev) ** 2 + grid.yy_op(dtype, dev) ** 2)
    u = torch.zeros(grid.shape, dtype=dtype, device=dev)
    return u, q


def coupled_rhs(t, y, cfg: MEMSConfig):
    """Method-of-lines RHS of the coupled (u, Q) system, the PMA.py
    formulation (ode_coupled_systems, PMA.py:377-415): mesh and solution
    evolve as one stiff ODE system.  ``y`` stacks [u, q] as (2, n, n)."""
    grid = cfg.grid
    u, q = y[0], y[1]
    geom = curvilinear.mesh_geometry(q, grid)
    src = monitor_source(u, geom, grid, cfg)
    mon = smooth_and_regularise(src, geom.jac, grid.dx, grid.dy,
                                cfg.smoothing_iters, 1.0)
    dqdt = solve_pma(mon, geom.jac, grid, cfg.pma)
    dudt = rhs_pde(u, geom, cfg)
    return torch.stack([dudt, dqdt])


def graphed_coupled_rhs(cfg: MEMSConfig, y0: torch.Tensor):
    """:func:`coupled_rhs` for states shaped like ``y0`` (on a CUDA device)
    as one CUDA-graph replay: the same kernels on the same inputs as the
    eager call, enqueued without the host's ~2,200 dispatches a call (the
    BDF's finite-difference matvecs call it tens of thousands of times).
    Returns ``f(t, y)``, whose result is a fresh tensor."""
    dev = y0.device
    x = y0.clone()
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):  # builds the cached bases, tables and masks
            coupled_rhs(0.0, x, cfg)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = coupled_rhs(0.0, x, cfg)

    def rhs(t, y):
        x.copy_(y)
        graph.replay()
        return out.clone()

    return rhs


def evolve_coupled(cfg: MEMSConfig, tf: float, bdf=None, u0=None, q0=None,
                   device="cuda"):
    """Integrate the coupled system to ``tf`` with the adaptive BDF/JFNK
    integrator (the reference hands it to scipy's BDF, PMA.py:68).  Returns
    ``(u, q, BDFResult)``.  On a CUDA device the right-hand side runs as a
    CUDA graph (:func:`graphed_coupled_rhs`)."""
    from ..solvers.bdf import BDF

    dev = resolve_device(device)
    if bdf is None:
        bdf = BDF()
    if u0 is None or q0 is None:
        u0, q0 = initial_state(cfg, device=dev)
    y0 = torch.stack([torch.as_tensor(u0, device=dev),
                      torch.as_tensor(q0, device=dev)])
    f = (graphed_coupled_rhs(cfg, y0) if dev.type == "cuda"
         else partial(coupled_rhs, cfg=cfg))
    res = bdf.solve(f, y0, 0.0, tf, device=dev)
    return res.y[0], res.y[1], res


def evolve(cfg: MEMSConfig, nsteps: int, solver: NewtonKrylov | None = None,
           u0=None, q0=None, device="cuda"):
    """``nsteps`` operator-split steps (the time horizon follows from the
    adaptive dt; the reference loops while t < Tf).  Returns ``(u, q, t,
    dts, iters)``, ``t`` a Python float and ``dts``, ``iters`` numpy arrays
    of length ``nsteps``."""
    dev = resolve_device(device)
    step = make_step(cfg, solver, dev)
    if u0 is None or q0 is None:
        u0, q0 = initial_state(cfg, device=dev)
    u = torch.as_tensor(u0, device=dev)
    q = torch.as_tensor(q0, device=dev)
    t, dts, iters = 0.0, [], []
    for _ in range(nsteps):
        out = step(u, q)
        u, q, t = out.u, out.q, t + out.dt
        dts.append(out.dt)
        iters.append(out.newton_iters)
    return u, q, t, np.asarray(dts), np.asarray(iters, dtype=np.int64)
