"""Thin-film droplet spreading/coalescence on an adaptive moving mesh
(port of ``iterative_solvers_tpu/models/droplet.py``).

Lubrication PDE in curvilinear form on the PMA mesh,

    dh/dt = div( h^3/3 grad p ),   p = -lap h + Pi(h) + Bo cos(a) h

with disjoining pressure ``Pi(h) = (n-1)(m-1) [(eps/h)^m - (eps/h)^n] /
(2 eps (n-m))``, Crank–Nicolson JFNK time stepping and the PMA mesh
sub-loop.  :func:`make_step` is the entry point.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.grid import Grid2D
from ..meshmove.pma import PMAParams, loop_pma
from ..ops import curvilinear, stencils
from ..ops.curvilinear import MeshGeometry
from ..ops.droplet_jvp import jvp_matvec
from ..solvers.newton import NewtonKrylov


@dataclasses.dataclass(frozen=True)
class DropletConfig:
    """The reference's droplet globals."""

    # physics
    R: float = 1.0            # droplet radius
    a: float = 100.0          # interface sharpness of the seeding profile
    epsilon: float = 1e-2     # precursor-film thickness
    n_exp: int = 6            # disjoining-pressure exponents
    m_exp: int = 3
    Bo: float = 0.01          # Bond number
    incline: float = 0.0      # substrate inclination angle

    # grid
    nx: int = 91
    ny: int = 61
    xl: float = -3.0
    xr: float = 6.0
    yb: float = -3.0
    yt: float = 3.0

    # mesh adaptivity
    alpha: float = 0.01
    gamma: float = 0.1
    mackenzie_c: float = 0.15
    dtmesh: float = 1e-7
    smoothing_iters: int = 4
    spectral_dtype: str | None = None   # "float32" = f32 PMA transforms
    mesh_dtype: str | None = None       # "float32" = whole PMA loop in f32
    spectral_precision: str = "highest"
    monitor_cap: float | None = None    # bounded mesh compression (fine grids)

    def __post_init__(self):
        # the DCT matmuls run in full precision only: a reduced-precision
        # pass (TF32 here) is the error class that tangles the mesh
        if self.spectral_precision != "highest":
            raise ValueError(f"spectral_precision={self.spectral_precision!r}:"
                             " the port runs the DCTs in full precision only")

    @property
    def grid(self) -> Grid2D:
        return Grid2D(nx=self.nx, ny=self.ny, xl=self.xl, xr=self.xr,
                      yb=self.yb, yt=self.yt)

    @property
    def pma(self) -> PMAParams:
        return PMAParams(alpha=self.alpha, gamma=self.gamma,
                         mackenzie_c=self.mackenzie_c,
                         smoothing_iters=self.smoothing_iters,
                         spectral_dtype=self.spectral_dtype,
                         mesh_dtype=self.mesh_dtype,
                         monitor_cap=self.monitor_cap)

    @property
    def epsilon2(self) -> float:
        """Thickness/extent ratio Ho/Lo (1/Dy)."""
        return 1.0 / (self.yt - self.yb)


# -- physics -----------------------------------------------------------------

def disjoining_pressure(h, cfg: DropletConfig):
    """Pi(h)."""
    n, m, eps = cfg.n_exp, cfg.m_exp, cfg.epsilon
    r = eps / h
    return (n - 1) * (m - 1) * (r ** m - r ** n) / (2.0 * eps * (n - m))


def pressure(h, hxx, hyy, cfg: DropletConfig):
    """p = -lap h + Pi(h) + Bo cos(a) h."""
    return (-(hxx + hyy) + disjoining_pressure(h, cfg)
            + float(cfg.Bo * np.cos(cfg.incline)) * h)


def _flux_divergence(p_dx, p_dy, h, geom: MeshGeometry, grid: Grid2D,
                     cfg: DropletConfig):
    """div( h^3/3 (grad p - driving) ) in curvilinear form."""
    drive = float(cfg.Bo * np.sin(cfg.incline) / cfg.epsilon2)
    h3 = h ** 3 / 3.0
    A = (p_dx - drive) * h3
    B = p_dy * h3
    a_ksi = stencils.d1_x(A, grid.dx)
    a_eta = stencils.d1_y(A, grid.dy)
    b_ksi = stencils.d1_x(B, grid.dx)
    b_eta = stencils.d1_y(B, grid.dy)
    return (geom.yy * a_ksi - geom.xy * a_eta
            - geom.xy * b_ksi + geom.xx * b_eta) / geom.jac


def pressure_grad_xy(p, geom: MeshGeometry, grid: Grid2D):
    """Physical-space pressure gradient with dp/dn = 0 on the boundary."""
    p_ksi = curvilinear._zero_edges(stencils.d1_x(p, grid.dx), rows=False)
    p_eta = curvilinear._zero_edges(stencils.d1_y(p, grid.dy), cols=False)
    return curvilinear.grad_xy(p_ksi, p_eta, geom)


def pde_rhs(h, geom: MeshGeometry, cfg: DropletConfig):
    """Explicit dh/dt at the current state, with the pressure taken from the
    quirk-BC'd solution derivatives as the reference's time loop does."""
    grid = cfg.grid
    h_ksi, h_eta = curvilinear.grad_ksi_neumann(h, grid, quirk=True)
    hxx, hyy = curvilinear.laplace(h, h_ksi, h_eta, geom, grid)
    p = pressure(h, hxx, hyy, cfg)
    p_dx, p_dy = pressure_grad_xy(p, geom, grid)
    return _flux_divergence(p_dx, p_dy, h, geom, grid, cfg)


def cn_residual(u, u_old, F, dt, geom: MeshGeometry, cfg: DropletConfig):
    """Crank–Nicolson residual, not divided by dt:
    ``F(u) = (u - u_old) - dt (F2(u) + F)/2``.  The Laplacian inside uses
    the raw computational derivatives of u."""
    grid = cfg.grid
    u_ksi = stencils.d1_x(u, grid.dx)
    u_eta = stencils.d1_y(u, grid.dy)
    u_xx, u_yy = curvilinear.laplace(u, u_ksi, u_eta, geom, grid)
    p = pressure(u, u_xx, u_yy, cfg)
    p_dx, p_dy = pressure_grad_xy(p, geom, grid)
    F2 = _flux_divergence(p_dx, p_dy, u, geom, grid, cfg)
    return (u - u_old) - dt * (F2 + F) / 2.0


def jvp_field_stack(x, geom: MeshGeometry, cfg: DropletConfig, dt):
    """Coefficient fields of the linearised CN residual at the Newton
    iterate ``x``: stack = [1/J, Q_ksiksi, Q_etaeta, Q_ksieta, c0..c3] with

        c0 = Pi'(x) + Bo cos(a)            [local pressure linearisation]
        c1 = (dt/2) x^3/3                  [mobility]
        c2 = (dt/2) (p_dx(x) - drive) x^2  [product-rule flux terms]
        c3 = (dt/2) p_dy(x) x^2

    so the matvec computes ``J v = v - dF2'[v]`` with dt/2 folded in.
    """
    grid = cfg.grid
    n, m, eps = cfg.n_exp, cfg.m_exp, cfg.epsilon
    K = (n - 1) * (m - 1) / (2.0 * eps * (n - m))
    r = eps / x
    dpi = K * (-m * r ** m + n * r ** n) / x
    c0 = dpi + float(cfg.Bo * np.cos(cfg.incline))
    x_ksi = stencils.d1_x(x, grid.dx)
    x_eta = stencils.d1_y(x, grid.dy)
    xxd, yyd = curvilinear.laplace(x, x_ksi, x_eta, geom, grid)
    p = pressure(x, xxd, yyd, cfg)
    p_dx, p_dy = pressure_grad_xy(p, geom, grid)
    drive = float(cfg.Bo * np.sin(cfg.incline) / cfg.epsilon2)
    half_dt = 0.5 * dt
    c1 = half_dt * x ** 3 / 3.0
    x2 = half_dt * x * x
    c2 = (p_dx - drive) * x2
    c3 = p_dy * x2
    inv_j = 1.0 / geom.jac
    return torch.stack([inv_j, geom.xx, geom.yy, geom.xy, c0, c1, c2, c3])


def monitor_source(u, geom: MeshGeometry, grid: Grid2D):
    """mon = |u_xx + u_yy|^2 with the reference's quirk BCs."""
    u_ksi, u_eta = curvilinear.grad_ksi_neumann(u, grid, quirk=True)
    uxx, uyy = curvilinear.laplace(u, u_ksi, u_eta, geom, grid)
    return torch.abs(uxx + uyy) ** 2


# -- droplet seeding ---------------------------------------------------------

def _softplus(x):
    """log(1 + exp(x)) = max(x, 0) + log1p(exp(-|x|)): no overflow in f32."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def seed_profile(r, R, cfg: DropletConfig):
    """G(r): smoothed distance to the contact line, in softplus form (the
    reference's literal form computes exp(2aR) ~ e^200, inf below f64)."""
    a = cfg.a
    return R + (_softplus(-2.0 * a * (r + R))
                - _softplus(-2.0 * a * (r - R))) / (2.0 * a)


def seed_height(psi, R, V):
    """H(psi): parabolic cap of volume ~V."""
    return 4.0 * V * (1.0 - psi * psi / (R * R)) / (R * R)


def seeded_solution(geom: MeshGeometry, cfg: DropletConfig,
                    drops: Sequence[tuple[float, float, float, float]]):
    """Multi-droplet quasi-static solution on the current mesh; ``drops``
    entries are (x, y, R, V)."""
    u = torch.full(geom.x.shape, cfg.epsilon, dtype=geom.x.dtype,
                   device=geom.x.device)
    for (x0, y0, R, V) in drops:
        r = torch.sqrt((geom.x - x0) ** 2 + (geom.y - y0) ** 2)
        u = u + (1.0 - cfg.epsilon) * seed_height(seed_profile(r, R, cfg), R, V)
    return u


def initial_mesh_potential(cfg: DropletConfig, dtype=torch.float64,
                           device="cuda"):
    """Q = (ksi^2 + eta^2)/2 — the identity mesh, on ``device`` (default
    CUDA; raises if CUDA is absent and ``device="cpu"`` was not passed)."""
    dev = resolve_device(device)
    grid = cfg.grid
    return 0.5 * (grid.xx_op(dtype, dev) ** 2 + grid.yy_op(dtype, dev) ** 2)


# -- the step ----------------------------------------------------------------

class DropletStepResult(NamedTuple):
    u: torch.Tensor
    q: torch.Tensor
    newton_iters: int
    f_norm: float
    converged: bool


def make_step(cfg: DropletConfig, dt: float, dtmesh: float, pma_loops: int,
              solver: NewtonKrylov | None = None,
              deviation_form: bool = False,
              jvp_dtype: str | None = None,
              jvp_kernel: bool = False,
              device="cuda"):
    """One evolve_with_PDE step: CN/JFNK solve of the PDE on the frozen
    mesh, then ``pma_loops`` explicit PMA sub-steps.  Returns
    ``step(u, q, dt_n, dtmesh_n=None, x0=None)``.

    ``deviation_form=True`` reads the mesh state as the deviation potential
    (``ops.curvilinear.mesh_geometry_dev``) — the f32-robust fine-grid form.

    ``jvp_dtype="float32"`` runs the inner Krylov on exact f32 JVPs
    (``torch.func.jvp`` of the f32-cast residual) instead of f64 FD
    directional derivatives; outer residuals, line search and convergence
    checks stay in the state dtype.

    ``jvp_kernel=True`` (with ``jvp_dtype="float32"``) replaces that JVP by
    :func:`..ops.droplet_jvp.jvp_matvec` on the coefficient stack of
    :func:`jvp_field_stack` — the hand-written CUDA kernel on a GPU.

    ``device`` is where the step runs (default CUDA; raises if CUDA is
    absent and ``device="cpu"`` was not passed).
    """
    dev = resolve_device(device)
    if solver is None:
        # reference: newton_krylov(..., maxiter=20, f_tol=1e-7)
        solver = NewtonKrylov(f_tol=1e-7, maxiter=20)
    if jvp_kernel and jvp_dtype != "float32":
        raise ValueError("jvp_kernel requires jvp_dtype='float32'")
    grid = cfg.grid
    geometry_fn = (curvilinear.mesh_geometry_dev if deviation_form
                   else curvilinear.mesh_geometry)

    def step(u, q, dt_n, dtmesh_n=None, x0=None):
        # ``dtmesh_n`` overrides the static ``dtmesh``; ``x0`` overrides the
        # Newton initial guess (the reference starts from u_old)
        u = torch.as_tensor(u, device=dev)
        q = torch.as_tensor(q, device=dev)
        geom = geometry_fn(q, grid)
        F = pde_rhs(u, geom, cfg)
        slv = solver
        if jvp_dtype is not None:
            jd = getattr(torch, jvp_dtype)
            geom_j = MeshGeometry(*(a.to(jd) for a in geom))
            u_j, F_j = u.to(jd), F.to(jd)
            dt_j = torch.tensor(dt_n, dtype=jd, device=dev)

            if jvp_kernel:
                def factory(x, fx):
                    stack = jvp_field_stack(x.to(jd), geom_j, cfg, dt_j)
                    return lambda v: jvp_matvec(v, stack, grid)
            else:
                def factory(x, fx):
                    x_j = x.to(jd)

                    def res_j(w):
                        return cn_residual(w, u_old=u_j, F=F_j, dt=dt_j,
                                           geom=geom_j, cfg=cfg)
                    return lambda v: torch.func.jvp(res_j, (x_j,), (v,))[1]

            slv = dataclasses.replace(solver, matvec_factory=factory,
                                      inner_dtype=jvp_dtype)
        res_fn = partial(cn_residual, u_old=u, F=F, dt=dt_n, geom=geom, cfg=cfg)
        res = slv.solve(res_fn, u if x0 is None else torch.as_tensor(x0, device=dev))
        # reference ordering: the PMA monitor is driven by the *old* solution
        q_new = loop_pma(q, u, dtmesh if dtmesh_n is None else dtmesh_n,
                         pma_loops, grid, cfg.pma, monitor_source, geometry_fn)
        return DropletStepResult(u=res.x, q=q_new, newton_iters=res.iters,
                                 f_norm=res.f_norm, converged=res.converged)

    return step


# -- mesh-quality diagnostics ------------------------------------------------

def min_spacing(geom: MeshGeometry):
    """Minimum interior node spacing to the E, S, SE, SW neighbours (the
    reference's per-step mesh-quality diagnostic)."""
    xx, yy = geom.x, geom.y
    xc, yc = xx[1:-1, 1:-1], yy[1:-1, 1:-1]
    e = torch.abs(xx[1:-1, 2:] - xc)
    s = torch.abs(yc - yy[:-2, 1:-1])
    se = torch.sqrt((yy[:-2, 2:] - yc) ** 2 + (xx[:-2, 2:] - xc) ** 2)
    sw = torch.sqrt((yy[:-2, :-2] - yc) ** 2 + (xx[:-2, :-2] - xc) ** 2)
    return torch.min(torch.stack([e, s, se, sw], dim=-1))
