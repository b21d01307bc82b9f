"""Thin-film droplet spreading/coalescence on an adaptive moving mesh
(port of ``iterative_solvers_tpu/models/droplet.py``).

Lubrication PDE in curvilinear form on the PMA mesh,

    dh/dt = div( h^3/3 grad p ),   p = -lap h + Pi(h) + Bo cos(a) h

with disjoining pressure ``Pi(h) = (n-1)(m-1) [(eps/h)^m - (eps/h)^n] /
(2 eps (n-m))``, Crank–Nicolson JFNK time stepping and the PMA mesh
sub-loop, quasi-static droplet seeding and inflation, the radius laws and
the mesh-quality diagnostics.  :func:`make_step` is the step;
:func:`evolve`, :func:`inflate` and :func:`evolve_radius_explicit` are the
drivers, host loops with the JAX package's iteration counts and order of
operations.
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
from ..utils.trace import count, span


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
    spectral_precision: str = "highest"  # "high" too: both full f32 here
    monitor_cap: float | None = None    # bounded mesh compression (fine grids)

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
                         spectral_precision=self.spectral_precision,
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


def make_cn_residual_df(u_old, F, geom: MeshGeometry, cfg: DropletConfig):
    """Double-float (two-f32) evaluation of :func:`cn_residual`
    (:mod:`..ops.df64`).

    The geometry-derived coefficient pairs are split once from the f64
    geometry (they are frozen across a step's Newton iterations); each
    evaluation splits only the state.  Returns ``res(x_f64, dt) -> f64
    residual`` matching ``cn_residual(x, u_old, F, dt, geom, cfg)`` to
    ~1e-13 relative.  Eager PyTorch: about 12,000 calls an evaluation at
    any grid size, against the f64 residual's ~760.
    """
    from ..ops import df64 as df

    grid = cfg.grid
    j = geom.jac
    a11 = df.from64((geom.xy * geom.xy + geom.yy * geom.yy) / j)
    a22 = df.from64((geom.xy * geom.xy + geom.xx * geom.xx) / j)
    a12 = df.from64(-(geom.xy * (geom.xx + geom.yy)) / j)
    inv_j = df.from64(1.0 / j)
    qxx = df.from64(geom.xx)
    qyy = df.from64(geom.yy)
    qxy = df.from64(geom.xy)
    u_old_p = df.from64(u_old)
    F_p = df.from64(F)
    n, m, eps = cfg.n_exp, cfg.m_exp, cfg.epsilon
    K = (n - 1) * (m - 1) / (2.0 * eps * (n - m))
    bo_c = float(cfg.Bo * np.cos(cfg.incline))
    neg_drive = float(np.float32(-cfg.Bo * np.sin(cfg.incline) / cfg.epsilon2))
    dx, dy = grid.dx, grid.dy

    def ipow(x, k: int):
        acc = x
        for _ in range(k - 1):
            acc = df.mul(acc, x)
        return acc

    def res(x, dt):
        u = df.from64(x)
        u_ksi = df.d1_x_df(u, dx)
        u_eta = df.d1_y_df(u, dy)

        # curvilinear Laplacian (ops.curvilinear.laplace)
        fx = df.flux_div_x_df(a11, u, 1.0 / (dx * dx))
        fy = df.tT(df.flux_div_x_df(df.tT(a22), df.tT(u), 1.0 / (dy * dy)))
        tx = df.d1_x_df(df.mul(a12, u_eta), dx)
        tx = df.set_col(df.set_col(tx, 0), -1)
        ty = df.d1_y_df(df.mul(a12, u_ksi), dy)
        ty = df.set_row(df.set_row(ty, 0), -1)
        u_xx = df.mul(df.add(fx, tx), inv_j)
        u_yy = df.mul(df.add(fy, ty), inv_j)

        # pressure with the disjoining term
        r = df.scale(df.recip(u), eps)
        pi = df.scale(df.sub(ipow(r, m), ipow(r, n)), K)
        p = df.add(df.neg(df.add(u_xx, u_yy)),
                   df.add(pi, df.scale(u, bo_c)))

        # dp/dn = 0 gradient (pressure_grad_xy)
        p_ksi = df.set_col(df.set_col(df.d1_x_df(p, dx), 0), -1)
        p_eta = df.set_row(df.set_row(df.d1_y_df(p, dy), 0), -1)
        p_dx = df.mul(df.sub(df.mul(qyy, p_ksi), df.mul(qxy, p_eta)), inv_j)
        p_dy = df.mul(df.sub(df.mul(qxx, p_eta), df.mul(qxy, p_ksi)), inv_j)

        # conservative flux divergence (_flux_divergence)
        h3 = df.scale(ipow(u, 3), 1.0 / 3.0)
        A = df.mul(df.add_f(p_dx, neg_drive), h3)
        B = df.mul(p_dy, h3)
        f2 = df.mul(
            df.add(df.sub(df.mul(qyy, df.d1_x_df(A, dx)),
                          df.mul(qxy, df.d1_y_df(A, dy))),
                   df.sub(df.mul(qxx, df.d1_y_df(B, dy)),
                          df.mul(qxy, df.d1_x_df(B, dx)))),
            inv_j)

        # dt enters split from f64, as the state does
        dtp = df.from64(torch.tensor(float(dt), dtype=torch.float64,
                                     device=x.device))
        r_out = df.sub(df.sub(u, u_old_p),
                       df.mul_pow2(df.mul(df.add(f2, F_p), dtp), 0.5))
        return df.to64(r_out)

    return res


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


def monitor_source(u, geom: MeshGeometry, grid: Grid2D, *,
                   staged=curvilinear.unstaged, fd=stencils):
    """mon = |u_xx + u_yy|^2 with the reference's quirk BCs.  ``staged`` and
    ``fd`` as in ``ops.curvilinear.laplace``; ``staged`` also stands where
    the fused PMA kernel keeps ``u`` (the gradients it reads where they are
    used)."""
    u_ksi, u_eta = curvilinear.grad_ksi_neumann(u, grid, quirk=True, fd=fd)
    uxx, uyy = curvilinear.laplace(staged("u", u), u_ksi, u_eta, geom, grid,
                                   staged=staged, fd=fd)
    return torch.abs(uxx + uyy) ** 2


# the fused stage that computes this source (``ops.pma_substep.MONITOR``)
monitor_source.pma_kernel = "quirk_laplacian_sq"


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


def asymptotic_radius_ode(r, t, cfg: DropletConfig):
    """dR/dt of the asymptotic spreading law; numpy (a 1-D ODE integrated
    on the host by :func:`asymptotic_radius_trajectory`)."""
    lam = cfg.epsilon * 4.06522
    return (512.0 / r ** 9 - 1.0) / (3.0 * np.log(0.5 * r / lam) - 3.0)


def rdot(R, V, cfg: DropletConfig):
    """The explicit radius law."""
    return (8.0 * V / R ** 3 - 1.0) / float(3.0 * np.log(1.0 / cfg.epsilon))


def initial_mesh_potential(cfg: DropletConfig, dtype=torch.float64,
                           device="cuda"):
    """Q = (ksi^2 + eta^2)/2 — the identity mesh, on ``device`` (default
    CUDA; raises if CUDA is absent and ``device="cpu"`` was not passed)."""
    dev = resolve_device(device)
    grid = cfg.grid
    return 0.5 * (grid.xx_op(dtype, dev) ** 2 + grid.yy_op(dtype, dev) ** 2)


def inflate(cfg: DropletConfig, drops, vsteps: int, dtmesh: float,
            pma_loops: int, q0=None, dtype=torch.float64, geometry_fn=None,
            start: int = 0, count: int | None = None, u_prev=None,
            device="cuda"):
    """Quasi-static inflation: ramp the drop volumes over ``vsteps`` while
    sub-iterating the PMA mesh (``pma_loops`` sub-steps a volume step).
    ``drops`` entries are (x, y, R, V_final).  Returns ``(q, u)``.

    The reference's ordering: volume step i seeds its solution on the
    pre-PMA mesh, while the PMA monitor uses the previous volume step's
    solution (``u_prev`` lags by one volume step).

    ``geometry_fn=curvilinear.mesh_geometry_dev`` reads the state as the
    deviation potential (``q0`` then the deviation, zeros for an identity
    mesh).  ``start``/``count``/``u_prev`` resume the ramp: volume steps
    ``[start, start + count)`` from the given carry.  ``device`` as in
    :func:`make_step`.
    """
    dev = resolve_device(device)
    grid = cfg.grid
    if geometry_fn is None:
        geometry_fn = curvilinear.mesh_geometry
    if q0 is None:
        q0 = initial_mesh_potential(cfg, dtype, dev)
    q = torch.as_tensor(q0, device=dev)
    if count is None:
        count = vsteps - start
    drops = [tuple(float(c) for c in d) for d in drops]
    if u_prev is None:
        u_prev = torch.full(grid.shape, cfg.epsilon, dtype=q.dtype, device=dev)
    u_prev = torch.as_tensor(u_prev, device=dev)
    for i in range(start, start + count):
        frac = (i + 1) / vsteps
        u_new = seeded_solution(geometry_fn(q, grid), cfg,
                                [(x0, y0, R, vf * frac) for x0, y0, R, vf in drops])
        q = loop_pma(q, u_prev, dtmesh, pma_loops, grid, cfg.pma,
                     monitor_source, geometry_fn)
        u_prev = u_new
    return q, u_prev


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
              residual_mode: str = "f64",
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

    ``residual_mode="df64"`` evaluates the outer residuals (convergence
    checks, line search, forcing) with the compensated two-f32 chain of
    :func:`make_cn_residual_df` instead of f64; the state stays f64.  Pair
    it with ``jvp_dtype`` (FD differencing would difference its rounding
    floor).

    ``device`` is where the step runs (default CUDA; raises if CUDA is
    absent and ``device="cpu"`` was not passed).

    With the tracing of ``utils.trace`` on, the step records a ``step`` span
    and the counter ``droplet.residual_evals``: every evaluation of the
    residual handed to the solver, Newton's own and each finite-difference
    matvec (the JVP paths' matvecs evaluate none).
    """
    dev = resolve_device(device)
    if solver is None:
        # reference: newton_krylov(..., maxiter=20, f_tol=1e-7)
        solver = NewtonKrylov(f_tol=1e-7, maxiter=20)
    if jvp_kernel and jvp_dtype != "float32":
        raise ValueError("jvp_kernel requires jvp_dtype='float32'")
    if residual_mode not in ("f64", "df64"):
        raise ValueError(
            f"residual_mode must be 'f64' or 'df64', got {residual_mode!r}")
    grid = cfg.grid
    geometry_fn = (curvilinear.mesh_geometry_dev if deviation_form
                   else curvilinear.mesh_geometry)

    def step(u, q, dt_n, dtmesh_n=None, x0=None):
        # ``dtmesh_n`` overrides the static ``dtmesh``; ``x0`` overrides the
        # Newton initial guess (the reference starts from u_old)
        with span("step"):
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
            if residual_mode == "df64":
                rdf = make_cn_residual_df(u, F, geom, cfg)
                res_fn = partial(rdf, dt=dt_n)
            else:
                res_fn = partial(cn_residual, u_old=u, F=F, dt=dt_n, geom=geom,
                                 cfg=cfg)

            def residual(v):
                # Newton's own evaluations and every finite-difference matvec
                count("droplet.residual_evals")
                return res_fn(v)

            res = slv.solve(residual, u if x0 is None else torch.as_tensor(x0, device=dev))
            # reference ordering: the PMA monitor is driven by the *old* solution
            q_new = loop_pma(q, u, dtmesh if dtmesh_n is None else dtmesh_n,
                             pma_loops, grid, cfg.pma, monitor_source, geometry_fn)
            return DropletStepResult(u=res.x, q=q_new, newton_iters=res.iters,
                                     f_norm=res.f_norm, converged=res.converged)

    return step


def evolve(cfg: DropletConfig, u0, q0, dt: float, nsteps: int,
           dtmesh: float = 3e-9, pma_loops: int = 400,
           solver: NewtonKrylov | None = None, device="cuda", **step_kw):
    """``nsteps`` steps of :func:`make_step` with the reference's adaptive
    dt law: step n runs at ``dt * scale`` and then
    ``scale += exp(-10 ||u_new - u_old||_2)``.  ``step_kw``
    (``jvp_dtype``, ``jvp_kernel``, ``deviation_form``, ``residual_mode``)
    go to :func:`make_step`.  Returns ``(u, q, t, (iters, f_norms, dts))``,
    the last three numpy arrays of length ``nsteps``."""
    dev = resolve_device(device)
    step = make_step(cfg, dt, dtmesh, pma_loops, solver, device=dev, **step_kw)
    u = torch.as_tensor(u0, device=dev)
    q = torch.as_tensor(q0, device=dev)
    scale, t = 1.0, 0.0
    iters, f_norms, dts = [], [], []
    for _ in range(nsteps):
        dt_n = dt * scale
        out = step(u, q, dt_n)
        norm = torch.sqrt(torch.sum((out.u - u) ** 2)).item()
        scale += float(np.exp(-10.0 * norm))
        t += dt_n
        iters.append(out.newton_iters)
        f_norms.append(out.f_norm)
        dts.append(dt_n)
        u, q = out.u, out.q
    return u, q, t, (np.asarray(iters, dtype=np.int64), np.asarray(f_norms),
                     np.asarray(dts))


def fast_solver(f_tol: float = 1e-7, inner_m: int = 12,
                outer_k: int = 6, maxiter: int = 20) -> NewtonKrylov:
    """The droplet JFNK with an f32 inner Krylov (the FD directional
    derivatives stay f64: the disjoining pressure's cancellations need
    it) and scipy's iteration caps."""
    return NewtonKrylov(f_tol=f_tol, maxiter=maxiter, inner_m=inner_m,
                        outer_k=outer_k, inner_dtype="float32")


def asymptotic_radius_trajectory(cfg: DropletConfig, r0: float,
                                 times: np.ndarray) -> np.ndarray:
    """Integrate the asymptotic spreading law over ``times`` (16 RK4
    sub-steps per interval, on the host); returns R at each time."""
    r = float(r0)
    out = [r]
    for t0, t1 in zip(times[:-1], times[1:]):
        nsub = 16
        h = (t1 - t0) / nsub
        for i in range(nsub):
            t = t0 + i * h
            k1 = float(asymptotic_radius_ode(r, t, cfg))
            k2 = float(asymptotic_radius_ode(r + 0.5 * h * k1, t + 0.5 * h, cfg))
            k3 = float(asymptotic_radius_ode(r + 0.5 * h * k2, t + 0.5 * h, cfg))
            k4 = float(asymptotic_radius_ode(r + h * k3, t + h, cfg))
            r += h * (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
        out.append(r)
    return np.asarray(out)


def evolve_radius_explicit(cfg: DropletConfig, u0, q0, *, r0: float,
                           r_final: float, volume: float = 1.0,
                           tol: float = 1e-2, pma_loops: int = 25,
                           dtmesh: float | None = None, max_steps: int = 500,
                           device="cuda"):
    """Explicit radius evolution: grow R by :func:`rdot` with
    ``dt = 0.05 R^2``, re-seed the quasi-static solution at the new radius
    on the current mesh, then run ``pma_loops`` PMA sub-steps; until
    ``|r_final - R| <= tol`` or ``max_steps``.  Returns ``(u, q, R, steps)``."""
    dev = resolve_device(device)
    grid = cfg.grid
    if dtmesh is None:
        dtmesh = cfg.dtmesh
    dt_r = 5e-2  # the reference's dtR
    u = torch.as_tensor(u0, device=dev)
    q = torch.as_tensor(q0, device=dev)
    r, steps = float(r0), 0
    while abs(r_final - r) > tol and steps < max_steps:
        r = r + dt_r * r * r * rdot(r, volume, cfg)
        geom = curvilinear.mesh_geometry(q, grid)
        rr = torch.sqrt(geom.x ** 2 + geom.y ** 2)
        u = cfg.epsilon + (1.0 - cfg.epsilon) * seed_height(
            seed_profile(rr, r, cfg), r, volume)
        q = loop_pma(q, u, dtmesh, pma_loops, grid, cfg.pma, monitor_source)
        steps += 1
    return u, q, r, steps


# -- mesh-quality diagnostics ------------------------------------------------

def interior_spacings(geom: MeshGeometry):
    """Spacings of each interior node to its E, S, SE and SW neighbours, an
    ``(ny-2, nx-2, 4)`` stack (the intended index alignment: the
    reference's SE/SW expressions mix row offsets, a diagnostics-only quirk
    not reproduced)."""
    xx, yy = geom.x, geom.y
    xc, yc = xx[1:-1, 1:-1], yy[1:-1, 1:-1]
    e = torch.abs(xx[1:-1, 2:] - xc)
    s = torch.abs(yc - yy[:-2, 1:-1])
    se = torch.sqrt((yy[:-2, 2:] - yc) ** 2 + (xx[:-2, 2:] - xc) ** 2)
    sw = torch.sqrt((yy[:-2, :-2] - yc) ** 2 + (xx[:-2, :-2] - xc) ** 2)
    return torch.stack([e, s, se, sw], dim=-1)


def min_spacing(geom: MeshGeometry):
    """Minimum interior node spacing (the reference's per-step mesh-quality
    diagnostic; of order 1/a near the contact line)."""
    return torch.min(interior_spacings(geom))


def distance_to_contact_line(geom: MeshGeometry, R: float,
                             center: tuple[float, float] = (0.0, 0.0)):
    """Per-node distance ``| |x - c| - R |`` to the contact line of a drop
    of radius ``R`` centred at ``center``."""
    r = torch.sqrt((geom.x - center[0]) ** 2 + (geom.y - center[1]) ** 2)
    return torch.abs(r - R)


def contact_line_stats(geom: MeshGeometry, R: float,
                       center: tuple[float, float] = (0.0, 0.0),
                       band: float = 0.02):
    """Mesh adaptivity at the contact line: the number of nodes within
    ``band`` of it, the closest node's distance, and the smallest interior
    spacing among band nodes (which should be of order 1/a).  0-dim
    tensors."""
    d = distance_to_contact_line(geom, R, center)
    in_band = d < band
    sp = torch.min(interior_spacings(geom), dim=-1).values
    inf = torch.full_like(sp, float("inf"))
    return {
        "band_nodes": torch.sum(in_band),
        "min_distance": torch.min(d),
        "min_band_spacing": torch.min(torch.where(in_band[1:-1, 1:-1], sp, inf)),
    }
