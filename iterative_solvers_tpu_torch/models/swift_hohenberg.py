"""Swift–Hohenberg pattern formation
(port of ``iterative_solvers_tpu/models/swift_hohenberg.py``).

    du/dt = L u + g u^2 - u^3,   L = -(1 + lap)^2 + r  (periodic)

on ``(n, n)`` fields, with the discrete ``L = -Lap^2 - 2 Lap + (r-1) I``
built matrix-free from the 5-point periodic Laplacian.

Two steppers:
- :func:`make_cn_step` / :func:`evolve_cn` — the Crank–Nicolson residual
  solved by Jacobian-free Newton–Krylov;
- :func:`semi_implicit_step` / :func:`evolve_semi_implicit` — the
  linearised lagged-nonlinearity step ``(I + D - kL/2) u+ = (I + kL/2) u``
  by Jacobi-preconditioned restarted GMRES.

Every ``L`` goes through :func:`apply_L`, which on a GPU launches the
``sh_operator`` CUDA kernel for f32 (inner Krylov) and f64 (outer
residuals, semi-implicit solve) fields alike.  The kernel has no
derivative rule, so on a GPU the Newton solver needs FD JVPs (the default)
or the analytic :func:`jacobian_matvec_factory` (:func:`fast_solver`).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from .. import resolve_device
from ..ops.periodic_stencil import sh_operator_kernel
from ..solvers.gmres import GmresResult, gmres
from ..solvers.newton import NewtonKrylov, NewtonResult
from ..utils.trace import span


@dataclasses.dataclass(frozen=True)
class SHConfig:
    """Reference defaults: sh_scipy_nk.py:15-29."""

    d: float = 40.0      # domain size
    n: int = 64          # points per direction
    k: float = 0.2       # time step
    r: float = 0.01      # bifurcation parameter
    g: float = 1.0       # quadratic coefficient

    @property
    def h(self) -> float:
        return self.d / self.n


def apply_L(u, cfg: SHConfig):
    """``L u = -Lap^2 u - 2 Lap u + (r-1) u``: the ``sh_operator`` kernel
    on a CUDA tensor (f32 or f64), its plain version on a CPU tensor."""
    return sh_operator_kernel(u, cfg.h, cfg.r)


def cn_residual(u, u_old, L_uold, cfg: SHConfig):
    """Crank–Nicolson residual (sh_scipy_nk.py:47-49):

    F(u) = (u - u_old)/k - (L u + g u^2 - u^3 + L u_old + g u_old^2 - u_old^3)/2
    """
    uu = u * u
    uo2 = u_old * u_old
    rhs_new = apply_L(u, cfg) + cfg.g * uu - u * uu
    rhs_old = L_uold + cfg.g * uo2 - u_old * uo2
    return (u - u_old) / cfg.k - (rhs_new + rhs_old) / 2.0


@dataclasses.dataclass(frozen=True)
class JacobianMatvec:
    """Analytic Jacobian of the CN residual for ``NewtonKrylov.matvec_factory``:
    ``J v = v/k - (L v + (2 g u - 3 u^2) v) / 2``, in the inner dtype.
    ``apply`` replaces :func:`apply_L` (``v -> L v``); the sharded step
    (``dist.solvers``) sets it to the operator on a rank's block."""

    cfg: SHConfig
    inner_dtype: str | None = None
    apply: object = None

    def __call__(self, x, fx):
        cfg = self.cfg
        coef = 2.0 * cfg.g * x - 3.0 * x * x
        if self.inner_dtype is not None:
            coef = coef.to(getattr(torch, self.inner_dtype))
        op = self.apply if self.apply is not None else (lambda v: apply_L(v, cfg))

        def mv(v):
            return v / cfg.k - (op(v) + coef * v) / 2.0

        return mv


def jacobian_matvec_factory(cfg: SHConfig, inner_dtype: str | None = None):
    """The :class:`JacobianMatvec` of ``cfg`` in ``inner_dtype``."""
    return JacobianMatvec(cfg, inner_dtype)


def fast_solver(cfg: SHConfig, f_tol: float = 6e-6, inner_m: int = 10,
                outer_k: int = 5) -> NewtonKrylov:
    """JFNK with analytic f32 Jacobian matvecs and f32 inner Krylov; the
    outer residuals stay in the state dtype (f64)."""
    return NewtonKrylov(
        f_tol=f_tol, inner_m=inner_m, outer_k=outer_k,
        inner_dtype="float32",
        matvec_factory=jacobian_matvec_factory(cfg, "float32"),
    )


def make_cn_step(cfg: SHConfig, solver: NewtonKrylov | None = None,
                 device="cuda"):
    """Returns ``step(u_old) -> (u_new, NewtonResult)`` on ``device``
    (default CUDA; raises if CUDA is absent and ``device="cpu"`` was not
    passed)."""
    dev = resolve_device(device)
    if solver is None:
        # scipy newton_krylov defaults: f_tol = eps**(1/3) ≈ 6e-6
        solver = NewtonKrylov(maxiter=100)

    def step(u_old) -> tuple[torch.Tensor, NewtonResult]:
        with span("step"):
            u_old = torch.as_tensor(u_old, device=dev)
            L_uold = apply_L(u_old, cfg)
            res = solver.solve(partial(cn_residual, u_old=u_old, L_uold=L_uold,
                                       cfg=cfg), u_old)
            return res.x, res

    return step


def evolve_cn(u0, nsteps: int, cfg: SHConfig,
              solver: NewtonKrylov | None = None, device="cuda"):
    """Run ``nsteps`` CN/JFNK steps.  Returns ``(u, iters, f_norms)`` with
    the Newton iterations and final max-norm residual of each step as
    numpy arrays."""
    dev = resolve_device(device)
    step = make_cn_step(cfg, solver, dev)
    u, iters, f_norms = torch.as_tensor(u0, device=dev), [], []
    for _ in range(nsteps):
        u, res = step(u)
        iters.append(res.iters)
        f_norms.append(res.f_norm)
    return u, np.asarray(iters, dtype=np.int64), np.asarray(f_norms)


def semi_implicit_step(u, u_old, cfg: SHConfig, *, tol=1e-10, restart=40,
                       maxiter=400, device="cuda") -> tuple[torch.Tensor, GmresResult]:
    """Linearised step of sh_linearised.py:51-57.

    D = diag((5u - u_old)^2 k/16 - g k u); solve
    ``(I + D - kL/2) u_new = (I + kL/2) u`` by GMRES, right-preconditioned
    by Jacobi (the diagonal of I + D plus the constant stencil diagonal).
    """
    with span("step"):
        dev = resolve_device(device)
        u = torch.as_tensor(u, device=dev)
        u_old = torch.as_tensor(u_old, device=dev)
        k = cfg.k
        D = (5.0 * u - u_old) ** 2 * (k / 16.0) - cfg.g * k * u
        b = u + (k / 2.0) * apply_L(u, cfg)

        def matvec(v):
            return v + D * v - (k / 2.0) * apply_L(v, cfg)

        # diagonal of L: -(diag(Lap^2)) - 2 diag(Lap) + (r-1); diag(Lap) = -4/h^2,
        # diag(Lap^2) = 20/h^4 for the periodic 5-point stencil
        h2 = cfg.h * cfg.h
        diag_L = -(20.0 / (h2 * h2)) + 8.0 / h2 + (cfg.r - 1.0)
        diag = 1.0 + D - (k / 2.0) * diag_L
        res = gmres(matvec, b, x0=u, tol=tol, restart=restart, maxiter=maxiter,
                    M=lambda v: v / diag)
        return res.x, res


def evolve_semi_implicit(u0, nsteps: int, cfg: SHConfig, device="cuda", **kw):
    """sh_linearised.py main loop: u_old lags one step behind u."""
    dev = resolve_device(device)
    u = u_old = torch.as_tensor(u0, device=dev)
    for _ in range(nsteps):
        u, u_old = semi_implicit_step(u, u_old, cfg, device=dev, **kw)[0], u
    return u
