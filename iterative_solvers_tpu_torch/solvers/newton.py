"""Jacobian-free Newton–Krylov (port of ``iterative_solvers_tpu/solvers/newton.py``).

The semantics of ``scipy.optimize.newton_krylov``:

- **matvec**: finite-difference directional derivative
  ``J v ≈ (F(x + sc v) - F(x)) / sc`` with ``sc = omega / ||v||`` and
  ``omega = rdiff * max(1, max|x|) / max(1, max|F|)`` (scipy's rule), or a
  caller's analytic ``matvec_factory``;
- **inner solver**: one LGMRES cycle per Newton iteration (more with
  ``inner_maxiter``), recycled outer vectors carried across iterations;
- **forcing**: the Eisenstat–Walker schedule of scipy's ``_nonlin.py``
  (``gamma=0.9``, ``eta_max=0.9999``, ``eta_threshold=0.1``);
- **line search**: Armijo backtracking on ``||F(x + s dx)||^2``;
- **termination**: scipy's max-norm criteria.

Newton, Armijo and LGMRES are host loops over device tensors; the host
reads scalars only where the loop makes a convergence or breakdown
decision, never inside a matvec.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from .gmres import _norm
from .lgmres import _lgmres_cycle, _np_dtype, init_recycle


def _maxnorm(v):
    return torch.max(torch.abs(v))


class NewtonResult(NamedTuple):
    x: torch.Tensor
    f_norm: float          # max|F(x)| at the solution
    iters: int             # Newton iterations taken
    func_evals: int        # residual evaluations (approximate, as scipy)
    converged: bool


@dataclasses.dataclass(frozen=True)
class NewtonKrylov:
    """Configured JFNK solver; call ``.solve(residual, x0, *args)``.
    Defaults mirror ``scipy.optimize.newton_krylov``."""

    f_tol: float | None = None         # None -> eps**(1/3) of f64 (≈6.06e-6)
    f_rtol: float = np.inf
    x_tol: float = np.inf
    x_rtol: float = np.inf
    maxiter: int = 100
    inner_m: int = 30                  # lgmres subspace per Newton iteration
    outer_k: int = 10                  # recycled vectors
    inner_maxiter: int = 1             # lgmres cycles per Newton iteration
    rdiff: float | None = None         # None -> eps**0.5 of the state dtype
    line_search: bool = True
    max_backtracks: int = 8
    inner_dtype: str | None = None
    # e.g. "float32": run the LGMRES cycle in that dtype while residuals,
    # line search and convergence checks stay in the state dtype.
    matvec_factory: Callable | None = None
    # ``matvec_factory(x, fx) -> (v -> J v)`` in the inner dtype: an
    # analytic Jacobian that replaces the FD residual evaluations.
    psolve_factory: Callable | None = None
    # ``psolve_factory(x, fx) -> (v -> M^{-1} v)``: flexible right
    # preconditioner of the inner cycle.

    def solve(self, residual: Callable, x0: torch.Tensor, *args) -> NewtonResult:
        """Solve ``residual(x, *args) = 0`` starting from ``x0``."""
        dtype = x0.dtype
        inner_dt = getattr(torch, self.inner_dtype) if self.inner_dtype else None
        if inner_dt == dtype:
            inner_dt = None
        kdt = inner_dt if inner_dt is not None else dtype
        f_tol = float(np.finfo(np.float64).eps) ** (1 / 3) \
            if self.f_tol is None else self.f_tol
        f_tol = float(_np_dtype(dtype).type(f_tol))
        rdiff = (self.rdiff if self.rdiff is not None
                 else torch.finfo(dtype).eps ** 0.5)
        rdiff = torch.tensor(rdiff, dtype=dtype, device=x0.device)

        def func(x):
            return residual(x, *args)

        def fd_matvec_at(x, f0):
            """scipy KrylovJacobian.matvec (FD directional derivative)."""
            omega = (rdiff * torch.clamp_min(_maxnorm(x), 1.0)
                     / torch.clamp_min(_maxnorm(f0), 1.0))

            def mv(v):
                nv = _norm(v)
                sc = omega / torch.where(nv > 0, nv, torch.ones_like(nv))
                return torch.where(nv > 0, (func(x + sc * v) - f0) / sc,
                                   torch.zeros_like(v))
            return mv

        def armijo(x, dx, f0_sqnorm):
            """Backtracking line search on phi(s) = ||F(x + s dx)||^2."""
            t = 1e-4
            s, k = 1.0, 0
            fx = func(x + dx)
            phi = _norm(fx).item() ** 2
            while phi > (1 - t * s) ** 2 * f0_sqnorm and k < self.max_backtracks:
                s *= 0.5
                fx = func(x + s * dx)
                phi = _norm(fx).item() ** 2
                k += 1
            return s, fx, k + 1

        gamma, eta_max, eta_threshold = 0.9, 0.9999, 0.1
        x = x0
        fx = func(x0)
        f_norm = _maxnorm(fx).item()
        f0_norm = f_norm
        done = f_norm <= f_tol
        eta = 1e-3
        rec = init_recycle(x0.shape, self.outer_k, kdt, x0.device)
        it, nfev = 0, 1
        while not done and it < self.maxiter:
            if self.matvec_factory is not None:
                mv = self.matvec_factory(x, fx)
                rhs = -fx.to(kdt)
            elif inner_dt is not None:
                mv_full = fd_matvec_at(x, fx)
                mv = lambda v, f=mv_full: f(v.to(dtype)).to(inner_dt)  # noqa: E731
                rhs = -fx.to(kdt)
            else:
                mv = fd_matvec_at(x, fx)
                rhs = -fx
            ps = (self.psolve_factory(x, fx) if self.psolve_factory
                  is not None else (lambda v: v))
            ndt = _np_dtype(kdt)
            rnorm = ndt.type(_norm(rhs).item())
            tol_inner = ndt.type(min(eta, eta * float(rnorm)) * float(rnorm))
            dx, _, inner_j, rec = _lgmres_cycle(
                mv, ps, torch.zeros_like(rhs), rhs, rnorm, tol_inner,
                self.inner_m, rec)
            for _ in range(self.inner_maxiter - 1):
                # restart on the true linear residual, recycle buffer kept
                r = rhs - mv(dx)
                rn = ndt.type(_norm(r).item())
                if not rn > tol_inner:
                    break
                dx, _, jstep, rec = _lgmres_cycle(
                    mv, ps, dx, r, rn, tol_inner, self.inner_m, rec)
                inner_j += jstep
            dx = dx.to(dtype)

            if self.line_search:
                s, fx_new, ls_evals = armijo(x, dx, _norm(fx).item() ** 2)
            else:
                s, fx_new, ls_evals = 1.0, func(x + dx), 1
            x_new = x + s * dx
            f_norm_new, dx_norm, x_norm = torch.stack(
                [_maxnorm(fx_new), _maxnorm(s * dx), _maxnorm(x_new)]).tolist()

            # Eisenstat–Walker forcing-term schedule (scipy _nonlin.py)
            eta_a = gamma * (f_norm_new / max(f_norm, 1e-300)) ** 2
            if gamma * eta ** 2 < eta_threshold:
                eta = min(eta_max, eta_a)
            else:
                eta = min(eta_max, max(eta_a, gamma * eta ** 2))

            # scipy TerminationCondition.check with maxnorm: the f- and
            # x-criteria are AND-ed, so inf defaults reduce to f <= f_tol
            done = ((f_norm_new <= f_tol
                     and f_norm_new / self.f_rtol <= f0_norm
                     and dx_norm <= self.x_tol
                     and dx_norm / self.x_rtol <= x_norm)
                    or f_norm_new == 0.0)
            x, fx, f_norm = x_new, fx_new, f_norm_new
            nfev += inner_j + ls_evals
            it += 1

        return NewtonResult(x=x, f_norm=f_norm, iters=it, func_evals=nfev,
                            converged=bool(done))
