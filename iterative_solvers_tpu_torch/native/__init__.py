"""The native solver API on the port
(counterpart of ``iterative_solvers_tpu/native/__init__.py``).

The JAX package binds a C++ library (CSR SpMV, LGMRES, Jacobian-free
Newton–Krylov with a Python residual callback, and the Swift–Hohenberg
driver) through ctypes.  The port gives the same entry points over its own
pieces, on the GPU unless the caller passes ``device="cpu"``; numpy and
scipy arrays go in and numpy arrays come out:

- :func:`spmv_csr` — ``ops.sparse.CSR.matvec``;
- :func:`lgmres_csr` — ``solvers.lgmres.lgmres`` on that matvec, with the
  library's stopping rule (``||b - A x|| <= tol ||b||``) and its outer
  cycle count;
- :func:`nonlin_solve` — ``solvers.newton.newton_krylov`` with the
  library's (scipy's) defaults; the residual stays a numpy callback, so
  every evaluation takes the state to the host and back;
- :func:`sh_evolve` — ``models.swift_hohenberg.make_cn_step`` with those
  Newton defaults: the CN residual on the SH operator, which on a GPU is
  the ``sh_operator`` kernel in f64;
- :func:`sh_operator_nnz` — ``ops.sparse.sh_operator``'s nnz;
- :func:`ensure_built` — builds the port's CUDA kernel library.

``python -m iterative_solvers_tpu_torch.native`` is the counterpart of the
library's ``sh_driver`` executable.
"""
from __future__ import annotations

import pathlib
import shutil

import numpy as np
import torch

from .. import resolve_device, to_numpy
from ..models.swift_hohenberg import SHConfig, make_cn_step
from ..ops import _build
from ..ops import sparse
from ..solvers.lgmres import _lgmres_run
from ..solvers.newton import NewtonKrylov

F_TOL = 6.05545445239334e-06   # eps**(1/3): scipy's newton_krylov default


def ensure_built(force: bool = False) -> pathlib.Path:
    """Build the port's kernel library (``ops/_build.load_library``) and
    return its path.  Raises where it cannot be built (no CUDA, no
    ``nvcc``): there is no fallback.  ``force`` rebuilds from scratch."""
    if force:
        _build.clear()
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    return pathlib.Path(_build.load_library()._name)


def _csr(a_csr, dev) -> sparse.CSR:
    return sparse.CSR.from_scipy(a_csr.tocsr().astype(np.float64), device=dev)


def _vec(x, dev):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64).reshape(-1),
                           device=dev)


def spmv_csr(a_csr, x, *, device="cuda") -> np.ndarray:
    """``A x`` of a scipy sparse matrix."""
    dev = resolve_device(device)
    return to_numpy(_csr(a_csr, dev).matvec(_vec(x, dev)))


def lgmres_csr(a_csr, b, x0=None, *, tol=1e-8, maxiter=1000, inner_m=30,
               outer_k=3, device="cuda"):
    """LGMRES solve of a scipy sparse system, stopped when
    ``||b - A x|| <= tol ||b||`` or after ``maxiter`` outer cycles.
    Returns ``(x, info)``: ``converged``, ``outer_cycles``, ``matvecs``
    (every product with A, the residuals' included) and ``residual``
    (``||b - A x||``)."""
    dev = resolve_device(device)
    a = _csr(a_csr, dev)
    calls = [0]

    def matvec(v):
        calls[0] += 1
        return a.matvec(v)

    b = _vec(b, dev)
    res, _, cycles = _lgmres_run(matvec, b, None if x0 is None else _vec(x0, dev),
                                 tol=tol, atol=0.0, inner_m=inner_m, outer_k=outer_k,
                                 maxiter=maxiter, M=None, recycle=None, store_av=True,
                                 group=None)
    return to_numpy(res.x), {"converged": res.converged, "outer_cycles": cycles,
                             "matvecs": calls[0], "residual": res.resnorm}


def nonlin_solve(residual, x0, *, f_tol=F_TOL, f_rtol=np.inf, x_tol=np.inf,
                 x_rtol=np.inf, maxiter=100, inner_m=30, outer_k=10, device="cuda"):
    """Jacobian-free Newton–Krylov on a numpy residual ``F(x) -> F`` (flat
    f64 arrays).  Returns ``(x, info)``: ``converged``, ``iterations``,
    ``func_evals`` (calls of ``residual``) and ``f_norm`` (max |F(x)|)."""
    dev = resolve_device(device)
    calls = [0]

    def func(x):
        calls[0] += 1
        f = np.asarray(residual(to_numpy(x).copy()), dtype=np.float64).reshape(-1)
        return torch.as_tensor(f, device=dev)

    res = NewtonKrylov(f_tol=f_tol, f_rtol=f_rtol, x_tol=x_tol, x_rtol=x_rtol,
                       maxiter=maxiter, inner_m=inner_m, outer_k=outer_k).solve(
        func, _vec(x0, dev))
    return to_numpy(res.x), {"converged": res.converged, "iterations": res.iters,
                             "func_evals": calls[0], "f_norm": res.f_norm}


def _sh_steps(u0, nsteps, *, n=64, d=40.0, k=0.2, r=0.01, g=1.0, f_tol=F_TOL,
              device="cuda"):
    """``nsteps`` Swift–Hohenberg CN/JFNK steps from the flat ``u0`` with the
    library's Newton defaults.  Returns ``(u, [NewtonResult a step])``."""
    dev = resolve_device(device)
    step = make_cn_step(SHConfig(d=d, n=n, k=k, r=r, g=g),
                        NewtonKrylov(f_tol=f_tol, maxiter=100, inner_m=30, outer_k=10),
                        dev)
    u = _vec(u0, dev).reshape(n, n)
    stats = []
    for _ in range(nsteps):
        u, res = step(u)
        stats.append(res)
    return to_numpy(u).reshape(-1), stats


def sh_evolve(u0, nsteps, *, n=64, d=40.0, k=0.2, r=0.01, g=1.0, f_tol=F_TOL,
              device="cuda"):
    """The Swift–Hohenberg CN/NK evolution of the reference's C++ workload.
    Returns ``(u, number of converged steps)``."""
    u, stats = _sh_steps(u0, nsteps, n=n, d=d, k=k, r=r, g=g, f_tol=f_tol, device=device)
    return u, sum(s.converged for s in stats)


def sh_operator_nnz(n, d, r) -> int:
    """The nnz of the assembled SH operator on an n x n grid of side d."""
    return int(sparse.sh_operator(n, d / n, r).nnz)
