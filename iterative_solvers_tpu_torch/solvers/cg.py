"""Preconditioned conjugate gradients for SPD systems
(port of ``iterative_solvers_tpu/solvers/cg.py``).

Complements GMRES for the symmetric operators of the workload set
(Poisson, shifted Laplacians).  Vectors are fields of any shape on the
device.  The loop runs on the host, in the style of :func:`..gmres.gmres`:
per iteration one host sync, for the convergence test ``||r|| > tol_abs``,
which is evaluated once per iteration before the update as in the JAX
loop, so iteration counts match; ``alpha`` and ``beta`` stay on the
device.  ``group`` sums the inner products over the ranks of a sharded
field (``dist/``); ``None`` is the single-device path.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..dist.comm import reduce_sum
from ..utils.trace import to_host
from .gmres import _norm, _np_dtype


def _dot(a, b, group=None):
    return reduce_sum(torch.dot(a.reshape(-1), b.reshape(-1)), group)


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: float         # final residual norm ||b - A x||, recomputed
    converged: bool


def cg(matvec: Callable, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
       maxiter: int | None = None, M: Callable | None = None,
       group=None) -> CGResult:
    """Solve SPD ``A x = b``; ``M`` applies an approximate inverse.
    Convergence: ``||b - A x|| <= max(tol ||b||, atol)``."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if maxiter is None:
        maxiter = 10 * b.numel()
    precond = M if M is not None else (lambda v: v)
    ndt = _np_dtype(b.dtype)
    tol_abs = ndt.type(max(tol * to_host(_norm(b, group)), atol))

    x = x0
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = _dot(r, z, group)
    k = 0
    while ndt.type(to_host(_norm(r, group))) > tol_abs and k < maxiter:
        ap = matvec(p)
        alpha = rz / _dot(p, ap, group)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _dot(r, z, group)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    res = ndt.type(to_host(_norm(b - matvec(x), group)))
    return CGResult(x=x, iters=k, resnorm=float(res),
                    converged=bool(res <= tol_abs))
