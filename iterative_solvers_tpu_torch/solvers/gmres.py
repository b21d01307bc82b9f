"""Restarted GMRES and the Krylov helpers it shares with LGMRES
(port of ``iterative_solvers_tpu/solvers/gmres.py``).

Vectors are fields of any shape on the device.  Orthogonalisation is
classical Gram–Schmidt with one re-orthogonalisation (CGS2) against the
live basis rows, as two matrix-vector products per round (the JAX
package's chunked form of the same projection is a TPU memory-traffic
device and is not carried).  The small Hessenberg/Givens recurrence lives
on the host (numpy, in the Krylov dtype): its inputs come back with the
one host sync per Arnoldi step that the convergence decision needs anyway.

``group`` is the reduction of a field sharded over ranks
(``dist/``): every inner product and norm is summed over that process
group, so every rank takes the same host decisions; ``None`` (the
default) is the single-device path.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

from ..dist.comm import reduce_sum
from ..utils.trace import span, to_host


def _norm(a, group=None):
    """Euclidean norm of a field, as a 0-d device tensor."""
    a = a.reshape(-1)
    return torch.sqrt(reduce_sum(torch.dot(a, a), group))


def _cgs2(V, w, group=None):
    """CGS2 of ``w`` against the rows of ``V`` (``V`` holds exactly the live
    basis rows).  Returns ``(h, w_deflated)`` with ``h`` of length
    ``V.shape[0]`` on the device; with a ``group``, one all-reduce of each
    round's projections."""
    Vf = V.reshape(V.shape[0], -1)
    wf = w.reshape(-1)
    h = reduce_sum(Vf @ wf, group)
    wf = wf - h @ Vf
    h2 = reduce_sum(Vf @ wf, group)
    wf = wf - h2 @ Vf
    return h + h2, wf.reshape(w.shape)


def _apply_givens(h: np.ndarray, cs: np.ndarray, sn: np.ndarray, j: int):
    """Apply the first ``j`` stored rotations to the new column ``h``
    (host numpy, in place)."""
    for i in range(j):
        hi, hi1 = h[i], h[i + 1]
        h[i] = cs[i] * hi + sn[i] * hi1
        h[i + 1] = -sn[i] * hi + cs[i] * hi1
    return h


def _np_dtype(dtype: torch.dtype):
    return np.dtype(str(dtype).removeprefix("torch."))


def _givens_step(h: np.ndarray, beta, cs: np.ndarray, sn: np.ndarray,
                 g: np.ndarray, j: int):
    """Reduce the new Hessenberg column ``h`` (subdiagonal ``beta``) with
    the stored rotations and a new one; updates ``h``, ``cs``, ``sn`` and
    ``g`` in place and returns the residual estimate ``|g[j + 1]|``."""
    h = _apply_givens(h, cs, sn, j)
    hj = h[j]
    rho = np.sqrt(hj * hj + beta * beta)
    one, zero = h.dtype.type(1), h.dtype.type(0)
    c, s = (hj / rho, beta / rho) if rho > 0 else (one, zero)
    cs[j], sn[j] = c, s
    h[j] = rho
    g[j + 1] = -s * g[j]
    g[j] = c * g[j]
    return abs(g[j + 1])


def _arnoldi_column(V, w, j: int, ndt, group=None):
    """CGS2 of ``w`` against the ``j + 1`` live rows of ``V``; stores the
    normalised remainder in ``V[j + 1]`` and returns the Hessenberg column
    (host, length ``V.shape[0]``) and its subdiagonal — the step's one
    host sync."""
    h_dev, w = _cgs2(V[:j + 1], w, group)
    hb = to_host(torch.cat([h_dev, _norm(w, group)[None]]), "numpy")
    h = np.zeros(V.shape[0], dtype=ndt)
    h[:j + 1] = hb[:j + 1]
    beta = hb[j + 1]
    V[j + 1] = w / float(beta if beta > 0 else 1.0)
    return h, beta


class GmresResult(NamedTuple):
    x: torch.Tensor
    iters: int             # total inner (Arnoldi) iterations
    resnorm: float         # final residual norm ||b - A x||, recomputed
    converged: bool


def _gmres_cycle(matvec: Callable, precond: Callable, x0, r0, r0norm, tol_abs,
                 restart: int, group=None):
    """One restart cycle from residual ``r0`` (norm ``r0norm``, host).
    Returns ``(x_new, res_est, j)`` with host numbers."""
    with span("krylov.cycle"):
        ndt = _np_dtype(r0.dtype)
        m = restart
        V = torch.zeros((m + 1,) + tuple(r0.shape), dtype=r0.dtype, device=r0.device)
        V[0] = r0 / float(r0norm if r0norm > 0 else 1.0)
        R = np.eye(m, dtype=ndt)
        g = np.zeros(m + 1, dtype=ndt)
        g[0] = r0norm
        cs = np.zeros(m, dtype=ndt)
        sn = np.zeros(m, dtype=ndt)

        j, res = 0, ndt.type(r0norm)
        while j < m and res > tol_abs:
            h, beta = _arnoldi_column(V, matvec(precond(V[j])), j, ndt, group)
            res = _givens_step(h, beta, cs, sn, g, j)
            R[:, j] = h[:m]
            j += 1

        if j == 0:
            return x0, res, 0
        # entries of g at/beyond the active column count hold the residual
        # value, not least-squares data: the triangle is the leading j x j
        y = scipy.linalg.solve_triangular(R[:j, :j], g[:j], lower=False)
        y = torch.as_tensor(y.astype(ndt), device=r0.device)
        dx = torch.tensordot(y, V[:j], dims=1)
        return x0 + precond(dx), res, j


def gmres(matvec: Callable, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
          restart: int = 30, maxiter: int | None = None,
          M: Callable | None = None, group=None) -> GmresResult:
    """Solve ``A x = b`` with right-preconditioned restarted GMRES.

    ``M``, if given, applies an approximate inverse of ``A`` (right
    preconditioning: the reported residual is the true one).  ``maxiter``
    bounds the inner (Arnoldi) iterations, checked between restarts.
    Convergence: ``||b - A x|| <= max(tol ||b||, atol)``.  ``b`` may be
    a rank's block of a field sharded over ``group`` (each rank's
    ``restart`` is then capped by its own block's size).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    precond = M if M is not None else (lambda v: v)
    restart = int(min(restart, b.numel()))
    if maxiter is None:
        maxiter = 10 * restart
    ndt = _np_dtype(b.dtype)
    tol_abs = ndt.type(max(tol * to_host(_norm(b, group)), atol))

    x, iters = x0, 0
    r = b - matvec(x)
    res = ndt.type(to_host(_norm(r, group)))
    while res > tol_abs and iters < maxiter:
        x, _, j = _gmres_cycle(matvec, precond, x, r, res, tol_abs, restart, group)
        iters += j
        # the Givens estimate can drift below the true residual (CGS2
        # roundoff): the outer loop and the report use the true residual
        r = b - matvec(x)
        res = ndt.type(to_host(_norm(r, group)))
    return GmresResult(x=x, iters=iters, resnorm=float(res),
                       converged=bool(res <= tol_abs))
