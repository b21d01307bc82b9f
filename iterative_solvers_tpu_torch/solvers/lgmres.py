"""LGMRES with outer-vector recycling
(port of ``iterative_solvers_tpu/solvers/lgmres.py``).

Each cycle builds an augmented subspace of ``inner_m`` Arnoldi vectors
plus up to ``outer_k`` recycled solution directions from earlier cycles,
solves the flexible-GMRES least-squares problem over it (the ``A z_j``
orthonormalised into ``V``, the Hessenberg reduced by Givens rotations)
and appends the new correction to the recycle buffer — scipy's ``lgmres``
semantics.  The Newton solver uses one cycle per Newton iteration with the
buffer carried across iterations and no cached ``A z``; :func:`lgmres` is
the standalone solver, which caches ``A z`` (``store_av``) by default.

The loop runs on the host; fields stay on the device.  Per Arnoldi step
there is one host sync, for the convergence decision.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

from .gmres import _arnoldi_column, _givens_step, _norm, _np_dtype


class LgmresRecycle(NamedTuple):
    """Fixed-size recycle buffer of normalised outer directions.

    ``z[i]`` are earlier updates ``dx/||dx||``, oldest first among the
    first ``count`` slots.  ``az[i]`` caches ``A z[i]`` when the buffer
    was made with ``store_av`` (``None`` otherwise: the Newton solver's
    Jacobian changes between iterations, scipy's ``store_outer_Av=False``).
    """

    z: torch.Tensor                # (outer_k, *shape)
    count: int                     # number of valid entries
    az: torch.Tensor | None = None  # (outer_k, *shape) or None


class LgmresResult(NamedTuple):
    x: torch.Tensor
    iters: int             # total inner (Arnoldi) iterations
    resnorm: float         # final residual norm ||b - A x||, recomputed
    converged: bool


def init_recycle(shape, outer_k: int, dtype, device="cpu",
                 store_av: bool = False) -> LgmresRecycle:
    z = torch.zeros((outer_k,) + tuple(shape), dtype=dtype, device=device)
    return LgmresRecycle(z=z, count=0,
                         az=torch.zeros_like(z) if store_av else None)


def _push_recycle(rec: LgmresRecycle, dx, adx=None) -> LgmresRecycle:
    """Append dx/||dx|| (and A dx/||dx|| when the buffer caches A z) to the
    buffer, evicting the oldest entry when full; a zero ``dx`` leaves the
    buffer as it is."""
    nx = _np_dtype(dx.dtype).type(_norm(dx).item())
    if not nx > 0:
        return rec
    scale = float(nx.dtype.type(1.0) / nx)
    k = rec.z.shape[0]

    def pushed(buf, new):
        if rec.count >= k:
            buf = torch.roll(buf, -1, dims=0)
            buf[-1] = new * scale
        else:
            buf = buf.clone()
            buf[rec.count] = new * scale
        return buf

    return LgmresRecycle(z=pushed(rec.z, dx), count=min(rec.count + 1, k),
                         az=None if rec.az is None else pushed(rec.az, adx))


def _lgmres_cycle(matvec: Callable, precond: Callable, x, r, rnorm, tol_abs,
                  inner_m: int, rec: LgmresRecycle):
    """One augmented (inner_m + count) cycle from residual ``r`` with norm
    ``rnorm`` (host scalar).  Returns ``(x + dx, res_est, j, rec)`` with the
    Givens residual estimate and the step count as host numbers."""
    ndt = _np_dtype(r.dtype)
    rnorm = ndt.type(rnorm)
    tol_abs = ndt.type(tol_abs)
    shape = r.shape
    outer_k = rec.z.shape[0]
    mtot = inner_m + outer_k
    steps = inner_m + rec.count

    V = torch.zeros((mtot + 1,) + shape, dtype=r.dtype, device=r.device)
    # flexible-right preconditioning: the Arnoldi basis starts from the raw
    # residual (scipy _fgmres: v0 = r/||r||); M^{-1} enters only through
    # the directions z_j = precond(V[j]).  Starting from precond(r) breaks
    # the least-squares identity V[0] g[0] ~ r whenever M != I.
    V[0] = r / float(rnorm if rnorm > 0 else 1.0)
    Z = torch.zeros((mtot,) + shape, dtype=r.dtype, device=r.device)
    R = np.eye(mtot, dtype=ndt)
    g = np.zeros(mtot + 1, dtype=ndt)
    g[0] = rnorm
    cs = np.zeros(mtot, dtype=ndt)
    sn = np.zeros(mtot, dtype=ndt)

    j, res = 0, rnorm
    while j < steps and res > tol_abs:
        if j >= inner_m:
            z = rec.z[j - inner_m]
            w = matvec(z) if rec.az is None else rec.az[j - inner_m]
        else:
            z = precond(V[j])
            w = matvec(z)
        Z[j] = z
        h, beta = _arnoldi_column(V, w, j, ndt)
        res = _givens_step(h, beta, cs, sn, g, j)
        R[:, j] = h[:mtot]
        j += 1

    if j == 0:
        dx = torch.zeros_like(r)
    else:
        # entries of g at/beyond the active column count hold the residual
        # value, not least-squares data: the triangle is the leading j x j
        y = scipy.linalg.solve_triangular(R[:j, :j], g[:j], lower=False)
        y = torch.as_tensor(y.astype(ndt), device=r.device)
        dx = torch.tensordot(y, Z[:j], dims=1)
    rec = _push_recycle(rec, dx, None if rec.az is None else matvec(dx))
    return x + dx, res, j, rec


def lgmres(matvec: Callable, b, x0=None, *, tol: float = 1e-5,
           atol: float = 0.0, inner_m: int = 30, outer_k: int = 3,
           maxiter: int = 1000, M: Callable | None = None,
           recycle: LgmresRecycle | None = None,
           store_av: bool = True) -> tuple[LgmresResult, LgmresRecycle]:
    """Solve ``A x = b`` by LGMRES.  Returns ``(result, recycle buffer)``.

    ``maxiter`` counts outer cycles (scipy's convention).  Pass the
    returned buffer back in to speed up a sequence of related solves; a
    buffer passed in keeps its own ``store_av`` setting.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    precond = M if M is not None else (lambda v: v)
    inner_m = int(min(inner_m, b.numel()))
    if recycle is None:
        recycle = init_recycle(b.shape, outer_k, b.dtype, b.device, store_av)
    ndt = _np_dtype(b.dtype)
    tol_abs = ndt.type(max(tol * _norm(b).item(), atol))

    x, rec, iters, cycles = x0, recycle, 0, 0
    r = b - matvec(x)
    res = ndt.type(_norm(r).item())
    while res > tol_abs and cycles < maxiter:
        x, _, j, rec = _lgmres_cycle(matvec, precond, x, r, res, tol_abs,
                                     inner_m, rec)
        iters += j
        cycles += 1
        # gate the outer loop on the true residual (the Givens estimate drifts)
        r = b - matvec(x)
        res = ndt.type(_norm(r).item())
    return (LgmresResult(x=x, iters=iters, resnorm=float(res),
                         converged=bool(res <= tol_abs)), rec)
