"""LGMRES cycle with outer-vector recycling
(port of ``iterative_solvers_tpu/solvers/lgmres.py``).

Each cycle builds an augmented subspace of ``inner_m`` Arnoldi vectors
plus up to ``outer_k`` recycled solution directions from earlier cycles,
solves the flexible-GMRES least-squares problem over it (the ``A z_j``
orthonormalised into ``V``, the Hessenberg reduced by Givens rotations)
and appends the new correction to the recycle buffer — scipy's ``lgmres``
semantics, as the Newton solver uses them (one cycle per Newton
iteration, recycle buffer carried across iterations).

The loop runs on the host; fields stay on the device.  Per Arnoldi step
there is one host sync, for the convergence decision.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

from .gmres import _apply_givens, _cgs2, _norm


class LgmresRecycle(NamedTuple):
    """Fixed-size recycle buffer of normalised outer directions.

    ``z[i]`` are earlier updates ``dx/||dx||``, oldest first among the
    first ``count`` slots.  (The Jacobian changes between Newton
    iterations, so no ``A z`` is cached: scipy's ``store_outer_Av=False``.)
    """

    z: torch.Tensor      # (outer_k, *shape)
    count: int           # number of valid entries


def init_recycle(shape, outer_k: int, dtype, device="cpu") -> LgmresRecycle:
    z = torch.zeros((outer_k,) + tuple(shape), dtype=dtype, device=device)
    return LgmresRecycle(z=z, count=0)


def _np_dtype(dtype: torch.dtype):
    return np.dtype(str(dtype).removeprefix("torch."))


def _push_recycle(rec: LgmresRecycle, dx) -> LgmresRecycle:
    """Append dx/||dx|| to the buffer, evicting the oldest entry when
    full; a zero ``dx`` leaves the buffer as it is."""
    nx = _np_dtype(dx.dtype).type(_norm(dx).item())
    if not nx > 0:
        return rec
    scale = float(nx.dtype.type(1.0) / nx)
    k = rec.z.shape[0]
    if rec.count >= k:
        z = torch.roll(rec.z, -1, dims=0)
        z[-1] = dx * scale
    else:
        z = rec.z.clone()
        z[rec.count] = dx * scale
    return LgmresRecycle(z=z, count=min(rec.count + 1, k))


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
        z = rec.z[j - inner_m] if j >= inner_m else precond(V[j])
        w = matvec(z)
        Z[j] = z
        h_dev, w = _cgs2(V[:j + 1], w)
        # the step's one host sync: Hessenberg column and its subdiagonal
        hb = torch.cat([h_dev, _norm(w)[None]]).cpu().numpy()
        h = np.zeros(mtot + 1, dtype=ndt)
        h[:j + 1] = hb[:j + 1]
        beta = hb[j + 1]
        V[j + 1] = w / float(beta if beta > 0 else 1.0)

        h = _apply_givens(h, cs, sn, j)
        hj = h[j]
        rho = np.sqrt(hj * hj + beta * beta)
        c, s = (hj / rho, beta / rho) if rho > 0 else (ndt.type(1), ndt.type(0))
        cs[j], sn[j] = c, s
        h[j] = rho
        R[:, j] = h[:mtot]
        res = abs(-s * g[j])
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        j += 1

    if j == 0:
        dx = torch.zeros_like(r)
    else:
        # entries of g at/beyond the active column count hold the residual
        # value, not least-squares data: the triangle is the leading j x j
        y = scipy.linalg.solve_triangular(R[:j, :j], g[:j], lower=False)
        y = torch.as_tensor(y.astype(ndt), device=r.device)
        dx = torch.tensordot(y, Z[:j], dims=1)
    rec = _push_recycle(rec, dx)
    return x + dx, res, j, rec
