"""Preconditioners for the Krylov solvers
(port of ``iterative_solvers_tpu/solvers/preconditioners.py``).

All preconditioners are functions ``M(v) -> z`` (approximate ``A^{-1} v``)
for the ``M=`` argument of :func:`..gmres.gmres`, :func:`..lgmres.lgmres`
(right preconditioning) and :func:`..cg.cg`.

- Jacobi and block-Jacobi apply as an elementwise product and a batched
  small matmul.
- ILU(0) is factored on the host (inherently sequential) and *applied* on
  the device by fixed-sweep Jacobi–Richardson iteration on the triangular
  factors: exact triangular solves are sequential, and a few sweeps give
  an application accurate enough for preconditioning.
- The spectral preconditioner reuses the DST fast solver as the ideal
  preconditioner for near-constant-coefficient shifted Laplacians.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import resolve_device


def jacobi(diag) -> Callable:
    """Point Jacobi from the operator diagonal (a tensor)."""
    inv = 1.0 / diag
    return lambda v: inv * v


def block_jacobi_dense(a_scipy, block: int, device="cuda") -> Callable:
    """Block-Jacobi with dense ``block x block`` diagonal blocks, inverted on
    the host once and applied as a batched matmul."""
    dev = resolve_device(device)
    n = a_scipy.shape[0]
    if n % block:
        raise ValueError(f"block size {block} does not divide n = {n}")
    nb = n // block
    a = a_scipy.tocsr()
    blocks = np.zeros((nb, block, block))
    for b in range(nb):
        sl = slice(b * block, (b + 1) * block)
        blocks[b] = a[sl, sl].toarray()
    inv = torch.as_tensor(np.linalg.inv(blocks), device=dev)

    def apply(v):
        vb = v.reshape(nb, block)
        return torch.einsum("nij,nj->ni", inv.to(v.dtype), vb).reshape(v.shape)

    return apply


def _ilu0_csr(a):
    """Sparse-pattern IKJ ILU(0): factor in place on the CSR structure.

    For each row i, eliminate against previous rows k in the row's own
    sparsity; updates touch only positions already present in row i.
    """
    lu = a.copy().tocsr()
    lu.sort_indices()
    n = lu.shape[0]
    indptr, indices, data = lu.indptr, lu.indices, lu.data
    diag_pos = np.empty(n, dtype=np.int64)
    for i in range(n):
        row = indices[indptr[i]:indptr[i + 1]]
        d = np.searchsorted(row, i)
        if not (d < row.size and row[d] == i):
            raise ValueError(f"ILU(0) needs a stored diagonal: none at row {i}")
        diag_pos[i] = indptr[i] + d
    for i in range(1, n):
        lo, hi = indptr[i], indptr[i + 1]
        row_cols = indices[lo:hi]
        for kk in range(lo, hi):
            k = indices[kk]
            if k >= i:
                break
            piv = data[diag_pos[k]]
            if piv == 0.0:
                continue
            data[kk] /= piv
            # subtract multiple of row k's upper part, pattern-restricted
            klo, khi = diag_pos[k] + 1, indptr[k + 1]
            if klo >= khi:
                continue
            kcols = indices[klo:khi]
            # positions of kcols within row i (only those present)
            pos = np.searchsorted(row_cols, kcols)
            valid = (pos < row_cols.size)
            valid[valid] &= row_cols[pos[valid]] == kcols[valid]
            data[lo + pos[valid]] -= data[kk] * data[klo:khi][valid]
    return lu


class ILU0:
    """Zero-fill incomplete LU.  Factored on the host (sparse-pattern IKJ
    on the CSR structure, a Python loop over rows), applied on the device
    with fixed-sweep triangular iteration through ``CSR.matvec``."""

    def __init__(self, a_scipy, sweeps: int = 6, device="cuda"):
        import scipy.sparse as sp

        from ..ops.sparse import CSR

        dev = resolve_device(device)
        a = a_scipy.tocsr().astype(np.float64)
        n = a.shape[0]
        lu = _ilu0_csr(a)
        self._l = (sp.tril(lu, k=-1) + sp.identity(n)).tocsr()
        self._u = sp.triu(lu).tocsr()
        self.sweeps = sweeps
        self._lj = CSR.from_scipy((self._l - sp.identity(n)).tocsr(), device=dev)
        self._uj = CSR.from_scipy(
            (self._u - sp.diags(self._u.diagonal())).tocsr(), device=dev)
        self._udiag_inv = torch.as_tensor(1.0 / self._u.diagonal(), device=dev)

    def __call__(self, v):
        shape = v.shape
        vf = v.reshape(-1)
        # L y = v, unit lower triangular: y = v - L_strict y (sweeps)
        y = vf
        for _ in range(self.sweeps):
            y = vf - self._lj.matvec(y)
        # U x = y: x = Dinv (y - U_strict x)
        x = self._udiag_inv * y
        for _ in range(self.sweeps):
            x = self._udiag_inv * (y - self._uj.matvec(x))
        return x.reshape(shape)


def spectral_helmholtz(shift: float, hx: float, hy: float) -> Callable:
    """Exact inverse of (shift*I - lap) with Dirichlet BCs via DST — an
    ideal preconditioner for perturbed/variable-coefficient versions."""
    from .fast_poisson import helmholtz_dirichlet_solve

    return lambda v: helmholtz_dirichlet_solve(v, shift, hx, hy)
