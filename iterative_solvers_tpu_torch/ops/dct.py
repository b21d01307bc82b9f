"""Orthonormal DCT-II / DCT-III and DST-I as basis matmuls
(port of ``iterative_solvers_tpu/ops/dct.py``).

An N-point DCT is a dense ``(N, N)`` cosine matrix, so the transform of an
``(ny, nx)`` field is two matmuls.  The basis is orthonormal: the inverse
is its transpose.  f32 matmuls must run in full f32 on the GPU
(``resolve_device`` turns TF32 off): TF32 noise in the mesh velocity is the
error class that tangled the moving mesh on the reference's hardware.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def _dct2_basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix C with X = C @ x (scipy dct(norm='ortho'))."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    c = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    c *= np.sqrt(2.0 / n)
    c[0] *= np.sqrt(0.5)
    return c


@lru_cache(maxsize=32)
def _dct2_basis(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_dct2_basis_np(n)).to(device=device, dtype=dtype)


_PRECISIONS = (None, "highest", "high")


def _check_precision(precision):
    """The JAX package's ``"high"`` is three bf16 passes, close to f32; the
    nearest cuBLAS mode is TF32 (10-bit mantissa), the error class that
    tangles the mesh.  So every accepted precision runs full-f32 matmuls
    (``resolve_device`` keeps TF32 off), and anything lower raises."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision={precision!r}: only None, 'highest' or "
                         "'high' (all full f32) are allowed")


def dct2(u, precision=None):
    """Orthonormal DCT-II along both axes of a 2-D field.  ``precision``
    is None, ``"highest"`` or ``"high"``: all three run full-f32 matmuls."""
    _check_precision(precision)
    cy = _dct2_basis(u.shape[0], u.dtype, u.device)
    cx = _dct2_basis(u.shape[1], u.dtype, u.device)
    return (cy @ u) @ cx.T


def idct2(u, precision=None):
    """Inverse (orthonormal DCT-III) along both axes; ``precision`` as in
    :func:`dct2`."""
    _check_precision(precision)
    cy = _dct2_basis(u.shape[0], u.dtype, u.device)
    cx = _dct2_basis(u.shape[1], u.dtype, u.device)
    return (cy.T @ u) @ cx


def _apply_along(c, u, axis: int):
    """``c`` contracted with ``u`` along ``axis`` (``tensordot`` with the
    transformed axis moved back into place)."""
    return torch.movedim(torch.tensordot(c, torch.movedim(u, axis, 0), dims=1),
                         0, axis)


def dct1d(u, axis: int = -1):
    """Orthonormal DCT-II along one axis."""
    return _apply_along(_dct2_basis(u.shape[axis], u.dtype, u.device), u, axis)


def idct1d(u, axis: int = -1):
    """Inverse (orthonormal DCT-III) along one axis."""
    return _apply_along(_dct2_basis(u.shape[axis], u.dtype, u.device).T, u, axis)


@lru_cache(maxsize=32)
def _dst1_basis_np(n: int) -> np.ndarray:
    """Orthonormal DST-I matrix (its own inverse):
    ``S[k, m] = sqrt(2/(n+1)) sin(pi k m / (n+1))``, k, m = 1..n."""
    k = np.arange(1, n + 1)[:, None]
    m = np.arange(1, n + 1)[None, :]
    return np.sin(np.pi * k * m / (n + 1)) * np.sqrt(2.0 / (n + 1))


@lru_cache(maxsize=32)
def _dst1_basis(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_dst1_basis_np(n)).to(device=device, dtype=dtype)


def dst2(u):
    """Orthonormal DST-I along both axes (diagonalises the homogeneous-
    Dirichlet 5-point Laplacian: the fast Poisson solver's transform)."""
    sy = _dst1_basis(u.shape[0], u.dtype, u.device)
    sx = _dst1_basis(u.shape[1], u.dtype, u.device)
    return (sy @ u) @ sx.T
