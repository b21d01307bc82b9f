"""Orthonormal 2-D DCT-II / DCT-III as basis matmuls
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


def dct2(u):
    """Orthonormal DCT-II along both axes of a 2-D field."""
    cy = _dct2_basis(u.shape[0], u.dtype, u.device)
    cx = _dct2_basis(u.shape[1], u.dtype, u.device)
    return (cy @ u) @ cx.T


def idct2(u):
    """Inverse (orthonormal DCT-III) along both axes."""
    cy = _dct2_basis(u.shape[0], u.dtype, u.device)
    cx = _dct2_basis(u.shape[1], u.dtype, u.device)
    return (cy.T @ u) @ cx
