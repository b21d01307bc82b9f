"""Direct spectral solvers for constant-coefficient elliptic problems
(port of ``iterative_solvers_tpu/solvers/fast_poisson.py``).

The direct method for separable constant-coefficient operators is
diagonalisation by fast transforms: the homogeneous-Dirichlet 5-point
Laplacian by the DST-I along both axes.  The DST is a dense orthogonal
matmul, two ``(n, n) @ (n, n)`` products per transform, exact to
rounding; f32 products run in full f32 (``resolve_device`` turns TF32
off), since TF32 noise would sit in a *direct* solver's answer.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.dct import _dst1_basis


@lru_cache(maxsize=16)
def _dirichlet_eigs_np(m: int, h: float) -> np.ndarray:
    """Eigenvalues of the 1-D Dirichlet second difference / h^2:
    ``(2 cos(pi k/(m+1)) - 2)/h^2``, k = 1..m."""
    k = np.arange(1, m + 1)
    return (2.0 * np.cos(np.pi * k / (m + 1)) - 2.0) / (h * h)


@lru_cache(maxsize=16)
def _dirichlet_eigs(m: int, h: float, dtype: torch.dtype, device: torch.device):
    return torch.as_tensor(_dirichlet_eigs_np(m, h)).to(device=device, dtype=dtype)


def _solve(f, denom, hx: float, hy: float | None):
    """``S^T ((S f S^T) / denom(lam)) S`` with ``lam`` the eigenvalues of
    the Dirichlet Laplacian on ``f``'s grid."""
    if hy is None:
        hy = hx
    my, mx = f.shape
    sy = _dst1_basis(my, f.dtype, f.device)
    sx = _dst1_basis(mx, f.dtype, f.device)
    lam = (_dirichlet_eigs(my, hy, f.dtype, f.device)[:, None]
           + _dirichlet_eigs(mx, hx, f.dtype, f.device)[None, :])
    fhat = (sy @ f) @ sx.T
    return (sy.T @ (fhat / denom(lam))) @ sx


def poisson_dirichlet_solve(f, hx: float, hy: float | None = None):
    """Solve ``lap u = f`` (5-point, homogeneous Dirichlet) on the interior
    nodes; ``f`` has shape (my, mx) of interior unknowns."""
    return _solve(f, lambda lam: lam, hx, hy)


def helmholtz_dirichlet_solve(f, shift: float, hx: float, hy: float | None = None):
    """Solve ``(shift*I - lap) u = f`` with homogeneous Dirichlet BCs."""
    return _solve(f, lambda lam: shift - lam, hx, hy)
