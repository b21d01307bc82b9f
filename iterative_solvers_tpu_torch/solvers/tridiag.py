"""Tridiagonal LU factorisation and solve
(port of ``iterative_solvers_tpu/solvers/tridiag.py``).

The recurrences are sequential in ``n``.  The JAX package runs them as
``lax.scan``s inside one compiled program; here each is a Python loop of
``n`` steps over 0-d slices of tensors that stay on the device, a few
small launches per step.  That is slow by nature (launch-bound, ~n x 3
launches per sweep) and is the honest counterpart: the values never
leave the device.  ``trisolve`` takes right-hand sides batched along the
trailing axes, ``b`` of shape ``(n, ...)``: batch many small solves
rather than loop over them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TriLU(NamedTuple):
    l: torch.Tensor      # (n-1,) subdiagonal of L
    v: torch.Tensor      # (n,)   diagonal of U
    gamma: torch.Tensor  # (n-1,) superdiagonal (unchanged by the factorisation)


def trilu(alpha, beta, gamma) -> TriLU:
    """LU-factorise the tridiagonal matrix with sub/main/super diagonals
    ``alpha (n-1), beta (n), gamma (n-1)`` such that L U = A."""
    n = beta.shape[0]
    l = torch.empty_like(alpha)
    v = torch.empty_like(beta)
    v[0] = beta[0]
    for i in range(1, n):
        l[i - 1] = alpha[i - 1] / v[i - 1]
        v[i] = beta[i] - l[i - 1] * gamma[i - 1]
    return TriLU(l=l, v=v, gamma=gamma)


def trisolve(lu: TriLU, b):
    """Solve A x = b given the factorisation (forward then backward sweep);
    ``b`` has shape ``(n,)`` or ``(n, ...)``."""
    n = b.shape[0]
    y = torch.empty_like(b)
    y[0] = b[0]
    for i in range(1, n):
        y[i] = b[i] - lu.l[i - 1] * y[i - 1]
    u = torch.empty_like(b)
    u[n - 1] = y[n - 1] / lu.v[n - 1]
    for i in range(n - 2, -1, -1):
        u[i] = (y[i] - lu.gamma[i] * u[i + 1]) / lu.v[i]
    return u


def tridiag_solve(alpha, beta, gamma, b):
    """One-shot Thomas solve."""
    return trisolve(trilu(alpha, beta, gamma), b)
