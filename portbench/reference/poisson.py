"""Plain formulas of the Poisson duct flow, the yardstick of the
``poisson999`` cell.

Written from the reference's ``lab14_p2.py:19-59``: the 5-point Laplacian
on the (n - 1)^2 interior nodes of the unit square with u = 0 on the
boundary, ``lap u = b``, and the flow rate Q by the trapezium rule.  The
exact discrete solution diagonalises the operator in the sine basis:
``S_jk = sin(pi j k / n)`` (``S S = (n / 2) I``) and the eigenvalues
``(2 cos(pi j / n) - 2) / h^2`` of each axis, 4 matrix products.  Plain
PyTorch in float64 on whatever device the tensors are on; it imports
nothing of the program.
"""
from __future__ import annotations

import math

import torch


def laplacian(u, h: float):
    """``lap u`` on the interior nodes, zero outside (the Dirichlet
    boundary), by zero padding and slicing."""
    p = torch.nn.functional.pad(u, (1, 1, 1, 1))
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4.0 * u) / (h * h)


def residual_rel(x, b, h: float) -> float:
    """``||b - lap x||_2 / ||b||_2`` in float64."""
    x, b = x.double(), b.double()
    return float(torch.linalg.vector_norm(b - laplacian(x, h)) / torch.linalg.vector_norm(b))


def sine_basis(n: int, dtype=torch.float64, device=None):
    """``S_jk = sin(pi j k / n)``, j, k = 1 .. n - 1."""
    j = torch.arange(1, n, dtype=dtype, device=device)
    return torch.sin(math.pi * torch.outer(j, j) / n)


def solve_exact(b, n: int):
    """The exact discrete solution of ``lap u = b`` (b on the (n - 1)^2
    interior nodes, h = 1 / n) in float64."""
    b = b.double()
    h = 1.0 / n
    s = sine_basis(n, device=b.device)
    j = torch.arange(1, n, dtype=torch.float64, device=b.device)
    mu = (2.0 * torch.cos(math.pi * j / n) - 2.0) / (h * h)
    bhat = s @ b @ s
    return (2.0 / n) ** 2 * (s @ (bhat / (mu[:, None] + mu[None, :])) @ s)


def field_error_rel(x, u_exact) -> float:
    """``max |x - u_exact| / max |u_exact|``."""
    return float((x.double() - u_exact).abs().max() / u_exact.abs().max())


def flow_rate(u, h: float) -> float:
    """Q = the integral of u over the unit square by the trapezium rule
    (u = 0 on the boundary, so the interior nodes each weigh h^2)."""
    return float(u.double().sum() * h * h)
