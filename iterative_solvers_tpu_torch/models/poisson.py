"""Poisson duct-flow benchmark
(port of ``iterative_solvers_tpu/models/poisson.py``).

Solves ``lap u = -1`` on the unit square with homogeneous Dirichlet BCs and
evaluates the flow rate ``Q = integral of u`` by the 2-D trapezium rule.
The system ((n-1)^2 unknowns for n intervals; 999^2 in the reference's
run) is solved either directly by DST diagonalisation or iteratively by
matrix-free CG, both to far below discretisation error.

The reference's own series constant is mis-normalised; the correct
separated-variables value is ``Q = 1/12 - (16/pi^5) sum_{m odd}
tanh(m pi/2)/m^5 = 0.0351444...``, which :func:`flow_rate_exact` gives.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.stencils import lap_dirichlet_5pt
from ..solvers.cg import cg
from ..solvers.fast_poisson import poisson_dirichlet_solve


def _rhs(n: int, dtype, device):
    m = n - 1
    return torch.full((m, m), -1.0, dtype=dtype, device=resolve_device(device))


def solve_direct(n: int, dtype=torch.float64, device="cuda"):
    """DST direct solve of lap u = -1 with n intervals per direction.
    Returns the full (n+1, n+1) field including boundary zeros."""
    u_int = poisson_dirichlet_solve(_rhs(n, dtype, device), 1.0 / n)
    return F.pad(u_int, (1, 1, 1, 1))


def solve_cg(n: int, tol=1e-10, dtype=torch.float64, device="cuda"):
    """Matrix-free CG solve of the same system (stencil matvec)."""
    h = 1.0 / n
    res = cg(lambda u: lap_dirichlet_5pt(u, h), _rhs(n, dtype, device), tol=tol,
             maxiter=20 * n)
    return F.pad(res.x, (1, 1, 1, 1)), res


def flow_rate(u, h: float):
    """2-D trapezium rule for the integral of ``u`` (a 0-d tensor)."""
    corners = u[0, 0] + u[0, -1] + u[-1, 0] + u[-1, -1]
    edges = (
        torch.sum(u[0, :]) + torch.sum(u[-1, :]) + torch.sum(u[:, 0]) + torch.sum(u[:, -1])
    )
    return 0.25 * h * h * (4.0 * torch.sum(u) - 2.0 * edges + corners)


def flow_rate_exact(terms: int = 2000) -> float:
    """Correct separation-of-variables series for the unit-square duct:
    Q = 1/12 - (16/pi^5) * sum_{m odd} tanh(m pi / 2) / m^5 = 0.03514425..."""
    m = np.arange(1, 2 * terms, 2, dtype=np.float64)
    return float(1.0 / 12.0 - (16.0 / np.pi ** 5) * np.sum(np.tanh(m * np.pi / 2) / m ** 5))
