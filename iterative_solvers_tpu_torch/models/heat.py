"""1-D heat-equation steppers (port of ``iterative_solvers_tpu/models/heat.py``).

- :func:`ftcs_evolve` — explicit forward-time centred-space with the
  p >= 1/2 stability bound exposed, left-end insulated variant included.
- :func:`cn_evolve` — implicit Crank–Nicolson via the tridiagonal Thomas
  solver, factored once and reused every step.

The time loops run on the host; the state stays on the device of ``u0``.
"""
from __future__ import annotations

import math

import torch

from ..solvers.tridiag import trilu, trisolve


def stability_parameter(a: float, k: float, n: int) -> float:
    """p = a k n^2 (explicit scheme stable iff p < 1/2)."""
    return a * k * n * n


def ftcs_step(u, p: float, insulated_left: bool = False):
    """One FTCS step on n+1 nodes with Dirichlet ends (u[0]=u[-1]=0) or an
    insulated (zero-flux) left end."""
    interior = p * u[2:] + (1 - 2 * p) * u[1:-1] + p * u[:-2]
    zero = torch.zeros((1,), dtype=u.dtype, device=u.device)
    left = (2 * p * u[1] + (1 - 2 * p) * u[0])[None] if insulated_left else zero
    return torch.cat([left, interior, zero])


def ftcs_evolve(u0, nsteps: int, a: float, k: float,
                insulated_left: bool = False):
    p = stability_parameter(a, k, u0.shape[0] - 1)
    u = u0
    for _ in range(nsteps):
        u = ftcs_step(u, p, insulated_left)
    return u


def cn_evolve(u0, nsteps: int, a: float, k: float):
    """Crank–Nicolson with homogeneous Dirichlet ends; interior solve by the
    tridiagonal LU factored once."""
    n = u0.shape[0] - 1
    p = a * k * n * n
    m = n - 1  # interior unknowns
    alpha = torch.full((m - 1,), -p, dtype=u0.dtype, device=u0.device)
    beta = torch.full((m,), 2 * (p + 1), dtype=u0.dtype, device=u0.device)
    lu = trilu(alpha, beta, alpha)
    zero = torch.zeros((1,), dtype=u0.dtype, device=u0.device)
    u = u0
    for _ in range(nsteps):
        b = p * u[2:] + 2 * (1 - p) * u[1:-1] + p * u[:-2]
        u = torch.cat([zero, trisolve(lu, b), zero])
    return u


def exact_dirichlet(x, t, a: float = 1.0):
    """u = exp(-a pi^2 t) sin(pi x)."""
    return math.exp(-a * math.pi ** 2 * t) * torch.sin(math.pi * x)


def exact_insulated(x, t, a: float = 1.0):
    """u = exp(-a pi^2 t/4) cos(pi x/2)."""
    return math.exp(-a * math.pi ** 2 * t / 4) * torch.cos(math.pi * x / 2)
