"""Plain Swift–Hohenberg formulas, the yardstick of the ``sh2048`` cells.

Written from the reference scripts (``sh_scipy_nk.py:31-49``,
``sh_linearised.py:30-57``): the periodic 5-point Laplacian ``Lap``, the
operator ``L = -Lap^2 - 2 Lap + (r - 1) I``, the Crank–Nicolson residual
and the linearised step's system.  Plain PyTorch in float64 on whatever
device the tensors are on; it imports nothing of the program.
"""
from __future__ import annotations

import torch


def lap_periodic(u, h: float):
    """5-point Laplacian with both axes periodic."""
    return (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) + torch.roll(u, 1, 1)
            + torch.roll(u, -1, 1) - 4.0 * u) / (h * h)


def sh_L(u, h: float, r: float):
    """``L u = -Lap(Lap u) - 2 Lap u + (r - 1) u``."""
    l1 = lap_periodic(u, h)
    return -lap_periodic(l1, h) - 2.0 * l1 + (r - 1.0) * u


def cn_residual(u, u_old, p: dict):
    """``(u - u_old)/k - (L u + g u^2 - u^3 + L u_old + g u_old^2 - u_old^3)/2``
    in float64; ``p`` holds ``h``, ``k``, ``r`` and ``g``."""
    u, u_old = u.double(), u_old.double()
    h, k, r, g = p["h"], p["k"], p["r"], p["g"]
    rhs_new = sh_L(u, h, r) + g * u * u - u * u * u
    rhs_old = sh_L(u_old, h, r) + g * u_old * u_old - u_old * u_old * u_old
    return (u - u_old) / k - (rhs_new + rhs_old) / 2.0


def cn_residual_max(u, u_old, p: dict) -> float:
    """Max-norm of :func:`cn_residual`: what the CN step's ``f_tol`` bounds."""
    return float(torch.max(torch.abs(cn_residual(u, u_old, p))))


def semi_residual_rel(x, u, u_old, p: dict) -> float:
    """``||b - A x|| / ||b||`` of the linearised step
    ``(I + D - kL/2) x = (I + kL/2) u`` with
    ``D = (5u - u_old)^2 k/16 - g k u``, in float64: what its GMRES ``tol``
    bounds."""
    x, u, u_old = x.double(), u.double(), u_old.double()
    h, k, r, g = p["h"], p["k"], p["r"], p["g"]
    D = (5.0 * u - u_old) ** 2 * (k / 16.0) - g * k * u
    b = u + (k / 2.0) * sh_L(u, h, r)
    ax = x + D * x - (k / 2.0) * sh_L(x, h, r)
    return float(torch.linalg.vector_norm(b - ax) / torch.linalg.vector_norm(b))
