"""Explicit wave-equation steppers (port of ``iterative_solvers_tpu/models/wave.py``).

- :func:`damped_wave_1d` — damped 1-D wave with an oscillating-inlet boundary.
- :func:`tank_wave_2d` — 2-D wave in a tank with Neumann walls and corner
  averaging.

The time loops run on the host; the state stays on the device.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import resolve_device


def damped_wave_1d(n: int, k: float, nsteps: int, inlet: Callable,
                   dtype=torch.float64, device="cuda"):
    """u_tt + u_t = u_xx on (0,1), u(0,t) = inlet(t), u(1,t)=0, zero IC.

    ``inlet`` is called with the time as a 0-d tensor on ``device`` and
    returns the boundary value (a 0-d tensor).  Returns the final state and
    the full trajectory (nsteps+1, n+1).
    """
    dev = resolve_device(device)
    a = 1 + k / 2
    b = 1 - k / 2
    c = k * k * n * n
    times = torch.arange(1, nsteps + 1, device=dev).to(dtype) * k

    def boundary(t):
        return torch.as_tensor(inlet(t), device=dev).to(dtype).reshape(1)

    zero = torch.zeros((1,), dtype=dtype, device=dev)
    u_prev = torch.zeros(n + 1, dtype=dtype, device=dev)
    u = torch.cat([boundary(times[0]), u_prev[1:]])
    traj = [u_prev, u]
    for s in range(nsteps):
        interior = (2 * u[1:-1] - b * u_prev[1:-1]
                    + c * (u[2:] - 2 * u[1:-1] + u[:-2])) / a
        u_prev, u = u, torch.cat([boundary(times[s]), interior, zero])
        traj.append(u)
    return u, torch.stack(traj[:-1])


def _tank_laplacian(u, p: float):
    """p-scaled 5-point Laplacian with mirrored (Neumann) walls; the
    corners stay zero (see :func:`_average_corners`)."""
    lap = torch.zeros_like(u)
    lap[1:-1, 1:-1] = p * (u[2:, 1:-1] + u[1:-1, 2:] - 4 * u[1:-1, 1:-1]
                           + u[:-2, 1:-1] + u[1:-1, :-2])
    lap[0, 1:-1] = p * (2 * u[1, 1:-1] + u[0, 2:] - 4 * u[0, 1:-1] + u[0, :-2])
    lap[-1, 1:-1] = p * (u[-1, 2:] - 4 * u[-1, 1:-1] + 2 * u[-2, 1:-1] + u[-1, :-2])
    lap[1:-1, 0] = p * (u[2:, 0] + 2 * u[1:-1, 1] - 4 * u[1:-1, 0] + u[:-2, 0])
    lap[1:-1, -1] = p * (u[2:, -1] - 4 * u[1:-1, -1] + u[:-2, -1] + 2 * u[1:-1, -2])
    return lap


def _average_corners(u):
    """A copy of ``u`` with each corner the mean of its two wall neighbours,
    set one after the other."""
    u = u.clone()
    u[0, 0] = 0.5 * (u[0, 1] + u[1, 0])
    u[0, -1] = 0.5 * (u[0, -2] + u[1, -1])
    u[-1, 0] = 0.5 * (u[-2, 0] + u[-1, 1])
    u[-1, -1] = 0.5 * (u[-2, -1] + u[-1, -2])
    return u


def tank_wave_2d(u0, nsteps: int, k: float, p: float = 0.4,
                 damping: float = 4.0):
    """Damped 2-D wave with Neumann walls; the first step applies the zero-
    velocity condition."""
    u_prev, u = u0, _average_corners(u0 + 0.5 * _tank_laplacian(u0, p))
    for _ in range(max(nsteps - 1, 0)):
        u_new = (2 * u - (1 - 0.5 * damping * k) * u_prev + _tank_laplacian(u, p)) / (
            1 + 0.5 * damping * k)
        u_prev, u = u, _average_corners(u_new)
    return u
