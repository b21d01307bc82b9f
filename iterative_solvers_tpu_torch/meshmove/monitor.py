"""Monitor smoothing filter and Mackenzie regularisation
(port of ``iterative_solvers_tpu/meshmove/monitor.py``)."""
from __future__ import annotations

import torch


def smooth_pass(t):
    """One pass of the reference's fourth-order 9-point filter, with its
    own edge and corner weights."""
    mon = torch.empty_like(t)
    # interior: t + (N+S+E+W)/8 + diagonals/16
    mon[1:-1, 1:-1] = (
        t[1:-1, 1:-1]
        + (t[:-2, 1:-1] + t[2:, 1:-1] + t[1:-1, :-2] + t[1:-1, 2:]) / 8.0
        + (t[:-2, :-2] + t[:-2, 2:] + t[2:, :-2] + t[2:, 2:]) / 16.0
    )
    # edges without corners
    mon[1:-1, -1] = (4 * t[1:-1, -1] + 2 * t[:-2, -1] + 2 * t[2:, -1]
                     + 2 * t[1:-1, -2] + t[2:, -2] + t[:-2, -2]) / 12.0
    mon[1:-1, 0] = (4 * t[1:-1, 0] + 2 * t[:-2, 0] + 2 * t[2:, 0]
                    + 2 * t[1:-1, 1] + t[2:, 1] + t[:-2, 1]) / 12.0
    mon[-1, 1:-1] = (4 * t[-1, 1:-1] + 2 * t[-1, :-2] + 2 * t[-1, 2:]
                     + 2 * t[-2, 1:-1] + t[-2, 2:] + t[-2, :-2]) / 12.0
    mon[0, 1:-1] = (4 * t[0, 1:-1] + 2 * t[0, :-2] + 2 * t[0, 2:]
                    + 2 * t[1, 1:-1] + t[1, 2:] + t[1, :-2]) / 12.0
    # corners
    mon[0, 0] = (4 * t[0, 0] + 2 * t[0, 1] + 2 * t[1, 0] + t[1, 1]) / 9.0
    mon[0, -1] = (4 * t[0, -1] + 2 * t[0, -2] + 2 * t[1, -1] + t[1, -2]) / 9.0
    mon[-1, 0] = (4 * t[-1, 0] + 2 * t[-1, 1] + 2 * t[-2, 0] + t[-2, 1]) / 9.0
    mon[-1, -1] = (4 * t[-1, -1] + 2 * t[-1, -2] + 2 * t[-2, -1]
                   + t[-2, -2]) / 9.0
    return mon


def smooth_and_regularise(mon_src, jac, dx: float, dy: float,
                          smoothing_iters: int = 4, mackenzie_c: float = 1.0,
                          cap: float | None = None):
    """Smooth the raw monitor and add the Mackenzie floor
    ``C * sum(mon |J|) dx dy`` (C = 0.15 for the droplet).  ``cap`` bounds
    the monitor at ``cap`` times that floor first (bounded mesh compression
    for fine grids); None is reference-exact."""
    mon = mon_src
    for _ in range(smoothing_iters):
        mon = smooth_pass(mon)
    floor = mackenzie_c * (torch.sum(mon * torch.abs(jac)) * dx * dy)
    if cap is not None:
        mon = torch.minimum(mon, cap * floor)
    return mon + floor
