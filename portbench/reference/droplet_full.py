"""Plain droplet formulas in the full form, the yardstick of the ``bench91``
cell: the reference's ``droplet.py`` coalescence run moves the potential Q
itself (``Q = (x^2 + y^2)/2`` at the start), not its deviation.

Written from the reference's ``compute_Q_spatial_ders``: ``Q_ksi`` pinned
to the domain's x-limits on the left and right edges and ``Q_eta`` to its
y-limits on the bottom and top, the one-sided Neumann correction
``25 / (6 h) |edge|`` on the edge second derivatives, and no cross
derivative on the boundary.  The film physics, the CN residual, the
monitor, its filter and the DCT bases do not depend on the form and are
taken from the plain copy of the deviation form (``reference/droplet.py``).
Plain PyTorch on whatever device the tensors are on; it imports nothing of
the program.
"""
from __future__ import annotations

import torch

from . import droplet as plain
from .droplet import Params


def geometry(q, p: Params):
    """``(x, y, Q_xx, Q_yy, Q_xy, J)`` of the full potential ``q``."""
    qx = plain.d1_x(q, p.dx)
    qx[:, 0] = p.xl
    qx[:, -1] = p.xr
    qy = plain.d1_y(q, p.dy)
    qy[0, :] = p.yb
    qy[-1, :] = p.yt
    qxx = plain.d2_x(q, p.dx)
    qxx[:, 0] += 25.0 / (6.0 * p.dx) * abs(p.xl)
    qxx[:, -1] += 25.0 / (6.0 * p.dx) * abs(p.xr)
    qyy = plain.d2_y(q, p.dy)
    qyy[0, :] += 25.0 / (6.0 * p.dy) * abs(p.yb)
    qyy[-1, :] += 25.0 / (6.0 * p.dy) * abs(p.yt)
    qxy = plain._zero_edges(plain.d1_y(plain.d1_x(q, p.dx), p.dy))
    return qx, qy, qxx, qyy, qxy, qxx * qyy - qxy * qxy


def step_residual_max(u_new, u_old, q_old, dt: float, p: Params) -> float:
    """Max-norm of the CN residual of a step from ``(u_old, q_old)`` at
    ``u_new``, in float64 on ``q_old``'s frozen mesh: what the step's
    Newton ``f_tol`` bounds."""
    u_new, u_old, q_old = u_new.double(), u_old.double(), q_old.double()
    geom = geometry(q_old, p)
    F = plain.pde_rhs(u_old, geom, p)
    return float(torch.max(torch.abs(plain.cn_residual(u_new, u_old, F, dt, geom, p))))


class PMA(plain.PMA):
    """The PMA sub-step on the full potential; ``loop`` carries the
    increment apart from Q, in this object's dtype, as the deviation form's."""

    def dqdt(self, q, u):
        p = self.p
        geom = geometry(q, p)
        mon = plain.monitor_source(u, geom, p)
        for _ in range(p.smoothing_iters):
            mon = plain.smooth_pass(mon)
        jac = geom[5]
        mon = mon + p.mackenzie_c * (torch.sum(mon * torch.abs(jac)) * p.dx * p.dy)
        rhs = torch.sqrt(mon * torch.abs(jac)) / p.alpha
        t = self.tf32
        spec = plain._mm(plain._mm(self.cy, rhs, t), self.cx.T, t) / self.denom
        return plain._mm(plain._mm(self.cy.T, spec, t), self.cx, t)


def min_jacobian(q, p: Params) -> float:
    return float(torch.min(geometry(q.double(), p)[5]))
