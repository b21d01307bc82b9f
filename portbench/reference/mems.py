"""Plain MEMS touchdown formulas, the yardstick of the ``mems51`` cell.

Written from the reference's ``PMA2_nk.py`` (the operator-split
Crank–Nicolson step of a biharmonic membrane with the Van der Waals term on
a PMA moving mesh): the mesh geometry of the full potential Q
(``compute_Q_spatial_ders``), the curvilinear Laplacian with raw first
derivatives and the biharmonic as two applications of it
(``compute_rhs_pde``), the CN ``residual``, the ``1/(1+u)^6`` monitor with
the reference's 9-point filter and the Mackenzie floor (C = 1), the
spectral PMA solve with the published eigenvalues (``solve_PMA``) and the
step ``dt = k min (1+u)^3`` (``compute_g``).  Plain PyTorch in float64 on
whatever device the tensors are on, with TF32 off; it imports nothing of
the program.  The 4th-order stencils, the conservative Laplacian and the
filter are the reference repository's own, shared with its ``droplet.py``,
and are taken from the droplet's plain copy (``reference/droplet.py``).

Departures from ``PMA2_nk.py``, none of which changes a number beyond
rounding: fields are ``(n, n)`` arrays differenced by slices, where the
reference multiplies flattened vectors by sparse matrices; the DCT-II is an
explicit orthonormal cosine matrix, where the reference calls
``scipy.fft.dct``; only the configuration's branches are written
(epsilon = 0: the monitor ``1/(1+u)^6`` and no ``epsilon^(m-2)`` term;
p = 2 and p = 1 of the membrane operator); the Lagrangian mesh-advection
term, which the reference implements and never enables, is left out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import droplet as plain


@dataclasses.dataclass(frozen=True)
class Params:
    """The MEMS configuration (``PMA2_nk.py``'s globals) on ``[-1, 1]^2``."""

    n: int
    p: int
    m: int
    alpha: float
    gamma: float
    epsilon: float
    beta: float
    lambd: float
    smoothing_iters: int
    k: float

    @classmethod
    def of(cls, cfg: dict):
        """The parameters a configuration file holds."""
        return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls)})

    @property
    def dx(self) -> float:
        return 2.0 / (self.n - 1)

    dy = dx


def geometry(q, p: Params):
    """``(x, y, Q_xx, Q_yy, Q_xy, J)`` of the full potential Q with the PMA
    boundary conditions: ``Q_ksi`` pinned to -1 and 1 on the left and right
    edges and ``Q_eta`` on the bottom and top, the Neumann correction
    ``25 / (6 h)`` on the edge second derivatives, no cross derivative on
    the boundary."""
    h = p.dx
    qx = plain.d1_x(q, h)
    qx[:, 0], qx[:, -1] = -1.0, 1.0
    qy = plain.d1_y(q, h)
    qy[0, :], qy[-1, :] = -1.0, 1.0
    qxx = plain.d2_x(q, h)
    qxx[:, 0] += 25.0 / (6.0 * h)
    qxx[:, -1] += 25.0 / (6.0 * h)
    qyy = plain.d2_y(q, h)
    qyy[0, :] += 25.0 / (6.0 * h)
    qyy[-1, :] += 25.0 / (6.0 * h)
    qxy = plain._zero_edges(plain.d1_y(plain.d1_x(q, h), h))
    return qx, qy, qxx, qyy, qxy, qxx * qyy - qxy * qxy


def laplacian(v, geom, p: Params):
    """``v_xx + v_yy`` on the mesh with the raw first derivatives (the
    residual's convention: no edge zeroing of ``v_ksi``, ``v_eta``)."""
    vxx, vyy = plain.laplace(v, plain.d1_x(v, p.dx), plain.d1_y(v, p.dy), geom, p)
    return vxx + vyy


def _interior(f):
    out = torch.zeros_like(f)
    out[1:-1, 1:-1] = f[1:-1, 1:-1]
    return out


def rhs(u, geom, p: Params):
    """``du/dt = -beta^2 lap^2 u - lambda/(1+u)^2`` (p = 2; ``+ beta^2 lap u``
    for p = 1), zero on the boundary."""
    if p.epsilon != 0:
        raise NotImplementedError("the reference is written for epsilon = 0")
    f = -p.lambd / (1.0 + u) ** 2
    lap = laplacian(u, geom, p)
    f = f + p.beta ** 2 * lap if p.p == 1 else f - p.beta ** 2 * laplacian(lap, geom, p)
    return _interior(f)


def cn_residual(u, u_old, cn_term, dt: float, geom, p: Params):
    """``(u - u_old)/dt - (rhs(u) + rhs(u_old))/2`` on the frozen mesh."""
    return (u - u_old) / dt - (rhs(u, geom, p) + cn_term) / 2.0


def monitor(u, geom, p: Params):
    """``1/(1+u)^6`` smoothed by the 9-point filter ``smoothing_iters`` times,
    plus the Mackenzie floor ``sum(mon |J|) dx dy`` (C = 1)."""
    mon = 1.0 / (1.0 + u) ** 6
    for _ in range(p.smoothing_iters):
        mon = plain.smooth_pass(mon)
    return mon + torch.sum(mon * torch.abs(geom[5])) * p.dx * p.dy


def _leig(p: Params) -> np.ndarray:
    """The published eigenvalues ``(2 cos(pi i/(n-1)) - 2) + (2 cos(pi j/(n-1)) - 2)``
    over ``dx dy``."""
    e = 2.0 * np.cos(np.pi * np.arange(p.n) / (p.n - 1)) - 2.0
    return (e[:, None] + e[None, :]) / (p.dx * p.dy)


def q_dt(u, q, p: Params):
    """``dQ/dt = [alpha (I - gamma lap)]^-1 sqrt(mon |J|)`` by the DCT-II."""
    geom = geometry(q, p)
    r = torch.sqrt(monitor(u, geom, p) * torch.abs(geom[5])) / p.alpha
    c = plain._dct_basis(p.n, r.dtype, r.device)
    denom = torch.as_tensor(1.0 - p.gamma * _leig(p), dtype=r.dtype, device=r.device)
    with plain.full_float32():
        return c.T @ ((c @ r @ c.T) / denom) @ c


def step_dt(u, p: Params) -> float:
    """``k min (1+u)^3``."""
    return float(torch.min((1.0 + u) ** 3)) * p.k


def step_residual_max(u_new, u_old, q_old, dt: float, p: Params) -> float:
    """``max |F_CN(u_new)|`` in float64 on ``q_old``'s frozen mesh: what the
    step's Newton ``f_tol`` bounds (the max norm it stops on)."""
    u_new, u_old, q_old = u_new.double(), u_old.double(), q_old.double()
    geom = geometry(q_old, p)
    f = cn_residual(u_new, u_old, rhs(u_old, geom, p), dt, geom, p)
    return float(torch.max(torch.abs(f)))


def dt_rel_error(dt: float, u_old, p: Params) -> float:
    return abs(dt - step_dt(u_old.double(), p)) / dt


def mesh_update_error(q_new, q_old, u_old, dt: float, p: Params) -> float:
    """``max |(q_new - q_old) - dt q_dt| / max |dt q_dt|`` with ``q_dt`` the
    reference's from ``(u_old, q_old)``."""
    q_old = q_old.double()
    inc_ref = dt * q_dt(u_old.double(), q_old, p)
    inc = q_new.double() - q_old
    return float(torch.max(torch.abs(inc - inc_ref)) / torch.max(torch.abs(inc_ref)))


def min_jacobian(q, p: Params) -> float:
    return float(torch.min(geometry(q.double(), p)[5]))


def min_spacing(q, p: Params) -> float:
    """The smallest distance from an interior node to its E, S, SE or SW
    neighbour in physical space."""
    x, y = geometry(q.double(), p)[:2]
    xc, yc = x[1:-1, 1:-1], y[1:-1, 1:-1]
    e = torch.abs(x[1:-1, 2:] - xc)
    s = torch.abs(yc - y[:-2, 1:-1])
    se = torch.hypot(y[:-2, 2:] - yc, x[:-2, 2:] - xc)
    sw = torch.hypot(y[:-2, :-2] - yc, x[:-2, :-2] - xc)
    return float(torch.min(torch.stack([e, s, se, sw])))
