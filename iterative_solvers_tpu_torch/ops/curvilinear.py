"""Curvilinear (moving-mesh) operators
(port of ``iterative_solvers_tpu/ops/curvilinear.py``).

- :func:`mesh_geometry` / :func:`mesh_geometry_dev` — derivatives of the
  mesh potential with the PMA Neumann boundary treatment, and the Hessian
  determinant ``J``;
- :func:`grad_xy` — physical-space gradient through the inverse metric;
- :func:`laplace` — the conservative 4th-order curvilinear Laplacian with
  its three rings of one-sided boundary formulas.

Edge writes go into tensors the stencils freshly returned, never into an
input.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.grid import Grid2D
from . import stencils


class MeshGeometry(NamedTuple):
    """Derivatives of the mesh potential Q on the computational grid."""

    x: torch.Tensor      # Q_ksi    (physical x coordinates)
    y: torch.Tensor      # Q_eta    (physical y coordinates)
    xx: torch.Tensor     # Q_ksiksi
    yy: torch.Tensor     # Q_etaeta
    xy: torch.Tensor     # Q_ksieta
    jac: torch.Tensor    # Q_ksiksi * Q_etaeta - Q_ksieta^2


def _zero_edges(f, cols: bool = True, rows: bool = True):
    """Zero the left/right columns and/or bottom/top rows of ``f`` in place
    (``f`` is a tensor the caller owns)."""
    if cols:
        f[:, 0] = 0.0
        f[:, -1] = 0.0
    if rows:
        f[0, :] = 0.0
        f[-1, :] = 0.0
    return f


def mesh_geometry(q, grid: Grid2D) -> MeshGeometry:
    """Q derivatives with the PMA boundary conditions: ``Q_ksi`` pinned to
    the domain x-limits on the left/right edges, ``Q_eta`` to the y-limits
    on bottom/top, the one-sided Neumann correction ``25/(6h) |edge|`` on
    the second derivatives, and a zero cross derivative on the boundary."""
    dx, dy = grid.dx, grid.dy

    qx = stencils.d1_x(q, dx)
    qx[:, 0] = grid.xl
    qx[:, -1] = grid.xr
    qy = stencils.d1_y(q, dy)
    qy[0, :] = grid.yb
    qy[-1, :] = grid.yt

    qxx = stencils.d2_x(q, dx)
    cx = 25.0 / (6.0 * dx)
    qxx[:, 0] += cx * abs(grid.xl)
    qxx[:, -1] += cx * abs(grid.xr)
    qyy = stencils.d2_y(q, dy)
    cy = 25.0 / (6.0 * dy)
    qyy[0, :] += cy * abs(grid.yb)
    qyy[-1, :] += cy * abs(grid.yt)

    qxy = _zero_edges(stencils.dxy(q, dx, dy))

    jac = qxx * qyy - qxy * qxy
    return MeshGeometry(x=qx, y=qy, xx=qxx, yy=qyy, xy=qxy, jac=jac)


def mesh_geometry_dev(phi, grid: Grid2D) -> MeshGeometry:
    """Mesh geometry from the deviation potential ``Q = (x^2+y^2)/2 + phi``.

    Only the O(1) deviation is differenced (the identity part's derivatives
    are analytic: x, y, 1, 1, 0), so no stencil cancels ``Q/h^2``-sized
    terms — the f32-robust form for fine grids.  ``phi`` has homogeneous
    Neumann BCs, so the one-sided second-derivative corrections vanish.
    """
    dx, dy = grid.dx, grid.dy

    px = stencils.d1_x(phi, dx)
    px[:, 0] = 0.0
    px[:, -1] = 0.0
    py = stencils.d1_y(phi, dy)
    py[0, :] = 0.0
    py[-1, :] = 0.0

    pxx = stencils.d2_x(phi, dx)
    pyy = stencils.d2_y(phi, dy)
    pxy = _zero_edges(stencils.dxy(phi, dx, dy))

    xx_id = grid.xx_op(phi.dtype, phi.device)
    yy_id = grid.yy_op(phi.dtype, phi.device)
    qxx = 1.0 + pxx
    qyy = 1.0 + pyy
    jac = qxx * qyy - pxy * pxy
    return MeshGeometry(x=xx_id + px, y=yy_id + py, xx=qxx, yy=qyy, xy=pxy,
                        jac=jac)


def to_deviation(q, grid: Grid2D):
    """Split a full mesh potential into its identity part and deviation."""
    q_id = 0.5 * (grid.xx_op(q.dtype, q.device) ** 2
                  + grid.yy_op(q.dtype, q.device) ** 2)
    return q - q_id


def grad_ksi_neumann(v, grid: Grid2D, quirk: bool = False):
    """Computational-space gradient with homogeneous Neumann edges zeroed.

    ``quirk=True`` reproduces the reference's slip: it zeroes ``v_ksi``
    (not ``v_eta``) on the bottom row, and ``v_eta`` only on the top row.
    """
    vx = stencils.d1_x(v, grid.dx)
    vy = stencils.d1_y(v, grid.dy)
    vx[:, 0] = 0.0
    vx[:, -1] = 0.0
    if quirk:
        vx[0, :] = 0.0
        vy[-1, :] = 0.0
    else:
        vy[0, :] = 0.0
        vy[-1, :] = 0.0
    return vx, vy


def grad_xy(v_ksi, v_eta, geom: MeshGeometry):
    """Physical-space gradient from computational-space derivatives."""
    vx = (geom.yy * v_ksi - geom.xy * v_eta) / geom.jac
    vy = (-geom.xy * v_ksi + geom.xx * v_eta) / geom.jac
    return vx, vy


def _flux_div_x(a, v, inv_h2):
    """Conservative 4th-order ``(a v_ksi)_ksi`` along the last axis.

    Columns 3..n-4 use the 4th-order conservative form; columns 1, 2, n-3,
    n-2 one-sided product rules; columns 0 and n-1 are zero.
    """
    interior = (
        4.0 * a[:, 2:-4] * (v[:, :-6] - 8.0 * v[:, 1:-5] + 8.0 * v[:, 3:-3] - v[:, 4:-2])
        - (-a[:, 1:-5] + 9.0 * a[:, 2:-4] + 9.0 * a[:, 3:-3] - a[:, 4:-2])
        * (v[:, 1:-5] - 27.0 * v[:, 2:-4] + 27.0 * v[:, 3:-3] - v[:, 4:-2])
        + (-a[:, 2:-4] + 9.0 * a[:, 3:-3] + 9.0 * a[:, 4:-2] - a[:, 5:-1])
        * (v[:, 2:-4] - 27.0 * v[:, 3:-3] + 27.0 * v[:, 4:-2] - v[:, 5:-1])
        - 4.0 * a[:, 4:-2] * (v[:, 2:-4] - 8.0 * v[:, 3:-3] + 8.0 * v[:, 5:-1] - v[:, 6:])
    ) * (inv_h2 / 288.0)

    # next-to-boundary columns (product rule with one-sided stencils)
    c1 = (
        a[:, 1]
        * (10.0 * v[:, 0] - 15.0 * v[:, 1] - 4.0 * v[:, 2] + 14.0 * v[:, 3] - 6.0 * v[:, 4] + v[:, 5])
        / 12.0
        + (-3.0 * v[:, 0] - 10.0 * v[:, 1] + 18.0 * v[:, 2] - 6.0 * v[:, 3] + v[:, 4])
        * (-3.0 * a[:, 0] - 10.0 * a[:, 1] + 18.0 * a[:, 2] - 6.0 * a[:, 3] + a[:, 4])
        / 144.0
    ) * inv_h2
    cm2 = (
        a[:, -2]
        * (10.0 * v[:, -1] - 15.0 * v[:, -2] - 4.0 * v[:, -3] + 14.0 * v[:, -4] - 6.0 * v[:, -5] + v[:, -6])
        / 12.0
        + (3.0 * v[:, -1] + 10.0 * v[:, -2] - 18.0 * v[:, -3] + 6.0 * v[:, -4] - v[:, -5])
        * (3.0 * a[:, -1] + 10.0 * a[:, -2] - 18.0 * a[:, -3] + 6.0 * a[:, -4] - a[:, -5])
        / 144.0
    ) * inv_h2

    # next-to-next-to-boundary columns (centred 2nd derivative + product term)
    c2 = (
        a[:, 2] * (-v[:, 0] + 16.0 * v[:, 1] - 30.0 * v[:, 2] + 16.0 * v[:, 3] - v[:, 4]) / 12.0
        + (v[:, 0] - 8.0 * v[:, 1] + 8.0 * v[:, 3] - v[:, 4])
        * (a[:, 0] - 8.0 * a[:, 1] + 8.0 * a[:, 3] - a[:, 4])
        / 144.0
    ) * inv_h2
    cm3 = (
        a[:, -3] * (-v[:, -1] + 16.0 * v[:, -2] - 30.0 * v[:, -3] + 16.0 * v[:, -4] - v[:, -5]) / 12.0
        + (v[:, -5] - 8.0 * v[:, -4] + 8.0 * v[:, -2] - v[:, -1])
        * (a[:, -5] - 8.0 * a[:, -4] + 8.0 * a[:, -2] - a[:, -1])
        / 144.0
    ) * inv_h2

    zero = torch.zeros_like(c1)
    return torch.cat([zero[:, None], c1[:, None], c2[:, None], interior,
                      cm3[:, None], cm2[:, None], zero[:, None]], dim=1)


def laplace(v, v_ksi, v_eta, geom: MeshGeometry, grid: Grid2D):
    """Curvilinear Laplacian: returns ``(v_xx, v_yy)`` on the moving mesh.

    ``v_ksi``/``v_eta`` are the computational-space first derivatives of
    ``v`` that feed the cross terms.
    """
    j = geom.jac
    a11 = (geom.xy * geom.xy + geom.yy * geom.yy) / j
    a22 = (geom.xy * geom.xy + geom.xx * geom.xx) / j
    a12 = -(geom.xy * (geom.xx + geom.yy)) / j

    v_xx = _flux_div_x(a11, v, 1.0 / (grid.dx * grid.dx))
    v_yy = _flux_div_x(a22.T, v.T, 1.0 / (grid.dy * grid.dy)).T

    # cross terms: (A12 v_eta)_ksi with left/right edges zeroed, and
    # (A12 v_ksi)_eta with top/bottom edges zeroed
    tx = _zero_edges(stencils.d1_x(a12 * v_eta, grid.dx), rows=False)
    ty = _zero_edges(stencils.d1_y(a12 * v_ksi, grid.dy), cols=False)
    return (v_xx + tx) / j, (v_yy + ty) / j
