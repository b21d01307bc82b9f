"""Curvilinear (moving-mesh) operators
(port of ``iterative_solvers_tpu/ops/curvilinear.py``).

- :func:`mesh_geometry` / :func:`mesh_geometry_dev` — derivatives of the
  mesh potential with the PMA Neumann boundary treatment, and the Hessian
  determinant ``J``;
- :func:`grad_xy` — physical-space gradient through the inverse metric;
- :func:`laplace` — the conservative 4th-order curvilinear Laplacian with
  its three rings of one-sided boundary formulas (the flux divergences of
  ``ops.stencils``); :func:`laplacian_xy` its sum with Neumann edges.

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


def unstaged(name: str, f):
    """The default ``staged`` hook of :func:`mesh_geometry_dev` and
    :func:`laplace`: ``f`` itself."""
    return f


def mesh_geometry_dev(phi, grid: Grid2D, coords=None, *,
                      staged=unstaged, fd=stencils) -> MeshGeometry:
    """Mesh geometry from the deviation potential ``Q = (x^2+y^2)/2 + phi``.

    Only the O(1) deviation is differenced (the identity part's derivatives
    are analytic: x, y, 1, 1, 0), so no stencil cancels ``Q/h^2``-sized
    terms — the f32-robust form for fine grids.  ``phi`` has homogeneous
    Neumann BCs, so the one-sided second-derivative corrections vanish.

    ``coords=(xx, yy)`` replaces the grid's coordinate fields: the sharded
    droplet path (``dist.droplet``) passes the blocks that match a
    halo-extended ``phi`` block.

    ``staged(name, f)`` stands where the fused PMA kernel keeps ``name`` in
    shared memory (``dxp`` = d1_x(phi), ``jac``): the CPU rehearsal of its
    tiling (``ops.pma_substep.pma_substep_tiled_sim``) passes a window.

    ``fd`` is the set of stencils it calls (``d1_x``, ``d1_y``, ``d2_x``,
    ``d2_y``): ``ops.stencils``, or ``ops.stencils.PLAIN``, their plain
    bodies on any device, for the plain version a kernel is held to.
    """
    dx, dy = grid.dx, grid.dy

    px = fd.d1_x(phi, dx)
    px[:, 0] = 0.0
    px[:, -1] = 0.0
    py = fd.d1_y(phi, dy)
    py[0, :] = 0.0
    py[-1, :] = 0.0

    pxx = fd.d2_x(phi, dx)
    pyy = fd.d2_y(phi, dy)
    pxy = _zero_edges(fd.d1_y(staged("dxp", fd.d1_x(phi, dx)), dy))

    if coords is None:
        xx_id = grid.xx_op(phi.dtype, phi.device)
        yy_id = grid.yy_op(phi.dtype, phi.device)
    else:
        xx_id, yy_id = (c.to(phi.dtype) for c in coords)
    qxx = 1.0 + pxx
    qyy = 1.0 + pyy
    jac = staged("jac", qxx * qyy - pxy * pxy)
    return MeshGeometry(x=xx_id + px, y=yy_id + py, xx=qxx, yy=qyy, xy=pxy,
                        jac=jac)


# the form ``ops.pma_substep``'s kernels compute (``GEOMETRY`` there)
mesh_geometry_dev.pma_kernel = "deviation"


def to_deviation(q, grid: Grid2D):
    """Split a full mesh potential into its identity part and deviation."""
    q_id = 0.5 * (grid.xx_op(q.dtype, q.device) ** 2
                  + grid.yy_op(q.dtype, q.device) ** 2)
    return q - q_id


def grad_ksi_neumann(v, grid: Grid2D, quirk: bool = False, *, fd=stencils):
    """Computational-space gradient with homogeneous Neumann edges zeroed.

    ``quirk=True`` reproduces the reference's slip: it zeroes ``v_ksi``
    (not ``v_eta``) on the bottom row, and ``v_eta`` only on the top row.
    ``fd`` as in :func:`mesh_geometry_dev`.
    """
    vx = fd.d1_x(v, grid.dx)
    vy = fd.d1_y(v, grid.dy)
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


def _flux_div_widened(a, v, inv_h2, edge_dtype, axis: int):
    """The plain flux divergence along ``axis`` (-1: ``flux_div_x``, -2:
    ``flux_div_y``) with its one-sided ends evaluated from 6-point edge
    strips in the wider ``edge_dtype`` (e.g. ``torch.float64``) and cast
    back: their product rules cancel ``v/h^2``-sized terms, the f32
    accuracy limit at fine grids."""
    flux = stencils.flux_div_x_plain if axis == -1 else stencils.flux_div_y_plain
    out = flux(a, v, inv_h2)
    if edge_dtype == v.dtype:
        return out
    n, strip = v.shape[axis], 6  # the widest one-sided formula reads 6 edge points
    lo, hi = (flux(a.narrow(axis, k, strip).to(edge_dtype),
                   v.narrow(axis, k, strip).to(edge_dtype), inv_h2).to(v.dtype)
              for k in (0, n - strip))
    return torch.cat([lo.narrow(axis, 0, 3), out.narrow(axis, 3, n - 6),
                      hi.narrow(axis, 3, 3)], dim=axis)


def laplace(v, v_ksi, v_eta, geom: MeshGeometry, grid: Grid2D,
            edge_dtype=None, *, staged=unstaged, fd=stencils):
    """Curvilinear Laplacian: returns ``(v_xx, v_yy)`` on the moving mesh.

    ``v_ksi``/``v_eta`` are the computational-space first derivatives of
    ``v`` that feed the cross terms.  The flux divergences are ``fd``'s
    ``flux_div_x`` and ``flux_div_y`` (on the card one kernel launch each);
    ``edge_dtype`` widens their one-sided ends and takes the plain bodies
    (see :func:`_flux_div_widened`).  ``staged`` and ``fd`` as in
    :func:`mesh_geometry_dev` (``a11``, ``a22``, ``p`` = a12 v_eta,
    ``q`` = a12 v_ksi).
    """
    j = geom.jac
    a11 = staged("a11", (geom.xy * geom.xy + geom.yy * geom.yy) / j)
    a22 = staged("a22", (geom.xy * geom.xy + geom.xx * geom.xx) / j)
    a12 = -(geom.xy * (geom.xx + geom.yy)) / j

    ihx, ihy = 1.0 / (grid.dx * grid.dx), 1.0 / (grid.dy * grid.dy)
    if edge_dtype is None:
        v_xx = fd.flux_div_x(a11, v, ihx)
        v_yy = fd.flux_div_y(a22, v, ihy)
    else:
        v_xx = _flux_div_widened(a11, v, ihx, edge_dtype, -1)
        v_yy = _flux_div_widened(a22, v, ihy, edge_dtype, -2)

    # cross terms: (A12 v_eta)_ksi with left/right edges zeroed, and
    # (A12 v_ksi)_eta with top/bottom edges zeroed
    tx = _zero_edges(fd.d1_x(staged("p", a12 * v_eta), grid.dx), rows=False)
    ty = _zero_edges(fd.d1_y(staged("q", a12 * v_ksi), grid.dy), cols=False)
    return (v_xx + tx) / j, (v_yy + ty) / j


def laplacian_xy(v, geom: MeshGeometry, grid: Grid2D):
    """Physical Laplacian ``v_xx + v_yy`` with homogeneous Neumann edges."""
    v_ksi, v_eta = grad_ksi_neumann(v, grid)
    v_xx, v_yy = laplace(v, v_ksi, v_eta, geom, grid)
    return v_xx + v_yy
