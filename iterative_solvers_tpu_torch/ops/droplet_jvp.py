"""The droplet inner-Krylov JVP matvec: plain version and CUDA kernel
(counterpart of ``iterative_solvers_tpu/ops/pallas_droplet.py``).

Each inner-Krylov matvec of the droplet JFNK step linearises the
curvilinear Crank–Nicolson residual around the Newton iterate.  For frozen
coefficient fields the directional derivative is the linear chain

    dp  = -(lap_c v) + c0 v
    (dpx, dpy) = grad_xy(dp)            [with dp/dn = 0 edges]
    dA  = dpx c1 + c2 v ,  dB = dpy c1 + c3 v
    dF2 = (yy d1x(dA) - xy d1y(dA) - xy d1x(dB) + xx d1y(dB)) / J
    J v = v - dF2                        [dt/2 folded into c1..c3]

with the coefficient stack of ``models.droplet.jvp_field_stack``.

- :func:`jvp_apply_ref` — the plain PyTorch version, built on the tested
  stencil and curvilinear primitives (the stencils' plain bodies, on the
  card too); used for CPU tensors and as the kernel's oracle.
- :func:`jvp_matvec` — the wrapper: CPU tensors take the plain version,
  CUDA tensors launch the hand-written kernel ``csrc/droplet_jvp.cu`` (one
  fused launch, intermediates staged in shared memory, counted in
  ``ops._build.LAUNCHES`` under ``"droplet_jvp"``) or raise.
- :func:`jvp_apply_tiled_sim` — a CPU rehearsal of the kernel's tiling:
  the chain computed tile by tile from staged windows that hold nothing
  outside the regions the kernel stages; :func:`edge_strip_points` rehearses
  how an edge tile's one-sided points are handed to threads.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.grid import Grid2D
from . import stencils
from ._build import F32, check, launch
from .curvilinear import _zero_edges


def _chain(v, stack, grid: Grid2D, staged=lambda name, f: f):
    """The linearised chain; ``staged(name, f)`` stands where the kernel
    keeps the intermediate ``name`` in shared memory (``v``, ``a11``,
    ``a22``, ``p``, ``q``, ``dp``, ``dA``, ``dB``).  The pointwise stack
    fields are read where they are used.  The stencils and the flux
    divergences are their plain bodies (``stencils.PLAIN``) on every device."""
    inv_j, xx, yy, xy, c0, c1, c2, c3 = stack
    dx, dy = grid.dx, grid.dy
    fd = stencils.PLAIN
    v = staged("v", v)
    a11 = staged("a11", (xy * xy + yy * yy) * inv_j)
    a22 = staged("a22", (xy * xy + xx * xx) * inv_j)
    a12 = -(xy * (xx + yy)) * inv_j

    p = staged("p", a12 * fd.d1_y(v, dy))
    q = staged("q", a12 * fd.d1_x(v, dx))
    fx = fd.flux_div_x(a11, v, 1.0 / (dx * dx))
    fy = fd.flux_div_y(a22, v, 1.0 / (dy * dy))
    tx = _zero_edges(fd.d1_x(p, dx), rows=False)
    ty = _zero_edges(fd.d1_y(q, dy), cols=False)
    v_xx = (fx + tx) * inv_j
    v_yy = (fy + ty) * inv_j

    dp = staged("dp", -(v_xx + v_yy) + c0 * v)
    dpk = _zero_edges(fd.d1_x(dp, dx), rows=False)
    dpe = _zero_edges(fd.d1_y(dp, dy), cols=False)
    dpx = (yy * dpk - xy * dpe) * inv_j
    dpy = (-xy * dpk + xx * dpe) * inv_j

    dA = staged("dA", dpx * c1 + c2 * v)
    dB = staged("dB", dpy * c1 + c3 * v)
    dF2 = (yy * fd.d1_x(dA, dx) - xy * fd.d1_y(dA, dy)
           - xy * fd.d1_x(dB, dx) + xx * fd.d1_y(dB, dy)) * inv_j
    return v - dF2


def jvp_apply_ref(v, stack, grid: Grid2D):
    """The linearised droplet CN chain in plain PyTorch (stack =
    [inv_j, xx, yy, xy, c0, c1, c2, c3], dt/2 folded into c1..c3)."""
    return _chain(v, stack, grid)


def _grow(r, n: int, k: int, e: int):
    """The points a stage reads along an axis of length ``n`` to produce
    the points ``r = (lo, hi)``: ``r`` grown by the interior reach ``k``
    and clamped to the domain; where it then touches an edge, at least the
    ``e`` points from that edge that the one-sided formulas read (d1:
    ``k, e = 2, 5``; flux: ``3, 6``).  The kernel's ``grow``."""
    lo, hi = max(r[0] - k, 0), min(r[1] + k, n)
    if lo == 0:
        hi = max(hi, e)
    if hi == n:
        lo = min(lo, n - e)
    return lo, hi


def tile_regions(rows, cols, ny: int, nx: int):
    """The ``(rows, cols)`` box each staged intermediate of the kernel
    covers for the output tile ``rows x cols`` (global ``(lo, hi)`` pairs):
    dA, dB on the tile + 2, dp on + 4, a11 and P = a12 v_eta on rows + 4 by
    columns + 6, a22 and Q = a12 v_ksi on rows + 6 by columns + 4, v on + 7,
    each clamped to the domain by :func:`_grow`.

    Where ``nx`` is a multiple of 4 and v's region touches no edge of the
    domain, the kernel's threads compute groups of 4 columns and the column
    ranges grow to multiples of 4: the tile + 8 for v, a11 and P, + 4 for
    the rest.  The two outermost dA, dB columns each side then come from
    columns of dp that nothing wrote; no stage reads them.  (In a tile at
    the domain's edge the groups whose taps are all interior ones are
    computed the same way and every other point by the one-sided formulas;
    what the stages read stays inside the boxes given here.)"""
    r2, c2 = _grow(rows, ny, 2, 5), _grow(cols, nx, 2, 5)
    r4, c4 = _grow(r2, ny, 2, 5), _grow(c2, nx, 2, 5)
    r6, c6 = _grow(r4, ny, 2, 5), _grow(c4, nx, 2, 5)
    r7, c7 = _grow(r4, ny, 3, 6), _grow(c4, nx, 3, 6)
    if (nx % 4 == 0 and cols[0] % 4 == 0 and cols[1] % 4 == 0
            and r7[0] > 0 and r7[1] < ny and c7[0] > 0 and c7[1] < nx):
        c7 = c6 = cols[0] - 8, cols[1] + 8
        c4 = c2 = cols[0] - 4, cols[1] + 4
    return {"v": (r7, c7), "a11": (r4, c6), "p": (r4, c6), "a22": (r6, c4),
            "q": (r6, c4), "dp": (r4, c4), "dA": (r2, c2), "dB": (r2, c2)}


def edge_strip_points(rows, cols, ny: int, nx: int, y_reach: int, x_edges: bool):
    """The kernel's ``for_edge_strips``, index for index: the points
    ``(i, j)`` of the box ``rows x cols`` that lie in the grid's first or
    last group of 4 columns (if ``x_edges``) or within ``y_reach`` rows of
    its top or bottom edge, in the order the kernel's threads take them.
    In a tile at the domain's edge these are the points that the one-sided
    formulas compute, a thread a point; the 4-column path computes the
    rest."""
    xl = min(max(cols[0], 4), cols[1]) if x_edges else cols[0]
    xr = max(min(cols[1], nx - 4), xl) if x_edges else cols[1]
    wl, wm = xl - cols[0], xr - xl
    wx = wl + (cols[1] - xr)
    yt = min(max(rows[0], y_reach), rows[1])
    yb = max(min(rows[1], ny - y_reach), yt)
    nt = yt - rows[0]
    n_x = (rows[1] - rows[0]) * wx
    points = []
    for k in range(n_x + (nt + rows[1] - yb) * wm):
        if k < n_x:
            a, b = divmod(k, wx)
            points.append((rows[0] + a, cols[0] + b if b < wl else xr + (b - wl)))
        else:
            a, b = divmod(k - n_x, wm)
            points.append((rows[0] + a if a < nt else yb + (a - nt), xl + b))
    return points


def jvp_apply_tiled_sim(v, stack, grid: Grid2D, tile, offset=(0, 0)):
    """CPU rehearsal of the fused kernel's tiling, in plain PyTorch.

    The output is computed tile by tile (``tile = (ty, tx)`` outputs; tile
    edges at ``offset + k * tile``, so a non-zero offset puts a tile edge 1
    to 6 points from the domain's).  For each tile every staged
    intermediate holds its values on its region of :func:`tile_regions`
    only, indexed globally, and NaN everywhere else: a stencil tap that a
    region does not hold, or a one-sided edge row missing from a clamped
    halo, comes out as NaN in the tile.
    """
    ny, nx = v.shape

    def edges(n, t, off):
        return sorted({0, n, *range(off % t, n, t)})

    out = torch.empty_like(v)
    ie, je = edges(ny, tile[0], offset[0]), edges(nx, tile[1], offset[1])
    for rows in zip(ie[:-1], ie[1:]):
        for cols in zip(je[:-1], je[1:]):
            regions = tile_regions(rows, cols, ny, nx)

            def staged(name, f):
                (a, b), (c, d) = regions[name]
                g = torch.full_like(f, float("nan"))
                g[a:b, c:d] = f[a:b, c:d]
                return g

            full = _chain(v, stack, grid, staged)
            out[rows[0]:rows[1], cols[0]:cols[1]] = \
                full[rows[0]:rows[1], cols[0]:cols[1]]
    return out


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGS = {"droplet_jvp": [_P, _P, _P, _I, _I, _D, _D, _P]}


def jvp_matvec(v, stack, grid: Grid2D):
    """``v - dF2[v]`` on the ``(ny, nx)`` grid.

    On a CUDA tensor it launches the CUDA kernel once (f32, contiguous,
    ``ny, nx >= 8``, any shape otherwise; no device scratch) and raises on
    anything the kernel does not take or on a failed launch; on a CPU
    tensor it runs :func:`jvp_apply_ref`.
    """
    if v.device.type == "cpu":
        return jvp_apply_ref(v, stack, grid)
    shape = grid.shape
    if tuple(v.shape) != shape or tuple(stack.shape) != (8, *shape):
        raise ValueError(f"droplet_jvp kernel: v {tuple(v.shape)}, stack "
                         f"{tuple(stack.shape)} for grid {shape}")
    if min(shape) < 8:
        raise ValueError(f"droplet_jvp kernel needs ny, nx >= 8, got {shape}")
    check("droplet_jvp", v, stack, dtypes=F32)
    out = torch.empty_like(v)
    launch(("droplet_jvp", "f32", None), "droplet_jvp", _ARGS, v.device,
           v.data_ptr(), stack.data_ptr(), out.data_ptr(), grid.ny, grid.nx, grid.dx, grid.dy)
    return out
