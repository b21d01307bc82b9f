"""The PMA sub-step's stencil and pointwise chain as CUDA kernels (no TPU
counterpart: the JAX package leaves this chain to XLA).

One explicit sub-step of ``meshmove.pma.loop_pma`` on the deviation
potential (``ops.curvilinear.mesh_geometry_dev``) with the droplet's monitor
(``models.droplet.monitor_source``), in f32:

    src, J = |lap_xy u|^2 and the Hessian determinant, on phi = base + s
    mon    = 4 passes of the 9-point filter over src
    rhs    = sqrt((mon + c sum(mon |J|) dx dy) |J|) / alpha
    dqdt   = idct2(dct2(rhs) / (1 - gamma leig))
    s     += dt dqdt

- :func:`source`, :func:`smooth`, :func:`rhs`, :func:`divide`,
  :func:`accumulate` — the stages, one launch each of the hand-written
  kernels of ``csrc/pma_substep.cu``; they take CUDA tensors only (the
  plain version is the eager chain itself, which ``loop_pma`` runs
  elsewhere).  The launches are counted in ``ops._build.LAUNCHES`` under
  the kernel's name (``"pma_source"``, ...).
- :func:`substep` — the stages and the four DCT matmuls (``torch.matmul``):
  12 launches a sub-step.
- :func:`pma_substep_tiled_sim` — a CPU rehearsal of the kernels' tiling:
  stages 1-3 computed tile by tile by the eager functions, from staged
  windows that hold nothing outside the regions the kernels stage.

The kernels round every operation as the eager op it stands for rounds on
the card (see the note at the top of the ``.cu`` file), so the stages equal
the eager chain bit for bit; the one deliberate difference is the order of
the Mackenzie sum (per-block partials, then a fixed-order sum of them).

:data:`GEOMETRY` and :data:`MONITOR` name the forms the kernels compute;
``mesh_geometry_dev`` and the droplet's ``monitor_source`` carry them as
their ``pma_kernel`` attribute, which is how ``loop_pma`` knows it may take
this path.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.grid import Grid2D
from ._build import F32, call, check, launch
from .curvilinear import grad_ksi_neumann, mesh_geometry_dev
from .dct import dct2, idct2
from .droplet_jvp import _grow

GEOMETRY = "deviation"            # mesh_geometry_dev: phi's derivatives, J
MONITOR = "quirk_laplacian_sq"    # |laplace(u, grad_ksi_neumann(u, quirk))|^2

# The smoothing kernel's block covers 32 columns x 64 rows (one partial sum
# of mon |J| each); the source kernel's tile is 32 x 32.
SMOOTH_TILE = (64, 32)
SOURCE_TILE = (32, 32)


def film_gradient(u, grid: Grid2D):
    """``(u_ksi, u_eta)`` with the reference's quirk edges: the film's part
    of the monitor source, which the sub-steps do not change (contiguous,
    as the kernels take them)."""
    return tuple(g.contiguous() for g in grad_ksi_neumann(u, grid, quirk=True))


# -- the kernels -------------------------------------------------------------

_P = ctypes.c_void_p
_I, _D = ctypes.c_int, ctypes.c_double
_ARGS = {
    "pma_source": [_P] * 8 + [_I, _I, _D, _D, _P],
    "pma_smooth": [_P] * 4 + [_I, _I, _P],
    "pma_rhs": [_P, _P, _P, _I, _P, _P, _I, _I, _D, _D, _D, _D, _P],
    "pma_divide": [_P, _P, _P, _I, _P],
    "pma_accumulate": [_P, _P, _P, _I, _D, _P],
    "pma_source_resources": [_P],
}


def _check(kernel: str, shape, *fields, extra=()):
    """Raise on anything ``kernel`` does not take: ``fields`` of the grid's
    ``shape`` and ``extra`` pairs ``(tensor, its shape)``, all f32,
    contiguous and on one CUDA device."""
    pairs = [(f, shape) for f in fields] + list(extra)
    for f, want in pairs:
        if tuple(f.shape) != tuple(want):
            raise ValueError(f"{kernel} kernel: {tuple(f.shape)} where it takes {tuple(want)}")
    if min(shape) < 8:
        raise ValueError(f"{kernel} kernel needs ny, nx >= 8, got {tuple(shape)}")
    check(kernel, *(f for f, _ in pairs), dtypes=F32)


def _launch(kernel: str, device, *args):
    launch((kernel, "f32", None), kernel, _ARGS, device, *args)


def _ptr(t):
    return None if t is None else t.data_ptr()


def source(base, s, u, u_ksi, u_eta, grid: Grid2D, stages=None):
    """``(src, J)``: the monitor source and the Jacobian on ``phi = base +
    s`` (``base`` None: ``phi = s``).  ``stages``, a ``(3, ny, nx)`` f32
    tensor, receives the kernel's a11, a22, a12 (CUDA only)."""
    fields = (s, u, u_ksi, u_eta) + (() if base is None else (base,))
    _check("pma_source", grid.shape, *fields,
           extra=() if stages is None else ((stages, (3, *grid.shape)),))
    src, jac = torch.empty_like(s), torch.empty_like(s)
    _launch("pma_source", s.device, _ptr(base), s.data_ptr(), u.data_ptr(), u_ksi.data_ptr(),
            u_eta.data_ptr(), src.data_ptr(), jac.data_ptr(), _ptr(stages), grid.ny,
            grid.nx, grid.dx, grid.dy)
    return src, jac


def partials_count(grid: Grid2D) -> int:
    """How many partial sums :func:`smooth` writes on the card."""
    return -(-grid.nx // SMOOTH_TILE[1]) * -(-grid.ny // SMOOTH_TILE[0])


def smooth(t, jac=None):
    """One smoothing pass; with ``jac``, ``(mon, partials)``: also the
    partial sums of ``mon |J|``, one a kernel block."""
    ny, nx = t.shape
    _check("pma_smooth", t.shape, t, *(() if jac is None else (jac,)))
    out = torch.empty_like(t)
    partials = None if jac is None else t.new_empty(partials_count(Grid2D(nx=nx, ny=ny)))
    _launch("pma_smooth", t.device, t.data_ptr(), _ptr(jac), out.data_ptr(), _ptr(partials),
            ny, nx)
    return out if jac is None else (out, partials)


def rhs(mon, jac, partials, grid: Grid2D, mackenzie_c: float, alpha: float, floor_out=None):
    """The spectral solve's right-hand side from the smoothed monitor and the
    partial sums of :func:`smooth`; ``floor_out`` (one f32) receives the
    Mackenzie floor."""
    extra = ((partials, (partials_count(grid),)),)
    _check("pma_rhs", grid.shape, mon, jac,
           extra=extra if floor_out is None else extra + ((floor_out, (1,)),))
    out = torch.empty_like(mon)
    _launch("pma_rhs", mon.device, mon.data_ptr(), jac.data_ptr(), partials.data_ptr(),
            partials.numel(), out.data_ptr(), _ptr(floor_out), grid.ny, grid.nx, grid.dx,
            grid.dy, float(mackenzie_c), float(alpha))
    return out


def divide(spec, den):
    """``spec / den``, pointwise."""
    _check("pma_divide", spec.shape, spec, den)
    out = torch.empty_like(spec)
    _launch("pma_divide", spec.device, spec.data_ptr(), den.data_ptr(), out.data_ptr(),
            spec.numel())
    return out


def accumulate(s, dqdt, dt: float):
    """``s + dt * dqdt``, pointwise."""
    _check("pma_accumulate", s.shape, s, dqdt)
    out = torch.empty_like(s)
    _launch("pma_accumulate", s.device, s.data_ptr(), dqdt.data_ptr(), out.data_ptr(),
            s.numel(), float(dt))
    return out


def source_resources() -> dict:
    """Registers, shared memory, spills and resident blocks of the card's
    ``pma_source`` kernel."""
    r = (ctypes.c_int * 5)()
    call("pma_source_resources", _ARGS, ctypes.cast(r, ctypes.c_void_p))
    return dict(zip(("registers", "shared_bytes", "spill_bytes", "blocks_per_sm",
                     "threads"), list(r)))


def substep(base, s, u, u_ksi, u_eta, den, grid: Grid2D, *, dt: float,
            smoothing_iters: int, mackenzie_c: float, alpha: float, precision=None):
    """``s + dt dqdt``: one sub-step of the PMA on ``phi = base + s``;
    ``den = 1 - gamma leig`` and ``(u_ksi, u_eta) = film_gradient(u)``
    computed once by the caller; ``precision`` that of the DCT matmuls
    (:func:`.dct.dct2`)."""
    src, jac = source(base, s, u, u_ksi, u_eta, grid)
    mon = src
    for _ in range(smoothing_iters - 1):
        mon = smooth(mon)
    mon, partials = smooth(mon, jac)
    q_rhs = rhs(mon, jac, partials, grid, mackenzie_c, alpha)
    return accumulate(s, idct2(divide(dct2(q_rhs, precision), den), precision), dt)


# -- the CPU rehearsal of the kernels' tiling --------------------------------

def source_regions(rows, cols, ny: int, nx: int):
    """The ``(rows, cols)`` box each staged plane of the source kernel
    covers for the output tile ``rows x cols`` (global ``(lo, hi)`` pairs):
    the metric planes on the tile + 2 (the flux's and the cross terms'
    reach), u on + 3, d1_x(phi) on the metric's rows + 2 by its columns,
    phi on the metric's box + 2, each clamped to the domain as the kernel's
    ``grow`` clamps it (:func:`..droplet_jvp._grow`; d2 reads 6 edge
    points)."""
    rm, cm = _grow(rows, ny, 2, 5), _grow(cols, nx, 2, 5)
    metric = (rm, cm)
    return {"phi": (_grow(rm, ny, 2, 6), _grow(cm, nx, 2, 6)),
            "u": (_grow(rows, ny, 3, 6), _grow(cols, nx, 3, 6)),
            "dxp": (_grow(rm, ny, 2, 5), cm),
            "jac": metric, "a11": metric, "a22": metric, "p": metric, "q": metric}


def _tiles(n: int, t: int):
    edges = list(range(0, n, t)) + [n]
    return list(zip(edges[:-1], edges[1:]))


def _window(f, box):
    """``f`` on ``box`` only, NaN elsewhere."""
    (a, b), (c, d) = box
    g = torch.full_like(f, float("nan"))
    g[a:b, c:d] = f[a:b, c:d]
    return g


def pma_substep_tiled_sim(base, s, u, grid: Grid2D, *, monitor_source, smooth_pass,
                          smoothing_iters: int, mackenzie_c: float, alpha: float,
                          source_tile=SOURCE_TILE, smooth_tile=SMOOTH_TILE):
    """CPU rehearsal of stages 1-3 (source, smoothing, right-hand side) by
    the eager functions, tile by tile: ``mesh_geometry_dev``, then
    ``monitor_source(u, geom, grid, staged=...)`` (the form :data:`MONITOR`
    names) and ``smooth_pass`` (``meshmove.monitor``'s 9-point filter).

    Stage 1 computes each ``source_tile`` output tile from windows that
    hold every staged plane on its region of :func:`source_regions` only,
    NaN elsewhere (the functions' ``staged`` hook): a stencil tap that a
    region does not hold, or a one-sided edge row missing from a clamped
    halo, comes out NaN in the tile.  Each smoothing pass computes each
    ``smooth_tile`` tile from its input on the tile grown by 1; the last
    pass also takes one partial sum of ``mon |J|`` a tile, and stage 3 sums
    the partials in tile order.
    Returns ``{"src", "jac", "passes", "floor", "rhs"}``.
    """
    ny, nx = s.shape
    phi = s if base is None else base + s
    src, jac = torch.empty_like(s), torch.empty_like(s)
    for rows in _tiles(ny, source_tile[0]):
        for cols in _tiles(nx, source_tile[1]):
            regions = source_regions(rows, cols, ny, nx)

            def staged(name, f):
                return _window(f, regions[name])

            geom = mesh_geometry_dev(staged("phi", phi), grid, staged=staged)
            tsrc = monitor_source(u, geom, grid, staged=staged)
            src[rows[0]:rows[1], cols[0]:cols[1]] = tsrc[rows[0]:rows[1], cols[0]:cols[1]]
            jac[rows[0]:rows[1], cols[0]:cols[1]] = geom.jac[rows[0]:rows[1], cols[0]:cols[1]]
    passes, mon, partials = [], src, []
    for k in range(smoothing_iters):
        out = torch.empty_like(mon)
        for rows in _tiles(ny, smooth_tile[0]):
            for cols in _tiles(nx, smooth_tile[1]):
                box = (_grow(rows, ny, 1, 2), _grow(cols, nx, 1, 2))
                tile = smooth_pass(_window(mon, box))[rows[0]:rows[1], cols[0]:cols[1]]
                out[rows[0]:rows[1], cols[0]:cols[1]] = tile
                if k == smoothing_iters - 1:
                    partials.append(torch.sum(
                        tile * torch.abs(jac[rows[0]:rows[1], cols[0]:cols[1]])))
        passes.append(out)
        mon = out
    floor = mackenzie_c * (torch.sum(torch.stack(partials)) * grid.dx * grid.dy)
    return {"src": src, "jac": jac, "passes": passes, "floor": floor,
            "rhs": torch.sqrt((mon + floor) * torch.abs(jac)) / alpha}
