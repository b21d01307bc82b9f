"""The diagonal-format SpMV / SpMM kernels
(counterpart of ``iterative_solvers_tpu/ops/pallas_spmv.py``).

- :func:`grid_dia_matvec` — ``y = A x`` for a :class:`GridDIA` on the
  ``(ny, nx)`` grid view, clamped or cyclic, through the tiled kernel with
  per-block live-term lists;
- :func:`dia_flat_matvec` — ``y = A x`` for a row-aligned flat :class:`DIA`;
- :func:`grid_dia_matmat` — the GridDIA product for a stack
  ``(nrhs, ny, nx)``, each coefficient read once per point;
- :func:`grid_dia_matmat_interleaved` — the same on the row-interleaved
  layout ``(ny, nrhs, nx)``.

On a CPU tensor each runs its plain version (``GridDIA._apply``,
``DIA.matvec``, the per-rhs stack); on a CUDA tensor it launches the
hand-written kernel of ``csrc/dia_spmv.cu`` or raises.  The kernels take
f32 and f64, any ``ny, nx >= 1``, any shifts or offsets, any number of
terms (none gives ``y = 0``) and any ``nrhs >= 1``: there is no
eligibility gate and so no fallback.  A term whose source lies outside
the grid adds nothing whatever its coefficient, as in the plain versions.
The launches are counted in ``ops._build.LAUNCHES`` under the wrapper's
name, with the path that took them.

The SpMV's tiled kernel gives each block an 8 x 128 tile and its own list
of live terms (dead ones dropped, those whose sources all lie in the grid
taken as one flat offset with no per-point test, the rest tested per
point), a thread 4 points of a row; :func:`matvec_path` picks its
``"vector"`` path (16-byte loads of coefficients and y) where the rows are
whole, aligned 16-byte vectors and its ``"scalar"`` path otherwise, from
shape and address alone.  :func:`grid_dia_matvec_tiled_sim` rehearses it
on the CPU, and :func:`grid_dia_block_terms` is its classification of the
terms for one tile.

The SpMM has two hand-written kernels, chosen by :func:`spmm_path` from
the container's terms, the shape and the addresses alone, never by a
failed launch: the row-slab kernel (``"slab"``) where the signed reach of
the terms fits its staged halo and the rows are whole, aligned 16-byte
vectors, the tiled kernel (``"general"``) for every other container or
shape (far shifts, odd widths, unaligned stacks).  The tiled SpMM takes
the tiled SpMV's per-block live-term lists to a stack: a tile of 8 x 64
f32 / 8 x 32 f64 points, a register tile of up to 8 right-hand sides, each
coefficient loaded once for all of them, and x staged in a shared-memory
window of the tile and its reach; :func:`matvec_path` names its path for
the stack too (``"vector"``: the window copied as 16-byte vectors); the
SpMM's path is the kernel's, ``"slab"`` or ``"general"``.
:func:`grid_dia_matmat_slab_sim` and :func:`grid_dia_matmat_tiled_sim`
rehearse the two on the CPU.

The JAX wrappers' ``block_rows`` sizes the TPU's slab pipeline and has no
counterpart here.  The kernels have no derivative rule, as the Pallas
kernels have none: autodiff through a CUDA call raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ._build import DTYPES, check, launch
from .sparse import DIA, GridDIA, term_order

_INT32_MAX = 2 ** 31 - 1

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = {"grid_dia_matvec": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
         "dia_flat_matvec": [_P, _P, _I, _P, _P, ctypes.c_longlong, _P],
         "grid_dia_matmat": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
         "grid_dia_matmat_interleaved": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
         "grid_dia_matmat_slab": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]}


@lru_cache(maxsize=128)
def _term_rows(shifts, grid, cyclic: bool, signed: bool):
    """``(k, dy, dx)`` per term of a GridDIA in the order ``_apply`` sums
    them.  Cyclic shifts are reduced to ``[0, n)`` (the general kernels
    wrap by one compare and subtract) or, ``signed``, to ``(-n/2, n/2]``
    (the slab kernel's reach); clamped terms that reach no grid point are
    left out."""
    ny, nx = grid
    near, far = term_order(shifts, cyclic)
    if not cyclic:
        return tuple(t for t in near + far if abs(t[1]) < ny and abs(t[2]) < nx)

    def reduce(d, n):
        d %= n
        return d - n if signed and d > n // 2 else d
    return tuple((k, reduce(dy, ny), reduce(dx, nx)) for k, dy, dx in near + far)


@lru_cache(maxsize=64)
def _grid_terms(shifts, grid, cyclic: bool, device: torch.device):
    """The general kernels' term table of a GridDIA on ``device``, built
    once per container structure: int32 rows ``(k, dy, dx)``."""
    rows = _term_rows(shifts, grid, cyclic, False)
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1, 3)


def _slab_rows(shifts, grid, cyclic: bool):
    """The slab kernel's terms of a GridDIA (signed shifts) and their reach
    ``(hy, hx)``, the largest ``|dy|`` and ``|dx|``."""
    rows = _term_rows(shifts, grid, cyclic, True)
    hy = max((abs(dy) for _, dy, _ in rows), default=0)
    hx = max((abs(dx) for _, _, dx in rows), default=0)
    return rows, hy, hx


@lru_cache(maxsize=64)
def _slab_terms(shifts, grid, cyclic: bool, device: torch.device):
    """The slab kernel's term table on ``device``: int32 rows ``(k, dy, dx)``."""
    rows = _term_rows(shifts, grid, cyclic, True)
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1, 3)


# The slab kernel's tiling, as in csrc/dia_spmv.cu (SlabOf): element size
# -> (strip columns W, slab rows B, stages S); one 16-byte halo vector each
# side of a strip, 2 staged halo rows (8 where the reach needs more, at
# most 8), 227 KB of shared memory a block.
_SLAB_TILING = {4: (64, 8, 2), 8: (32, 8, 2)}
_SLAB_MAX_HY = 8
_SMEM_PER_BLOCK = 232448


def _slab_smem_bytes(nterms: int, nrhs: int, hy: int, itemsize: int) -> int:
    """Dynamic shared memory of a slab launch (``slab_smem_bytes`` in the
    CUDA source): S stages of the coefficient chunk and the x slab with
    its staged halo rows (2 for a reach of up to 2, else 8), and the term
    table."""
    w, b, stages = _SLAB_TILING[itemsize]
    vector = 16 // itemsize
    staged = 2 if hy <= 2 else _SLAB_MAX_HY
    stage = nterms * b * w + nrhs * (b + 2 * staged) * (w + 2 * vector)
    return stages * stage * itemsize + 8 * nterms


def spmm_path(a: GridDIA, x) -> str:
    """Which SpMM kernel takes ``A @ X`` for the stack ``x`` (either
    layout): ``"slab"`` where the terms' signed reach fits the staged halo
    (``|dy| <= 8``, ``|dx|`` at most one 16-byte vector), ``nx`` is a
    multiple of a 16-byte vector, ``x`` and the coefficients are 16-byte
    aligned and the stages fit a block's shared memory; ``"general"``
    otherwise.  Decided from shape, terms and address alone."""
    if x.dtype not in DTYPES or a.data.dtype != x.dtype:
        return "general"
    itemsize = x.element_size()
    vector = 16 // itemsize
    ny, nx = a.grid
    rows, hy, hx = _slab_rows(a.shifts, a.grid, a.cyclic)
    nrhs = x.numel() // max(ny * nx, 1)
    if (nx % vector or hy > _SLAB_MAX_HY or hx > vector
            or (x.data_ptr() | a.data.data_ptr()) % 16
            or _slab_smem_bytes(len(rows), nrhs, hy, itemsize) > _SMEM_PER_BLOCK):
        return "general"
    return "slab"


def grid_dia_matmat_slab_sim(a: GridDIA, x, layout: str = "stacked", W: int = 64,
                             B: int = 8, Hy: int = 2, Hx: int = 4):
    """CPU rehearsal of the row-slab kernel, in plain PyTorch: ``y`` is
    built strip by strip (``W`` columns, the last one ragged) and slab by
    slab (``B`` rows, the last one ragged) from what the kernel stages: the
    coefficient chunk of the slab, and the x slab in ``B + 2 Hy`` staged
    rows of which the ``hy`` above and below the slab that the terms reach
    are filled, with one halo vector of ``Hx`` columns each side, copied a
    vector at a time from the wrapped rows and columns (cyclic) or
    zero-filled (clamped), a ragged strip's right halo right after its last
    column; the top ``2 hy`` rows of every slab but a strip's first are
    taken from the previous slab's staged rows, as the kernel does within a
    segment.  What the kernel does not stage is NaN, so a tap outside the
    staged window shows.  The terms are summed in the table's order, each
    product rounded on its own (the kernel contracts them into FMAs).  ``x``
    is ``(nrhs, ny, nx)`` (``layout="stacked"``) or ``(ny, nrhs, nx)``
    (``"interleaved"``)."""
    ny, nx = a.grid
    rows, hy, hx = _slab_rows(a.shifts, a.grid, a.cyclic)
    if nx % Hx or W % Hx or hy > Hy or hx > Hx:
        raise ValueError(f"the slab kernel does not take reach {(hy, hx)} on a "
                         f"{ny} x {nx} grid with halo {(Hy, Hx)} and strips of {W}")
    x3 = x if layout == "stacked" else x.movedim(1, 0)
    nrhs = x3.shape[0]
    y = torch.empty_like(x3)
    coef = a.data[[k for k, _, _ in rows]] if rows else a.data[:0]
    for c0 in range(0, nx, W):
        w = min(W, nx - c0)
        # the staged vectors of a row: one halo vector each side of the strip
        gcol, cok = [], []
        for v in range(w // Hx + 2):
            gc = c0 - Hx + v * Hx
            ok = 0 <= gc < nx
            if a.cyclic:
                gc, ok = gc % nx, True
            gcol.append(gc if ok else 0)
            cok.append(ok)
        prev = None
        for r0 in range(0, ny, B):
            b = min(B, ny - r0)
            xs = torch.full((nrhs, B + 2 * Hy, W + 2 * Hx), float("nan"), dtype=x.dtype)
            for i in range(Hy - hy, Hy + b + hy):  # staged row Hy + r is slab row r
                if prev is not None and i < Hy + hy:
                    xs[:, i] = prev[:, i + B]
                    continue
                gr = r0 - Hy + i
                rok = 0 <= gr < ny
                if a.cyclic:
                    gr, rok = gr % ny, True
                for v, (gc, ok) in enumerate(zip(gcol, cok)):
                    dst = xs[:, i, v * Hx:(v + 1) * Hx]
                    dst.copy_(x3[:, gr, gc:gc + Hx] if rok and ok else torch.zeros_like(dst))
            cs = torch.full((len(rows), B, W), float("nan"), dtype=x.dtype)
            cs[:, :b, :w] = coef[:, r0:r0 + b, c0:c0 + w]
            acc = torch.zeros((nrhs, b, w), dtype=x.dtype)
            for t, (_, dy, dx) in enumerate(rows):
                acc = acc + cs[t, :b, :w] * xs[:, Hy + dy:Hy + dy + b, Hx + dx:Hx + dx + w]
            y[:, r0:r0 + b, c0:c0 + w] = acc
            prev = xs
    return y if layout == "stacked" else y.movedim(0, 1)


# The tiled SpMV's tiling, as in csrc/dia_spmv.cu (MvTiling, MvOf): 8 rows x
# 32 threads a tile, 4 points a thread along a row (one f32 vector, two f64
# vectors 32 vectors apart, or 4 scalar points 32 columns apart): tiles of
# 8 x 128; terms classified and walked in chunks of 256.
_MV_ROWS, _MV_TX, _MV_POINTS, _MV_CHUNK = 8, 32, 4, 256


def matvec_path(a: GridDIA, x2) -> str:
    """Which path of the tiled SpMV takes ``A @ x2`` (and of the tiled
    SpMM, for a stack ``x2`` in either layout): ``"vector"`` where ``nx``
    is a multiple of a 16-byte vector and ``x2`` and the coefficients are
    16-byte aligned (the output is allocated aligned), so that the SpMV's
    coefficients and y move as 16-byte vectors and the SpMM copies its x
    window as 16-byte vectors; ``"scalar"`` otherwise (odd widths such as
    999 f64).  Decided from shape and address alone (a functorch-wrapped
    tensor has no address: ``"scalar"``, and the launch refuses it)."""
    vector = 16 // x2.element_size() if x2.dtype in DTYPES else 0
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    if (not vector or a.grid[1] % vector or wrapped(x2) or wrapped(a.data)
            or (x2.data_ptr() | a.data.data_ptr()) % 16):
        return "scalar"
    return "vector"


def _axis_kind(lo: int, hi: int, d: int, n: int, cyclic: bool):
    """The tile's indices ``[lo, hi]`` along an axis of length ``n``
    shifted by ``d`` (``axis_kind`` in the CUDA source): ``("dead", d)``
    when no source lies in the axis, ``("whole", e)`` when every source
    does (cyclic: none of them wraps; ``e`` is the shift that reaches
    them), ``("partial", d)`` otherwise."""
    if cyclic:
        if hi + d < n:
            return "whole", d
        if lo + d >= n:
            return "whole", d - n
        return "partial", d
    if hi + d < 0 or lo + d >= n:
        return "dead", d
    return ("whole" if lo + d >= 0 and hi + d < n else "partial"), d


def grid_dia_block_terms(rows, grid, cyclic: bool, r0: int, r1: int, c0: int, c1: int,
                         row_stride: int | None = None):
    """The live-term list that the tiled kernels build for the tile of rows
    ``[r0, r1)`` and columns ``[c0, c1)`` from the term table ``rows``
    (``(k, dy, dx)``, cyclic shifts in ``[0, n)``): the terms with a source
    in the grid, in table order, as ``(kind, k, dy, dx, xoff)`` with kind
    ``"whole"`` (every source in the grid and, cyclic, none wrapping within
    the tile: ``xoff`` is the flat offset of the source in x, whose rows
    lie ``row_stride`` apart, ``nx`` by default; no per-point test) or
    ``"partial"`` (tested per point)."""
    ny, nx = grid
    row_stride = nx if row_stride is None else row_stride
    out = []
    for k, dy, dx in rows:
        ky, ey = _axis_kind(r0, r1 - 1, dy, ny, cyclic)
        kx, ex = _axis_kind(c0, c1 - 1, dx, nx, cyclic)
        if "dead" in (ky, kx):
            continue
        kind = "whole" if ky == kx == "whole" else "partial"
        out.append((kind, k, dy, dx, ey * row_stride + ex))
    return out


def _tile_points(r0: int, c0: int, grid, rows: int, tx: int, points: int, vector: int):
    """The grid points of the tile at ``(r0, c0)`` in the order the
    kernel's threads hold them: for each row, thread ``t`` of ``tx`` takes
    ``points // vector`` slots ``m``, each ``vector`` columns from
    ``c0 + (m tx + t) vector`` (``vector`` 1: the scalar path); a slot lies
    in the grid whole or not at all.  Returns the flat rows and columns."""
    ny, nx = grid
    rr, cs = [], []
    for r in range(r0, min(r0 + rows, ny)):
        for t in range(tx):
            for m in range(points // vector):
                c = c0 + (m * tx + t) * vector
                if c < nx:
                    rr += [r] * vector
                    cs += range(c, c + vector)
    return torch.tensor(rr, dtype=torch.long), torch.tensor(cs, dtype=torch.long)


def grid_dia_matvec_tiled_sim(a: GridDIA, x2, path: str = "vector", rows: int = _MV_ROWS,
                              tx: int = _MV_TX, points: int = _MV_POINTS,
                              chunk: int = _MV_CHUNK):
    """CPU rehearsal of the tiled SpMV, in plain PyTorch: ``y`` is built
    tile by tile (``rows`` x ``tx * points`` columns, the last ones ragged)
    from what the kernel reads, at the points its threads hold
    (:func:`_tile_points`: 16-byte vectors on the ``"vector"`` path, single
    columns on the ``"scalar"`` one).  For each chunk of ``chunk`` terms of
    the table the tile's live list (:func:`grid_dia_block_terms`) is
    walked in order: a whole term reads each point's coefficient and the
    source at the point's flat index plus ``xoff``; a partial one tests
    each point's source (wrapped when cyclic) and reads the coefficient
    and x only where it lies in the grid.  What the kernel must not read is
    NaN: every coefficient whose source lies outside the grid, x outside
    ``[0, n)`` of the flat grid, and every output not written (each is
    written once); a dropped live term, a flat offset that should have
    wrapped or been tested, or a missed point so shows.  Products are
    rounded on their own (the kernel fuses them into FMAs)."""
    ny, nx = a.grid
    vector = 16 // x2.element_size() if path == "vector" else 1
    if nx % vector or points % vector:
        raise ValueError(f"the vector path takes rows of whole 16-byte vectors and whole "
                         f"vectors a thread, got nx = {nx}, {points} points a thread")
    terms = _term_rows(a.shifts, a.grid, a.cyclic, False)
    n = ny * nx
    data = a.data.clone()
    gr, gc = torch.arange(ny)[:, None], torch.arange(nx)[None, :]
    if not a.cyclic:  # the coefficients the kernel must not read
        for k, (dy, dx) in enumerate(a.shifts):
            data[k][(gr + dy < 0) | (gr + dy >= ny) | (gc + dx < 0) | (gc + dx >= nx)] = \
                float("nan")
    flat = data.reshape(len(a.shifts), n)
    nan = torch.full((n,), float("nan"), dtype=x2.dtype)
    xpad = torch.cat([nan, x2.reshape(n), nan])  # a flat read outside [0, n) is NaN
    y = torch.full((n,), float("nan"), dtype=x2.dtype)
    width = tx * points
    for r0 in range(0, ny, rows):
        for c0 in range(0, nx, width):
            pr, pc = _tile_points(r0, c0, a.grid, rows, tx, points, vector)
            here = pr * nx + pc
            acc = torch.zeros(here.numel(), dtype=x2.dtype)
            for t0 in range(0, len(terms), chunk):
                live = grid_dia_block_terms(terms[t0:t0 + chunk], a.grid, a.cyclic, r0,
                                            min(r0 + rows, ny), c0, min(c0 + width, nx))
                for kind, k, dy, dx, xoff in live:
                    if kind == "whole":
                        acc = acc + flat[k][here] * xpad[here + xoff + n]
                        continue
                    sr, sc = pr + dy, pc + dx
                    if a.cyclic:
                        sr, sc = sr % ny, sc % nx
                    ok = (sr >= 0) & (sr < ny) & (sc >= 0) & (sc < nx)
                    d, xs = torch.zeros_like(acc), torch.zeros_like(acc)
                    d[ok] = flat[k][here[ok]]
                    xs[ok] = xpad[(sr * nx + sc)[ok] + n]
                    acc = acc + d * xs
            if not bool(y[here].isnan().all()):
                raise AssertionError(f"the tile at {(r0, c0)} writes a point twice")
            y[here] = acc
    return y.reshape(ny, nx)


# The tiled SpMM's tiling, as in csrc/dia_spmv.cu (MmTiling, MmOf): 8 rows x
# 32 threads a tile, 2 f32 or 1 f64 points a thread 32 columns apart: tiles
# of 8 x 64 f32, 8 x 32 f64 (element size -> columns) on both paths; a
# register tile of 8 right-hand sides; terms in chunks of 256.
_MM_ROWS, _MM_COLS, _MM_RHS_TILE = 8, {4: 64, 8: 32}, 8


def grid_dia_matmat_tiled_sim(a: GridDIA, x, layout: str = "stacked", rows: int = _MM_ROWS,
                              cols: int | None = None, rhs_tile: int = _MM_RHS_TILE,
                              chunk: int = _MV_CHUNK):
    """CPU rehearsal of the tiled SpMM, in plain PyTorch: ``Y = A X`` is
    built tile by tile (``rows`` x ``cols``, the kernel's 8 x 64 f32 /
    8 x 32 f64 by default, the last ones ragged) and, within a tile, a
    register tile of ``rhs_tile`` right-hand sides at a time.  For each
    chunk of ``chunk`` terms of the table the tile's live list
    (:func:`grid_dia_block_terms`, with x's row stride) is walked in table
    order: a whole term reads each point's coefficient and, for every
    right-hand side of the tile, the source at the point's flat x index
    plus ``xoff``; a partial one tests each point's source (wrapped when
    cyclic) and reads only where it lies in the grid.  What the kernel must
    not read is NaN: every coefficient whose source lies outside the grid,
    x outside the stack's buffer, and every output not written (each is
    written once).  Products are rounded on their own (the kernel fuses
    them into FMAs).  ``x`` is ``(nrhs, ny, nx)`` (``layout="stacked"``)
    or ``(ny, nrhs, nx)`` (``"interleaved"``)."""
    ny, nx = a.grid
    stacked = layout == "stacked"
    nrhs = x.shape[0] if stacked else x.shape[1]
    rs, ws = (ny * nx, nx) if stacked else (nx, nrhs * nx)
    cols = _MM_COLS[x.element_size()] if cols is None else cols
    terms = _term_rows(a.shifts, a.grid, a.cyclic, False)
    data = a.data.clone()
    gr, gc = torch.arange(ny)[:, None], torch.arange(nx)[None, :]
    if not a.cyclic:  # the coefficients the kernel must not read
        for k, (dy, dx) in enumerate(a.shifts):
            data[k][(gr + dy < 0) | (gr + dy >= ny) | (gc + dx < 0) | (gc + dx >= nx)] = \
                float("nan")
    flat = data.reshape(len(a.shifts), ny * nx)
    total = x.numel()
    nan = torch.full((total,), float("nan"), dtype=x.dtype)
    xpad = torch.cat([nan, x.reshape(total), nan])  # a read outside the buffer is NaN
    y = torch.full((total,), float("nan"), dtype=x.dtype)
    for r0 in range(0, ny, rows):
        for c0 in range(0, nx, cols):
            r1, c1 = min(r0 + rows, ny), min(c0 + cols, nx)
            pr = torch.arange(r0, r1).repeat_interleave(c1 - c0)
            pc = torch.arange(c0, c1).repeat(r1 - r0)
            here, xat = pr * nx + pc, pr * ws + pc
            for j0 in range(0, nrhs, rhs_tile):
                jrs = torch.arange(j0, min(j0 + rhs_tile, nrhs))[:, None] * rs
                acc = torch.zeros((jrs.shape[0], here.numel()), dtype=x.dtype)
                for t0 in range(0, len(terms), chunk):
                    live = grid_dia_block_terms(terms[t0:t0 + chunk], a.grid, a.cyclic, r0, r1,
                                                c0, c1, row_stride=ws)
                    for kind, k, dy, dx, xoff in live:
                        if kind == "whole":
                            acc = acc + flat[k][here] * xpad[jrs + xat + xoff + total]
                            continue
                        sr, sc = pr + dy, pc + dx
                        if a.cyclic:
                            sr, sc = sr % ny, sc % nx
                        ok = (sr >= 0) & (sr < ny) & (sc >= 0) & (sc < nx)
                        d, xs = torch.zeros(here.numel(), dtype=x.dtype), torch.zeros_like(acc)
                        d[ok] = flat[k][here[ok]]
                        xs[:, ok] = xpad[jrs + (sr * ws + sc)[ok] + total]
                        acc = acc + d * xs
                at = jrs + xat
                if not bool(y[at].isnan().all()):
                    raise AssertionError(f"the tile at {(r0, c0)} writes a point twice")
                y[at] = acc
    return y.reshape(x.shape)


@lru_cache(maxsize=64)
def _flat_terms(offsets, n: int, device: torch.device):
    """The flat kernel's term table: int32 rows ``(k, off)`` in the order
    of ``offsets``, without the diagonals that lie outside the matrix."""
    rows = [(k, off) for k, off in enumerate(offsets) if abs(off) < n]
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1, 2)


def _check_operands(name: str, data, x, data_shape, x_shape):
    """What holds on either device: one device, one dtype, the container's
    shapes."""
    if data.device != x.device:
        raise ValueError(f"{name}: the matrix lies on {data.device}, x on {x.device}")
    if data.dtype != x.dtype:
        raise TypeError(f"{name}: the matrix holds {data.dtype}, x is {x.dtype}")
    if tuple(data.shape) != tuple(data_shape):
        raise ValueError(f"{name}: data has shape {tuple(data.shape)}, "
                         f"expected {tuple(data_shape)}")
    if x_shape is not None and tuple(x.shape) != tuple(x_shape):
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, "
                         f"expected {tuple(x_shape)}")


def _check(kernel: str, data, x) -> str:
    """Raise on operands the kernel does not take; returns x's dtype tag."""
    if x.numel() == 0:
        raise ValueError(f"{kernel} kernel takes a non-empty x")
    return check(kernel, x, data)


def _launch(key: tuple, c_base: str, data, terms, x, *ints):
    """Allocate the output and launch ``c_base`` on checked operands,
    counted under ``key``."""
    out = torch.empty_like(x)
    launch(key, c_base, _ARGS, x.device, data.data_ptr(), terms.data_ptr(), terms.shape[0],
           x.data_ptr(), out.data_ptr(), *ints)
    return out


def grid_dia_matvec(a: GridDIA, x2):
    """``y = A @ x`` on the 2-D grid view ``x2`` of shape ``a.grid``:
    through the tiled kernel on the path :func:`matvec_path` names."""
    ny, nx = a.grid
    _check_operands("grid_dia_matvec", a.data, x2, (len(a.shifts), ny, nx), (ny, nx))
    if x2.device.type == "cpu":
        return a._apply(x2)
    tag = _check("grid_dia_matvec", a.data, x2)
    terms = _grid_terms(a.shifts, a.grid, a.cyclic, x2.device)
    path = matvec_path(a, x2)
    return _launch(("grid_dia_matvec", tag, path), "grid_dia_matvec", a.data, terms, x2,
                   ny, nx, int(a.cyclic), int(path == "vector"))


def dia_flat_matvec(a: DIA, grid: tuple[int, int], x):
    """``y = A @ x`` for a row-aligned flat DIA matrix whose rows are the
    flattened ``(ny, nx)`` grid; ``x`` holds ``ny * nx`` values in any
    shape and ``y`` comes back in that shape."""
    ny, nx = grid
    if a.n != ny * nx:
        raise ValueError(f"dia_flat_matvec: n = {a.n} is not {ny} x {nx}")
    _check_operands("dia_flat_matvec", a.data, x, (len(a.offsets), a.n), None)
    if x.numel() != a.n:
        raise ValueError(f"dia_flat_matvec: x holds {x.numel()} values, n = {a.n}")
    if x.device.type == "cpu":
        return a.matvec(x)
    if a.n > _INT32_MAX:
        raise ValueError(f"dia_flat_matvec kernel takes n < 2^31, got {a.n}")
    tag = _check("dia_flat_matvec", a.data, x)
    terms = _flat_terms(a.offsets, a.n, x.device)
    return _launch(("dia_flat_matvec", tag, None), "dia_flat_matvec", a.data, terms, x, a.n)


def _matmat_plain(a: GridDIA, x3):
    """Per-rhs ``_apply`` of an ``(nrhs, ny, nx)`` stack."""
    return torch.stack([a._apply(x3[r]) for r in range(x3.shape[0])])


def _matmat_launch(a: GridDIA, x, nrhs: int, interleaved: bool, path=None):
    """Check the stack ``x`` and launch the SpMM kernel of ``path`` (by
    default the one :func:`spmm_path` names) on it."""
    kernel = "grid_dia_matmat_interleaved" if interleaved else "grid_dia_matmat"
    tag = _check(kernel, a.data, x)
    path = path or spmm_path(a, x)
    ny, nx = a.grid
    if path == "slab":
        _, hy, hx = _slab_rows(a.shifts, a.grid, a.cyclic)
        terms = _slab_terms(a.shifts, a.grid, a.cyclic, x.device)
        return _launch((kernel, tag, path), "grid_dia_matmat_slab", a.data, terms, x, nrhs,
                       ny, nx, int(a.cyclic), int(interleaved), hy, hx)
    terms = _grid_terms(a.shifts, a.grid, a.cyclic, x.device)
    return _launch((kernel, tag, path), kernel, a.data, terms, x, nrhs, ny, nx, int(a.cyclic),
                   int(matvec_path(a, x) == "vector"))


def _matmat_general(a: GridDIA, x, interleaved: bool = False):
    """The general (tiled) SpMM kernel on any CUDA stack (counted on the
    ``"general"`` path): for timing it against the slab kernel in one
    process."""
    nrhs = x.shape[1] if interleaved else x.shape[0]
    return _matmat_launch(a, x, nrhs, interleaved, "general")


def grid_dia_matmat(a: GridDIA, x3):
    """``Y[j] = A @ X[j]`` for an ``(nrhs, ny, nx)`` stack: through the
    slab kernel where :func:`spmm_path` says ``"slab"``, else through the
    general one."""
    ny, nx = a.grid
    if x3.dim() != 3 or x3.shape[0] < 1:
        raise ValueError(f"grid_dia_matmat takes an (nrhs, ny, nx) stack, got "
                         f"{tuple(x3.shape)}")
    nrhs = x3.shape[0]
    _check_operands("grid_dia_matmat", a.data, x3, (len(a.shifts), ny, nx),
                    (nrhs, ny, nx))
    if x3.device.type == "cpu":
        return _matmat_plain(a, x3)
    return _matmat_launch(a, x3, nrhs, False)


def grid_dia_matmat_interleaved(a: GridDIA, xi):
    """``Y = A @ X`` with the right-hand sides in the row-interleaved layout
    ``(ny, nrhs, nx)``: element ``(r, j, c)`` belongs to rhs ``j``.  Block
    Krylov callers keep their vectors in this layout.  The kernel is chosen
    as in :func:`grid_dia_matmat`."""
    ny, nx = a.grid
    if xi.dim() != 3 or xi.shape[1] < 1:
        raise ValueError(f"grid_dia_matmat_interleaved takes an (ny, nrhs, nx) "
                         f"stack, got {tuple(xi.shape)}")
    nrhs = xi.shape[1]
    _check_operands("grid_dia_matmat_interleaved", a.data, xi,
                    (len(a.shifts), ny, nx), (ny, nrhs, nx))
    if xi.device.type == "cpu":
        return torch.movedim(_matmat_plain(a, torch.movedim(xi, 1, 0)), 0, 1)
    return _matmat_launch(a, xi, nrhs, True)

