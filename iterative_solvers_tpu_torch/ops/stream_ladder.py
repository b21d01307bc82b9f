"""The card's streaming kernels: read, write and staged copy
(counterparts of the ``pallas_call``s of the JAX package's
``tools/stream_ladder.py``, ``tools/pallas_pipeline_experiment.py`` and
``tools/pallas_grid_experiment.py``).

- :func:`stream_read` — ``tok + sum_c u[c*bm : c*bm + 8]``, streaming every
  byte of ``u`` (``read_kernel``);
- :func:`stream_write` — rows ``[c*bm, (c+1)*bm)`` = ``tok[0] * 0.5 + c``
  (``write_kernel``);
- :func:`staged_copy` — ``out = u`` through a ``slots``-deep ring with
  ``depth`` tiles in flight, the 8 periodic rows above and below each tile
  loaded and discarded with ``halos`` (``copy_kernel``, ``make_pipeline``,
  ``grid_copy``).

On a CPU tensor each runs its plain version (:func:`read_plain`,
:func:`write_plain`, ``u.clone()``); on a CUDA tensor it launches the
hand-written kernel of ``csrc/stream_ladder.cu`` (f32 or f64) or raises.
The knobs are the TPU kernels' own: ``bm`` rows a tile, ``slots`` stages
of the ring, ``depth`` tiles in flight, ``halos``.  A tile is ``bm`` rows by
a strip of columns that :func:`stream_tiling` sizes so that ``slots``
tiles fit a block's ring.  The launches are counted in
``ops._build.LAUNCHES`` under the wrapper's name.
"""
from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import torch

from ._build import DTYPES, check, launch

HALO = 8                  # rows folded by the read; halo rows each side of a tile
_RING_BYTES = 115712      # csrc/stream_ladder.cu kRingBytes: two blocks an SM
_MAX_WIDTH = 512          # kMaxWidth: columns of a strip
_MAX_SLOTS = 8            # kMaxSlots
_BLOCKS_PER_SM = 2
_WAVES = 4                # blocks launched: about this many waves of the card


@dataclasses.dataclass(frozen=True)
class StreamTiling:
    """A launch's tiling: strips of ``width`` columns (the last one
    ragged), ``per`` consecutive chunks a block, ``groups`` blocks down
    each strip."""

    width: int
    per: int
    groups: int


def stream_tiling(n_rows: int, n_cols: int, bm: int, slots: int, halos: bool,
                  itemsize: int, sms: int) -> StreamTiling:
    """The tiling ``csrc/stream_ladder.cu`` is launched with: the widest
    strip whose ``slots`` tiles of ``bm`` (+ 16 halo) rows fit the ring, in
    whole 128-byte lines where a row of the strip can hold one, else in
    32-byte sectors, else 16-byte vectors, at most 512 columns and the
    field's width; then as many consecutive chunks a block as make about
    four waves of two blocks an SM over ``sms`` SMs."""
    rows = bm + 2 * HALO * bool(halos)
    fit = _RING_BYTES // (slots * rows)
    if fit < 16:
        raise ValueError(f"{slots} slots of {rows} rows leave under 16 bytes a row "
                         f"in the {_RING_BYTES}-byte ring")
    unit = next(u for u in (128, 32, 16) if fit >= u)
    width = min(fit // unit * unit // itemsize, _MAX_WIDTH, n_cols)
    strips = -(-n_cols // width)
    nchunks = n_rows // bm
    per = max(1, -(-strips * nchunks // (_WAVES * _BLOCKS_PER_SM * sms)))
    return StreamTiling(width=width, per=per, groups=-(-nchunks // per))


def check_knobs(n_rows: int, n_cols: int, bm: int, slots: int, depth: int | None = None,
                dtype=None, halos: bool = False) -> None:
    """Raise on a configuration the kernels do not take: ``bm`` a positive
    multiple of 8 dividing ``n_rows``, rows of whole 16-byte vectors,
    ``1 <= slots <= 8`` (with a ``depth``: ``1 <= depth < slots``), a ring
    that holds ``slots`` tiles of at least 16 bytes a row, f32 or f64."""
    if dtype is not None and dtype not in DTYPES:
        raise TypeError(f"the stream kernels take float32 or float64, got {dtype}")
    if bm < HALO or bm % HALO:
        raise ValueError(f"bm must be a positive multiple of {HALO}, got {bm}")
    if n_rows < bm or n_rows % bm:
        raise ValueError(f"bm = {bm} must divide n_rows = {n_rows}")
    itemsize = 8 if dtype == torch.float64 else 4
    if n_cols < 1 or n_cols * itemsize % 16:
        raise ValueError(f"n_cols = {n_cols} must make rows of whole 16-byte vectors")
    if not 1 <= slots <= _MAX_SLOTS:
        raise ValueError(f"slots must be in 1..{_MAX_SLOTS}, got {slots}")
    if depth is not None and not 1 <= depth < slots:
        raise ValueError(f"depth must be in 1..slots-1 = {slots - 1}, got {depth}")
    stream_tiling(n_rows, n_cols, bm, slots, halos, itemsize, 1)


def read_plain(u, tok, bm: int):
    """``tok + sum_c u[c*bm : c*bm + 8]``: the read kernel's function."""
    n_rows, n_cols = u.shape
    return tok + u.view(n_rows // bm, bm, n_cols)[:, :HALO].sum(0)


def write_plain(tok, n_rows: int, bm: int):
    """Rows ``[c*bm, (c+1)*bm)`` = ``tok[0] * 0.5 + c``: the write kernel's."""
    c = torch.arange(n_rows // bm, dtype=tok.dtype, device=tok.device).repeat_interleave(bm)
    return tok[0] * 0.5 + c[:, None]


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = {"stream_read": [_P, _P, _P, _P] + [_I] * 6 + [_P],
         "stream_write": [_P, _P] + [_I] * 6 + [_P],
         "staged_copy": [_P, _P] + [_I] * 8 + [_P]}


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_field(name: str, x, shape, dtype=None):
    """Raise unless ``x`` is an f32 / f64 tensor (of ``dtype`` if given) of
    ``shape`` on the CPU or, contiguous and 16-byte aligned, on a card."""
    if x.dtype not in DTYPES or (dtype is not None and x.dtype != dtype):
        raise TypeError(f"{name}: float32 or float64 {dtype or ''} expected, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(shape)} expected, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: a CPU or CUDA tensor expected, got {x.device}")
    if x.device.type == "cuda" and not (x.is_contiguous() and x.data_ptr() % 16 == 0):
        raise ValueError(f"{name}: the kernel takes a contiguous, 16-byte aligned field")


def stream_read(u, tok, bm: int, slots: int):
    """``tok + sum_c u[c*bm : c*bm + 8]`` of the ``(n_rows, n_cols)`` field
    ``u`` and the ``(8, n_cols)`` token, every chunk of ``u`` streamed whole
    through a ``slots``-deep ring.  The kernel sums each block's chunks in
    order and the blocks' partial sums in order after ``tok``."""
    n_rows, n_cols = u.shape
    check_knobs(n_rows, n_cols, bm, slots, dtype=u.dtype)
    check_field("stream_read u", u, (n_rows, n_cols))
    check_field("stream_read tok", tok, (HALO, n_cols), u.dtype)
    if tok.device != u.device:
        raise ValueError(f"stream_read: u on {u.device}, tok on {tok.device}")
    if u.device.type == "cpu":
        return read_plain(u, tok, bm)
    tag = check("stream_read", u, tok)
    t = stream_tiling(n_rows, n_cols, bm, slots, False, u.element_size(),
                      _sms(u.device.index or 0))
    partial = torch.empty((t.groups, HALO, n_cols), dtype=u.dtype, device=u.device)
    out = torch.empty_like(tok)
    launch(("stream_read", tag, None), "stream_read", _ARGS, u.device, u.data_ptr(),
           tok.data_ptr(), partial.data_ptr(), out.data_ptr(), n_rows, n_cols, bm, slots,
           t.width, t.per)
    return out


def stream_write(tok, n_rows: int, bm: int, slots: int):
    """The ``(n_rows, n_cols)`` field whose rows ``[c*bm, (c+1)*bm)`` are
    ``tok[0] * 0.5 + c``, written through a ``slots``-deep ring of tiles
    (a tile's stores overlap the next ``slots - 1`` tiles' fills)."""
    n_cols = tok.shape[-1]
    check_knobs(n_rows, n_cols, bm, slots, dtype=tok.dtype)
    check_field("stream_write tok", tok, (HALO, n_cols))
    if tok.device.type == "cpu":
        return write_plain(tok, n_rows, bm)
    tag = check("stream_write", tok)
    t = stream_tiling(n_rows, n_cols, bm, slots, False, tok.element_size(),
                      _sms(tok.device.index or 0))
    out = torch.empty((n_rows, n_cols), dtype=tok.dtype, device=tok.device)
    launch(("stream_write", tag, None), "stream_write", _ARGS, tok.device, tok.data_ptr(),
           out.data_ptr(), n_rows, n_cols, bm, slots, t.width, t.per)
    return out


def staged_copy(u, bm: int, slots: int = 2, depth: int = 1, halos: bool = False):
    """``out = u`` through a ``slots``-deep ring of ``bm``-row tiles with
    ``depth`` tiles' loads in flight; with ``halos`` each tile's 8 periodic
    rows above and below are loaded too and discarded."""
    n_rows, n_cols = u.shape
    check_knobs(n_rows, n_cols, bm, slots, depth, dtype=u.dtype, halos=halos)
    check_field("staged_copy u", u, (n_rows, n_cols))
    if u.device.type == "cpu":
        return u.clone()
    tag = check("staged_copy", u)
    t = stream_tiling(n_rows, n_cols, bm, slots, halos, u.element_size(),
                      _sms(u.device.index or 0))
    out = torch.empty_like(u)
    launch(("staged_copy", tag, None), "staged_copy", _ARGS, u.device, u.data_ptr(),
           out.data_ptr(), n_rows, n_cols, bm, slots, depth, int(bool(halos)), t.width, t.per)
    return out

