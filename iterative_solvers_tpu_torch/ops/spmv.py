"""The diagonal-format SpMV / SpMM kernels
(counterpart of ``iterative_solvers_tpu/ops/pallas_spmv.py``).

- :func:`grid_dia_matvec` — ``y = A x`` for a :class:`GridDIA` on the
  ``(ny, nx)`` grid view, clamped or cyclic;
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
Each wrapper's ``.launches`` counts its kernel launches and
``.launches_by_dtype`` splits the count into ``"f32"`` and ``"f64"``.

The JAX wrappers' ``block_rows`` sizes the TPU's slab pipeline and has no
counterpart here.  The kernels have no derivative rule, as the Pallas
kernels have none: autodiff through a CUDA call raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .periodic_stencil import _DTYPES, _check_no_autodiff
from .sparse import DIA, GridDIA, term_order

_INT32_MAX = 2 ** 31 - 1


@lru_cache(maxsize=None)
def _kernel(name: str):
    from ._build import c_function

    p, i = ctypes.c_void_p, ctypes.c_int
    if name.startswith("dia_flat_matvec"):
        args = [p, p, i, p, p, ctypes.c_longlong, p]
    elif name.startswith("grid_dia_matvec"):
        args = [p, p, i, p, p, i, i, i, p]
    else:  # the two SpMM layouts
        args = [p, p, i, p, p, i, i, i, i, p]
    return c_function(name, args)


@lru_cache(maxsize=64)
def _grid_terms(shifts, grid, cyclic: bool, device: torch.device):
    """The kernels' term table of a GridDIA on ``device``, built once per
    container structure: int32 rows ``(k, dy, dx)`` in the order ``_apply``
    sums the terms.  Cyclic shifts are reduced to ``[0, ny) x [0, nx)``;
    clamped terms that reach no grid point are left out."""
    ny, nx = grid
    near, far = term_order(shifts, cyclic)
    if cyclic:
        rows = [(k, dy % ny, dx % nx) for k, dy, dx in near + far]
    else:
        rows = [t for t in near + far if abs(t[1]) < ny and abs(t[2]) < nx]
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1, 3)


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


def _launch(wrapper, name: str, data, terms, x, *ints):
    """Check the operands for the kernel ``name``, allocate the output,
    launch on the current stream and count the launch on ``wrapper``;
    raise on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on a CUDA device, got {x.device}")
    _check_no_autodiff(x, name)
    _check_no_autodiff(data, name)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or float64, got {x.dtype}")
    if not (x.is_contiguous() and data.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    if x.numel() == 0:
        raise ValueError(f"{name} kernel takes a non-empty x")
    out = torch.empty_like(x)
    tag = _DTYPES[x.dtype]
    err = _kernel(f"{name}_{tag}")(
        data.data_ptr(), terms.data_ptr(), terms.shape[0], x.data_ptr(),
        out.data_ptr(), *ints,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.launches_by_dtype[tag] += 1
    return out


def grid_dia_matvec(a: GridDIA, x2):
    """``y = A @ x`` on the 2-D grid view ``x2`` of shape ``a.grid``."""
    ny, nx = a.grid
    _check_operands("grid_dia_matvec", a.data, x2, (len(a.shifts), ny, nx), (ny, nx))
    if x2.device.type == "cpu":
        return a._apply(x2)
    terms = _grid_terms(a.shifts, a.grid, a.cyclic, x2.device)
    return _launch(grid_dia_matvec, "grid_dia_matvec", a.data, terms, x2,
                   ny, nx, int(a.cyclic))


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
    terms = _flat_terms(a.offsets, a.n, x.device)
    return _launch(dia_flat_matvec, "dia_flat_matvec", a.data, terms, x, a.n)


def _matmat_plain(a: GridDIA, x3):
    """Per-rhs ``_apply`` of an ``(nrhs, ny, nx)`` stack."""
    return torch.stack([a._apply(x3[r]) for r in range(x3.shape[0])])


def grid_dia_matmat(a: GridDIA, x3):
    """``Y[j] = A @ X[j]`` for an ``(nrhs, ny, nx)`` stack."""
    ny, nx = a.grid
    if x3.dim() != 3 or x3.shape[0] < 1:
        raise ValueError(f"grid_dia_matmat takes an (nrhs, ny, nx) stack, got "
                         f"{tuple(x3.shape)}")
    nrhs = x3.shape[0]
    _check_operands("grid_dia_matmat", a.data, x3, (len(a.shifts), ny, nx),
                    (nrhs, ny, nx))
    if x3.device.type == "cpu":
        return _matmat_plain(a, x3)
    terms = _grid_terms(a.shifts, a.grid, a.cyclic, x3.device)
    return _launch(grid_dia_matmat, "grid_dia_matmat", a.data, terms, x3,
                   nrhs, ny, nx, int(a.cyclic))


def grid_dia_matmat_interleaved(a: GridDIA, xi):
    """``Y = A @ X`` with the right-hand sides in the row-interleaved layout
    ``(ny, nrhs, nx)``: element ``(r, j, c)`` belongs to rhs ``j``.  Block
    Krylov callers keep their vectors in this layout."""
    ny, nx = a.grid
    if xi.dim() != 3 or xi.shape[1] < 1:
        raise ValueError(f"grid_dia_matmat_interleaved takes an (ny, nrhs, nx) "
                         f"stack, got {tuple(xi.shape)}")
    nrhs = xi.shape[1]
    _check_operands("grid_dia_matmat_interleaved", a.data, xi,
                    (len(a.shifts), ny, nx), (ny, nrhs, nx))
    if xi.device.type == "cpu":
        return torch.movedim(_matmat_plain(a, torch.movedim(xi, 1, 0)), 0, 1)
    terms = _grid_terms(a.shifts, a.grid, a.cyclic, xi.device)
    return _launch(grid_dia_matmat_interleaved, "grid_dia_matmat_interleaved",
                   a.data, terms, xi, nrhs, ny, nx, int(a.cyclic))


WRAPPERS = (grid_dia_matvec, dia_flat_matvec, grid_dia_matmat,
            grid_dia_matmat_interleaved)


def reset_launches():
    """Set the four wrappers' launch counts to 0."""
    for fn in WRAPPERS:
        fn.launches = 0
        fn.launches_by_dtype = dict.fromkeys(_DTYPES.values(), 0)


reset_launches()
