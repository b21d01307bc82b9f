"""The periodic stencil kernels of the Swift–Hohenberg model
(counterpart of ``iterative_solvers_tpu/ops/pallas_stencil.py``).

- :func:`lap_periodic_kernel` — the 5-point periodic Laplacian;
- :func:`sh_operator_kernel` — the fused ``L = -Lap^2 - 2 Lap + (r-1) I``.

On a CPU tensor each runs its plain version (``ops.stencils.lap_periodic``,
``ops.stencils.sh_linear_operator``); on a CUDA tensor it launches the
hand-written kernel of ``csrc/periodic_stencil.cu`` (f32 or f64, any 2-D
contiguous shape with ``ny, nx >= 3`` resp. ``>= 4``) or raises; the
launches are counted in ``ops._build.LAUNCHES`` under ``"lap_periodic"``
and ``"sh_operator"`` (with its path).

``sh_operator`` has two hand-written kernels, chosen by the field's shape
and address alone (:func:`sh_operator_path`), never by a failed launch:
the strip-marching kernel where a row is whole 16-byte vectors (``nx`` a
multiple of 4 in f32, of 2 in f64) and the field is 16-byte aligned, the
tiled kernel of the earlier design for every other shape (24 x 23,
61 x 91).  :func:`sh_operator_strip_sim` rehearses the strip kernel's
marching on the CPU.

The JAX wrappers' ``block_rows``, ``slots``, ``streams`` and ``mode`` tune
the TPU's DMA pipeline and have no counterpart here; their ``inplace``
option only avoids XLA's copy of a while-loop carry, which PyTorch does
not make.  The kernels have no derivative rule, as the Pallas kernels have
none: autodiff through a CUDA call raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import stencils
from ._build import check, launch

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGS = {"lap_periodic": [_P, _P, _I, _I, _D, _P],
         "sh_operator": [_P, _P, _I, _I, _D, _D, _P],
         "sh_operator_v1": [_P, _P, _I, _I, _D, _D, _P]}


def sh_operator_path(u) -> str:
    """Which ``sh_operator`` kernel takes the field ``u``: ``"strip"``
    (rows of whole, aligned 16-byte vectors) or ``"tile"`` (any shape)."""
    vector = 16 // u.element_size()
    return "strip" if u.shape[-1] % vector == 0 and u.data_ptr() % 16 == 0 else "tile"


def _launch(kernel: str, min_n: int, u, *scalars, path=None):
    """Check ``u`` for ``kernel``, allocate the output and launch: the C
    function ``kernel``, or for ``sh_operator`` that of ``path`` (by
    default the one :func:`sh_operator_path` names)."""
    if u.dim() != 2:
        raise ValueError(f"{kernel} kernel takes a 2-D field, got shape {tuple(u.shape)}")
    ny, nx = u.shape
    if ny < min_n or nx < min_n:
        raise ValueError(f"{kernel} kernel needs ny, nx >= {min_n}, got {(ny, nx)}")
    tag = check(kernel, u)
    c_base = kernel
    if kernel == "sh_operator":
        path = path or sh_operator_path(u)
        c_base = "sh_operator" if path == "strip" else "sh_operator_v1"
    out = torch.empty_like(u)
    launch((kernel, tag, path), c_base, _ARGS, u.device, u.data_ptr(), out.data_ptr(), ny, nx,
           *scalars)
    return out


def lap_periodic_kernel(u, h: float):
    """Periodic 5-point Laplacian of the ``(ny, nx)`` field ``u``."""
    if u.device.type == "cpu":
        return stencils.lap_periodic(u, h)
    return _launch("lap_periodic", 3, u, 1.0 / (h * h))


def sh_operator_kernel(u, h: float, r: float):
    """``-Lap^2 u - 2 Lap u + (r-1) u`` of the ``(ny, nx)`` field ``u``,
    periodic, in one pass: through the strip-marching kernel where
    :func:`sh_operator_path` says ``"strip"``, else through the tiled one."""
    if u.device.type == "cpu":
        return stencils.sh_linear_operator(u, h, r)
    return _launch("sh_operator", 4, u, 1.0 / (h * h), r - 1.0)


def _sh_operator_v1(u, h: float, r: float):
    """The tiled kernel on any CUDA field (counted on the ``"tile"`` path):
    for timing the earlier design against the strip kernel in one
    process."""
    return _launch("sh_operator", 4, u, 1.0 / (h * h), r - 1.0, path="tile")


def sh_operator_strip_sim(u, h: float, r: float, strip: int = 128, seg: int = 8):
    """CPU rehearsal of the strip-marching kernel, in plain PyTorch: each
    strip of ``strip`` columns marches down each segment of ``seg`` rows
    with a rolling window of u rows and of Lap u rows, the two halo columns
    each side and the row index wrapped by compare-and-subtract, the taps
    summed in the kernel's order."""
    ny, nx = u.shape
    inv_h2 = 1.0 / (h * h)
    out = torch.empty_like(u)

    def lap(a, b, c):  # Lap u of the middle row b, one column in from each end
        return (b[:-2] + b[2:] + a[1:-1] + c[1:-1] - 4.0 * b[1:-1]) * inv_h2

    for j0 in range(0, nx, strip):
        width = min(strip, nx - j0)
        cols = torch.arange(j0 - 2, j0 + width + 2)
        cols = torch.where(cols < 0, cols + nx, cols)
        cols = torch.where(cols >= nx, cols - nx, cols)
        for i0 in range(0, ny, seg):
            nxt = i0 - 2 if i0 >= 2 else i0 - 2 + ny

            def load():
                nonlocal nxt
                row = u[nxt, cols]
                nxt = 0 if nxt + 1 == ny else nxt + 1
                return row

            w0, w1, ua, ub = load(), load(), load(), load()
            la, lb = lap(w0, w1, ua), lap(w1, ua, ub)
            for t in range(i0, min(i0 + seg, ny)):
                uc = load()
                lc = lap(ua, ub, uc)
                lap2 = lap(la, lb, lc)
                out[t, j0:j0 + width] = (-lap2 - 2.0 * lb[1:-1]
                                         + (r - 1.0) * ua[2:-2])
                ua, ub, la, lb = ub, uc, lb, lc
    return out

