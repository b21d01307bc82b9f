"""The periodic stencil kernels of the Swift–Hohenberg model
(counterpart of ``iterative_solvers_tpu/ops/pallas_stencil.py``).

- :func:`lap_periodic_kernel` — the 5-point periodic Laplacian;
- :func:`sh_operator_kernel` — the fused ``L = -Lap^2 - 2 Lap + (r-1) I``.

On a CPU tensor each runs its plain version (``ops.stencils.lap_periodic``,
``ops.stencils.sh_linear_operator``); on a CUDA tensor it launches the
hand-written kernel of ``csrc/periodic_stencil.cu`` (f32 or f64, any 2-D
contiguous shape with ``ny, nx >= 3`` resp. ``>= 4``) or raises.  Each
wrapper's ``.launches`` counts its kernel launches, and
``.launches_by_dtype`` splits the count into ``"f32"`` and ``"f64"``.

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
from functools import lru_cache

import torch
from torch.autograd import forward_ad

from . import stencils

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


@lru_cache(maxsize=None)
def _kernel(name: str):
    from ._build import c_function

    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_double]
    if name.startswith("sh_operator"):
        args.append(ctypes.c_double)
    return c_function(name, args + [ctypes.c_void_p])


def sh_operator_path(u) -> str:
    """Which ``sh_operator`` kernel takes the field ``u``: ``"strip"``
    (rows of whole, aligned 16-byte vectors) or ``"tile"`` (any shape)."""
    vector = 16 // u.element_size()
    return "strip" if u.shape[-1] % vector == 0 and u.data_ptr() % 16 == 0 else "tile"


def _check_no_autodiff(u, name: str):
    """Raise if ``u`` carries a tangent or a gradient: the kernels have no
    derivative rule (neither had the TPU kernels), so ``torch.func.jvp`` or
    autograd through a CUDA call would silently lose the derivative."""
    if (torch._C._functorch.is_functorch_wrapped_tensor(u)
            or u.requires_grad or forward_ad.unpack_dual(u).tangent is not None):
        raise RuntimeError(
            f"the {name} kernel has no derivative rule: use finite-difference "
            "JVPs (jvp_mode='fd') or an analytic matvec_factory on the GPU")


def _launch(wrapper, name: str, min_n: int, u, *scalars, c_name=None):
    """Check ``u`` for the kernel ``name``, allocate the output, launch on
    the current stream and count the launch on ``wrapper`` if there is one;
    raise on anything the kernel does not take.  The C function is ``name``
    + dtype tag, or ``c_name(u)`` + dtype tag where the kernel is chosen by
    the checked field's shape and address."""
    if u.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on a CUDA device, got {u.device}")
    _check_no_autodiff(u, name)
    if u.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or float64, got {u.dtype}")
    if u.dim() != 2:
        raise ValueError(f"{name} kernel takes a 2-D field, got shape {tuple(u.shape)}")
    ny, nx = u.shape
    if ny < min_n or nx < min_n:
        raise ValueError(f"{name} kernel needs ny, nx >= {min_n}, got {(ny, nx)}")
    if not u.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous field")
    out = torch.empty_like(u)
    tag = _DTYPES[u.dtype]
    if c_name is not None:
        name = c_name(u)
    err = _kernel(f"{name}_{tag}")(
        u.data_ptr(), out.data_ptr(), ny, nx, *scalars,
        torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if wrapper is not None:
        wrapper.launches += 1
        wrapper.launches_by_dtype[tag] += 1
    return out


def lap_periodic_kernel(u, h: float):
    """Periodic 5-point Laplacian of the ``(ny, nx)`` field ``u``."""
    if u.device.type == "cpu":
        return stencils.lap_periodic(u, h)
    return _launch(lap_periodic_kernel, "lap_periodic", 3, u, 1.0 / (h * h))


def _sh_c_name(u) -> str:
    """The C function of the kernel that takes the field: strip or tiled."""
    return "sh_operator" if sh_operator_path(u) == "strip" else "sh_operator_v1"


def sh_operator_kernel(u, h: float, r: float):
    """``-Lap^2 u - 2 Lap u + (r-1) u`` of the ``(ny, nx)`` field ``u``,
    periodic, in one pass: through the strip-marching kernel where
    :func:`sh_operator_path` says ``"strip"``, else through the tiled one."""
    if u.device.type == "cpu":
        return stencils.sh_linear_operator(u, h, r)
    return _launch(sh_operator_kernel, "sh_operator", 4, u, 1.0 / (h * h), r - 1.0,
                   c_name=_sh_c_name)


def _sh_operator_v1(u, h: float, r: float):
    """The tiled kernel on any CUDA field, counted nowhere: for timing the
    earlier design against the strip kernel in one process."""
    return _launch(None, "sh_operator", 4, u, 1.0 / (h * h), r - 1.0,
                   c_name=lambda u: "sh_operator_v1")


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


def reset_launches():
    """Set both wrappers' launch counts to 0."""
    for fn in (lap_periodic_kernel, sh_operator_kernel):
        fn.launches = 0
        fn.launches_by_dtype = dict.fromkeys(_DTYPES.values(), 0)


reset_launches()
