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


def _check_no_autodiff(u, name: str):
    """Raise if ``u`` carries a tangent or a gradient: the kernels have no
    derivative rule (neither had the TPU kernels), so ``torch.func.jvp`` or
    autograd through a CUDA call would silently lose the derivative."""
    if (torch._C._functorch.is_functorch_wrapped_tensor(u)
            or u.requires_grad or forward_ad.unpack_dual(u).tangent is not None):
        raise RuntimeError(
            f"the {name} kernel has no derivative rule: use finite-difference "
            "JVPs (jvp_mode='fd') or an analytic matvec_factory on the GPU")


def _launch(wrapper, name: str, min_n: int, u, *scalars):
    """Check ``u`` for the kernel ``name``, allocate the output, launch on
    the current stream and count the launch on ``wrapper``; raise on
    anything the kernel does not take."""
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
    err = _kernel(f"{name}_{tag}")(
        u.data_ptr(), out.data_ptr(), ny, nx, *scalars,
        torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.launches_by_dtype[tag] += 1
    return out


def lap_periodic_kernel(u, h: float):
    """Periodic 5-point Laplacian of the ``(ny, nx)`` field ``u``."""
    if u.device.type == "cpu":
        return stencils.lap_periodic(u, h)
    return _launch(lap_periodic_kernel, "lap_periodic", 3, u, 1.0 / (h * h))


def sh_operator_kernel(u, h: float, r: float):
    """``-Lap^2 u - 2 Lap u + (r-1) u`` of the ``(ny, nx)`` field ``u``,
    periodic, in one pass."""
    if u.device.type == "cpu":
        return stencils.sh_linear_operator(u, h, r)
    return _launch(sh_operator_kernel, "sh_operator", 4, u, 1.0 / (h * h),
                   r - 1.0)


def reset_launches():
    """Set both wrappers' launch counts to 0."""
    for fn in (lap_periodic_kernel, sh_operator_kernel):
        fn.launches = 0
        fn.launches_by_dtype = dict.fromkeys(_DTYPES.values(), 0)


reset_launches()
