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
  stencil and curvilinear primitives; used for CPU tensors and as the
  kernel's oracle.
- :func:`jvp_matvec` — the wrapper: CPU tensors take the plain version,
  CUDA tensors launch the hand-written kernel ``csrc/droplet_jvp.cu`` or
  raise.  ``jvp_matvec.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..core.grid import Grid2D
from . import stencils
from .curvilinear import _flux_div_x, _zero_edges


def jvp_apply_ref(v, stack, grid: Grid2D):
    """The linearised droplet CN chain in plain PyTorch (stack =
    [inv_j, xx, yy, xy, c0, c1, c2, c3], dt/2 folded into c1..c3)."""
    inv_j, xx, yy, xy, c0, c1, c2, c3 = stack
    dx, dy = grid.dx, grid.dy
    a11 = (xy * xy + yy * yy) * inv_j
    a22 = (xy * xy + xx * xx) * inv_j
    a12 = -(xy * (xx + yy)) * inv_j

    v_ksi = stencils.d1_x(v, dx)
    v_eta = stencils.d1_y(v, dy)
    fx = _flux_div_x(a11, v, 1.0 / (dx * dx))
    fy = _flux_div_x(a22.T, v.T, 1.0 / (dy * dy)).T
    tx = _zero_edges(stencils.d1_x(a12 * v_eta, dx), rows=False)
    ty = _zero_edges(stencils.d1_y(a12 * v_ksi, dy), cols=False)
    v_xx = (fx + tx) * inv_j
    v_yy = (fy + ty) * inv_j

    dp = -(v_xx + v_yy) + c0 * v
    dpk = _zero_edges(stencils.d1_x(dp, dx), rows=False)
    dpe = _zero_edges(stencils.d1_y(dp, dy), cols=False)
    dpx = (yy * dpk - xy * dpe) * inv_j
    dpy = (-xy * dpk + xx * dpe) * inv_j

    dA = dpx * c1 + c2 * v
    dB = dpy * c1 + c3 * v
    dF2 = (yy * stencils.d1_x(dA, dx) - xy * stencils.d1_y(dA, dy)
           - xy * stencils.d1_x(dB, dx) + xx * stencils.d1_y(dB, dy)) * inv_j
    return v - dF2


@lru_cache(maxsize=None)
def _kernel():
    from ._build import load_library

    lib = load_library("droplet_jvp")
    fn = lib.droplet_jvp_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def jvp_matvec(v, stack, grid: Grid2D):
    """``v - dF2[v]`` on the ``(ny, nx)`` grid.

    On a CUDA tensor it launches the CUDA kernel (f32, ``ny, nx >= 8``,
    any shape otherwise) and raises on anything the kernel does not take
    or on a failed launch; on a CPU tensor it runs :func:`jvp_apply_ref`.
    """
    if v.device.type == "cpu":
        return jvp_apply_ref(v, stack, grid)
    ny, nx = grid.shape
    if v.dtype != torch.float32 or stack.dtype != torch.float32:
        raise TypeError(f"droplet_jvp kernel takes float32, got {v.dtype} "
                        f"and {stack.dtype}")
    if tuple(v.shape) != (ny, nx) or tuple(stack.shape) != (8, ny, nx):
        raise ValueError(f"droplet_jvp kernel: v {tuple(v.shape)}, stack "
                         f"{tuple(stack.shape)} for grid {(ny, nx)}")
    if ny < 8 or nx < 8:
        raise ValueError(f"droplet_jvp kernel needs ny, nx >= 8, got {(ny, nx)}")
    if stack.device != v.device:
        raise ValueError("v and stack must be on the same device")
    v = v.contiguous()
    stack = stack.contiguous()
    out = torch.empty_like(v)
    scratch = torch.empty((3, ny, nx), dtype=torch.float32, device=v.device)
    err = _kernel()(v.data_ptr(), stack.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), ny, nx, grid.dx, grid.dy,
                    torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"droplet_jvp kernel launch failed: CUDA error {err}")
    jvp_matvec.launches += 1
    return out


jvp_matvec.launches = 0
