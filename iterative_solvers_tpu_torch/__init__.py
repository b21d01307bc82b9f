"""iterative_solvers_tpu_torch — the PyTorch/CUDA port of ``iterative_solvers_tpu``.

The JAX package beside it is the reference; this package keeps its module
layout and function names so each counterpart is easy to find:

- ``core``     — grid descriptor
- ``ops``      — finite-difference stencils, curvilinear operators, DCTs as
                 basis matmuls, the droplet JVP matvec (hand-written CUDA
                 kernel in ``ops/csrc``) and its build
- ``meshmove`` — monitor smoothing and the parabolic Monge–Ampère mesh loop
- ``solvers``  — LGMRES with outer-vector recycling and Jacobian-free
                 Newton–Krylov, as host-side loops over device tensors
- ``models``   — the moving-mesh thin-film droplet Crank–Nicolson step
- ``io``       — the golden fixture state and conversion of JAX-side state

It imports ``torch`` (and numpy/scipy) only.  Entry points run on the GPU
unless the caller passes ``device="cpu"``; with no GPU present and no
explicit CPU request they raise.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    absent (no silent CPU fallback).

    On a CUDA device it also pins every f32 matmul (the DCT basis products
    and the Gram–Schmidt dots) to full f32: TF32 keeps ~3 decimal digits,
    the class of error that tangled the moving mesh into NaN on the
    reference's low-precision matmul default.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev
