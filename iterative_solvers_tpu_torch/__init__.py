"""iterative_solvers_tpu_torch — the PyTorch/CUDA port of ``iterative_solvers_tpu``.

The JAX package beside it is the reference; this package keeps its module
layout and function names so each counterpart is easy to find:

- ``core``     — grid descriptor
- ``ops``      — finite-difference stencils, curvilinear operators, DCT/DST
                 as basis matmuls, the sparse containers (DIA, CSR, COO,
                 BSR, GridDIA) with their assembly helpers, and the
                 hand-written CUDA kernels of ``ops/csrc`` with their
                 wrappers and build: the droplet JVP matvec, the periodic
                 stencils, the diagonal-format SpMV / SpMM, the PMA
                 sub-step's stencil and pointwise chain
- ``meshmove`` — monitor smoothing and the parabolic Monge–Ampère mesh loop
- ``solvers``  — GMRES, LGMRES with outer-vector recycling, CG,
                 Jacobian-free Newton–Krylov and the variable-order BDF
                 integrator as host-side loops over device tensors; the
                 backoff stepper; DST direct solvers, preconditioners,
                 tridiagonal LU
- ``models``   — the moving-mesh thin-film droplet step, Swift–Hohenberg,
                 the MEMS touchdown problem (operator-split and coupled),
                 the Poisson duct flow, the 1-D heat and the wave steppers
- ``dist``     — the distribution layer on ``torch.distributed``: process
                 groups and the device mesh, halo exchange, the sharded
                 stencils, Swift–Hohenberg and droplet steps
- ``io``       — the golden fixture state, checkpoints (whole and sharded),
                 and conversion of JAX-side state
- ``utils``    — byte and operation counts of the hot kernels and of the
                 collectives, metrics, timers, the host loops' spans and
                 counters (``utils.trace``, off by default), offline
                 rendering
- ``cli``      — ``python -m iterative_solvers_tpu_torch.cli
                 {sh,droplet,mems,poisson}``
- ``examples`` — the JAX package's six drivers (the large-grid droplet
                 runs, the flagship, the full SH experiment, the MEMS
                 touchdown runs):
                 ``python -m iterative_solvers_tpu_torch.examples.<name>``
- ``native``   — the native solver library's entry points (CSR SpMV,
                 LGMRES, JFNK on a numpy callback, the SH driver) over
                 the port's own solvers

It imports ``torch`` (and numpy/scipy) only.  Entry points run on the GPU
unless the caller passes ``device="cpu"``; with no GPU present and no
explicit CPU request they raise.
"""
from __future__ import annotations

import numpy as np
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


def to_numpy(a):
    """A tensor (on any device) or array-like as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
