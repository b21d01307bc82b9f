"""Build and load the port's CUDA kernels from the sources in ``ops/csrc``.

The build runs at first use, on a machine with ``nvcc``, through
``torch.utils.cpp_extension.load`` into ``iterative_solvers_tpu_torch/_build/``
(listed in ``.gitignore``).  The sources include no PyTorch header and
export a plain C interface, so the build takes seconds, not minutes; the
library is loaded with ``ctypes`` and called with raw device pointers and
the current stream.  Flags: ``-arch=sm_90a`` (Hopper), ``-O3``, and no
``--use_fast_math``.
"""
from __future__ import annotations

import ctypes
import pathlib
from functools import lru_cache

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_FLAGS = ["-arch=sm_90a", "-O3", "-std=c++17"]


@lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per process, cached on disk by
    content) and return it as a ``ctypes`` library.  Raises if the build
    fails — there is no fallback."""
    import torch
    from torch.utils.cpp_extension import load

    if not torch.cuda.is_available():
        raise RuntimeError(f"building {name}: CUDA is not available")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(name=name, sources=[str(CSRC / f"{name}.cu")],
                build_directory=str(BUILD_DIR), extra_cuda_cflags=CUDA_FLAGS,
                is_python_module=False, verbose=False)
    return ctypes.CDLL(path)
