"""Build and load the port's CUDA kernels from the sources in ``ops/csrc``,
and call them: the one seam between the Python wrappers and the card.

The build runs at first use, on a machine with ``nvcc``, through
``torch.utils.cpp_extension.load`` into ``iterative_solvers_tpu_torch/_build/``
(listed in ``.gitignore``).  Every ``csrc/*.cu`` goes into one shared
library in one ``load`` call, whose ninja build compiles the sources in
parallel.  The sources include no PyTorch header and export a plain C
interface, so the build takes seconds, not minutes; the library is loaded
with ``ctypes`` and called with raw device pointers and the current
stream.  Flags: ``-arch=sm_90a`` (Hopper), ``-O3``, and no
``--use_fast_math``.

Every kernel call goes through this module.  A wrapper keeps a table of
its C functions' argument types, its own shape checks and its choice of
kernel; :func:`check` refuses any operand that no kernel takes (off a
CUDA device, of another dtype, on two devices, not contiguous where
the kernel needs it, or carrying a gradient or a tangent: the kernels have no derivative rule);
:func:`launch` calls the C function, bound once, on the current stream,
raises on a failed launch and counts it in :data:`LAUNCHES` under
``(kernel, dtype, path)``.  :func:`launch_count` reads the counts and
:func:`reset_launch_counts` clears them.
"""
from __future__ import annotations

import collections
import ctypes
import pathlib
from functools import lru_cache

import torch
from torch.autograd import forward_ad

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"
CUDA_FLAGS = ["-arch=sm_90a", "-O3", "-std=c++17"]
LIBRARY = "iterative_solvers_tpu_torch_kernels"

DTYPES = {torch.float32: "f32", torch.float64: "f64"}
F32 = {torch.float32: "f32"}

# launches by (kernel, dtype tag, path or None)
LAUNCHES: collections.Counter = collections.Counter()
_BOUND: dict = {}
_wrapped = torch._C._functorch.is_functorch_wrapped_tensor


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile every ``csrc/*.cu`` into one library (once per process,
    cached on disk by content) and return it as a ``ctypes`` library.
    Raises if the build fails — there is no fallback."""
    from torch.utils.cpp_extension import load

    if not torch.cuda.is_available():
        raise RuntimeError("building the CUDA kernels: CUDA is not available")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(str(p) for p in CSRC.glob("*.cu"))
    path = load(name=LIBRARY, sources=sources, build_directory=str(BUILD_DIR),
                extra_cuda_cflags=CUDA_FLAGS, is_python_module=False,
                verbose=False)
    return ctypes.CDLL(path)


def clear() -> None:
    """Forget the library and every function bound from it: the next call
    builds and loads it anew."""
    load_library.cache_clear()
    _BOUND.clear()


def c_function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The exported C function ``name`` of the kernel library, with its
    argument types set and an ``int`` (``cudaError_t``) result."""
    fn = getattr(load_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _bound(name: str, argtypes):
    fn = _BOUND.get(name)
    if fn is None:
        fn = _BOUND[name] = c_function(name, argtypes)
    return fn


def check(kernel: str, *tensors, dtypes=DTYPES, strided: bool = False) -> str:
    """Raise unless every one of ``tensors`` is an operand the kernel takes:
    on one CUDA device, of one of ``dtypes``, contiguous (unless the kernel
    reads any ``strided`` layout), and carrying no gradient or tangent
    (neither had the TPU kernels a derivative rule, so autograd or
    ``torch.func.jvp`` through a call would lose the derivative).  Returns
    the first tensor's dtype tag."""
    dev = tensors[0].device
    for t in tensors:
        if (_wrapped(t) or t.requires_grad or (forward_ad._current_level >= 0
                                               and forward_ad.unpack_dual(t).tangent is not None)):
            raise RuntimeError(
                f"the {kernel} kernel has no derivative rule: use finite-difference "
                "JVPs (jvp_mode='fd') or an analytic matvec_factory on the GPU")
        if t.device != dev:
            raise ValueError(f"{kernel} kernel takes operands on the same device, "
                             f"got {dev} and {t.device}")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{kernel} kernel takes {names}, got {t.dtype}")
        if not (strided or t.is_contiguous()):
            raise ValueError(f"{kernel} kernel takes contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{kernel} kernel runs on a CUDA device, got {dev}")
    return dtypes[tensors[0].dtype]


def call(name: str, table: dict, *args) -> None:
    """Call the exported C function ``name`` (argument types
    ``table[name]``) with ``args``; raise on a non-zero ``cudaError_t``."""
    err = _bound(name, table[name])(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def launch(key: tuple, c_base: str, table: dict, device, *args) -> None:
    """Launch ``{c_base}_{dtype}`` (argument types ``table[c_base]``) with
    ``args`` and the current stream of ``device``, for ``key = (kernel,
    dtype, path)``; raise on a failed launch, else count it under ``key``."""
    err = _bound(f"{c_base}_{key[1]}", table[c_base])(
        *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{key[0]} kernel launch failed: CUDA error {err}")
    LAUNCHES[key] += 1


def launch_count(kernel=None, *, dtype=None, path=None, since=None) -> int:
    """The launches counted under ``kernel``, ``dtype`` and ``path`` (None:
    any), less those that ``since``, a copy of :data:`LAUNCHES` taken
    earlier, held."""
    def total(counts):
        return sum(n for (k, d, p), n in counts.items()
                   if kernel in (None, k) and dtype in (None, d) and path in (None, p))
    return total(LAUNCHES) - (total(since) if since is not None else 0)


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    LAUNCHES.clear()
