"""Wall timers and profiling helpers
(port of ``iterative_solvers_tpu/utils/timing.py``).

``device_timer`` brackets a phase with device synchronisation,
``median_ms`` times a call with a synchronise after each, and
``trace_annotation`` names a span in a ``torch.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device


def _sync(dev: torch.device) -> None:
    """Drain ``dev``'s work; a CPU device runs synchronously already."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_timer(results: dict, key: str, device="cuda"):
    """Adds the seconds of the block to ``results[key]``, the device
    synchronised before and after (default CUDA; raises if CUDA is absent
    and ``device="cpu"`` was not passed)."""
    dev = resolve_device(device)
    _sync(dev)
    t0 = time.perf_counter()
    yield
    _sync(dev)
    results[key] = results.get(key, 0.0) + time.perf_counter() - t0


def median_ms(fn: Callable, *args, iters: int = 20, warmup: int = 2,
              device="cuda") -> float:
    """Median wall-clock ms of ``fn(*args)``, the device synchronised after
    each call."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
        _sync(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return 1000.0 * float(np.median(ts))


def trace_annotation(name: str):
    """A named span in a ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)
