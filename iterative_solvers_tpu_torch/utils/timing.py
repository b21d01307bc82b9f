"""Wall timers and profiling helpers
(port of ``iterative_solvers_tpu/utils/timing.py``).

``device_timer`` brackets a phase with device synchronisation,
``median_ms`` times a call with a synchronise after each, and
``trace_annotation`` names a span in a ``torch.profiler`` trace.
``graph_ms`` times a call's device work alone in a CUDA-graph replay, and
``nvidia_smi`` reads the card's name and power limit, which every time
taken on a card is kept beside.
"""
from __future__ import annotations

import contextlib
import subprocess
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


def graph_ms(fn: Callable, calls: int = 10, reps: int = 7) -> float:
    """Device time per call of ``fn()`` on the card: ``calls`` back-to-back
    calls are captured into one CUDA graph, and the median CUDA-event time
    of its replays is divided by the count.  A replay enqueues the captured
    kernels with no Python between them, so this leaves out the time the
    device waits for the host's next enqueue.  ``fn`` must already have run
    once (nothing is built or copied to the device while capturing)."""
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def nvidia_smi() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
