"""The port's headline bench: one full droplet moving-mesh JFNK step at
91x61 with 400 PMA sub-steps, metric ``droplet_full_step_91x61_pma400``
(the counterpart of the repository's ``bench.py``, same definition).

- Configuration: ``config_for(parse_name(FIXTURE))`` with the spectral and
  mesh dtypes f32: f64 state and outer residuals, f32 inner Krylov
  (``fast_solver``), f32 PMA sub-loop.
- Starting state: ``u0``/``q0`` of ``tests/fixtures/golden_droplet_traj.npz``,
  the columns of that fixture file.
- Step: ``make_step(cfg, dt=1e-5, dtmesh=3e-9, pma_loops=400,
  solver=fast_solver())``, u and q carried from step to step; every step
  must converge (f_tol 1e-7) and the mesh must stay untangled (min
  Jacobian > 0 at each chain's end), or the run raises.
- Value: the marginal ms per step between chains of ``K_SHORT`` and
  ``K_LONG`` steps from the same state, each the median of ``reps`` chains
  timed on the host clock with one synchronisation at the chain's end (the
  Newton loop's own scalar reads stay inside the step).  ``K_LONG`` is 6,
  not the 10 of ``bench.py``: from this state at a fixed dt of 1e-5 the
  mesh degrades from the 7th step on and Newton fails in the 9th or 10th
  (port, f32 mesh: min Jacobian < 0 after step 8, no convergence in step
  9; port, f64 mesh: step 9; the JAX package on the CPU: NaN in step 10),
  while the first 6 steps converge in 3 Newton iterations each with min
  Jacobian >= 0.10.
- ``pma_share``: a separate traced chain of ``K_SHORT`` steps in which
  each step's ``loop_pma`` call is timed with CUDA events (host clock on
  the CPU): the sum of those spans over the chain's time, also timed with
  events.  The timed chains run untraced.

Run on one GPU: ``python -m iterative_solvers_tpu_torch.bench``.  Prints
one JSON line; ``vs_baseline`` is the reference's 990 ms CPU composite
step over the value (>1: faster than the reference).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from . import resolve_device
from .io import fixtures as fx
from .meshmove.pma import loop_pma
from .models import droplet as dp
from .ops import curvilinear

BASELINE_MS = 990.0  # the reference's step: ~91 residuals x 1.6 ms + 400 PMA x 2.1 ms
K_SHORT, K_LONG = 2, 6
FIXTURE = "initdrop_coal_1_91-61_100_0.005_0.01_0.1_0.15.txt"
DT, DTMESH = 1e-5, 3e-9


class BenchResult(NamedTuple):
    line: dict            # the JSON line's fields
    u: torch.Tensor       # the state after a chain of ``k_short`` steps
    q: torch.Tensor


def bench_config():
    """The bench's configuration: the coalescence fixture's, f32 mesh loop."""
    return dataclasses.replace(fx.config_for(fx.parse_name(FIXTURE)),
                               spectral_dtype="float32", mesh_dtype="float32")


def _ms(fn, dev) -> float:
    """Time of one ``fn()``: CUDA events on a GPU, else the host clock."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def run(device="cuda", reps: int = 7, pma_loops: int = 400,
        k_short: int = K_SHORT, k_long: int = K_LONG) -> BenchResult:
    """Time the step; raises if a step does not converge."""
    dev = resolve_device(device)
    cfg = bench_config()
    with np.load(fx.FIXTURES / "golden_droplet_traj.npz") as g:
        u0 = torch.tensor(g["u0"].reshape(cfg.grid.shape), device=dev)
        q0 = torch.tensor(g["q0"].reshape(cfg.grid.shape), device=dev)
    step = dp.make_step(cfg, dt=DT, dtmesh=DTMESH, pma_loops=pma_loops,
                        solver=dp.fast_solver(), device=dev)

    def chain(k):
        u, q, iters, f_norms = u0, q0, [], []
        for _ in range(k):
            out = step(u, q, DT)
            if not out.converged:
                raise RuntimeError(
                    f"JFNK missed f_tol=1e-7: f_norm {out.f_norm} after "
                    f"{out.newton_iters} Newton iterations")
            u, q = out.u, out.q
            iters.append(out.newton_iters)
            f_norms.append(out.f_norm)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return u, q, iters, f_norms

    def timed(k):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = chain(k)
            ts.append(time.perf_counter() - t0)
            min_jac = torch.min(curvilinear.mesh_geometry(out[1], cfg.grid).jac).item()
            if not min_jac > 0:
                raise RuntimeError(f"mesh tangled after {k} steps: min Jacobian {min_jac}")
        return float(np.median(ts)), out

    chain(1)  # warm-up: allocator, library handles, basis uploads
    t_short, (u1, q1, _, f_short) = timed(k_short)
    t_long, (_, _, iters, f_long) = timed(k_long)
    ms = 1e3 * (t_long - t_short) / (k_long - k_short)

    # the traced chain: a span around each step's call into the PMA layer
    spans = []

    def traced_loop_pma(*args, **kw):
        out = []
        spans.append(_ms(lambda: out.append(loop_pma(*args, **kw)), dev))
        return out[0]

    dp.loop_pma = traced_loop_pma
    try:
        traced_ms = _ms(lambda: chain(k_short), dev)
    finally:
        dp.loop_pma = loop_pma
    pma_ms = sum(spans) / k_short

    line = {
        "metric": f"droplet_full_step_{cfg.nx}x{cfg.ny}_pma{pma_loops}",
        "value": ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / ms,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "newton_iters": iters,
        "worst_f_norm": max(f_short + f_long),
        "pma_ms": pma_ms,
        "pma_share": sum(spans) / traced_ms,
        "chain_ms": {str(k_short): t_short * 1e3, str(k_long): t_long * 1e3},
        "reps": reps,
    }
    return BenchResult(line, u1, q1)


if __name__ == "__main__":
    print(json.dumps(run().line))
