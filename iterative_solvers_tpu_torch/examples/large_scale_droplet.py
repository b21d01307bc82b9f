"""Large-scale droplet coalescence (port of
``examples/large_scale_droplet.py``).

The reference caps at 91x61; this driver scales the same physics to
1024²-4096²:

1. upsample the 91x61 coalescence state's *mesh potential* to the fine
   grid (``io.fixtures.upsample``: boundary-consistent spline blending),
   the state from ``tests/fixtures/golden_droplet_step.npz``;
2. re-seed the coalescing droplets analytically on the refined mesh (the
   fine mesh resolves the 1/a interface the coarse state cannot);
3. equilibrate the mesh with PMA relaxation sweeps (f32, deviation form);
4. evolve with the mixed-precision JFNK stepper: f64 states and residuals,
   f32 inner Krylov, f32 spectral transforms.

Usage:  python -m iterative_solvers_tpu_torch.examples.large_scale_droplet
        [n] [steps] [kernel|jvp|dfres|fd] [device]
(defaults 1024, 3, kernel, cuda).  ``kernel`` runs the inner Krylov on the
``droplet_jvp`` CUDA kernel (analytic f32 linearisation), ``jvp`` on
``torch.func.jvp`` of the f32 residual, ``dfres`` the kernel with
two-f32 outer residuals, ``fd`` f64 finite differences.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..io import fixtures as fx
from ..meshmove.pma import loop_pma
from ..models import droplet as dp
from ..ops import curvilinear
from ..solvers.newton import NewtonKrylov

DROPS = [(0.0, 0.0, 1.0, 1.0), (3.0, 0.0, 1.0, 1.0)]
MODES = {"kernel": {"jvp_dtype": "float32", "jvp_kernel": True},
         "jvp": {"jvp_dtype": "float32"},
         "dfres": {"jvp_dtype": "float32", "jvp_kernel": True,
                   "residual_mode": "df64"},
         "fd": {}}


def mesh_dt(n: int) -> float:
    """Resolution-scaled explicit PMA step.  The monitor |lap u|^2 grows
    ~(interface curvature)^2 as the 1/a interface becomes resolved, and the
    1024²-tuned dtmesh over-compresses, then tangles, finer meshes; scaling
    it by (1024/n)^2 keeps the explicit mesh flow stable at every grid."""
    return 1e-10 * min(1.0, (1024.0 / n) ** 2)


def prepare(n: int, device="cuda"):
    """State preparation on the deviation-form mesh (phi = Q - identity):
    the f32-robust geometry at fine grids, which lets the whole PMA
    sub-loop run in f32 (``mesh_dtype``).  Returns ``(cfg, u, phi)`` on
    ``device`` (default CUDA; raises without a GPU unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    fixture, _ = fx.load_golden_step()
    big = fx.upsample(fixture, n, n)
    cfg = dataclasses.replace(fx.config_for(big), spectral_dtype="float32",
                              mesh_dtype="float32")
    phi = curvilinear.to_deviation(torch.tensor(big.q, device=dev), cfg.grid)
    for _ in range(3):
        geom = curvilinear.mesh_geometry_dev(phi, cfg.grid)
        u = dp.seeded_solution(geom, cfg, DROPS)
        phi = loop_pma(phi, u, mesh_dt(n), 60, cfg.grid, cfg.pma,
                       dp.monitor_source, curvilinear.mesh_geometry_dev)
    geom = curvilinear.mesh_geometry_dev(phi, cfg.grid)
    u = dp.seeded_solution(geom, cfg, DROPS)
    if not float(torch.min(geom.jac)) > 0:
        raise RuntimeError("mesh tangled during preparation")
    return cfg, u, phi


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Prepare the n² state, take one warm-up step and ``steps`` timed
    steps; print and return the JSON line (``step_ms`` the median)."""
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1024
    steps = int(argv[1]) if len(argv) > 1 else 3
    mode = argv[2] if len(argv) > 2 else "kernel"
    dev = resolve_device(argv[3] if len(argv) > 3 else "cuda")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    # dt scaled at 4096²: the fully-resolved interface steepens the
    # nonlinear system (the JAX package's 4096² run converged at 5e-10 and
    # stalled at 1e-9)
    dt = 1e-9 * min(1.0, 2048.0 / n)

    t0 = time.time()
    cfg, u, q = prepare(n, dev)
    _sync(dev)
    print(f"prepared {n}x{n} state in {time.time()-t0:.0f}s", flush=True)

    solver = NewtonKrylov(f_tol=1e-5, maxiter=14, inner_m=12, outer_k=6,
                          inner_dtype="float32", max_backtracks=4)
    step = dp.make_step(cfg, dt=dt, dtmesh=mesh_dt(n), pma_loops=20,
                        solver=solver, deviation_form=True, device=dev,
                        **MODES[mode])

    t0 = time.time()
    out = step(u, q, dt)
    _sync(dev)
    print(f"first step {time.time()-t0:.0f}s", flush=True)

    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step(out.u, out.q, dt)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    line = {
        "n": n,
        "step_ms": round(1000 * float(np.median(times)), 1),
        "converged": bool(out.converged),
        "newton_iters": int(out.newton_iters),
        "f_norm": float(out.f_norm),
        "dof_ratio_vs_reference": round(n * n / 5551.0, 1),
    }
    print(json.dumps(line), flush=True)
    return {**line, "steps_ms": [1000 * t for t in times], "mode": mode,
            "device": str(dev)}


if __name__ == "__main__":
    main()
