"""The reference's complete Swift–Hohenberg experiment, sh_scipy_nk.py
(port of ``examples/sh_full_experiment.py``): a 64² grid, dt = 0.2 to
Tf = 500, i.e. 2500 CN/JFNK steps at f_tol 6e-6, with per-step convergence
stats and an optional offline snapshot.

The JAX driver compiles by running the whole trajectory once before it
times the run; the port compiles nothing, so it takes one untimed warm-up
step instead (it loads the kernel library and builds the cached tables),
then times the whole run from u0.  On a GPU every f32 Jacobian matvec and
every f64 residual goes through the ``sh_operator`` kernel.

Usage:  python -m iterative_solvers_tpu_torch.examples.sh_full_experiment
        [steps] [out.png] [device=cpu]
(defaults 2500 steps, no image, the GPU).
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..models.swift_hohenberg import SHConfig, evolve_cn, fast_solver, make_cn_step
from . import split_args

F_TOL = 6e-6
SCIPY_S_PER_STEP = 0.043   # the reference's scipy step, the JAX driver's estimate


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def experiment(steps: int, device="cuda"):
    """One untimed warm-up step, then ``steps`` timed CN/JFNK steps from u0.
    Returns ``(line, u, iters)``: the JSON line, the final state and the
    Newton iterations of each step."""
    dev = resolve_device(device)
    cfg = SHConfig(n=64)  # reference defaults: d=40, k=0.2, r=0.01, g=1
    solver = fast_solver(cfg, f_tol=F_TOL, inner_m=10, outer_k=5)
    u0 = torch.tensor(np.random.default_rng(0).standard_normal((cfg.n, cfg.n)),
                      device=dev)
    make_cn_step(cfg, solver, dev)(u0)
    _sync(dev)

    t0 = time.perf_counter()
    u, iters, f_norms = evolve_cn(u0, steps, cfg, solver, dev)
    float(torch.sum(u))  # host read: the device has drained
    wall = time.perf_counter() - t0

    line = {
        "steps": steps,
        "t_final": steps * cfg.k,
        "wall_s": round(wall, 2),
        "ms_per_step": round(1000 * wall / steps, 3),
        "all_converged": bool((f_norms <= F_TOL).all()),
        "worst_fnorm": float(f_norms.max()),
        "mean_newton_iters": round(float(np.mean(iters)), 2),
        "scipy_reference_estimate_s": round(steps * SCIPY_S_PER_STEP, 1),
    }
    return line, u, iters


def main(argv=None) -> dict:
    """Print the JSON line; return it with ``u`` and ``newton_iters``."""
    pos, opts = split_args(sys.argv[1:] if argv is None else argv)
    steps = int(pos[0]) if len(pos) > 0 else 2500
    out_png = pos[1] if len(pos) > 1 else None
    line, u, iters = experiment(steps, opts.get("device", "cuda"))
    print(json.dumps(line), flush=True)
    if out_png:
        from ..utils.render import save_field_image

        save_field_image(u, out_png, title=f"SH t={line['t_final']:.0f}")
    return {**line, "u": u, "newton_iters": iters}


if __name__ == "__main__":
    main()
