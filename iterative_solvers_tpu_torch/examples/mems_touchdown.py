"""MEMS touchdown experiment (port of ``examples/mems_touchdown.py``).

Drives the reference's PMA2_nk.py configuration (p = 2 biharmonic, m = 3
Van der Waals, lambda = 1, beta = 0.15, N = 51, k = 1e-4) from the flat
state toward touchdown (u -> -1), with the adaptive clamp
``dt = k min(1+u)^3`` shrinking the step as the membrane approaches the
substrate.  Touchdown is a finite-time quenching singularity and the clamp
makes t asymptote to the touchdown time t*, so the run is characterised by
how far u_min gets, not by reaching the reference's Tf.

The JAX driver's ``lax.scan`` over a chunk of steps is a host loop here:
each chunk's rows (u_min, min mesh spacing) stay on the device and are
read once at the chunk's end, and the run stops at the first chunk end
where u_min <= ``u_stop``.

Optionally cross-checks against a headless scipy run of the reference's
own main loop over the same step horizon (``oracle=1``, which needs the
reference sources that ``tools/make_golden.py`` reads; the first
``oracle_steps`` steps are compared on u_min and dt).

Writes ``<out_dir>/mems_touchdown.jsonl``: a summary line, then the step
rows (every 20th and the last 100).

Usage: python -m iterative_solvers_tpu_torch.examples.mems_touchdown [key=val ...]
  keys: u_stop (-0.9), max_steps (60000), chunk (500), k (1e-4),
        oracle (0|1), oracle_steps (200), cpu (1 = run on the CPU; default
        0, the GPU), out_dir (default runs/)
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..models import mems
from ..models.droplet import min_spacing
from ..ops import curvilinear
from ..solvers.newton import NewtonKrylov
from . import OUT_DIR, split_args

TOOLS = pathlib.Path(__file__).resolve().parents[2] / "tools"


def run_ours(cfg, u_stop: float, max_steps: int, chunk: int, device="cuda"):
    """Chunks of ``chunk`` operator-split steps until ``max_steps`` rows or
    u_min <= ``u_stop`` at a chunk's end.  Returns ``(rows, (u, q, t),
    wall seconds)``; raises if a step does not converge."""
    dev = resolve_device(device)
    solver = NewtonKrylov(f_tol=6e-6, maxiter=40, inner_m=20, outer_k=8)
    step = mems.make_step(cfg, solver, dev)
    u, q = mems.initial_state(cfg, device=dev)
    t = 0.0
    rows = []
    t0 = time.time()
    while len(rows) < max_steps:
        host, umins, msps = [], [], []
        for _ in range(chunk):
            out = step(u, q)
            u, q, t = out.u, out.q, t + out.dt
            host.append((out.dt, t, out.newton_iters, out.converged))
            umins.append(torch.min(u))
            msps.append(min_spacing(curvilinear.mesh_geometry(q, cfg.grid)))
        umins = torch.stack(umins).tolist()
        msps = torch.stack(msps).tolist()
        for (dt, ti, iters, conv), umin, msp in zip(host, umins, msps):
            rows.append({
                "step": len(rows) + 1, "t": ti, "dt": dt, "u_min": umin,
                "newton_iters": iters, "converged": conv, "min_spacing": msp,
            })
        print(f"step {len(rows)}: t={t:.5f} dt={host[-1][0]:.3e} "
              f"u_min={umins[-1]:.4f}", flush=True)
        if not all(h[3] for h in host):
            raise RuntimeError("JFNK failed mid-run")
        if umins[-1] <= u_stop:
            break
    return rows, (u, q, t), time.time() - t0


def _load_patched():
    """``tools/make_golden.py``'s loader of the reference sources, loaded
    from its file (the tool imports numpy only); raises if the reference
    sources it reads are absent."""
    spec = importlib.util.spec_from_file_location("make_golden", TOOLS / "make_golden.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    if not (tool.REF / "PMA2_nk.py").exists():
        raise FileNotFoundError(
            f"oracle=1 needs the reference's PMA2_nk.py in {tool.REF}, which is absent")
    return tool.load_patched


def run_oracle(cfg, nsteps: int):
    """The reference's PMA2_nk main loop, headless, through the golden-tools
    loader (the reference's own code as a test oracle, on the host)."""
    from scipy.optimize import newton_krylov

    d = _load_patched()("PMA2_nk.py", {"plot_bool = True": "plot_bool = False"})
    nn = d["NN_"]
    Q, U = d["Q"], d["U"]
    Q.val = np.reshape(0.5 * d["ksiksi"] ** 2 + 0.5 * d["etaeta"] ** 2, nn)
    d["make_Ibdy"]()
    d["make_M"]()
    U.new = np.zeros(nn)
    t = 0.0
    rows = []
    for s in range(nsteps):
        U.val = U.new.copy()
        d["compute_Q_spatial_ders"]()
        d["J"] = Q.d2ksi * Q.d2eta - Q.dksideta ** 2
        d["compute_u_spatial_ders"]()
        dt = d["compute_g"]() * d["k"]
        d["dt"] = dt
        d["solve_PMA"]()
        d["CN_term"] = d["compute_rhs_pde"]()
        U.new = newton_krylov(d["residual"], U.val, verbose=0)
        Q.val = Q.val + dt * Q.dt
        t += dt
        rows.append({"step": s + 1, "t": t, "dt": float(dt),
                     "u_min": float(U.new.min())})
    return rows


def thin(rows: list) -> list:
    """The rows a record keeps: every 20th, and the last 100 in full."""
    return [r for i, r in enumerate(rows) if i % 20 == 0 or i >= len(rows) - 100]


def main(argv=None) -> dict:
    """Run, write the record, print its summary line; return the summary
    with ``rows`` (all of them) and ``path``."""
    _, o = split_args(sys.argv[1:] if argv is None else argv)
    u_stop = float(o.get("u_stop", -0.9))
    max_steps = int(o.get("max_steps", 60000))
    chunk = int(o.get("chunk", 500))
    cfg = mems.MEMSConfig(k=float(o.get("k", 1e-4)))
    # the JAX driver defaults to the CPU (cpu=1); the port's entry points
    # run on the GPU unless asked for the CPU
    device = "cpu" if o.get("cpu", "0") == "1" else "cuda"

    rows, _, wall = run_ours(cfg, u_stop, max_steps, chunk, device)

    parity = None
    if o.get("oracle", "0") == "1":
        n_or = int(o.get("oracle_steps", 200))
        t0 = time.time()
        orows = run_oracle(cfg, n_or)
        du = max(abs(rows[i]["u_min"] - orows[i]["u_min"]) for i in range(n_or))
        ddt = max(abs(rows[i]["dt"] - orows[i]["dt"]) / orows[i]["dt"]
                  for i in range(n_or))
        parity = {"oracle_steps": n_or, "max_abs_du_min": du,
                  "max_rel_ddt": ddt, "oracle_wall_s": time.time() - t0}
        print(f"oracle parity over {n_or} steps: |d u_min| {du:.2e}, "
              f"rel d dt {ddt:.2e}", flush=True)

    summary = {
        "summary": True, "config": "PMA2_nk defaults (p=2, m=3, "
        "lambda=1, beta=0.15, N=51, k=1e-4)",
        "steps": len(rows), "t_final": rows[-1]["t"],
        "dt_first": rows[0]["dt"], "dt_final": rows[-1]["dt"],
        "u_min_final": rows[-1]["u_min"], "u_stop": u_stop,
        "reached": rows[-1]["u_min"] <= u_stop,
        "wall_s": round(wall, 1), "parity": parity,
    }
    out_dir = pathlib.Path(o.get("out_dir", OUT_DIR))
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "mems_touchdown.jsonl"
    with open(out, "w") as f:
        f.write(json.dumps(summary) + "\n")
        f.writelines(json.dumps(r) + "\n" for r in thin(rows))
    print(json.dumps(summary))
    print(f"wrote {out}")
    return {**summary, "rows": rows, "path": out}


if __name__ == "__main__":
    main()
