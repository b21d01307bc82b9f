"""Coupled-BDF MEMS run toward touchdown (port of
``examples/mems_bdf_touchdown.py``).

The reference's PMA.py hands the coupled (u, Q) system to scipy's BDF with
Tf = 0.4 and the comment "solver should terminate before touchdown"; the
operator-split touchdown run measures this configuration's touchdown time
at t* ~ 0.312, so Tf = 0.4 is unreachable by construction.  This driver
integrates the coupled system toward t* in ``segments`` equal parts (the
system is autonomous: each segment runs over [0, tf/segments] from the
previous state, and t accumulates here) and holds u_min(t) against the
operator-split trajectory of ``benchmarks/mems_touchdown.jsonl`` (read,
never written).  On a GPU the right-hand side is a CUDA-graph replay
(``models.mems.graphed_coupled_rhs``).

Usage: python -m iterative_solvers_tpu_torch.examples.mems_bdf_touchdown
       [tf] [segments] [device=cpu] [out_dir=...]
(defaults 0.25, 10, the GPU, runs/).  Writes
``<out_dir>/mems_bdf_touchdown.jsonl``: a summary line, then a row a segment.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..models import mems
from ..solvers.bdf import BDF
from ..solvers.newton import NewtonKrylov
from . import OUT_DIR, split_args

SPLIT_RECORD = (pathlib.Path(__file__).resolve().parents[2] / "benchmarks"
                / "mems_touchdown.jsonl")


def split_curve(path=SPLIT_RECORD):
    """The operator-split run's ``(t, u_min)`` rows (its summary skipped)."""
    with open(path) as f:
        rows = [json.loads(line) for line in f][1:]
    return np.array([r["t"] for r in rows]), np.array([r["u_min"] for r in rows])


def run(cfg, tf: float, segments: int, device="cuda"):
    """``segments`` calls of ``evolve_coupled`` over ``tf / segments`` each.
    Returns ``(rows, (u, q))``; raises if a segment fails."""
    dev = resolve_device(device)
    os_t, os_umin = split_curve()
    bdf = BDF(rtol=1e-3, atol=1e-6, dt0=1e-6, max_steps=200000,
              newton=NewtonKrylov(f_tol=1e-10, maxiter=12, inner_m=20, outer_k=5))
    u, q = mems.initial_state(cfg, device=dev)
    rows = []
    t = 0.0
    t0w = time.time()
    total_steps = 0
    for seg in range(segments):
        u, q, res = mems.evolve_coupled(cfg, tf / segments, bdf=bdf, u0=u, q0=q,
                                        device=dev)
        if not res.success:
            raise RuntimeError(f"BDF failed in segment {seg}")
        t += float(res.t)
        total_steps += int(res.steps)
        umin = float(torch.min(u))
        umin_os = float(np.interp(t, os_t, os_umin))
        rows.append({
            "t": t, "u_min_bdf": umin, "u_min_split": umin_os,
            "diff": umin - umin_os, "steps_cum": total_steps,
            "rejected": int(res.rejected), "dt_final": float(res.dt_final),
            "wall_s": round(time.time() - t0w, 1),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows, (u, q)


def main(argv=None) -> dict:
    """Run, write the record, print its summary line; return the summary
    with ``rows`` and ``path``."""
    pos, o = split_args(sys.argv[1:] if argv is None else argv)
    tf = float(pos[0]) if len(pos) > 0 else 0.25
    segments = int(pos[1]) if len(pos) > 1 else 10
    t0w = time.time()
    rows, _ = run(mems.MEMSConfig(), tf, segments, o.get("device", "cuda"))
    summary = {
        "summary": True, "tf": tf, "touchdown_time_measured": 0.312,
        "t_reached": rows[-1]["t"], "u_min_final": rows[-1]["u_min_bdf"],
        "max_abs_diff_vs_split": max(abs(r["diff"]) for r in rows),
        "accepted_steps": rows[-1]["steps_cum"],
        "wall_s": round(time.time() - t0w, 1),
        "note": "Tf=0.4 (PMA.py:36) exceeds the measured touchdown "
                "time t* ~ 0.312; comparison runs toward t* instead.",
    }
    out_dir = pathlib.Path(o.get("out_dir", OUT_DIR))
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "mems_bdf_touchdown.jsonl"
    with open(out, "w") as f:
        f.write(json.dumps(summary) + "\n")
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print(json.dumps(summary))
    return {**summary, "rows": rows, "path": out}


if __name__ == "__main__":
    main()
