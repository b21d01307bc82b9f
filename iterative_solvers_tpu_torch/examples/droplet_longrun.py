"""Large-grid droplet coalescence into the physically meaningful regime
(port of ``examples/droplet_longrun.py``).

The reference's *additive* dt law (``scale += exp(-10||dU||)``) grows dt
by at most the base dt a step, so at the resolution-scaled base dt = 1e-9
the t ~ 0.01-0.1 regime where the drops spread is ~1e7 steps away.  This
driver uses a multiplicative controller instead:

    on success:  dt <- dt * growth(newton_iters)   (``growth`` when the
                 Newton count is at most half of ``maxiter``, halfway to 1
                 up to three quarters, hold above)
    on failure:  retry the step at dt/2 (up to 4 attempts), and start the
                 next step from the last dt that worked

as a host loop taking the JAX package's decisions.  The Newton initial
guess extrapolates the converged trajectory (``u + r (u - u_prev)``,
``r = dt / dt_prev``, clamped above a quarter of the precursor film).  The
mesh pseudo-step scales with the running dt (capped at the explicit
stability bound) to hold the mesh-pseudo-time : physical-time ratio
(1.2e-2 * dt a step across ``pma_loops`` sub-steps).

Runs in chunks of steps, each followed by a JSONL record a step, a
sharded checkpoint (``io.checkpoint.save_sharded``) and ``carry.json``
(step, t, dt); a run resumes from the newest checkpoint.  Like the JAX
package's, the checkpoint holds ``u`` and ``q`` only, so a resumed run
starts its first Newton solve without the extrapolated guess.

Usage:
  python -m iterative_solvers_tpu_torch.examples.droplet_longrun
      [n] [max_steps] [key=val ...]
    keys: chunk, dt0, dt_max, growth, f_tol, maxiter, inner_m, outer_k,
          inner_maxiter, pma_loops, t_stop, r_stop, monitor_cap (0 = off),
          dfres (1 = two-f32 outer residuals),
          fresh (1 = ignore an existing checkpoint), tag,
          from_tag (resume from another tag's checkpoint without touching
          it — pair with save=0), save (0 = no checkpoint/jsonl writes),
          out_dir (default: runs/ in the repository, git-ignored),
          device (default cuda)
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..io import checkpoint as ckpt
from ..io import fixtures as fx
from ..models import droplet as dp
from ..ops import curvilinear
from ..solvers.newton import NewtonKrylov
from . import OUT_DIR, split_args

DROPS = [(0.0, 0.0, 1.0, 1.0), (3.0, 0.0, 1.0, 1.0)]
H_WET = 0.1
FIXTURE = "initdrop_coal_1_91-61_100_0.005_0.01_0.1_0.15.txt"
PSEUDO_RATIO = 1.2e-2    # mesh pseudo-time : physical time, from the 91x61 run
MAX_ATTEMPTS = 4


def effective_radius(u, jac, dx, dy):
    area = torch.sum((u > H_WET) * torch.abs(jac)) * dx * dy
    return torch.sqrt(area / np.pi)


def longrun_config(n: int, o: dict):
    """The run's DropletConfig: the coalescence fixture's physics on an
    n² grid, f32 PMA transforms and sub-loop, the monitor cap."""
    mcap = float(o.get("monitor_cap", 15.0))
    return dataclasses.replace(
        fx.config_for(fx.parse_name(FIXTURE)), nx=n, ny=n,
        spectral_dtype="float32", mesh_dtype="float32",
        spectral_precision=("high" if n >= 2048 else "highest"),
        monitor_cap=(mcap if mcap > 0 else None))


class Carry(NamedTuple):
    u: torch.Tensor
    q: torch.Tensor
    dt: float          # the next step's first dt
    t: float
    u_prev: torch.Tensor
    dt_prev: float     # 0: no history (first step, or resumed)


@dataclasses.dataclass(frozen=True)
class Controller:
    """The dt controller's constants."""

    maxiter: int             # the Newton solver's
    growth: float = 1.25
    dt_max: float = 2e-3
    pma_loops: int = 400
    dtmesh_cap: float = 1e-11
    epsilon: float = 0.005   # precursor film: the guess's floor is a quarter

    def growth_factor(self, newton_iters: int) -> float:
        if newton_iters <= self.maxiter // 2:
            return self.growth
        if newton_iters <= (3 * self.maxiter) // 4:
            return (1.0 + self.growth) / 2.0
        return 1.0

    def mesh_dt(self, dt: float) -> float:
        return min(PSEUDO_RATIO * dt / self.pma_loops, self.dtmesh_cap)

    def next_dt(self, ok: bool, dt_used: float, newton_iters: int) -> float:
        g = self.growth_factor(newton_iters)
        return float(np.clip(dt_used * g if ok else dt_used, 1e-12, self.dt_max))

    def guess(self, c: Carry, dt: float):
        r = dt / max(c.dt_prev, 1e-300) if c.dt_prev > 0 else 0.0
        return torch.clamp_min(c.u + r * (c.u - c.u_prev), 0.25 * self.epsilon)


def advance(step, c: Carry, ctl: Controller, grid):
    """One controlled step: up to MAX_ATTEMPTS tries, halving dt after a
    failed one (not converged, or a non-finite state).  Returns the new
    carry and the step's record."""
    dtk, k, ok, out = c.dt, 0, False, None
    while not ok and k < MAX_ATTEMPTS:
        if k > 0:
            dtk *= 0.5
        out = step(c.u, c.q, dtk, ctl.mesh_dt(dtk), x0=ctl.guess(c, dtk))
        ok = bool(out.converged and torch.isfinite(out.u).all()
                  and torch.isfinite(out.q).all())
        k += 1
    u_n, q_n = (out.u, out.q) if ok else (c.u, c.q)
    geom = curvilinear.mesh_geometry_dev(q_n, grid)
    t_n = c.t + (dtk if ok else 0.0)
    rec = {"newton_iters": out.newton_iters, "f_norm": float(out.f_norm),
           "converged": ok, "attempts": k, "dt": dtk, "t": t_n,
           "r_eff": float(effective_radius(u_n, geom.jac, grid.dx, grid.dy)),
           "min_spacing": float(dp.min_spacing(geom))}
    carry = Carry(u=u_n, q=q_n, dt=ctl.next_dt(ok, dtk, out.newton_iters), t=t_n,
                  u_prev=c.u if ok else c.u_prev, dt_prev=dtk if ok else c.dt_prev)
    return carry, rec


def save_chunk(ck_dir: pathlib.Path, cfg, u, q, step: int, t: float, dt: float,
               wall_s: float = 0.0) -> None:
    """The restart point: ``u`` and ``q`` (``save_sharded``) and
    ``carry.json`` (step, t, dt)."""
    ckpt.save_sharded(ck_dir, {"u": u, "q": q}, config=cfg, step=step, time=t)
    (ck_dir / "carry.json").write_text(json.dumps(
        {"step": step, "t": t, "dt": dt, "wall_s_total": wall_s}))


def inflate(cfg, n: int, dtmesh: float, dev):
    """The quasi-static inflation (1000 volume steps of 20 PMA sub-steps
    from the identity mesh), in chunks of 50 volume steps at n >= 2048."""
    vsteps = 1000
    q = torch.zeros(cfg.grid.shape, dtype=torch.float64, device=dev)
    kw = dict(vsteps=vsteps, dtmesh=dtmesh, pma_loops=20,
              geometry_fn=curvilinear.mesh_geometry_dev, device=dev)
    if n < 2048:
        return dp.inflate(cfg, DROPS, q0=q, **kw)
    u = torch.full(cfg.grid.shape, cfg.epsilon, dtype=torch.float64, device=dev)
    for s0 in range(0, vsteps, 50):
        q, u = dp.inflate(cfg, DROPS, q0=q, start=s0, count=50, u_prev=u, **kw)
    return q, u


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1024
    max_steps = int(argv[1]) if len(argv) > 1 else 100000
    o = split_args(argv[2:])[1]
    tag = o.get("tag", f"{n}sq")
    dev = resolve_device(o.get("device", "cuda"))

    cfg = longrun_config(n, o)
    grid = cfg.grid
    dt0 = float(o.get("dt0", 1e-9 * min(1.0, 2048.0 / n)))
    t_stop = float(o.get("t_stop", 0.05))
    r_stop = float(o.get("r_stop", 1.6))
    chunk = int(o.get("chunk", 25))
    dtmesh_cap = 1e-11 * min(1.0, (1024.0 / n) ** 2)
    solver = NewtonKrylov(
        f_tol=float(o.get("f_tol", 1e-5)),
        maxiter=int(o.get("maxiter", 20)),
        inner_m=int(o.get("inner_m", 12)),
        outer_k=int(o.get("outer_k", 6)),
        inner_maxiter=int(o.get("inner_maxiter", 1)),
        inner_dtype="float32", max_backtracks=4)
    ctl = Controller(maxiter=solver.maxiter, growth=float(o.get("growth", 1.25)),
                     dt_max=float(o.get("dt_max", 2e-3)),
                     pma_loops=int(o.get("pma_loops", 400 if n <= 1024 else 50)),
                     dtmesh_cap=dtmesh_cap, epsilon=cfg.epsilon)
    step = dp.make_step(
        cfg, dt=dt0, dtmesh=dtmesh_cap, pma_loops=ctl.pma_loops, solver=solver,
        deviation_form=True, jvp_dtype="float32", jvp_kernel=True,
        residual_mode="df64" if o.get("dfres", "0") == "1" else "f64", device=dev)

    out_dir = pathlib.Path(o.get("out_dir", OUT_DIR))
    out_dir.mkdir(parents=True, exist_ok=True)
    ck_dir = out_dir / f"longrun_{o.get('from_tag', tag)}_ckpt"
    side = ck_dir / "carry.json"
    out_path = out_dir / f"longrun_droplet_{tag}.jsonl"
    fresh = o.get("fresh", "0") == "1"
    save = o.get("save", "1") == "1"

    if side.exists() and not fresh:
        loaded, _ = ckpt.load_sharded(ck_dir, {"u": dev, "q": dev}, config=cfg)
        u, q = loaded["u"], loaded["q"]
        sc = json.loads(side.read_text())
        t, dt, step0 = sc["t"], sc["dt"], sc["step"]
        print(f"[{tag}] resumed at step {step0}, t={t:.3e}, dt={dt:.3e}", flush=True)
    else:
        t0 = time.time()
        q, u = inflate(cfg, n, dtmesh_cap, dev)
        min_j = float(torch.min(curvilinear.mesh_geometry_dev(q, grid).jac))
        if not min_j > 0:
            raise RuntimeError("mesh tangled during inflation")
        print(f"[{tag}] inflation 1000 vsteps: {time.time() - t0:.1f}s "
              f"(min J = {min_j:.3f})", flush=True)
        t, dt, step0 = 0.0, dt0, 0
        if save:
            out_path.write_text("")  # truncate the jsonl for a fresh run

    carry = Carry(u=u, q=q, dt=dt, t=t, u_prev=u, dt_prev=0.0)
    t_wall = time.time()
    steps_done = step0
    records = []
    while steps_done < max_steps:
        tc0 = time.time()
        recs = []
        for i in range(chunk):
            carry, rec = advance(step, carry, ctl, grid)
            recs.append({"step": steps_done + i + 1, **rec})
        tc = time.time() - tc0
        records += recs
        steps_done += chunk
        if save:
            with open(out_path, "a") as f:
                f.writelines(json.dumps(r) + "\n" for r in recs)
            save_chunk(ck_dir, cfg, carry.u, carry.q, steps_done, carry.t,
                       carry.dt, time.time() - t_wall)
        last = recs[-1]
        print(f"[{tag}] step {steps_done}: t={carry.t:.4e} dt={carry.dt:.3e} "
              f"r_eff={last['r_eff']:.5f} iters={last['newton_iters']} "
              f"conv={sum(r['converged'] for r in recs)}/{chunk} "
              f"({tc:.1f}s/chunk)", flush=True)
        if carry.t >= t_stop or last["r_eff"] >= r_stop:
            print(f"[{tag}] stop condition reached", flush=True)
            break
    line = {"tag": tag, "steps": steps_done, "t": carry.t, "dt": carry.dt,
            "wall_s": round(time.time() - t_wall, 1)}
    print(json.dumps(line), flush=True)
    return {**line, "records": records, "u": carry.u, "q": carry.q}


if __name__ == "__main__":
    main()
