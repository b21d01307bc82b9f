"""The reference's flagship experiment, end to end, droplet.py's main()
(port of ``examples/droplet_flagship.py``):

1. quasi-static inflation of two coalescing droplets: 1000 volume steps
   with 20 PMA mesh sub-steps each;
2. 1000 CN/JFNK coalescence steps with the adaptive scale law
   ``scale += exp(-10 ||dU||)`` and 400 PMA sub-steps a step;
3. a per-step effective contact radius ``R_eff = sqrt(A/pi)`` (the wetted
   area on the moving mesh, A = sum 1{u>0.1} |J| dksi deta) beside the
   reference's asymptotic spreading law on the same times.

The base dt is 1e-5 at the reference's 91x61 grid, not its literal 1e-4:
at 1e-4 the first step does not converge even in scipy on the reference's
own fixture; the scale law grows dt from there as the reference intends.
n >= 256 runs the same experiment on an n x n grid with f32 transforms,
the deviation-form mesh, the f32 inner Krylov through the ``droplet_jvp``
kernel and resolution-scaled dt and mesh steps, and splices a sharded
checkpoint (save, reload bit for bit, continue from the reloaded state)
into the middle of the run.

The JAX driver's ``lax.while_loop`` of up to four attempts a step and its
``lax.scan`` over chunks are host loops here taking the same decisions in
Python floats: an attempt is ok when Newton converged and u and q are
finite; the scale is halved before each retry, and after a step whose
every attempt failed (the state is then kept); t advances on success only.
The host reads the ok flag, ``||u_n - u||``, R_eff and the min mesh spacing
once a step.  The configuration comes from the coalescence fixture's file
name alone (the JAX driver reads only its configuration from the file;
the inflation starts from a flat film either way).

Usage:  python -m iterative_solvers_tpu_torch.examples.droplet_flagship
        [n] [steps] [vsteps] [device=cpu] [out_dir=...]
(defaults 0, i.e. the reference's 91x61 grid, 1000, 1000, the GPU, runs/).
Writes ``<out_dir>/flagship_droplet_{tag}.jsonl`` (a summary line, then a
record a step) and prints the summary line; the splice checkpoint goes to
``<out_dir>/flagship_{tag}_splice_ckpt``.
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

from .. import resolve_device, to_numpy
from ..io import checkpoint as ckpt
from ..io import fixtures as fx
from ..models import droplet as dp
from ..ops import curvilinear
from ..solvers.newton import NewtonKrylov
from . import OUT_DIR, split_args
from .droplet_longrun import DROPS, FIXTURE, effective_radius

MAX_ATTEMPTS = 4
INFLATE_CHUNK = 50       # volume steps a call at n >= 2048


@dataclasses.dataclass(frozen=True)
class Setup:
    """The run's configuration and its dt and mesh-step laws."""

    n: int
    tag: str
    cfg: dp.DropletConfig
    dt: float            # the base dt; the scale law multiplies it
    dtmesh_inf: float    # the inflation's PMA step
    dtmesh_ev: float     # the evolve's PMA step
    pma_loops: int       # the evolve's PMA sub-steps a step
    norm_scale: float    # the scale law's per-dof normalisation of ||dU||

    @property
    def deviation_form(self) -> bool:
        return self.n > 0

    @property
    def geometry_fn(self):
        return (curvilinear.mesh_geometry_dev if self.deviation_form
                else curvilinear.mesh_geometry)

    def geometry(self, q):
        return self.geometry_fn(q, self.cfg.grid)

    def solver(self) -> NewtonKrylov:
        if not self.deviation_form:
            return dp.fast_solver()
        return NewtonKrylov(f_tol=1e-5, maxiter=14, inner_m=12, outer_k=6,
                            inner_dtype="float32", max_backtracks=4)

    def initial_q(self, dev):
        if not self.deviation_form:
            return dp.initial_mesh_potential(self.cfg, torch.float64, dev)
        return torch.zeros(self.cfg.grid.shape, dtype=torch.float64, device=dev)


def setup(n: int) -> Setup:
    """The JAX driver's settings for ``n`` (0: the reference's 91x61)."""
    base = fx.config_for(fx.parse_name(FIXTURE))
    if n == 0:
        # inflation: the reference's exact dtmesh (parity with its own
        # fixture); evolve: the reference's 3e-9 is tuned to dt = 1e-4, so
        # 3e-10 keeps its mesh-pseudo-time : physical-time ratio at 1e-5
        return Setup(n=0, tag="91x61", cfg=base, dt=1e-5, dtmesh_inf=5e-9,
                     dtmesh_ev=3e-10, pma_loops=400, norm_scale=1.0)
    # f32 transforms: "high" at n >= 2048 is the JAX package's 3-pass MXU
    # product; the port computes it in full f32 either way
    cfg = dataclasses.replace(base, nx=n, ny=n, spectral_dtype="float32",
                              mesh_dtype="float32",
                              spectral_precision="high" if n >= 2048 else "highest")
    # inflation: the explicit PMA step scaled with the resolution (the
    # monitor |lap u|^2 grows as the 1/a interface resolves); evolve: keep
    # the 91x61 run's mesh pseudo-time per physical step, 1.2e-2 dt, spent
    # in 400 sub-steps up to 1024^2 and in 50 larger ones above
    dtmesh_inf = 1e-11 * min(1.0, (1024.0 / n) ** 2)
    pma_loops = 400 if n <= 1024 else 50
    dt = 1e-9 * min(1.0, 2048.0 / n)
    dtmesh_ev = 1.2e-2 * dt / pma_loops
    if not dtmesh_ev < dtmesh_inf:
        raise ValueError("dtmesh stability margin: the evolve's PMA step "
                         f"{dtmesh_ev} is not below the inflation's {dtmesh_inf}")
    return Setup(n=n, tag=f"{n}sq", cfg=cfg, dt=dt, dtmesh_inf=dtmesh_inf,
                 dtmesh_ev=dtmesh_ev, pma_loops=pma_loops,
                 norm_scale=float(np.sqrt(5551.0 / (n * n))))


def inflate(s: Setup, vsteps: int, device="cuda", chunk: int | None = None):
    """The quasi-static inflation (``vsteps`` volume steps of 20 PMA
    sub-steps) in calls of ``chunk`` volume steps: by default 50 at
    n >= 2048 and all of them in one call below.  Returns ``(q, u,
    min_jac)``; raises if the mesh tangled."""
    if chunk is None:
        chunk = INFLATE_CHUNK if s.n >= 2048 else vsteps
    if vsteps % chunk:
        raise ValueError(f"vsteps {vsteps} is not a multiple of {chunk}")
    dev = resolve_device(device)
    q, u = s.initial_q(dev), None
    for s0 in range(0, vsteps, chunk):
        q, u = dp.inflate(s.cfg, DROPS, vsteps=vsteps, dtmesh=s.dtmesh_inf, pma_loops=20,
                          q0=q, geometry_fn=s.geometry_fn, start=s0, count=chunk,
                          u_prev=u, device=dev)
    min_jac = float(torch.min(s.geometry(q).jac))
    if not min_jac > 0:
        raise RuntimeError("mesh tangled during inflation")
    return q, u, min_jac


class Carry(NamedTuple):
    u: torch.Tensor
    q: torch.Tensor
    scale: float
    t: float


def advance(step, c: Carry, s: Setup):
    """One step of the JAX driver's body: up to MAX_ATTEMPTS tries, the
    scale halved before each retry; on success the scale law, else the
    state kept and the scale halved.  Returns the new carry and the step's
    record."""
    sc, k, ok, out = c.scale, 0, False, None
    while not ok and k < MAX_ATTEMPTS:
        if k > 0:
            sc *= 0.5
        out = step(c.u, c.q, s.dt * sc)
        ok = bool(out.converged and torch.isfinite(out.u).all()
                  and torch.isfinite(out.q).all())
        k += 1
    dt_n = s.dt * sc
    u_n, q_n = (out.u, out.q) if ok else (c.u, c.q)
    geom = s.geometry(q_n)
    grid = s.cfg.grid
    if ok:
        norm = torch.sqrt(torch.sum((u_n - c.u) ** 2)).item()
        scale = sc + float(np.exp(-10.0 * s.norm_scale * norm))
    else:
        scale = sc * 0.5
    t = c.t + (dt_n if ok else 0.0)
    rec = {"t": t, "dt": dt_n, "newton_iters": int(out.newton_iters),
           "f_norm": float(out.f_norm), "converged": ok,
           "r_eff": float(effective_radius(u_n, geom.jac, grid.dx, grid.dy)),
           "min_spacing": float(dp.min_spacing(geom))}
    return Carry(u=u_n, q=q_n, scale=scale, t=t), rec


def splice(s: Setup, c: Carry, step_no: int, ck_dir: pathlib.Path, dev) -> tuple:
    """Save the run state as a sharded checkpoint and reload it; raises
    unless the reload equals the state bit for bit (compared on the host).
    Returns the carry on the reloaded tensors and the splice's record."""
    t0 = time.time()
    ckpt.save_sharded(ck_dir, {"u": c.u, "q": c.q}, config=s.cfg, step=step_no, time=c.t)
    loaded, meta = ckpt.load_sharded(ck_dir, {"u": dev, "q": dev}, config=s.cfg)
    du = float(np.abs(to_numpy(loaded["u"]) - to_numpy(c.u)).max())
    dq = float(np.abs(to_numpy(loaded["q"]) - to_numpy(c.q)).max())
    if du != 0.0 or dq != 0.0:
        raise RuntimeError(f"checkpoint splice round-trip mismatch (du={du}, dq={dq})")
    rec = {"step": step_no, "meta_step": meta["step"], "du": du, "dq": dq,
           "seconds": time.time() - t0, "path": str(ck_dir)}
    return c._replace(u=loaded["u"], q=loaded["q"]), rec


def evolve(s: Setup, u, q, steps: int, chunk: int, device="cuda",
           pma_loops: int | None = None, out_dir=OUT_DIR):
    """``steps`` steps in chunks of ``chunk`` from ``(u, q)``, scale 1 and
    t = 0, with the splice after the middle chunk at n >= 256.
    ``pma_loops`` cuts the PMA sub-steps a step (the mesh step stays
    ``s.dtmesh_ev``).  Returns ``(records, carry, splice record or None)``."""
    dev = resolve_device(device)
    if steps % chunk:
        raise ValueError(f"steps {steps} is not a multiple of the chunk {chunk}")
    step = dp.make_step(s.cfg, dt=s.dt, dtmesh=s.dtmesh_ev,
                        pma_loops=s.pma_loops if pma_loops is None else pma_loops,
                        solver=s.solver(), device=dev,
                        **({"jvp_dtype": "float32", "jvp_kernel": True,
                            "deviation_form": True} if s.deviation_form else {}))
    c = Carry(u=torch.as_tensor(u, device=dev), q=torch.as_tensor(q, device=dev),
              scale=1.0, t=0.0)
    nchunks = steps // chunk
    splice_at = nchunks // 2 if s.n >= 256 else -1
    records, spliced = [], None
    for ci in range(nchunks):
        for _ in range(chunk):
            c, rec = advance(step, c, s)
            records.append({"step": len(records) + 1, **rec})
        print(f"  chunk {ci + 1}/{nchunks}: t={c.t:.3e} scale={c.scale:.1f}", flush=True)
        if ci + 1 == splice_at:
            ck_dir = pathlib.Path(out_dir) / f"flagship_{s.tag}_splice_ckpt"
            c, spliced = splice(s, c, (ci + 1) * chunk, ck_dir, dev)
            print(f"  [splice] sharded save+restore at step {spliced['step']}: "
                  f"bitwise OK ({spliced['seconds']:.1f}s)", flush=True)
    return records, c, spliced


def chunk_for(n: int, steps: int) -> int:
    """The JAX driver's chunk of steps."""
    return min(steps, 100 if n == 0 else (25 if n <= 1024 else 10))


def summarize(s: Setup, records: list, c: Carry, vsteps: int, steps: int,
              t_inflate: float, t_evolve: float) -> tuple[dict, np.ndarray]:
    """The summary line and the asymptotic radius on the run's times."""
    reffs = np.array([r["r_eff"] for r in records])
    times = np.concatenate(([0.0], [r["t"] for r in records]))
    r_asym = dp.asymptotic_radius_trajectory(s.cfg, float(reffs[0]), times)[1:]
    conv = np.array([r["converged"] for r in records])
    summary = {
        "summary": True, "tag": s.tag, "vsteps": vsteps, "steps": steps,
        "dt_base": s.dt, "inflate_s": round(t_inflate, 1),
        "evolve_s": round(t_evolve, 1),
        "ms_per_step": round(1000 * t_evolve / steps, 1),
        "all_converged": bool(conv.all()),
        "n_converged": int(conv.sum()),
        "final_scale": c.scale, "final_time": c.t,
        "r_eff_first": float(reffs[0]), "r_eff_final": float(reffs[-1]),
        "r_asym_final": float(r_asym[-1]),
        "max_fnorm": max(r["f_norm"] for r in records),
    }
    return summary, r_asym


def write_record(path: pathlib.Path, summary: dict, records: list, r_asym) -> None:
    """The JAX driver's record: the summary line, then one line a step."""
    with open(path, "w") as f:
        f.write(json.dumps(summary) + "\n")
        for r, ra in zip(records, r_asym):
            f.write(json.dumps({
                "step": r["step"], "t": r["t"], "dt": r["dt"],
                "newton_iters": r["newton_iters"], "f_norm": r["f_norm"],
                "converged": r["converged"], "r_eff": r["r_eff"],
                "r_asymptotic": float(ra), "min_spacing": r["min_spacing"],
            }) + "\n")


def main(argv=None) -> dict:
    """The whole experiment; returns the summary with ``records``,
    ``splice``, ``path`` and the final ``u`` and ``q``."""
    pos, o = split_args(sys.argv[1:] if argv is None else argv)
    n = int(pos[0]) if len(pos) > 0 else 0
    steps = int(pos[1]) if len(pos) > 1 else 1000
    vsteps = int(pos[2]) if len(pos) > 2 else 1000
    dev = resolve_device(o.get("device", "cuda"))
    out_dir = pathlib.Path(o.get("out_dir", OUT_DIR))
    out_dir.mkdir(parents=True, exist_ok=True)
    s = setup(n)

    print(f"[{s.tag}] running inflation ({vsteps} vsteps)...", flush=True)
    t0 = time.time()
    q, u, min_jac = inflate(s, vsteps, dev)
    t_inflate = time.time() - t0
    print(f"[{s.tag}] inflation {vsteps} vsteps: {t_inflate:.1f}s "
          f"(min J = {min_jac:.3f})", flush=True)

    t0 = time.time()
    records, c, spliced = evolve(s, u, q, steps, chunk_for(n, steps), dev,
                                 out_dir=out_dir)
    t_evolve = time.time() - t0
    summary, r_asym = summarize(s, records, c, vsteps, steps, t_inflate, t_evolve)
    path = out_dir / f"flagship_droplet_{s.tag}.jsonl"
    write_record(path, summary, records, r_asym)
    print(json.dumps(summary))
    print(f"wrote {path}", flush=True)
    return {**summary, "records": records, "splice": spliced, "path": path,
            "u": c.u, "q": c.q}


if __name__ == "__main__":
    main()
