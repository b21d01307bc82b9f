#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives ``iterative_solvers_tpu_torch`` only (no JAX), on the card:

1. device   — card name and power limit; TF32 off for f32 matmuls.
2. build    — compiles the CUDA kernels from ``iterative_solvers_tpu_torch/ops/csrc``.
3. prepare  — the 1024^2 state as the large-grid example prepares it: the
              91x61 coalescence fixture upsampled, deviation-form mesh,
              3 x 60 f32 PMA sweeps at dtmesh 1e-10, drops re-seeded.
4. kernel   — each kernel against its plain PyTorch version on the same
              inputs (the 91x61 fixture and the prepared 1024^2 state):
              max|kernel - plain| <= 1e-5 max|plain|; CUDA-event times.
5. step91   — the 91x61 f64 FD step against ``golden_droplet_step.npz``
              (u 1e-6, q 1e-8), then the f32 kernel-mode step (converged,
              Newton count within 1, u within 5e-7 of the FD step).
6. step1024 — the main path: the 1024^2 moving-mesh JFNK step with the
              fused JVP kernel, at dt 1e-9 and then at dt 5e-8 (each one
              warm-up step and 3 timed steps); kernel launch counts read
              around that run; CUDA-event time of the kernel, the residual
              evaluations, the stack builds and the PMA loop in each step.

Each phase prints one JSON line; any failed check exits non-zero.  The
last lines are the kernel list, the ``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N = 1024
DT = 1e-9          # the large-grid example's first step
DT_MAIN = 5e-8     # where the long-run controller is after ~20 steps
DROPS = [(0.0, 0.0, 1.0, 1.0), (3.0, 0.0, 1.0, 1.0)]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# f32 operations of the linearised chain per grid point, counted from
# ops/droplet_jvp.py::jvp_apply_ref: metric coefficients 12, v_ksi/v_eta 12,
# two conservative fluxes 80, cross terms 14, dp 8, grad dp 12, dpx/dpy 8,
# dA/dB 6, their four d1 24, dF2 and the output 9
JVP_FLOP_PER_POINT = 185
JVP_FIELDS_MOVED = 10          # v + 8 stack fields read once, out written once


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` launches."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


class Spans:
    """CUDA-event spans around named functions of a module: while active,
    each call of ``module.<name>`` records the stream time between its
    start and end.  ``take()`` returns ``{name: [calls, ms]}`` and resets."""

    def __init__(self, module, names):
        self.module = module
        self.orig = {n: getattr(module, n) for n in names}
        self.events = {n: [] for n in names}

    def _wrap(self, name, fn):
        import torch

        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.events[name].append((a, b))
            return out
        return timed

    def __enter__(self):
        for n, fn in self.orig.items():
            setattr(self.module, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)

    def take(self):
        out = {n: [len(ev), sum(a.elapsed_time(b) for a, b in ev)]
               for n, ev in self.events.items()}
        for ev in self.events.values():
            ev.clear()
        return out


def prepare_large(n: int, dev):
    """The large-grid state preparation (the JAX package's
    examples/large_scale_droplet.py::prepare) on the port."""
    import torch
    from iterative_solvers_tpu_torch.io import fixtures as fx
    from iterative_solvers_tpu_torch.meshmove.pma import loop_pma
    from iterative_solvers_tpu_torch.models import droplet as dp
    from iterative_solvers_tpu_torch.ops import curvilinear

    fix, _ = fx.load_golden_step()
    big = fx.upsample(fix, n, n)
    cfg = dataclasses.replace(fx.config_for(big), spectral_dtype="float32",
                              mesh_dtype="float32")
    dtmesh = 1e-10 * min(1.0, (1024.0 / n) ** 2)
    phi = curvilinear.to_deviation(torch.tensor(big.q, device=dev), cfg.grid)
    for _ in range(3):
        geom = curvilinear.mesh_geometry_dev(phi, cfg.grid)
        u = dp.seeded_solution(geom, cfg, DROPS)
        phi = loop_pma(phi, u, dtmesh, 60, cfg.grid, cfg.pma,
                       dp.monitor_source, curvilinear.mesh_geometry_dev)
    geom = curvilinear.mesh_geometry_dev(phi, cfg.grid)
    u = dp.seeded_solution(geom, cfg, DROPS)
    return cfg, u, phi, dtmesh, float(torch.min(geom.jac))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from iterative_solvers_tpu_torch import resolve_device
    from iterative_solvers_tpu_torch.io import fixtures as fx
    from iterative_solvers_tpu_torch.models import droplet as dp
    from iterative_solvers_tpu_torch.ops import _build, curvilinear
    from iterative_solvers_tpu_torch.ops.droplet_jvp import jvp_apply_ref, jvp_matvec
    from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov

    # -- 1. device ---------------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on for f32 matmuls")
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library("droplet_jvp")
    emit({"phase": "build", "kernels": ["droplet_jvp"],
          "seconds": time.perf_counter() - t0})

    # -- 3. prepare the 1024^2 state ----------------------------------------
    t0 = time.perf_counter()
    cfg_l, u_l, phi_l, dtmesh_l, min_jac = prepare_large(N, dev)
    torch.cuda.synchronize()
    check(min_jac > 0, f"mesh tangled during preparation: min jac {min_jac}")
    emit({"phase": "prepare", "n": N, "seconds": time.perf_counter() - t0,
          "min_jac": min_jac, "dtmesh": dtmesh_l})

    # -- 4. kernel vs plain ---------------------------------------------------
    fix, golden = fx.load_golden_step()
    cfg_s = fx.config_for(fix)
    u_s = torch.tensor(fix.u, device=dev)
    q_s = torch.tensor(fix.q, device=dev)
    kstats = {}
    for label, cfg, u, q, geom_fn, dt in (
            ("91x61", cfg_s, u_s, q_s, curvilinear.mesh_geometry, 1e-5),
            (f"{N}x{N}", cfg_l, u_l, phi_l, curvilinear.mesh_geometry_dev, DT_MAIN)):
        grid = cfg.grid
        geom32 = curvilinear.MeshGeometry(*(a.float() for a in geom_fn(q, grid)))
        stack = dp.jvp_field_stack(u.float(), geom32, cfg,
                                   torch.tensor(dt, dtype=torch.float32, device=dev))
        gen = torch.Generator(device=dev).manual_seed(7)
        v = torch.randn(grid.shape, generator=gen, device=dev, dtype=torch.float32)
        plain = jvp_apply_ref(v, stack, grid)
        got = jvp_matvec(v, stack, grid)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        scale = float(plain.abs().max())
        check(bool(torch.isfinite(got).all()), f"droplet_jvp {label}: non-finite output")
        check(err <= 1e-5 * scale,
              f"droplet_jvp {label}: max err {err} > 1e-5 x {scale}")
        ms = cuda_ms(lambda: jvp_matvec(v, stack, grid))
        plain_ms = cuda_ms(lambda: jvp_apply_ref(v, stack, grid))
        npts = grid.nx * grid.ny
        bytes_ms = JVP_FIELDS_MOVED * 4 * npts / HBM_BYTES_PER_S * 1e3
        ops_ms = JVP_FLOP_PER_POINT * npts / F32_FLOP_PER_S * 1e3
        kstats[label] = dict(max_abs_err=err, scale=scale, ms=ms, plain_ms=plain_ms,
                             bound_ms=max(bytes_ms, ops_ms),
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        emit({"phase": "kernel", "name": "droplet_jvp", "shape": [grid.ny, grid.nx],
              **kstats[label]})

    # -- 5. 91x61 step parity -------------------------------------------------
    dt_s = float(golden["dt"])
    t0 = time.perf_counter()
    out_fd = dp.make_step(cfg_s, dt=dt_s, dtmesh=3e-9, pma_loops=5)(u_s, q_s, dt_s)
    torch.cuda.synchronize()
    t_fd = time.perf_counter() - t0
    err_u = float((out_fd.u.cpu() - torch.tensor(golden["u_new"])).abs().max())
    err_q = float((out_fd.q.cpu() - torch.tensor(golden["q_new"])).abs().max())
    check(out_fd.converged, "91x61 FD step did not converge")
    check(err_u <= 1e-6, f"91x61 FD step: u off the golden step by {err_u}")
    check(err_q <= 1e-8, f"91x61 FD step: q off the golden step by {err_q}")
    jvp_matvec.launches = 0
    t0 = time.perf_counter()
    out_k = dp.make_step(cfg_s, dt=dt_s, dtmesh=3e-9, pma_loops=5,
                         jvp_dtype="float32", jvp_kernel=True)(u_s, q_s, dt_s)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches_s = jvp_matvec.launches
    err_k = float((out_k.u - out_fd.u).abs().max())
    check(out_k.converged, "91x61 kernel-mode step did not converge")
    check(abs(out_k.newton_iters - out_fd.newton_iters) <= 1,
          f"91x61 Newton counts {out_k.newton_iters} vs {out_fd.newton_iters}")
    check(err_k <= 5e-7, f"91x61 kernel-mode u off the FD step by {err_k}")
    check(launches_s > 0, "91x61 kernel-mode step launched no droplet_jvp kernel")
    emit({"phase": "step91", "fd": {"converged": out_fd.converged,
                                    "newton_iters": out_fd.newton_iters,
                                    "f_norm": out_fd.f_norm, "err_u_golden": err_u,
                                    "err_q_golden": err_q, "seconds": t_fd},
          "kernel_mode": {"converged": out_k.converged,
                          "newton_iters": out_k.newton_iters,
                          "f_norm": out_k.f_norm, "err_u_vs_fd": err_k,
                          "launches": launches_s, "seconds": t_k}})

    # -- 6. the 1024^2 main path ---------------------------------------------
    # The large-grid solver and step settings.  At dt = 1e-9 (the
    # large-grid example's first step) the initial residual is already
    # below f_tol and Newton takes no iteration, so the kernel is not
    # reached; DT_MAIN = 5e-8 is the dt the adaptive long-run controller
    # reaches within ~20 steps, where Newton takes several iterations.
    solver = NewtonKrylov(f_tol=1e-5, maxiter=14, inner_m=12, outer_k=6,
                          inner_dtype="float32", max_backtracks=4)
    step = dp.make_step(cfg_l, dt=DT, dtmesh=dtmesh_l, pma_loops=20,
                        solver=solver, deviation_form=True,
                        jvp_dtype="float32", jvp_kernel=True)
    spans = Spans(dp, ["jvp_matvec", "cn_residual", "jvp_field_stack", "loop_pma"])
    summaries = {}
    u, phi = u_l, phi_l
    jvp_matvec.launches = 0
    with spans:
        for dt in (DT, DT_MAIN):
            recs = []
            for k in range(4):  # one warm-up step, then 3 timed
                before = jvp_matvec.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(u, phi, dt)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3
                split = spans.take()
                rec = {"dt": dt, "step": k, "warmup": k == 0, "step_ms": step_ms,
                       "newton_iters": out.newton_iters, "f_norm": out.f_norm,
                       "converged": out.converged,
                       "launches": jvp_matvec.launches - before,
                       "calls_ms": split,
                       "kernel_share": split["jvp_matvec"][1] / step_ms}
                recs.append(rec)
                emit({"phase": "step1024", **rec})
                check(out.converged, f"{N}^2 step at dt {dt} did not converge: f_norm "
                      f"{out.f_norm} after {out.newton_iters} Newton iterations")
                u, phi = out.u, out.q
            summaries[dt] = recs[1:]
    launches_main = jvp_matvec.launches
    geom = curvilinear.mesh_geometry_dev(phi, cfg_l.grid)
    min_jac = float(torch.min(geom.jac))
    check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(phi).all()),
          f"{N}^2 state not finite")
    check(min_jac > 0, f"{N}^2 mesh tangled: min jac {min_jac}")
    check(launches_main > 0, "the main path launched no droplet_jvp kernel")
    check(all(r["launches"] > 0 for r in summaries[DT_MAIN]),
          f"a {N}^2 step at dt {DT_MAIN} launched no droplet_jvp kernel")
    for dt, timed in summaries.items():
        med = sorted(r["step_ms"] for r in timed)[len(timed) // 2]
        emit({"phase": "step1024_summary", "n": N, "dt": dt,
              "step_ms_median": med,
              "newton_iters": [r["newton_iters"] for r in timed],
              "f_norm": [r["f_norm"] for r in timed],
              "converged": [r["converged"] for r in timed],
              "launches_per_step": [r["launches"] for r in timed],
              "kernel_share": [r["kernel_share"] for r in timed]})
    emit({"phase": "step1024_final", "launches": launches_main, "min_jac": min_jac,
          "min_spacing": float(dp.min_spacing(geom))})

    big = kstats[f"{N}x{N}"]
    emit({"kernels": [{
        "name": "droplet_jvp", "route": "cuda",
        "source": "iterative_solvers_tpu_torch/ops/csrc/droplet_jvp.cu",
        "replaces": "iterative_solvers_tpu/ops/pallas_droplet.py:534",
        "launches": launches_main, "max_abs_err": big["max_abs_err"],
        "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "library_ms": None}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
