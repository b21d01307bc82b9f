#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives ``iterative_solvers_tpu_torch`` only (no JAX), on the card:

 1. device      — card name and power limit; TF32 off for f32 matmuls.
 2. build       — compiles every CUDA source of
                  ``iterative_solvers_tpu_torch/ops/csrc`` into one library.
 3. prepare     — the 1024^2 droplet state as the large-grid example
                  prepares it: the 91x61 coalescence fixture upsampled,
                  deviation-form mesh, 3 x 60 f32 PMA sweeps at dtmesh
                  1e-10, drops re-seeded.
 4. kernel      — the droplet JVP kernel against its plain PyTorch version
                  on the same inputs (the 91x61 fixture and the prepared
                  1024^2 state): max|kernel - plain| <= 1e-5 max|plain|;
                  CUDA-event times per call over back-to-back batches.
 5. step91      — the 91x61 f64 FD step against ``golden_droplet_step.npz``
                  (u 1e-6, q 1e-8), then the f32 kernel-mode step (converged,
                  Newton count within 1, u within 5e-7 of the FD step).
 6. step1024    — the droplet main path: the 1024^2 moving-mesh JFNK step
                  with the fused JVP kernel, at dt 1e-9 and then at dt 5e-8
                  (each one warm-up step and 3 timed steps); kernel launch
                  counts read around that run; CUDA-event time of the
                  kernel, the residual evaluations, the stack builds and
                  the PMA loop in each step; then one more dt 5e-8 step
                  under ``torch.profiler`` for the device's idle share.
 7. kernel      — the periodic stencil kernels (``lap_periodic``,
                  ``sh_operator``) against their plain versions at 4096^2
                  f32 (the kernel bench's parity inputs, h = 40/4096,
                  r = 0.01), at the SH path's 2048^2 f32 and f64 fields and
                  at 61x91: gate 1e-5 of max|plain| in f32, 1e-12 in f64;
                  CUDA-event medians of the kernel, the plain version and
                  the library yardstick (``conv2d`` of the circularly
                  padded field), and the bound.
 8. stencil_bench — the kernel bench's path: each kernel chained on its own
                  output at 4096^2 f32, launch counts read around it.
 9. sh_parity   — n = 24 on the card: the CN step (default FD solver)
                  within 1e-6 of ``scipy.optimize.newton_krylov`` on the
                  assembled operator, the ``fast_solver`` step within 2e-5
                  of it, ``semi_implicit_step`` (r = 0.2, g = 0) within 1e-8
                  of ``spsolve``.
10. sh2048      — the SH main path at the large-grid bench's configuration
                  (n = 2048, d = 40 n/64, f64 state, ``fast_solver(f_tol=6e-6,
                  inner_m=10, outer_k=5)``, u0 from
                  ``default_rng(1).standard_normal``): 10 ``evolve_cn`` steps
                  (all converged, worst f_norm <= 6e-6), 1 warm-up and 3
                  timed steps with CUDA-event spans of ``apply_L``, the
                  residual and the LGMRES cycle, one step under
                  ``torch.profiler`` for the device's idle share, then one
                  ``semi_implicit_step``; ``sh_operator`` launches per step
                  in f32 and f64.

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
F64_FLOP_PER_S = 34e12         # H100 SXM f64 outside the tensor cores
# f32 operations of the linearised chain per grid point, counted from
# ops/droplet_jvp.py::jvp_apply_ref: metric coefficients 12, v_ksi/v_eta 12,
# two conservative fluxes 80, cross terms 14, dp 8, grad dp 12, dpx/dpy 8,
# dA/dB 6, their four d1 24, dF2 and the output 9
JVP_FLOP_PER_POINT = 185
JVP_FIELDS_MOVED = 10          # v + 8 stack fields read once, out written once
# operations per point of the periodic stencils: Lap 3 adds, 4u (a mul and
# a sub) and the 1/h^2 scale; SH two Laplacians and -lap2 - 2 lap1 + (r-1) u
STENCIL_FLOP_PER_POINT = {"lap_periodic": 6, "sh_operator": 16}
SH_N = 2048                    # benchmarks/run_all.py::bench_large_sh


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


def cuda_ms(fn, reps: int = 15, batch: int = 10, warmup: int = 3) -> float:
    """Median CUDA-event time per call of ``fn()``, over ``reps`` batches
    of ``batch`` back-to-back calls: the host enqueues a call while the
    device runs the one before, so where the device is the slower side its
    time, not the wrapper's Python, is what the events see."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    times.sort()
    return times[len(times) // 2]


def device_profile(fn, top: int = 6) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and read the device's
    share of the wall time: ``busy_ms`` is the union of the device
    intervals (kernels, copies) in the trace, ``wall_ms`` the host clock
    around ``fn()`` closed by a synchronise (the profiler's own host cost
    is in it).  ``top_device_ms`` sums device time by the first 80
    characters of the kernel's name.  ``idle_share`` is "not measured" if
    the trace holds no device interval."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        key = e.name[:80]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
    busy_ms = busy_us / 1e3
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms if spans else None,
            "idle_share": 1.0 - busy_ms / wall_ms if spans else "not measured",
            "device_events": len(spans),
            "top_device_ms": dict(kernels)}


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


# -- the Swift-Hohenberg slice ---------------------------------------------------

def stencil_weights(kname: str, h: float, r: float, dtype, dev):
    """The stencil of ``kname`` as a conv2d weight and its circular pad:
    3x3 for Lap, 5x5 (13 points) for -Lap^2 - 2 Lap + (r-1) I."""
    import torch

    i2 = 1.0 / (h * h)
    if kname == "lap_periodic":
        w = [[0, i2, 0], [i2, -4 * i2, i2], [0, i2, 0]]
    else:
        i4 = i2 * i2
        a, d, e = 8 * i4 - 2 * i2, -2 * i4, -i4
        c = -20 * i4 + 8 * i2 + (r - 1.0)
        w = [[0, 0, e, 0, 0], [0, d, a, d, 0], [e, a, c, a, e],
             [0, d, a, d, 0], [0, 0, e, 0, 0]]
    w = torch.tensor(w, dtype=dtype, device=dev)[None, None]
    return w, w.shape[-1] // 2


def library_stencil(u, w, pad):
    """The library yardstick: one cuDNN convolution of the circularly
    padded field (the pad is counted in its time)."""
    import torch.nn.functional as F

    x = F.pad(u[None, None], (pad, pad, pad, pad), mode="circular")
    return F.conv2d(x, w)[0, 0]


def stencil_kernel_rows(dev):
    """Phase 7: each periodic stencil kernel against its plain version."""
    import numpy as np
    import torch
    from iterative_solvers_tpu_torch.ops import periodic_stencil as ps
    from iterative_solvers_tpu_torch.ops import stencils

    plain = {"lap_periodic": lambda u, h, r: stencils.lap_periodic(u, h),
             "sh_operator": stencils.sh_linear_operator}
    kernel = {"lap_periodic": lambda u, h, r: ps.lap_periodic_kernel(u, h),
              "sh_operator": ps.sh_operator_kernel}
    h_sh = 40.0 * SH_N / 64 / SH_N
    cases = [((4096, 4096), torch.float32, 40.0 / 4096, 1e-5),
             ((SH_N, SH_N), torch.float32, h_sh, 1e-5),
             ((SH_N, SH_N), torch.float64, h_sh, 1e-12),
             ((61, 91), torch.float32, 0.37, 1e-5),
             ((61, 91), torch.float64, 0.37, 1e-12)]
    rows = {}
    for shape, dtype, h, gate in cases:
        u0 = np.random.default_rng(0).standard_normal(shape)
        u = torch.tensor(u0, dtype=dtype, device=dev)
        r = 0.01
        for kname in ("lap_periodic", "sh_operator"):
            label = f"{shape[0]}x{shape[1]}_{'f32' if dtype == torch.float32 else 'f64'}"
            want = plain[kname](u, h, r)
            got = kernel[kname](u, h, r)
            w, pad = stencil_weights(kname, h, r, dtype, dev)
            lib = library_stencil(u, w, pad)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(bool(torch.isfinite(got).all()), f"{kname} {label}: non-finite output")
            check(got.shape == u.shape and got.dtype == dtype, f"{kname} {label}: shape/dtype")
            check(err <= gate * scale,
                  f"{kname} {label}: max err {err} > {gate} x {scale}")
            npts = shape[0] * shape[1]
            itemsize = u.element_size()
            bytes_ms = 2 * itemsize * npts / HBM_BYTES_PER_S * 1e3
            peak = F32_FLOP_PER_S if dtype == torch.float32 else F64_FLOP_PER_S
            ops_ms = STENCIL_FLOP_PER_POINT[kname] * npts / peak * 1e3
            row = dict(
                name=kname, shape=list(shape), dtype=str(dtype).removeprefix("torch."),
                h=h, r=r, max_abs_err=err, scale=scale, gate=gate,
                library_rel_err=float((lib - want).abs().max()) / scale,
                ms=cuda_ms(lambda: kernel[kname](u, h, r)),
                plain_ms=cuda_ms(lambda: plain[kname](u, h, r)),
                library_ms=cuda_ms(lambda: library_stencil(u, w, pad)),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            rows[kname, label] = row
            emit({"phase": "kernel", **row})
    return rows


def stencil_bench(dev, n: int = 4096, chain: int = 20):
    """Phase 8: the kernel bench's path (benchmarks/run_all.py
    ::bench_pallas_stencils): each kernel applied to its own output
    ``chain`` times at n^2 f32, h = sqrt(8) and r = 0.5 so that both
    operators are contractions; CUDA-event ms per launch."""
    import numpy as np
    import torch
    from iterative_solvers_tpu_torch.ops import periodic_stencil as ps

    h_b = float(np.sqrt(8.0))
    u0 = torch.tensor(np.random.default_rng(0).standard_normal((n, n)),
                      dtype=torch.float32, device=dev)
    ops = {"lap_periodic": lambda x: ps.lap_periodic_kernel(x, h_b),
           "sh_operator": lambda x: ps.sh_operator_kernel(x, h_b, 0.5)}
    torch.cuda.synchronize()
    ps.reset_launches()
    out = {}
    for kname, op in ops.items():
        x = op(u0)  # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(chain):
            x = op(x)
        b.record()
        b.synchronize()
        check(bool(torch.isfinite(x).all()), f"{kname} chain: non-finite output")
        out[kname] = a.elapsed_time(b) / chain
    launches = {"lap_periodic": ps.lap_periodic_kernel.launches,
                "sh_operator": ps.sh_operator_kernel.launches}
    check(all(v == chain + 1 for v in launches.values()),
          f"stencil bench launches {launches}, expected {chain + 1} each")
    emit({"phase": "stencil_bench", "n": n, "chain": chain, "ms_per_launch": out,
          "bound_ms": 2 * 4 * n * n / HBM_BYTES_PER_S * 1e3, "launches": launches})
    return launches


def sh_operator_scipy(n: int, h: float, r: float):
    """The scipy-assembled SH operator -Lap^2 - 2 Lap + (r-1) I on the
    row-major n x n periodic grid (the reference's sparse assembly)."""
    import scipy.sparse as sp

    e = 1.0 / (h * h)
    one = sp.diags([e, e, -2 * e, e, e], [1 - n, -1, 0, 1, n - 1], shape=(n, n))
    eye = sp.identity(n)
    lap = sp.kron(eye, one) + sp.kron(one, eye)
    return (-lap @ lap - 2 * lap + (r - 1) * sp.identity(n * n)).tocsr()


def sh_parity(dev, n: int = 24):
    """Phase 9: the SH steppers at n = 24 on the card against scipy."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.optimize import newton_krylov
    from scipy.sparse.linalg import spsolve
    from iterative_solvers_tpu_torch.models import swift_hohenberg as sh
    from iterative_solvers_tpu_torch.ops import periodic_stencil as ps

    cfg = sh.SHConfig(d=40.0, n=n, k=0.2)
    L = sh_operator_scipy(n, cfg.h, cfg.r)
    rng = np.random.default_rng(11)
    u0 = rng.standard_normal((n, n))
    uo = u0.reshape(-1)

    def residual(u):
        return (u - uo) / cfg.k - (L @ u + cfg.g * u * u - u ** 3
                                   + L @ uo + cfg.g * uo * uo - uo ** 3) / 2

    want = newton_krylov(residual, uo, f_tol=6e-6)
    ps.reset_launches()
    u_fd, res_fd = sh.make_cn_step(cfg, device=dev)(torch.tensor(u0))
    u_fast, res_fast = sh.make_cn_step(cfg, sh.fast_solver(cfg), device=dev)(
        torch.tensor(u0))
    torch.cuda.synchronize()
    err_fd = float(np.abs(u_fd.cpu().numpy().reshape(-1) - want).max())
    err_fast = float((u_fast - u_fd).abs().max())
    check(res_fd.converged and res_fast.converged, "n=24 SH CN steps did not converge")
    check(err_fd <= 1e-6, f"n=24 SH CN step off scipy by {err_fd}")
    check(err_fast <= 2e-5, f"n=24 SH fast_solver step off the FD step by {err_fast}")
    launches_cn = dict(ps.sh_operator_kernel.launches_by_dtype)
    check(launches_cn["f32"] > 0 and launches_cn["f64"] > 0,
          f"n=24 SH CN steps launched sh_operator {launches_cn}")

    scfg = sh.SHConfig(d=40.0, n=n, k=0.2, r=0.2, g=0.0)
    Ls = sh_operator_scipy(n, scfg.h, scfg.r)
    U = u0.reshape(-1)
    Uo = U + 0.1 * rng.standard_normal(n * n)
    eye = sp.identity(n * n, format="csc")
    D = sp.diags((5 * U - Uo) ** 2 * scfg.k / 16 - scfg.g * scfg.k * U)
    want_si = spsolve((eye + D - Ls * scfg.k / 2).tocsc(), (eye + Ls * scfg.k / 2) @ U)
    got_si, res_si = sh.semi_implicit_step(torch.tensor(U.reshape(n, n)),
                                           torch.tensor(Uo.reshape(n, n)), scfg,
                                           tol=1e-12, device=dev)
    err_si = float(np.abs(got_si.cpu().numpy().reshape(-1) - want_si).max())
    check(res_si.converged, "n=24 semi-implicit GMRES did not converge")
    check(err_si <= 1e-8, f"n=24 semi-implicit step off spsolve by {err_si}")
    emit({"phase": "sh_parity", "n": n,
          "cn_fd": {"newton_iters": res_fd.iters, "f_norm": res_fd.f_norm,
                    "err_vs_scipy": err_fd},
          "cn_fast": {"newton_iters": res_fast.iters, "f_norm": res_fast.f_norm,
                      "err_vs_fd_step": err_fast},
          "semi_implicit": {"gmres_iters": res_si.iters, "resnorm": res_si.resnorm,
                            "err_vs_spsolve": err_si},
          "sh_operator_launches": launches_cn})


def sh2048(dev):
    """Phase 10: the SH main path (benchmarks/run_all.py::bench_large_sh).
    Returns the sh_operator launches of the whole phase by dtype."""
    import numpy as np
    import torch
    from iterative_solvers_tpu_torch.models import swift_hohenberg as sh
    from iterative_solvers_tpu_torch.ops import periodic_stencil as ps
    from iterative_solvers_tpu_torch.solvers import newton

    n = SH_N
    cfg = sh.SHConfig(n=n, d=40.0 * n / 64)  # the 64^2 case's h
    solver = sh.fast_solver(cfg, f_tol=6e-6, inner_m=10, outer_k=5)
    u0 = torch.tensor(np.random.default_rng(1).standard_normal((n, n)), device=dev)
    torch.cuda.synchronize()
    ps.reset_launches()
    counts = ps.sh_operator_kernel.launches_by_dtype

    t0 = time.perf_counter()
    u, iters, f_norms = sh.evolve_cn(u0, 10, cfg, solver, device=dev)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    worst = float(np.max(f_norms))
    emit({"phase": "sh2048_chain", "n": n, "steps": 10, "seconds": chain_s,
          "newton_iters": iters.tolist(), "f_norms": f_norms.tolist(),
          "worst_f_norm": worst, "launches_by_dtype": dict(counts)})
    check(worst <= 6e-6, f"sh2048 chain diverged (worst f_norm {worst:.2e})")
    check(bool(torch.isfinite(u).all()), "sh2048 chain: state not finite")

    step = sh.make_cn_step(cfg, solver, device=dev)
    timed = []
    with Spans(sh, ["apply_L", "cn_residual"]) as s_sh, \
            Spans(newton, ["_lgmres_cycle"]) as s_nk:
        for k in range(4):  # one warm-up step, then 3 timed
            before = dict(counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u, res = step(u)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            launched = {d: counts[d] - before[d] for d in counts}
            rec = {"step": k, "warmup": k == 0, "step_ms": step_ms,
                   "newton_iters": res.iters, "f_norm": res.f_norm,
                   "converged": res.converged, "sh_operator_launches": launched,
                   "calls_ms": {**s_sh.take(), **s_nk.take()}}
            emit({"phase": "sh2048_step", **rec})
            check(res.converged, f"sh2048 step {k} did not converge: f_norm {res.f_norm}")
            check(launched["f32"] > 0 and launched["f64"] > 0,
                  f"sh2048 step {k} launched sh_operator {launched}")
            if k:
                timed.append(rec)

    emit({"phase": "sh2048_profile", **device_profile(lambda: step(u))})

    torch.cuda.synchronize()
    before = dict(counts)
    t0 = time.perf_counter()
    u_si, res_si = sh.semi_implicit_step(u, u, cfg, device=dev)
    torch.cuda.synchronize()
    si_ms = (time.perf_counter() - t0) * 1e3
    check(res_si.converged, f"sh2048 semi-implicit GMRES: resnorm {res_si.resnorm}")
    check(bool(torch.isfinite(u_si).all()), "sh2048 semi-implicit: state not finite")
    launched_si = {d: counts[d] - before[d] for d in counts}
    check(launched_si["f64"] > 0, "sh2048 semi-implicit step launched no sh_operator")
    emit({"phase": "sh2048_semi_implicit", "n": n, "ms": si_ms,
          "gmres_iters": res_si.iters, "resnorm": res_si.resnorm,
          "sh_operator_launches": launched_si})

    med = sorted(r["step_ms"] for r in timed)[len(timed) // 2]
    emit({"phase": "sh2048_summary", "n": n, "step_ms_median": med,
          "step_ms": [r["step_ms"] for r in timed],
          "newton_iters": [r["newton_iters"] for r in timed],
          "f_norm": [r["f_norm"] for r in timed],
          "launches_per_step": [r["sh_operator_launches"] for r in timed],
          "launches_by_dtype": dict(counts)})
    return dict(counts)


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
          and torch.backends.cudnn.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on for f32 matmuls or convolutions")
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "build", "sources": sorted(p.name for p in _build.CSRC.glob("*.cu")),
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
    prof = device_profile(lambda: step(u, phi, DT_MAIN))
    emit({"phase": "step1024_profile", "dt": DT_MAIN, **prof})
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

    # -- 7-10. the Swift-Hohenberg slice -------------------------------------
    rows = stencil_kernel_rows(dev)
    bench_launches = stencil_bench(dev)
    sh_parity(dev)
    sh_launches = sh2048(dev)

    big = kstats[f"{N}x{N}"]
    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(kname, row, launches):
        return {"name": kname, "route": "cuda",
                "source": "iterative_solvers_tpu_torch/ops/csrc/periodic_stencil.cu",
                "replaces": "iterative_solvers_tpu/ops/pallas_stencil.py:392",
                "launches": launches, **{k: row[k] for k in numbers},
                "shape": row["shape"], "dtype": row["dtype"]}

    sh64 = rows["sh_operator", f"{SH_N}x{SH_N}_f64"]
    emit({"kernels": [
        {"name": "droplet_jvp", "route": "cuda",
         "source": "iterative_solvers_tpu_torch/ops/csrc/droplet_jvp.cu",
         "replaces": "iterative_solvers_tpu/ops/pallas_droplet.py:534",
         "launches": launches_main, "max_abs_err": big["max_abs_err"],
         "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": None},
        entry("lap_periodic", rows["lap_periodic", "4096x4096_f32"],
              bench_launches["lap_periodic"]),
        {**entry("sh_operator", rows["sh_operator", f"{SH_N}x{SH_N}_f32"],
                 sh_launches["f32"] + sh_launches["f64"]),
         "launches_by_dtype": sh_launches,
         "f64": {"launches": sh_launches["f64"], "shape": sh64["shape"],
                 **{k: sh64[k] for k in numbers}}},
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
