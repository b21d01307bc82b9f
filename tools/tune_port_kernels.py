#!/usr/bin/env python3
"""Tile and segment tuning of the port's five redesigned CUDA kernels on
one GPU, and the times of the fused PMA sub-step's kernels, of the
stencils' kernel and of the flux divergence's kernel:
``python3 tools/tune_port_kernels.py [droplet] [sh] [spmm] [spmv]
[general] [pma] [fd] [flux]``.

Drives ``iterative_solvers_tpu_torch`` only (no JAX).  For each kernel it
prints what ``ptxas`` reports for the source (registers, spills, shared
memory), checks every variant against the plain PyTorch version, and times
it in a CUDA-graph replay of 10 captured calls (``utils/timing.graph_ms``:
the device alone), the chosen design (``droplet``) or the earlier design
(``sh``, ``spmm``) first and last:

- ``droplet``: the fused ``droplet_jvp`` kernel at each tile shape and block
  size of ``droplet_jvp_tile_f32`` at 1024^2 and 2048^2 f32, on a seeded
  synthetic coefficient stack, and its two probes (the stages without the
  copies, the copies without the stages: where the time goes);
- ``sh``: the strip-marching ``sh_operator`` at segment heights 8..128 and
  2, 4, 8 rows in flight, at 2048^2 f32 / f64 and 4096^2 f32;
- ``spmm``: the row-slab SpMM on the kernel bench's cyclic SH container
  (13 terms) x 8 at 1024^2 and 2048^2 f32, stacked layout, at each tiling
  of ``grid_dia_matmat_slab_variant_f32`` (strip width, slab rows, stages,
  columns a thread, where the halo rows come from, waves), its three probes
  (no copies; no arithmetic; copies alone), the interleaved layout, against
  the general kernel; and, for the card's streaming rate, a plain PyTorch
  copy, sum and add over the bytes the 2048^2 x 8 product moves;
- ``spmv``: the tiled ``grid_dia_matvec`` on the smoke run's clamped rows
  (the far-shift SH container and the biharmonic at 1024^2 f32, Dirichlet
  4096^2 f32 on the vector path; Poisson 999^2 f64 on the scalar path) at
  each tiling of ``grid_dia_matvec_variant_{f32,f64}`` (points a thread,
  rows a thread, terms whose loads are issued together, the other path),
  its four probes (every term tested at every point: no list; the loads
  without the multiply-adds; the coefficients alone; x alone), and the
  cyclic SH 2048^2 f32 row, the chosen tiling first and last, with the
  bytes bound of each row;
- ``general``: the tiled (general) SpMM on the smoke run's general rows
  (the far-shift clamped SH container at 1024^2 x 8 f32 on the vector path;
  the Poisson 999^2 operator x 8 f64 on the scalar path) at each tiling of
  ``grid_dia_matmat_general_variant_{f32,f64}`` (points a thread, terms
  whose loads are issued together, right-hand sides a register tile, the
  register cap, x as single points, the other path), the tiled SpMV's
  four probes, and both layouts of the chosen tiling, with the bytes bound
  of each row.

The sparse kernels' variants (``spmm``, ``spmv``, ``general``) are not in
the package's library: ``tools/dia_spmv_tuning.cu`` includes the library
source and exports them, and this script builds it into a library of its
own under ``_build/tuning``.

- ``pma``: the five kernels of the fused PMA sub-step (``pma_substep.cu``)
  at 1024^2 and 91x61 f32 on a seeded droplet-like state, each against
  its bytes bound and its plain (eager) stage (``chip_smoke.pma_kernel_rows``,
  which holds them to the eager stages bit for bit, ``pma_source`` from
  768 rows: below, the eager edge rows sum in another order, so there its
  error is reported, not checked), and the whole sub-step, fused against
  eager.
- ``fd``: the stencils' kernel (``fd_stencil.cu``, ``ops/stencils.d1_x``,
  ``d1_y``, ``d2_x``, ``d2_y``) at 51^2 f64 and 1024^2 f32 and f64 on a
  seeded field: ms over batches of calls and graph ms, against its bytes
  bound (the field read once, the result written once) and the plain body
  on the card (its interior ops, the cuBLAS edge-row products, the cat and
  the scale), with the largest gap to the plain body over its largest
  value (the edge rows' summation order, 0 where cuBLAS sums as the
  kernel does).
- ``flux``: the flux divergence's kernel (``flux_div.cu``,
  ``ops/stencils.flux_div_x``, ``flux_div_y``: the curvilinear Laplacian's
  conservative ``(a v')'``) at 51^2 f64 and 1024^2 f32 and f64 on a seeded
  pair ``(a, v)``, as ``fd``: ms over batches of calls and graph ms,
  against its bytes bound (``a`` and ``v`` read once, the result written
  once) and the plain body on the card (~156 eager launches a call), with
  the largest gap to the plain body over its largest value (0: bit for
  bit).

One JSON line per measurement, with the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
from functools import lru_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# the variants of the sparse kernels (spmm, spmv, general): the library
# source at other tilings, built on its own
TUNING_SOURCE = ROOT / "tools" / "dia_spmv_tuning.cu"

# variant of droplet_jvp_tile_f32 -> (tile rows, tile columns, threads, blocks an SM
# the registers are capped for)
JVP_TILES = {0: (16, 64, 256, 2), 1: (16, 64, 512, 2), 2: (32, 32, 512, 2)}
# its probes: the stages without the copies, the copies without the stages
JVP_PROBES = {3: "stages_only", 4: "copies_only"}


_REPORTED = set()


def ptxas_report(path: pathlib.Path):
    """Compile one source with ``-Xptxas -v`` and print the resource lines
    (once a run)."""
    from iterative_solvers_tpu_torch.ops import _build

    if path in _REPORTED:
        return
    _REPORTED.add(path)
    source = path.name
    out = subprocess.run(
        ["nvcc", *_build.CUDA_FLAGS, "-Xptxas", "-v", "-c", str(path), "-o", "/dev/null"],
        capture_output=True, text=True, timeout=600)
    lines = [ln for ln in out.stderr.splitlines() if "ptxas" in ln or "spill" in ln]
    name = None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "Used" in ln or "spill" in ln:
            cs.emit({"phase": "ptxas", "source": source, "entry": name,
                     "report": ln.split("info    : ")[-1].strip()})
    if out.returncode:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"nvcc failed on {source}")


@lru_cache(maxsize=None)
def tuning_library() -> ctypes.CDLL:
    """``TUNING_SOURCE`` built into a library of its own (once a process,
    beside the package's, with its flags)."""
    from torch.utils.cpp_extension import load
    from iterative_solvers_tpu_torch.ops import _build

    build_dir = _build.BUILD_DIR / "tuning"
    build_dir.mkdir(parents=True, exist_ok=True)
    return ctypes.CDLL(load(name="dia_spmv_tuning", sources=[str(TUNING_SOURCE)],
                            build_directory=str(build_dir),
                            extra_cuda_cflags=_build.CUDA_FLAGS, is_python_module=False,
                            verbose=False))


def tuning_function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The exported C function ``name`` of ``tuning_library()``, as
    ``_build.c_function``."""
    fn = getattr(tuning_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def tune_droplet(dev):
    import torch
    from iterative_solvers_tpu_torch.core.grid import Grid2D
    from iterative_solvers_tpu_torch.ops import _build, droplet_jvp as dj
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    ptxas_report(_build.CSRC / "droplet_jvp.cu")
    tile_fn = _build.c_function("droplet_jvp_tile_f32",
                                dj._ARGS["droplet_jvp"] + [ctypes.c_int])
    for n in (1024, 2048):
        grid = Grid2D(nx=n, ny=n, xl=-2.0, xr=5.0, yb=-3.5, yt=3.5)
        v, stack = cs.synthetic_jvp_inputs(n, n, dev)
        want = dj.jvp_apply_ref(v, stack, grid)
        scale = float(want.abs().max())
        out = torch.empty_like(v)

        def variant(k):
            err = tile_fn(v.data_ptr(), stack.data_ptr(), out.data_ptr(), n, n,
                          grid.dx, grid.dy,
                          torch.cuda.current_stream(dev).cuda_stream, k)
            if err:
                raise RuntimeError(f"variant {k}: CUDA error {err}")
            return out

        runs = [("chosen", lambda: dj.jvp_matvec(v, stack, grid))]
        runs += [(f"tile{ty}x{tx}_t{nt}_b{mb}", lambda k=k: variant(k))
                 for k, (ty, tx, nt, mb) in JVP_TILES.items()]
        runs += [(name, lambda k=k: variant(k)) for k, name in JVP_PROBES.items()]
        runs += [runs[0]]
        for label, fn in runs:
            got = fn()
            torch.cuda.synchronize()
            row = {"phase": "tune_droplet", "n": n, "variant": label,
                   "device_ms": graph_ms(fn)}
            if label not in JVP_PROBES.values():  # a probe's output is not J v
                err = float((got - want).abs().max())
                row["rel_err"] = err / scale
                cs.check(err <= 1e-5 * scale, f"{label} at {n}: error {err} on {scale}")
            cs.emit(row)


def tune_sh(dev):
    import numpy as np
    import torch
    from iterative_solvers_tpu_torch.ops import _build, periodic_stencil as ps
    from iterative_solvers_tpu_torch.ops import stencils
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    ptxas_report(_build.CSRC / "periodic_stencil.cu")
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    r = 0.01
    for n, dtype, h, gate in ((2048, torch.float32, 0.625, 1e-5),
                              (2048, torch.float64, 0.625, 1e-12),
                              (4096, torch.float32, 40.0 / 4096, 1e-5)):
        tag = "f32" if dtype == torch.float32 else "f64"
        fn_c = _build.c_function(f"sh_operator_strip_{tag}", args)
        u = torch.tensor(np.random.default_rng(0).standard_normal((n, n)),
                         dtype=dtype, device=dev)
        want = stencils.sh_linear_operator(u, h, r)
        scale = float(want.abs().max())
        out = torch.empty_like(u)

        def strip(seg, ahead):
            err = fn_c(u.data_ptr(), out.data_ptr(), n, n, 1.0 / (h * h), r - 1.0,
                       torch.cuda.current_stream(dev).cuda_stream, seg, ahead)
            if err:
                raise RuntimeError(f"seg {seg} ahead {ahead}: CUDA error {err}")
            return out

        runs = [("v1", lambda: ps._sh_operator_v1(u, h, r))]
        runs += [(f"seg{seg}_ahead{ahead}", lambda s=seg, a=ahead: strip(s, a))
                 for ahead in (2, 4, 8) for seg in (8, 16, 32, 64, 128)]
        runs += [("chosen", lambda: ps.sh_operator_kernel(u, h, r)), runs[0]]
        for label, fn in runs:
            got = fn()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            cs.emit({"phase": "tune_sh", "n": n, "dtype": tag, "variant": label,
                     "rel_err": err / scale, "device_ms": graph_ms(fn)})
            cs.check(err <= gate * scale, f"{label} at {n} {tag}: error {err} on {scale}")


# variant of grid_dia_matmat_slab_variant_f32 -> its tiling, as in
# csrc/dia_spmv.cu: strip columns W, slab rows B, stages S (2 blocks an SM but
# where noted), halo rows from the previous stage but where noted
SPMM_TILINGS = {0: "W64_B8_S2", 1: "W64_B8_S2_halo_rows_from_global",
                2: "W64_B8_S3_one_block", 3: "W32_B8_S2", 4: "W128_B8_S2_one_block",
                5: "W64_B16_S2_one_block", 6: "W64_B8_S2_two_columns_a_thread",
                7: "W64_B8_S2_4_waves"}
# its probes: the arithmetic without the copies, the copies and stores without
# the arithmetic, the copies alone
SPMM_PROBES = {10: "no_copies", 11: "no_arithmetic", 12: "copies_alone"}


def stream_reference(dev, nbytes: float):
    """The card's streaming rate on plain PyTorch calls that move about
    ``nbytes``: a copy (read once, write once) and an add (two reads, one
    write), in graph replay."""
    import torch
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    n = int(nbytes / 8)
    a = torch.ones(n, device=dev)
    b = torch.ones(n, device=dev)
    out = torch.empty(n, device=dev)
    ms = graph_ms(lambda: out.copy_(a))
    cs.emit({"phase": "tune_spmm", "variant": "torch_copy", "bytes": 8 * n,
             "device_ms": ms, "tb_per_s": 8 * n / ms / 1e9})
    r = torch.ones(int(nbytes * 352 / 486.5 / 4), device=dev)  # the SpMM's reads alone
    nr = r.numel()
    ms = graph_ms(lambda: r.sum())
    cs.emit({"phase": "tune_spmm", "variant": "torch_sum", "bytes": 4 * nr,
             "device_ms": ms, "tb_per_s": 4 * nr / ms / 1e9})
    del r
    n3 = int(nbytes / 12)
    a, b, out = a[:n3], b[:n3], out[:n3]
    ms = graph_ms(lambda: torch.add(a, b, out=out))
    cs.emit({"phase": "tune_spmm", "variant": "torch_add", "bytes": 12 * n3,
             "device_ms": ms, "tb_per_s": 12 * n3 / ms / 1e9})


def tune_spmm(dev):
    import numpy as np
    import torch
    from iterative_solvers_tpu_torch.ops import spmv
    from iterative_solvers_tpu_torch.ops.sparse import GridDIA
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    ptxas_report(TUNING_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn_c = tuning_function("grid_dia_matmat_slab_variant_f32",
                           [p, p, i, p, p, i, i, i, i, i, i, p, i])
    operators = cs.Operators()
    stream_reference(dev, (13 + 2 * 8) * 4 * cs.SP_N2 ** 2)
    for n in (cs.SP_N, cs.SP_N2):
        a = GridDIA.from_scipy(operators.get("sh", n), (n, n), cyclic=True, device=dev)
        a = a._replace(data=a.data.float())
        x3 = torch.tensor(np.random.default_rng(4).standard_normal((8, n, n)),
                          dtype=torch.float32, device=dev)
        xi = x3.movedim(0, 1).contiguous()
        want = spmv._matmat_plain(a, x3)
        scale = float(want.abs().max())
        _, hy, hx = spmv._slab_rows(a.shifts, a.grid, a.cyclic)
        terms = spmv._slab_terms(a.shifts, a.grid, a.cyclic, dev)
        out = torch.empty_like(x3)

        def variant(k):
            err = fn_c(a.data.data_ptr(), terms.data_ptr(), terms.shape[0], x3.data_ptr(),
                       out.data_ptr(), 8, n, n, 0, hy, hx,
                       torch.cuda.current_stream(dev).cuda_stream, k)
            if err:
                raise RuntimeError(f"variant {k}: CUDA error {err}")
            return out

        runs = [("general", lambda: spmv._matmat_general(a, x3))]
        runs += [(label, lambda k=k: variant(k)) for k, label in SPMM_TILINGS.items()]
        runs += [(name, lambda k=k: variant(k)) for k, name in SPMM_PROBES.items()]
        runs += [("chosen", lambda: spmv.grid_dia_matmat(a, x3)),
                 ("chosen_interleaved", lambda: spmv.grid_dia_matmat_interleaved(a, xi)),
                 ("general_interleaved", lambda: spmv._matmat_general(a, xi, True)),
                 runs[0]]
        for label, fn in runs:
            got = fn()
            torch.cuda.synchronize()
            row = {"phase": "tune_spmm", "n": n, "nrhs": 8, "variant": label,
                   "device_ms": graph_ms(fn)}
            if label not in SPMM_PROBES.values():  # a probe's output is not A X
                if label.endswith("interleaved"):
                    got = got.movedim(1, 0)
                err = float((got - want).abs().max())
                row["rel_err"] = err / scale
                cs.check(err <= 1e-5 * scale, f"{label} at {n}: error {err} on {scale}")
            cs.emit(row)


# variant of grid_dia_matvec_variant_{f32,f64} -> its tiling, as in
# csrc/dia_spmv.cu: path, points a thread along a row P, rows a thread R,
# terms whose loads are issued together U, threads along a row TX (variant
# 0: the chosen tiling)
MV_VARIANTS = {"f32": {0: "vector_P4_R1_U4_TX32", 1: "vector_U1", 2: "vector_U2",
                       3: "vector_U8", 4: "vector_P8", 5: "vector_R2", 6: "scalar_P4_U2",
                       7: "vector_TX64", 8: "vector_TX128", 9: "scalar_U4"},
               "f64": {0: "scalar_P4_R1_U2_TX32", 1: "scalar_U1", 2: "scalar_U4",
                       3: "scalar_U8", 4: "scalar_P2", 5: "scalar_P8", 6: "scalar_R2",
                       7: "scalar_TX64", 8: "scalar_TX128", 9: "vector_P4_U2",
                       10: "vector_U4", 11: "scalar_U4_in_64_registers"}}
# its probes: every term tested at every point (no list); the loads without
# the multiply-adds; the coefficients alone; x alone
MV_PROBES = {20: "no_list", 21: "loads_alone", 22: "coefficients_alone", 23: "x_alone"}
# (case, operator, n, cyclic, dtype tag): the smoke run's rows
MV_ROWS = [("sh_clamped_1024_f32", "sh", 1024, False, "f32"),
           ("biharmonic_1024_f32", "biharmonic", 1024, False, "f32"),
           ("dirichlet_4096_f32", "dirichlet", 4096, False, "f32"),
           ("poisson_999_f64", "poisson", 999, False, "f64"),
           ("biharmonic_1024_f64", "biharmonic", 1024, False, "f64"),
           ("sh_cyclic_2048_f32", "sh", 2048, True, "f32")]


def tune_spmv(dev):
    import numpy as np
    import torch
    from iterative_solvers_tpu_torch.ops import spmv
    from iterative_solvers_tpu_torch.ops.sparse import GridDIA
    from iterative_solvers_tpu_torch.utils.roofline import spmv_kernel_cost
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    ptxas_report(TUNING_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    operators = cs.Operators()
    for case, kind, n, cyclic, tag in MV_ROWS:
        dtype = torch.float32 if tag == "f32" else torch.float64
        npdt = np.float32 if tag == "f32" else np.float64
        m = operators.get(kind, n)
        a = GridDIA.from_scipy(m if cyclic else m.astype(npdt), (n, n), cyclic=cyclic,
                               device=dev)
        a = a._replace(data=a.data.to(dtype))
        x = torch.tensor(np.random.default_rng(0).standard_normal((n, n)), dtype=dtype,
                         device=dev)
        want = a._apply(x)
        scale = float(want.abs().max())
        gate = 1e-5 if tag == "f32" else 1e-12
        cost = spmv_kernel_cost(a.shifts, n, n, a.data.element_size(), cyclic=cyclic)
        peak = cs.F32_FLOP_PER_S if tag == "f32" else cs.F64_FLOP_PER_S
        bound_ms, _ = cost.bound_ms(cs.hbm_bytes_per_s(), peak)
        terms = spmv._grid_terms(a.shifts, a.grid, a.cyclic, dev)
        out = torch.empty_like(x)
        fn_c = tuning_function(f"grid_dia_matvec_variant_{tag}", [p, p, i, p, p, i, i, p, i])

        def variant(k):
            err = fn_c(a.data.data_ptr(), terms.data_ptr(), terms.shape[0], x.data_ptr(),
                       out.data_ptr(), n, n, torch.cuda.current_stream(dev).cuda_stream, k)
            if err:
                raise RuntimeError(f"variant {k}: CUDA error {err}")
            return out

        runs = [("chosen", lambda: spmv.grid_dia_matvec(a, x))]
        if not cyclic:  # the variants are clamped kernels
            runs += [(label, lambda k=k: variant(k)) for k, label in MV_VARIANTS[tag].items()
                     if not (label.startswith("vector") and n % (16 // x.element_size()))]
            runs += [(name, lambda k=k: variant(k)) for k, name in MV_PROBES.items()]
        runs += [runs[0]]
        for label, fn in runs:
            got = fn()
            torch.cuda.synchronize()
            ms = graph_ms(fn)
            row = {"phase": "tune_spmv", "case": case, "fields": len(a.shifts),
                   "terms": terms.shape[0], "variant": label, "device_ms": ms,
                   "bound_ms": bound_ms, "share_of_bound": bound_ms / ms}
            if label not in MV_PROBES.values():  # a probe's output is not A x
                err = float((got - want).abs().max())
                row["rel_err"] = err / scale
                cs.check(err <= gate * scale, f"{label} on {case}: error {err} on {scale}")
            if label == "chosen":
                row["path"] = spmv.matvec_path(a, x)
            cs.emit(row)


# variant of grid_dia_matmat_general_variant_{f32,f64} -> its tiling, as in
# csrc/dia_spmv.cu: points a thread along a row P, terms whose coefficient
# loads are issued together U, right-hand sides a register tile J, blocks an
# SM the registers are capped for B; the x window in shared memory (copied
# as 16-byte vectors on the vector path, element by element on the scalar
# one) or none, x through L1 (variant 0: the chosen tiling)
MM_VARIANTS = {"f32": {0: "P2_U4_J8_B4", 1: "U2", 2: "U8", 3: "B3", 4: "P1", 5: "J4",
                       6: "element_copies", 7: "no_window"},
               "f64": {0: "P1_U8_J8_B4", 1: "U4", 2: "B3", 3: "P2_U4_B2", 4: "no_window"}}
# the variants that copy the window as 16-byte vectors: rows of whole,
# aligned vectors only
VECTOR_ONLY = {"f32": set(MM_VARIANTS["f32"].values()) - {"element_copies", "no_window"},
               "f64": set()}
# (case, operator, n, dtype tag): the smoke run's general rows, x 8
MM_ROWS = [("sh_clamped_1024_x8_f32", "sh", 1024, "f32"),
           ("poisson_999_x8_f64", "poisson", 999, "f64")]


def tune_general(dev, nrhs: int = 8):
    import numpy as np
    import torch
    from iterative_solvers_tpu_torch.ops import spmv
    from iterative_solvers_tpu_torch.ops.sparse import GridDIA
    from iterative_solvers_tpu_torch.utils.roofline import spmv_kernel_cost
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    ptxas_report(TUNING_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    operators = cs.Operators()
    for case, kind, n, tag in MM_ROWS:
        npdt = np.float32 if tag == "f32" else np.float64
        a = GridDIA.from_scipy(operators.get(kind, n).astype(npdt), (n, n), device=dev)
        x3 = torch.tensor(np.random.default_rng(4).standard_normal((nrhs, n, n)),
                          dtype=a.data.dtype, device=dev)
        xi = x3.movedim(0, 1).contiguous()
        want = spmv._matmat_plain(a, x3)
        scale = float(want.abs().max())
        gate = 1e-5 if tag == "f32" else 1e-12
        cost = spmv_kernel_cost(a.shifts, n, n, a.data.element_size(), nrhs)
        peak = cs.F32_FLOP_PER_S if tag == "f32" else cs.F64_FLOP_PER_S
        bound_ms, _ = cost.bound_ms(cs.hbm_bytes_per_s(), peak)
        terms = spmv._grid_terms(a.shifts, a.grid, a.cyclic, dev)
        out = torch.empty_like(x3)
        fn_c = tuning_function(f"grid_dia_matmat_general_variant_{tag}",
                               [p, p, i, p, p, i, i, i, i, p, i])

        def variant(k):
            err = fn_c(a.data.data_ptr(), terms.data_ptr(), terms.shape[0], x3.data_ptr(),
                       out.data_ptr(), nrhs, n, n, 0, torch.cuda.current_stream(dev).cuda_stream,
                       k)
            if err:
                raise RuntimeError(f"variant {k}: CUDA error {err}")
            return out

        runs = [(label, lambda k=k: variant(k)) for k, label in MM_VARIANTS[tag].items()
                 if not (label in VECTOR_ONLY[tag] and n % (16 // x3.element_size()))]
        runs += [(name, lambda k=k: variant(k)) for k, name in MV_PROBES.items()]
        runs += [("chosen", lambda: spmv._matmat_general(a, x3)),
                 ("chosen_interleaved", lambda: spmv._matmat_general(a, xi, True))]
        for label, fn in runs:
            got = fn()
            torch.cuda.synchronize()
            ms = graph_ms(fn)
            row = {"phase": "tune_general", "case": case, "fields": len(a.shifts),
                   "terms": terms.shape[0], "nrhs": nrhs, "variant": label, "device_ms": ms,
                   "bound_ms": bound_ms, "share_of_bound": bound_ms / ms}
            if label not in MV_PROBES.values():  # a probe's output is not A X
                if label.endswith("interleaved"):
                    got = got.movedim(1, 0)
                err = float((got - want).abs().max())
                row["rel_err"] = err / scale
                cs.check(err <= gate * scale, f"{label} on {case}: error {err} on {scale}")
            if label == "chosen":
                row["path"] = spmv.matvec_path(a, x3)
            cs.emit(row)


def tune_pma(dev):
    import torch
    from iterative_solvers_tpu_torch.meshmove import pma
    from iterative_solvers_tpu_torch.models import droplet as dp
    from iterative_solvers_tpu_torch.ops import _build, curvilinear as cv, pma_substep as ps
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    ptxas_report(_build.CSRC / "pma_substep.cu")
    cs.emit({"phase": "tune_pma", "resources": ps.source_resources()})
    shapes = ((1024, 1024), (61, 91))
    for row in cs.pma_kernel_rows(dev, shapes):
        cs.emit({"phase": "tune_pma", **row})
    params = pma.PMAParams(alpha=0.01, gamma=0.1, mackenzie_c=0.15, spectral_dtype="float32",
                           mesh_dtype="float32")
    for ny, nx in shapes:
        grid, base, s, u = cs.pma_state(ny, nx, dev)
        uk, ue = ps.film_gradient(u, grid)
        den = 1.0 - params.gamma * pma._leig_tensor(grid, torch.float32, dev)

        def fused():
            return ps.substep(base, s, u, uk, ue, den, grid, dt=1e-10, smoothing_iters=4,
                              mackenzie_c=params.mackenzie_c, alpha=params.alpha)

        def eager():
            return s + 1e-10 * pma.pma_dqdt(base + s, u, grid, params, dp.monitor_source,
                                            cv.mesh_geometry_dev)

        fused(), eager()
        cs.emit({"phase": "tune_pma", "shape": [ny, nx], "kernel": "substep",
                 "graph_ms": graph_ms(fused), "plain_graph_ms": graph_ms(eager),
                 "rel_err": float((fused() - eager()).abs().max()) / float(
                     (eager() - s).abs().max())})


def tune_fd(dev):
    import torch
    from iterative_solvers_tpu_torch.ops import _build, stencils
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    ptxas_report(_build.CSRC / "fd_stencil.cu")
    res = (ctypes.c_int * 5)()
    fn = _build.c_function("fd_stencil_resources",
                           [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    for is_f64 in (0, 1):
        for order in (1, 2):
            if fn(is_f64, order, ctypes.cast(res, ctypes.c_void_p)):
                raise SystemExit("fd_stencil_resources failed")
            cs.emit({"phase": "tune_fd", "dtype": "f64" if is_f64 else "f32", "order": order,
                     "resources": dict(zip(("registers", "shared_bytes", "spill_bytes",
                                            "blocks_per_sm", "threads"), list(res)))})
    gen = torch.Generator(device="cpu").manual_seed(20)
    for shape, dtype in (((51, 51), torch.float64), ((1024, 1024), torch.float32),
                         ((1024, 1024), torch.float64)):
        u = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev, dtype)
        bound_ms = 2 * u.numel() * u.element_size() / 3.35e12 * 1e3
        for name in ("d1_x", "d1_y", "d2_x", "d2_y"):
            h = 0.1 if name.endswith("x") else 0.07
            kernel = lambda: getattr(stencils, name)(u, h)  # noqa: E731
            plain = lambda: getattr(stencils, f"{name}_plain")(u, h)  # noqa: E731
            want = plain()
            gap = float((kernel() - want).abs().max()) / float(want.abs().max())
            cs.emit({"phase": "tune_fd", "shape": list(shape), "dtype": str(dtype)[6:],
                     "kernel": name, "ms": cs.cuda_ms(kernel), "graph_ms": graph_ms(kernel),
                     "bound_ms": bound_ms, "plain_ms": cs.cuda_ms(plain),
                     "plain_graph_ms": graph_ms(plain), "rel_gap": gap})


def tune_flux(dev):
    import torch
    from iterative_solvers_tpu_torch.ops import _build, stencils
    from iterative_solvers_tpu_torch.utils.timing import graph_ms

    ptxas_report(_build.CSRC / "flux_div.cu")
    res = (ctypes.c_int * 5)()
    fn = _build.c_function("flux_div_resources", [ctypes.c_int, ctypes.c_void_p])
    for is_f64 in (0, 1):
        if fn(is_f64, ctypes.cast(res, ctypes.c_void_p)):
            raise SystemExit("flux_div_resources failed")
        cs.emit({"phase": "tune_flux", "dtype": "f64" if is_f64 else "f32",
                 "resources": dict(zip(("registers", "shared_bytes", "spill_bytes",
                                        "blocks_per_sm", "threads"), list(res)))})
    gen = torch.Generator(device="cpu").manual_seed(22)
    for shape, dtype in (((51, 51), torch.float64), ((1024, 1024), torch.float32),
                         ((1024, 1024), torch.float64)):
        a = (1.5 + 0.5 * torch.randn(shape, generator=gen, dtype=torch.float64)).to(dev, dtype)
        v = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev, dtype)
        bound_ms = 3 * v.numel() * v.element_size() / 3.35e12 * 1e3
        for name in ("flux_div_x", "flux_div_y"):
            ih = 123.4 if name.endswith("x") else 87.6
            kernel = lambda: getattr(stencils, name)(a, v, ih)  # noqa: E731
            plain = lambda: getattr(stencils, f"{name}_plain")(a, v, ih)  # noqa: E731
            want = plain()
            gap = float((kernel() - want).abs().max()) / float(want.abs().max())
            cs.emit({"phase": "tune_flux", "shape": list(shape), "dtype": str(dtype)[6:],
                     "kernel": name, "ms": cs.cuda_ms(kernel), "graph_ms": graph_ms(kernel),
                     "bound_ms": bound_ms, "plain_ms": cs.cuda_ms(plain),
                     "plain_graph_ms": graph_ms(plain), "rel_gap": gap})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_port_kernels: needs one CUDA device", file=sys.stderr)
        return 2
    from iterative_solvers_tpu_torch.ops import _build
    from iterative_solvers_tpu_torch.utils.timing import nvidia_smi

    which = sys.argv[1:] or ["droplet", "sh", "spmm", "spmv", "general", "pma", "fd", "flux"]
    print(nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    _build.load_library()
    if "droplet" in which:
        tune_droplet(dev)
    if "sh" in which:
        tune_sh(dev)
    if "spmm" in which:
        tune_spmm(dev)
    if "spmv" in which:
        tune_spmv(dev)
    if "general" in which:
        tune_general(dev)
    if "pma" in which:
        tune_pma(dev)
    if "fd" in which:
        tune_fd(dev)
    if "flux" in which:
        tune_flux(dev)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
