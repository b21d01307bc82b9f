"""Run one cell of the port's benchmark once.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell's
configuration, traffic mix and metric readers are found by the names that
``BENCHMARK.json`` gives: ``configs[].file``, ``portbench/traffic/<traffic>.json``
and ``portbench/metrics/<metric>.py``; a configuration's ``system`` names
its step builder, ``portbench/systems/<system>.py``, loaded from the
checkout's own folder as the readers are.  So a later configuration, cell,
mix or metric is added by files and entries alone.

A run: set-up (imports, the kernel library loaded or built into the
program's ``_build/``, the state made from the seed, ``warmup_steps``
steps), then a window of ``--seconds`` in which segments of
``segment_steps`` steps run back to back, each from the same prepared
state; each step is closed by a synchronise and timed on the host clock.
With ``--trace 1`` the window runs with spans around the program's layers
and is followed by one whole segment under the profiler, from the same
prepared state, so that the traced steps are the traffic's own; with
``--trace 0`` a cell with an end-to-end metric read from the device trace
runs that segment under a device-only profiler instead.  Then the
peak memory is read, the program's state is freed, and a sample of the
window's steps, drawn from the seed, is held to the plain reference.  The
last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import operator
import os
import pathlib
import random
import sys
import time

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
PORT = "iterative_solvers_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "iterative_solvers_tpu")
RULES = {"<=": operator.le, ">": operator.gt, ">=": operator.ge}


def process_start(now: float) -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (Linux ``/proc``; ``now`` where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


class Run:
    """What one run measured; the metric readers take their numbers from it."""

    def __init__(self):
        self.setup_s = None
        self.setup_split = {}
        self.step_s = []          # host-clock seconds of each step of the window
        self.infos = []           # the step's own report: converged, iterations
        self.segment_steps = 1
        self.window_s = 0.0
        self.spans = {}           # {name: [calls, ms]} over the window (--trace 1)
        self.trace = None         # trace.summarize() of the traced steps (--trace 1)
        self.device = None        # trace.device_busy() of one segment (--trace 0)
        self.meta = {}
        self.device_kind = None

    @property
    def steps(self) -> int:
        return len(self.step_s)


def load_cell(root: pathlib.Path, workload: str, trace: bool):
    """``(cell, config, traffic, metrics)`` of ``workload``: its entry, its
    configuration and traffic files, and the metric entries it reports
    (the end-to-end ones, or with ``trace`` the per-layer ones)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / PKG.name / "traffic" / f"{cell['traffic']}.json").read_text())
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if reported_in(bench, m, workload)]
    return cell, config, traffic, metrics


def reported_in(bench: dict, metric: dict, workload: str) -> bool:
    """Whether ``workload`` reports ``metric``: the cells its ``workloads``
    key lists; without the key, every cell for an end-to-end metric, and for
    a per-layer one every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return reported_in(bench, moved, workload)
    return True


def load_reader(root: pathlib.Path, name: str):
    path = root / PKG.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_system(root: pathlib.Path, name: str):
    """The step builder ``portbench/systems/<name>.py`` of the checkout
    ``root``, loaded by its path as a module of this package, so that its
    relative imports find the package's reference and helpers."""
    path = pathlib.Path(root) / PKG.name / "systems" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{PKG.name}.systems.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_beside(path: str, name: str):
    """The reader of metric ``name`` in the folder of the reader file
    ``path``: a metric that reads the same quantity under another name
    (in cells whose end-to-end metrics differ) loads it so."""
    return load_reader(pathlib.Path(path).resolve().parents[2], name)


def sample_picks(traffic: dict, seed: int) -> set:
    """Step indices of the window whose answers are checked: the first step
    (from the prepared state) and ``check_samples - 1`` more drawn from the
    seed among the rest of the first segment (every segment is the same
    work from the same state); the window's last step is added when it
    closes."""
    seg = traffic["segment_steps"]
    k = min(traffic["check_samples"] - 1, seg - 1)
    return {0} | set(random.Random(seed).sample(range(1, seg), k))


def fold_worst(acc: dict, readings: dict, limits: dict):
    """Keep in ``acc`` the worst of each reading: the largest of a number
    held under its limit, the smallest of one held above it."""
    for name, value in readings.items():
        pick = max if limits[name][1] == "<=" else min
        acc[name] = value if name not in acc else pick(acc[name], value)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda"):
    """Set up, measure and check one cell; returns ``(result, checks, run)``."""
    import torch

    cell_entry, config, traffic, metric_entries = load_cell(root, workload, trace)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    run = Run()
    lap = [t_start]

    def mark(name):
        now = time.perf_counter()
        run.setup_split[name] = now - lap[0]
        lap[0] = now

    importlib.import_module(PORT)
    system = load_system(root, config["system"])
    mark("imports")
    if cuda:
        build = importlib.import_module(PORT + ".ops._build")
        run.meta["library_built"] = not any(build.BUILD_DIR.glob("*.so"))
        build.load_library()
        run.device_kind = torch.cuda.get_device_name(dev)
    mark("library")
    cell = system.build(config, traffic, seed, dev)
    sync()
    mark("prepare")
    state = cell.initial
    for _ in range(traffic["warmup_steps"]):
        state, _ = cell.step(state)
    sync()
    mark("warmup")
    # the benchmark's own making of the state is the yardstick's, not the
    # program's set-up: it is reported in the split and left out
    run.setup_split["bench_own"] = cell.own_s
    run.setup_s = lap[0] - t_start - cell.own_s
    run.meta.update(cell.meta)

    spans = None
    if trace:
        from .spans import Spans
        spans = Spans(cell.spans, cuda).__enter__()
    picks, samples, seg = sample_picks(traffic, seed), {}, traffic["segment_steps"]
    run.segment_steps = seg
    state, pos = cell.initial, 0
    t_w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        new, info = cell.step(state)
        sync()
        t1 = time.perf_counter()
        i = run.steps
        run.step_s.append(t1 - t0)
        run.infos.append(info)
        if i in picks:
            samples[i] = (state, new, info)
        last = (i, (state, new, info))
        state, pos = new, pos + 1
        if pos == seg:
            state, pos = cell.initial, 0
        if t1 - t_w0 >= seconds:
            break
    run.window_s = t1 - t_w0
    samples[last[0]] = last[1]
    del last, new
    if trace:
        run.spans = spans.take()
        spans.__exit__(None, None, None)
    carry = [cell.initial]

    def segment(n):
        for _ in range(n):
            carry[0] = cell.step(carry[0])[0]

    if cuda and trace:
        from .trace import profile_steps
        run.trace = profile_steps(segment, seg)
    elif cuda and any(m["source"] == "device_trace" for m in metric_entries):
        from .trace import device_busy
        run.device = device_busy(segment, seg)
        run.meta["device_busy"] = {k: run.device[k] for k in ("busy_s", "wall_s",
                                                             "device_intervals", "reduce_s")}
    del carry
    del state
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the program's state is freed before the reference runs
    cell.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.limits()
    worst, own_gap = {}, {}
    for idx in sorted(samples):
        before, after, info = samples[idx]
        readings = cell.readings((before, after))
        fold_worst(worst, readings, limits)
        # the program's own reading of a compared number beside the reference's
        for name, key in cell.own.items():
            gap = abs(readings[name] - info[key]) / max(abs(readings[name]), 1e-300)
            own_gap[name] = max(own_gap.get(name, 0.0), gap)
    run.meta.update(cell.meta)      # and what the checks added to it
    failed = sum(1 for info in run.infos if not info["converged"])
    checks = [{"name": n, "value": worst[n], "limit": lim, "rule": rule,
               "ok": bool(RULES[rule](worst[n], lim))} for n, (lim, rule) in limits.items()]
    checks.append({"name": "failed_steps", "value": failed, "limit": 0, "rule": "<=",
                   "ok": failed == 0})
    checks.append({"name": "steps_checked", "value": len(samples), "limit": 1,
                   "rule": ">=", "ok": len(samples) >= 1})

    metrics = {}
    for m in metric_entries:
        value = load_reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": all(c["ok"] for c in checks) and run.steps > 0,
        "attempted": run.steps,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": run.device_kind or dev.type,
                   "count": cell_entry["chips"],
                   "memory_peak_bytes": int(peak)},
    }
    if run.trace is not None:
        result["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["wall_s"])
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    run.meta.update(setup_split=run.setup_split, setup_s=run.setup_s, window_s=run.window_s,
                    steps=run.steps, seg_steps=seg, spans=run.spans, own_gap=own_gap)
    return result, checks, run


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start(time.perf_counter())
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell, _, _, _ = load_cell(ROOT, args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, checks, run = run_cell(ROOT, args.workload, args.seed, args.seconds,
                                   bool(args.trace), t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 4
    iters = [i.get("newton_iters", i.get("krylov_iters")) for i in run.infos]
    print(json.dumps({"run": run.meta, "iters": iters,
                      "step_ms": [round(s * 1e3, 3) for s in run.step_s]}), flush=True)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} {c['rule']} {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
