"""The program's own spans and counters (``iterative_solvers_tpu_torch.utils.trace``),
read for the per-layer metrics of a ``--trace 1`` run.

The harness hands a metric reader the finished run alone, after the
window, its profiled segment and the reference checks, and turns none of
the program's tracing on.  So the first reader that asks starts a fresh
process (``python -m portbench.program <root> <workload> <seed> <device>``)
with the configuration, traffic and seed of the ``run_cell`` call that
loads it: a ``torch.profiler`` session leaves the host that ran it slower
for the rest of the process (PERF.md §6), so the readings are not taken
after the harness's profiled segment.  That process builds the cell, runs
its warm-up steps, then one whole segment from the prepared state with
the program's tracing on, each step closed by a synchronise as in the
window and the benchmark's outside spans (``spans.Spans``) around it; on
a card one more traced segment under ``torch.profiler`` follows.
Its last line is kept on the run (``run.program_reading``) and printed in
the run's earlier line (``run.meta["program"]``): the per-step readings,
the spans a step, the outside spans over the same steps, and the profiled
segment's idle gaps summed by the innermost program span over each gap's
middle (``idle_by_span``; ``outside`` where none is).  A program without
``utils/trace`` reads None, and its readers report nothing.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

from . import run as harness
from . import trace as devtrace

TRACE = "iterative_solvers_tpu_torch.utils.trace"
TIMEOUT_S = 600


def reading(run):
    """The program's readings of ``run`` (made once), or None."""
    if not hasattr(run, "program_reading"):
        run.program_reading = _read()
        if run.program_reading is not None:
            run.meta["program"] = run.program_reading
    return run.program_reading


def _call():
    """The locals of the ``run_cell`` call that is reading its metrics."""
    frame = sys._getframe()
    while frame is not None and frame.f_code is not harness.run_cell.__code__:
        frame = frame.f_back
    return None if frame is None else frame.f_locals


def _read():
    call = _call()
    if call is None or importlib.util.find_spec(TRACE) is None:
        return None
    import torch

    root = pathlib.Path(call["root"]).resolve()
    # the modules and the CPU thread count of this process
    path = [str(root)] + [os.path.abspath(p or os.curdir) for p in sys.path]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path),
               OMP_NUM_THREADS=str(torch.get_num_threads()))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{__package__}.program", str(root), call["workload"],
         str(call["seed"]), str(call["device"])],
        cwd=root, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"portbench.program failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.splitlines()[-1])
    if out is not None:
        out["process_s"] = time.perf_counter() - t0
    return out


def measure(root, workload: str, seed: int, device: str) -> dict:
    """Build ``workload`` from ``seed`` and read the program's tracing over
    one whole segment (and, on a card, a profiled one)."""
    import torch

    from .spans import Spans

    trace = importlib.import_module(TRACE)
    _, config, traffic, _ = harness.load_cell(pathlib.Path(root), workload, False)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        importlib.import_module(harness.PORT + ".ops._build").load_library()
    cell = harness.load_system(root, config["system"]).build(config, traffic, seed, dev)
    seg = traffic["segment_steps"]

    def segment(n=seg):
        state = cell.initial
        for _ in range(n):
            state = cell.step(state)[0]
            if cuda:
                torch.cuda.synchronize(dev)

    segment(traffic["warmup_steps"])
    with Spans(cell.spans, cuda) as outside:
        t0 = time.perf_counter()
        with trace.tracing():
            segment()
        wall_s = time.perf_counter() - t0
        outside_ms = outside.take()
    out = reduce_traced([trace.take()], wall_s, seg)
    if out is None:
        return None
    out["step_ms"] = 1e3 * wall_s / out["steps"]
    out["outside_ms_per_step"] = {k: ms / out["steps"] for k, (_, ms) in outside_ms.items()}
    if cuda:
        out["profiled"] = profile_segment(segment, trace, seg)
    return out


def reduce_traced(traces, wall_s, steps=None):
    """Per-step readings of the traced segments ``traces`` (``utils.trace``
    ``Trace`` values) whose steps took ``wall_s`` host seconds: over their
    ``step`` spans, or, where the program opened none (an entry point
    without one, such as a solver called directly), over the ``steps``
    that the caller ran; None when neither gives a count.  ``counters``
    holds every counter the program recorded, summed and divided by the
    steps."""
    from iterative_solvers_tpu_torch.utils.trace import self_ns

    steps = sum(1 for t in traces for s in t.spans if s.name == "step") or steps
    if not steps:
        return None
    total = {}
    for t in traces:
        for counters in t.counters.values():
            for name, v in counters.items():
                total[name] = total.get(name, 0) + v
    ns = {}
    calls = {}
    for t in traces:
        for s in t.spans:
            ns[s.name] = ns.get(s.name, 0) + s.t1_ns - s.t0_ns
            calls[s.name] = calls.get(s.name, 0) + 1
    solve_self = sum(self_ns(t.spans, "newton.solve", ("krylov.cycle",)) for t in traces)
    return {
        "steps": steps,
        "spans": {n: [calls[n], ns[n] * 1e-6] for n in sorted(ns)},
        "counters": {n: v / steps for n, v in sorted(total.items())},
        "host.syncs": total.get("host.syncs", 0) / steps,
        "host.wait_ms": total.get("host.wait_ns", 0) * 1e-6 / steps,
        "newton.self_ms": solve_self * 1e-6 / steps if "newton.solve" in calls else None,
        "pma.substep_ms": (ns["pma.substep"] * 1e-6 / calls["pma.substep"]
                           if "pma.substep" in calls else None),
        "krylov.cycle_ms": ns.get("krylov.cycle", 0) * 1e-6 / steps,
        "pma.loop_share": ns.get("pma.loop", 0) * 1e-9 / wall_s if wall_s else None,
    }


def profile_segment(segment, trace, nsteps: int) -> dict:
    """One whole segment with the program's tracing on under
    ``torch.profiler``, its spans in the trace as user annotations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            trace.tracing():
        t0 = time.perf_counter()
        segment()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    trace.take()
    t1 = time.perf_counter()
    out = reduce_profile(*split_events(_kineto_events(prof)), wall_s, nsteps)
    out["reduce_s"] = time.perf_counter() - t1
    return out


def _kineto_events(prof):
    """``(name, device, annotation, start_us, end_us, thread)`` of each
    event of a finished profile, read from the profiler's own results (no
    host-side event tree is built)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-3
        yield (e.name(), e.device_type() == DeviceType.CUDA, e.is_user_annotation(),
               s, s + e.duration_ns() * 1e-3, e.start_thread_id())


def split_events(events):
    """``(device, host, annotations)`` of the events
    ``(name, device, annotation, start_us, end_us, thread)``: the device
    intervals and host events as ``trace.summarize`` takes them, with
    every user annotation (the program's spans) set apart from both."""
    device, host, annotations = [], [], []
    for name, on_device, annotation, s, t, thread in events:
        if annotation:
            if not on_device:
                annotations.append((name, s, t, thread))
        elif on_device:
            device.append((name, s, t))
        else:
            host.append((name, s, t, thread))
    return device, host, annotations


def reduce_profile(device, host, annotations, wall_s: float, nsteps: int) -> dict:
    """``trace.summarize`` of the segment without its annotations, and
    ``idle_by_span``: the idle gaps' seconds summed by the innermost
    program span that covers each gap's middle (``outside`` where none
    does), largest first."""
    s = devtrace.summarize(device, host, wall_s, nsteps)
    _, gaps = devtrace.union(device)
    threads = {}
    for a in annotations:
        threads[a[3]] = threads.get(a[3], 0) + 1
    main = max(threads, key=threads.get) if threads else None
    by_span = {}
    for label, secs in devtrace._label_gaps(gaps, [a for a in annotations if a[3] == main]):
        label = "outside" if label == "python" else label
        by_span[label] = by_span.get(label, 0.0) + secs
    idle = sum(by_span.values())
    return {"wall_s": wall_s, "busy_s": s["busy_s"], "steps": nsteps,
            "device_idle": 1.0 - s["busy_s"] / wall_s if s["busy_s"] else None,
            "launches_per_step": s["launches"] / nsteps, "device_ops": s["device_ops"],
            "idle_gaps": s["idle_gaps"],
            "idle_by_span": sorted(([n, v] for n, v in by_span.items()), key=lambda x: -x[1]),
            "idle_under_spans": 1.0 - by_span.get("outside", 0.0) / idle if idle else None}


if __name__ == "__main__":
    root, workload, seed, device = sys.argv[1:5]
    print(json.dumps(measure(root, workload, int(seed), device)), flush=True)
