"""The device trace of a few whole steps, reduced to what the metrics
read.

The union of the device intervals is a frozen copy of the smoke script's
``device_profile``: ``busy_s`` is the length of the union of every device
interval (kernels, copies, sets) in a ``torch.profiler`` trace, ``wall_s``
the host clock around the traced steps, closed by a synchronise.  The
profiler can drop device intervals, so ``1 - busy_s / wall_s`` is an upper
bound of the device's idle share.  Each idle gap between device intervals
is named by what the host was doing at its middle: the innermost host
event (operator or CUDA runtime call) that covers it, or ``python`` where
none does.  ``device_busy`` is the lean reading of the union alone, which
an end-to-end metric takes in an untraced run."""
from __future__ import annotations

import time

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
TOP = 10


def profile_steps(run_steps, nsteps: int) -> dict:
    """Run ``run_steps(nsteps)`` under ``torch.profiler`` and reduce the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(nsteps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device.append(span)
        else:
            host.append(span + (e.thread,))
    return summarize(device, host, wall_s, nsteps)


def device_busy(run_steps, nsteps: int) -> dict:
    """Run ``run_steps(nsteps)`` under a device-only ``torch.profiler`` and
    return the union of its device intervals: the end-to-end device time,
    without the host events (operators, runtime calls) that the full trace
    records to name the idle gaps, which slow the host and its reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(nsteps)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    device = _device_intervals(prof)
    busy_us, _ = union(device)
    return {"wall_s": wall_s, "busy_s": busy_us * 1e-6 if device else None,
            "steps": nsteps, "device_intervals": len(device),
            "reduce_s": time.perf_counter() - t1}


def _device_intervals(prof) -> list:
    """``(name, start_us, end_us)`` of each device interval of a finished
    profile, read from the profiler's own results where this PyTorch has
    them (no host-side event tree is built), else from ``prof.events()``."""
    from torch.autograd import DeviceType

    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is None:
        return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", None) and e.is_user_annotation():
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        else:
            s, d = float(e.start_us()), float(e.duration_us())
        out.append((e.name(), s, s + d))
    return out


def union(device) -> tuple:
    """``(busy_us, gaps)``: the length of the union of the intervals
    ``(name, start_us, end_us)``, and the ``(end, start)`` of each gap
    between them."""
    busy_us, gaps, end = 0.0, [], None
    for s, t in sorted((s, t) for _, s, t in device):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy_us += t - s
            end = t
        elif t > end:
            busy_us += t - end
            end = t
    return busy_us, gaps


def _main_thread(host):
    counts = {}
    for h in host:
        counts[h[3]] = counts.get(h[3], 0) + 1
    return max(counts, key=counts.get) if counts else None


def summarize(device, host, wall_s: float, nsteps: int) -> dict:
    """``device``: ``(name, start_us, end_us)`` of each device interval;
    ``host``: ``(name, start_us, end_us, thread)`` of each host event."""
    kernels = {}
    for name, s, t in device:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t - s) * 1e-6
    busy_us, gaps = union(device)
    launches = sum(1 for h in host if h[0] in LAUNCH_CALLS)
    main = _main_thread(host)
    labelled = {}
    for label, secs in _label_gaps(gaps, [h for h in host if h[3] == main]):
        labelled[label] = labelled.get(label, 0.0) + secs
    ops = sorted(([n, k[1]] for n, k in kernels.items()), key=lambda x: -x[1])[:TOP]
    idle = sorted(([n, s] for n, s in labelled.items()), key=lambda x: -x[1])[:TOP]
    return {"wall_s": wall_s, "busy_s": busy_us * 1e-6 if device else None,
            "steps": nsteps, "launches": launches, "device_intervals": len(device),
            "kernels": kernels, "device_ops": ops, "idle_gaps": idle}


def _label_gaps(gaps, host):
    """``(label, seconds)`` of each gap, by the innermost host event that
    covers the gap's middle (host events of one thread nest)."""
    events = sorted(host, key=lambda h: (h[1], -h[2]))
    stack, i = [], 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while i < len(events) and events[i][1] <= mid:
            while stack and stack[-1][2] <= events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        yield (stack[-1][0] if stack else "python"), (g1 - g0) * 1e-6
