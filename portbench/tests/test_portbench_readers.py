"""The metric readers' arithmetic on synthetic spans and a synthetic trace,
and the trace's reduction: the busy union, the idle gaps and what the host
was doing in them, the launches."""
import math

import pytest

from portbench import peaks
from portbench.run import Run, load_reader
from portbench.trace import summarize, union
from portbench.tests.helpers import ROOT

KIND = "NVIDIA H100 80GB HBM3"


def reader(name):
    return load_reader(ROOT, name).read


def synthetic_trace():
    # device: two overlapping kernels, a gap, a copy; host: a step op with a
    # launch and a sync inside it, then nothing (python) over the second gap
    device = [("jvp_fused", 0.0, 40.0), ("sh_strip_kernel<float, 4>", 30.0, 50.0),
              ("Memcpy DtoD", 80.0, 100.0), ("sh_tile_kernel<double>", 130.0, 140.0)]
    host = [("aten::step", -5.0, 110.0, 1), ("cudaLaunchKernel", 55.0, 60.0, 1),
            ("cudaStreamSynchronize", 60.0, 79.0, 1), ("cudaLaunchKernel", 101.0, 102.0, 1),
            ("other thread op", 50.0, 140.0, 2)]
    return summarize(device, host, wall_s=200e-6, nsteps=2)


def test_trace_reduction():
    t = synthetic_trace()
    assert t["busy_s"] == pytest.approx(80e-6)          # 0-50, 80-100, 130-140
    assert t["launches"] == 2 and t["steps"] == 2 and t["device_intervals"] == 4
    gaps = dict(t["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)   # 50-80, middle 65
    assert gaps["python"] == pytest.approx(30e-6)                  # 100-130, middle 115
    assert t["kernels"]["jvp_fused"] == [1, pytest.approx(40e-6)]
    assert t["device_ops"][0] == ["jvp_fused", pytest.approx(40e-6)]


def traced_run():
    run = Run()
    run.trace = synthetic_trace()
    run.meta = {"points": 1024 * 1024}
    run.device_kind = KIND
    return run


def test_trace_readers():
    run = traced_run()
    assert reader("device.idle")(run) == pytest.approx(1 - 80 / 200)
    assert reader("host.launches")(run) == 1.0
    assert reader("device.idle.droplet")(run) == reader("device.idle")(run)
    assert reader("host.launches.droplet")(run) == 1.0
    assert reader("sh_operator.us")(run) == pytest.approx(15.0)   # (20 + 10) us / 2 calls
    bound_s = peaks.droplet_jvp_bytes(1024 * 1024) / 3.35e12
    assert reader("droplet_jvp_roofline")(run) == pytest.approx(100 * bound_s / 40e-6)


def test_span_and_step_readers():
    run = Run()
    run.setup_s = 12.5
    run.step_s = [0.1] * 19 + [0.3]
    run.window_s = 2.2
    run.spans = {"krylov": [40, 1500.0], "pma": [20, 1100.0]}
    run.infos = [{"newton_iters": k % 3, "converged": True} for k in range(20)]
    assert reader("setup_s")(run) == 12.5
    assert reader("step_ms")(run) == pytest.approx(110.0)
    assert reader("step_p95_ms")(run) == pytest.approx(100.0)   # 19th of 20, nearest rank
    run.step_s[-2] = 0.2
    assert reader("step_p95_ms")(run) == pytest.approx(200.0)
    assert reader("krylov.ms")(run) == pytest.approx(75.0)
    assert reader("krylov.ms.droplet")(run) == pytest.approx(75.0)
    assert reader("step_ms.droplet")(run) == pytest.approx(110.0)
    assert reader("pma.share")(run) == pytest.approx(0.5)
    assert reader("newton.iters")(run) == pytest.approx(sum(k % 3 for k in range(20)) / 20)
    run.segment_steps = 3      # 6 whole segments of 3: the last 2 steps are left out
    assert reader("newton.iters")(run) == pytest.approx(sum(k % 3 for k in range(18)) / 18)
    run.segment_steps = 40     # not one whole segment: every step counts
    assert reader("newton.iters")(run) == pytest.approx(sum(k % 3 for k in range(20)) / 20)
    assert reader("newton.iters.droplet")(run) == reader("newton.iters")(run)


def test_device_ms_reads_the_busy_union_a_step():
    run = Run()
    device = [("a", 0.0, 40.0), ("b", 30.0, 50.0), ("c", 80.0, 100.0)]
    busy_us, gaps = union(device)
    assert busy_us == 70.0 and gaps == [(50.0, 80.0)]
    run.device = {"busy_s": busy_us * 1e-6, "wall_s": 1.0, "steps": 2}
    assert reader("device_ms")(run) == pytest.approx(0.035)


class _Kineto:
    """A profiler result event as PyTorch's own results give it."""

    def __init__(self, name, device, start_us, dur_us, ns=True):
        self._v = (name, device, start_us, dur_us)
        if ns:
            self.start_ns = lambda: start_us * 1000
            self.duration_ns = lambda: dur_us * 1000
        else:
            self.start_us = lambda: start_us
            self.duration_us = lambda: dur_us

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]


@pytest.mark.parametrize("ns", [True, False])
def test_device_busy_reads_only_device_intervals(ns):
    from torch.autograd import DeviceType

    from portbench.trace import _device_intervals
    events = [_Kineto("k1", DeviceType.CUDA, 10, 30, ns), _Kineto("cudaLaunchKernel",
              DeviceType.CPU, 0, 5, ns), _Kineto("k2", DeviceType.CUDA, 30, 20, ns)]
    prof = type("P", (), {})()
    prof.profiler = type("R", (), {})()
    prof.profiler.kineto_results = type("K", (), {"events": lambda self: events})()
    device = _device_intervals(prof)
    assert [d[0] for d in device] == ["k1", "k2"]
    assert union(device)[0] == pytest.approx(40.0)     # 10-40 and 30-50


def test_cg_readers():
    run = traced_run()
    run.trace["kernels"]["void grid_dia_matvec_tiled_kernel<MvF64, false, 0>"] = [
        4, 4 * 22e-6]
    run.meta = {"grid": [999, 999], "itemsize": 8,
                "shifts": [[-1, 0], [0, -1], [0, 0], [0, 1], [1, 0]]}
    need = 8 * (999 * 999 + 4 * 998 * 999 + 2 * 999 * 999)
    assert peaks.grid_dia_matvec_bytes((999, 999), run.meta["shifts"], 8) == need
    assert reader("grid_dia_matvec_roofline")(run) == pytest.approx(
        100 * need / 3.35e12 / 22e-6)
    run.step_s = [0.5] * 5
    run.segment_steps = 2
    run.infos = [{"krylov_iters": k, "converged": True} for k in (10, 12, 10, 12, 99)]
    assert reader("cg.iters")(run) == pytest.approx(11.0)     # the last, partial segment out
    run.window_s = 2.5
    for name in ("step_ms", "host.launches", "device.idle"):
        assert reader(name + ".cg")(run) == reader(name)(run) is not None


def test_readers_find_nothing_and_return_nothing():
    run = Run()
    for name in ("device.idle", "host.launches", "sh_operator.us", "droplet_jvp_roofline",
                 "krylov.ms", "pma.share", "newton.iters", "step_ms", "step_p95_ms",
                 "device_ms", "step_ms.droplet", "newton.iters.droplet", "krylov.ms.droplet",
                 "host.launches.droplet", "device.idle.droplet", "cg.iters",
                 "grid_dia_matvec_roofline", "host.syncs.cg", "host.wait_ms.cg", "step_ms.cg",
                 "host.launches.cg", "device.idle.cg"):
        assert reader(name)(run) is None, name
    run.trace = summarize([], [], 1.0, 1)
    run.meta, run.device_kind = {"points": 4}, KIND
    assert reader("droplet_jvp_roofline")(run) is None and reader("device.idle")(run) is None
    run.meta.update(grid=[2, 2], shifts=[[0, 0]], itemsize=8)
    assert reader("grid_dia_matvec_roofline")(run) is None
    run.spans = {"krylov": [0, 0.0]}
    run.step_s, run.window_s = [0.1], 0.1
    assert reader("krylov.ms")(run) is None


def test_peaks_are_the_spec():
    assert peaks.hbm_bytes_per_s(KIND) == 3.35e12
    assert peaks.droplet_jvp_bytes(1) == 40
    with pytest.raises(KeyError):
        peaks.hbm_bytes_per_s("another card")
    assert math.isclose(reader("step_p95_ms")(type("R", (), {"step_s": [0.5]})()), 500.0)

