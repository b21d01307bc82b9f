"""The readers of the program's own spans and counters
(``portbench/program.py``): their arithmetic on a synthetic run and a
synthetic trace that holds the program's spans as user annotations, that
the annotations stay out of the trace's device and host reductions, that
a program without tracing reads nothing, and the readings of small
traced cells on the CPU."""
import sys

import pytest

from portbench import program
from portbench.run import Run, load_reader
from portbench.tests.helpers import ROOT, run_small, small_root
from portbench.trace import summarize

NEW = ("host.syncs", "host.wait_ms", "newton.self_ms", "pma.substep_ms")
DROPLET = ("host.syncs.droplet", "host.wait_ms.droplet", "newton.self_ms.droplet")


def reader(name):
    return load_reader(ROOT, name).read


def synthetic_traces():
    from iterative_solvers_tpu_torch.utils.trace import Span, Trace

    ms = 1_000_000
    a = Trace([Span("step", 0, None, 0, 100 * ms),
               Span("newton.solve", 0, 0, 0, 60 * ms),
               Span("newton.residual", 0, 1, 0, 5 * ms),
               Span("krylov.cycle", 0, 1, 10 * ms, 40 * ms),
               Span("pma.loop", 0, 0, 60 * ms, 100 * ms),
               Span("pma.substep", 0, 4, 60 * ms, 80 * ms),
               Span("pma.substep", 0, 4, 80 * ms, 100 * ms)],
              {0: {"host.syncs": 7, "host.wait_ns": 3 * ms}})
    b = Trace([Span("step", 1, None, 200 * ms, 300 * ms),
               Span("newton.solve", 1, 0, 200 * ms, 250 * ms),
               Span("krylov.cycle", 1, 1, 210 * ms, 230 * ms),
               Span("pma.loop", 1, 0, 250 * ms, 300 * ms),
               Span("pma.substep", 1, 3, 250 * ms, 300 * ms)],
              {1: {"host.syncs": 5, "host.wait_ns": 1 * ms}, None: {"host.syncs": 2}})
    return [a, b]


def test_reduce_traced_reads_per_step():
    r = program.reduce_traced(synthetic_traces(), wall_s=0.2)
    assert r["steps"] == 2
    assert r["host.syncs"] == pytest.approx(7.0)             # (7 + 5 + 2) / 2
    assert r["host.wait_ms"] == pytest.approx(2.0)
    assert r["newton.self_ms"] == pytest.approx(((60 - 30) + (50 - 20)) / 2)
    assert r["pma.substep_ms"] == pytest.approx(30.0)        # (20 + 20 + 50) / 3
    assert r["krylov.cycle_ms"] == pytest.approx(25.0)
    assert r["pma.loop_share"] == pytest.approx(0.09 / 0.2)
    assert r["spans"]["pma.substep"] == [3, pytest.approx(90.0)]
    assert program.reduce_traced([], 1.0) is None


def test_reduce_traced_without_step_spans_takes_the_callers_steps():
    from iterative_solvers_tpu_torch.utils.trace import Trace

    ms = 1_000_000
    t = Trace([], {None: {"host.syncs": 2108, "host.wait_ns": 30 * ms, "cg.restarts": 4}})
    assert program.reduce_traced([t], wall_s=1.0) is None
    r = program.reduce_traced([t], wall_s=1.0, steps=2)
    assert r["steps"] == 2 and r["spans"] == {}
    assert r["counters"] == {"cg.restarts": 2.0, "host.syncs": 1054.0, "host.wait_ns": 15 * ms}
    assert r["host.syncs"] == 1054.0 and r["host.wait_ms"] == pytest.approx(15.0)
    assert r["newton.self_ms"] is None and r["pma.substep_ms"] is None
    # where there are step spans, they count, whatever the caller ran
    traces = synthetic_traces()
    assert program.reduce_traced(traces, 0.2, steps=5) == program.reduce_traced(traces, 0.2)
    assert program.reduce_traced(traces, 0.2)["counters"] == {"host.syncs": 7.0,
                                                              "host.wait_ns": 2 * ms}
    run = Run()
    run.program_reading = r
    assert reader("host.syncs.cg")(run) == 1054.0
    assert reader("host.wait_ms.cg")(run) == pytest.approx(15.0)


def test_readers_read_the_program_reading():
    run = Run()
    run.program_reading = program.reduce_traced(synthetic_traces(), wall_s=0.2)
    want = {"host.syncs": 7.0, "host.wait_ms": 2.0, "newton.self_ms": 30.0,
            "pma.substep_ms": 30.0}
    for name in NEW:
        assert reader(name)(run) == pytest.approx(want[name]), name
    for name in DROPLET:
        assert reader(name)(run) == reader(name.rsplit(".", 1)[0])(run)
    run.program_reading["newton.self_ms"] = run.program_reading["pma.substep_ms"] = None
    assert reader("newton.self_ms")(run) is None and reader("pma.substep_ms")(run) is None


def test_readers_outside_a_run_or_without_tracing_read_nothing(monkeypatch, tmp_path):
    for name in NEW + DROPLET:
        assert reader(name)(Run()) is None, name         # not inside run_cell
    # a program without tracing, as the parent commit is: a package whose
    # utils have no trace module
    utils = tmp_path / "iterative_solvers_tpu_torch" / "utils"
    utils.mkdir(parents=True)
    (utils.parent / "__init__.py").write_text("")
    (utils / "__init__.py").write_text("")
    for name in [m for m in sys.modules if m.split(".")[0] == "iterative_solvers_tpu_torch"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(tmp_path))
    run = Run()
    assert program.reading(run) is None and "program" not in run.meta
    for name in NEW + DROPLET:
        assert reader(name)(run) is None, name


def synthetic_events():
    """``(name, device, annotation, start_us, end_us, thread)``: kernels
    with gaps at 50-80 (inside ``krylov.cycle``), 100-130 (inside
    ``newton.solve``, outside its cycle), 140-170 (no span), and the
    device-side copy of an annotation, which is no device interval."""
    return [("jvp_fused", True, False, 0.0, 40.0, 0),
            ("sh_strip_kernel<float, 4>", True, False, 30.0, 50.0, 0),
            ("Memcpy DtoD", True, False, 80.0, 100.0, 0),
            ("sh_tile_kernel<double>", True, False, 130.0, 140.0, 0),
            ("sh_tile_kernel<double>", True, False, 170.0, 180.0, 0),
            ("krylov.cycle", True, True, 40.0, 90.0, 0),
            ("aten::step", False, False, -5.0, 110.0, 1),
            ("cudaLaunchKernel", False, False, 55.0, 60.0, 1),
            ("cudaStreamSynchronize", False, False, 60.0, 79.0, 1),
            ("cudaLaunchKernel", False, False, 101.0, 102.0, 1),
            ("other thread op", False, False, 50.0, 140.0, 2),
            ("step", False, True, -10.0, 135.0, 1),
            ("newton.solve", False, True, -8.0, 134.0, 1),
            ("krylov.cycle", False, True, 45.0, 90.0, 1),
            ("pma.loop", False, True, 60.0, 200.0, 2)]      # another thread's


def test_annotations_stay_out_of_the_trace_reductions():
    events = synthetic_events()
    device, host, annotations = program.split_events(events)
    assert {a[0] for a in annotations} == {"step", "newton.solve", "krylov.cycle", "pma.loop"}
    plain = [e for e in events if not e[2]]
    d0, h0, a0 = program.split_events(plain)
    assert (device, host, a0) == (d0, h0, [])
    got = program.reduce_profile(device, host, annotations, 200e-6, 2)
    want = summarize(d0, h0, 200e-6, 2)
    assert got["idle_gaps"] == want["idle_gaps"] and got["device_ops"] == want["device_ops"]
    assert got["launches_per_step"] == want["launches"] / 2 == 1.0
    assert got["busy_s"] == want["busy_s"] == pytest.approx(90e-6)
    assert got["device_idle"] == pytest.approx(1 - 90 / 200)


def test_idle_by_span_names_the_innermost_program_span():
    device, host, annotations = program.split_events(synthetic_events())
    got = program.reduce_profile(device, host, annotations, 200e-6, 2)
    by = dict(got["idle_by_span"])
    assert by == {"krylov.cycle": pytest.approx(30e-6), "newton.solve": pytest.approx(30e-6),
                  "outside": pytest.approx(30e-6)}
    assert got["idle_under_spans"] == pytest.approx(2 / 3)
    got = program.reduce_profile(device, host, [], 200e-6, 2)
    assert got["idle_by_span"] == [["outside", pytest.approx(90e-6)]]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", ["sh24.cn", "sh24.semi"])
def test_traced_small_cells_report_the_program_metrics(small, cell):
    result, _, run = run_small(small, cell, seconds=2.0, trace=True)
    assert result["correct"] and run.steps >= 10          # a whole segment in the window
    names = set(result["metrics"])
    assert {"host.syncs", "host.wait_ms"} <= names
    assert ("newton.self_ms" in names) == (cell == "sh24.cn")
    assert not names & {"pma.substep_ms", *DROPLET}
    prog = run.meta["program"]
    assert prog["steps"] == 10 and prog["step_ms"] > 0 and prog["process_s"] > 0
    spans = prog["spans"]
    assert spans["step"][0] == 10 and spans["krylov.cycle"][0] >= 10
    # the program's cycle spans and the benchmark's outside spans read the same steps
    if cell == "sh24.cn":
        assert spans["newton.solve"][0] == 10
        assert prog["krylov.cycle_ms"] == pytest.approx(
            prog["outside_ms_per_step"]["krylov"], rel=0.1)
    else:
        # GMRES reads 2 + iterations + cycles; the iterations of the window's
        # first segment, the same work
        assert prog["host.syncs"] == pytest.approx(
            2 + spans["krylov.cycle"][0] / 10
            + sum(i["krylov_iters"] for i in run.infos[:10]) / 10)


def test_a_real_profile_sets_the_program_spans_apart():
    """The profiler's own results on the CPU: each program span comes out
    once as an annotation of one thread, and none among the host events."""
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    from iterative_solvers_tpu_torch.models import swift_hohenberg as sh
    from iterative_solvers_tpu_torch.utils import trace

    cfg = sh.SHConfig(n=16, d=10.0)
    step = sh.make_cn_step(cfg, sh.fast_solver(cfg), device="cpu")
    u = torch.randn((16, 16), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.tracing():
        step(u)
    spans = Counter(s.name for s in trace.take().spans)
    device, host, annotations = program.split_events(program._kineto_events(prof))
    assert Counter(a[0] for a in annotations) == spans and len({a[3] for a in annotations}) == 1
    assert not device and host and not set(spans) & {h[0] for h in host}
