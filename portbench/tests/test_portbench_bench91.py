"""The published droplet step (``bench91.pma400``) on the CPU at its own
91x61 grid with 20 PMA sub-steps (``tests/small/bench91.json``; a step takes
about half a second here): the checked-in state and the configuration
against the published ones, the full-form reference geometry against the
deviation form's, the program's step against the reference under every
reading, the controls failing a number, whole runs with the program broken
underneath coming out not correct, the new readers on a synthetic run, and
one traced run of the cell on the card (``python -m pytest -m gpu
portbench/tests``).

The CPU size keeps the published grid and cuts the sub-steps from 400 to
20, so its PMA number has a limit of its own (``tests/small/bench91.json``):
20 sub-steps average the float32 rounding of the stencils' edge rows less
than 400 do, and the sound reading is higher (1.6e-5 on the CPU against
5-9e-6 at 400), while the float32 state's rounding of Q, fixed in size, is
a 20 times larger share of a 20 times smaller increment (~1e-3)."""
import dataclasses
import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import program
from portbench.control import control_readings
from portbench.reference import droplet as plain
from portbench.reference import droplet_full as ref
from portbench.run import RULES, ROOT, Run, load_cell, load_reader
from portbench.systems import droplet91 as system
from portbench.tests.helpers import PKG, run_small, small_root

CONFIG = json.loads((PKG / "configs" / "bench91.json").read_text())
TRAFFIC = json.loads((PKG / "traffic" / "pma400.json").read_text())
SMALL = json.loads((PKG / "tests" / "small" / "bench91.json").read_text())
P = plain.Params.of(CONFIG)
CELL = "bench91_cpu.pma400"
STATE = "initdrop_coal_1_91-61_100_0.005_0.01_0.1_0.15.txt"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """91 x 61 fields: torch's intra-op threads cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("root"))


@pytest.fixture(scope="module")
def cell(root):
    _, config, traffic, _ = load_cell(root, CELL, False)
    return system.build(config, traffic, 2 ** 31 + 23, torch.device("cpu"))


def test_the_configuration_is_the_published_one():
    """Every number of the reference's coalescence run as the port's
    fixture reader gives it, the headline step's dtypes and solver, and the
    sub-loop at the script's own 400 sub-steps of 3e-9."""
    dp = importlib.import_module("iterative_solvers_tpu_torch.models.droplet")
    fx = importlib.import_module("iterative_solvers_tpu_torch.io.fixtures")
    newton = importlib.import_module("iterative_solvers_tpu_torch.solvers.newton")
    published = dataclasses.replace(fx.config_for(fx.parse_name(STATE)),
                                    spectral_dtype="float32", mesh_dtype="float32")
    ours = dp.DropletConfig(**{k: CONFIG[k] for k in system.KEYS})
    assert ours == dataclasses.replace(published, dtmesh=ours.dtmesh)
    assert newton.NewtonKrylov(**CONFIG["solver"]) == dp.fast_solver()
    assert (CONFIG["pma_loops"], CONFIG["dtmesh"], CONFIG["deviation_form"]) == (400, 3e-9, False)
    assert (TRAFFIC["dt"], TRAFFIC["segment_steps"], TRAFFIC["check_samples"]) == (1e-5, 2, 2)


def test_the_seed_scales_the_film_within_its_amplitude(cell):
    with np.load(system.DATA) as d:
        u, q = d["u"], d["q"]
    assert u.shape == q.shape == (P.ny, P.nx) and u.dtype == q.dtype == np.float64
    got_u, got_q = (t.numpy() for t in cell.initial)
    rel = got_u / u - 1.0
    assert 0 < np.abs(rel).max() <= CONFIG["seed_amplitude"] and np.array_equal(got_q, q)
    assert not rel[0].any() and not rel[-1].any() and not rel[:, 0].any() and not rel[:, -1].any()
    a, b = (system.seeded_factor(P.ny, P.nx, 1.0, s, torch.float64, "cpu") for s in (1, 2))
    assert not torch.equal(a, b) and float((a - 1.0).abs().max()) <= 1.0


REGIONS = {"interior": (slice(1, -1), slice(1, -1)), "left column": (slice(None), 0),
           "right column": (slice(None), -1), "bottom row": (0, slice(None)),
           "top row": (-1, slice(None))}


@pytest.mark.parametrize("region", sorted(REGIONS))
def test_full_form_geometry_is_the_deviation_form_of_the_same_mesh(region):
    """On ``phi = Q - (x^2 + y^2)/2`` the two forms agree to float64 rounding
    as the second differences amplify it (32 ulps of max|Q| over h^2) in
    every region: the pinned edge Q_ksi, Q_eta are the identity's x, y where
    the deviation form zeroes phi's (phi_ksi is 1.1e-4 there, not zero); the
    correction 25/(6h)|edge| is what the one-sided row gives on the
    identity's x^2/2, so 1 + row(phi) in the deviation form; the cross
    derivative is zero on the boundary in both."""
    with np.load(system.DATA) as d:
        q = torch.tensor(d["q"])
    x, y = P.coords(torch.float64, "cpu")
    full = ref.geometry(q, P)
    dev = plain.geometry(q - 0.5 * (x * x + y * y), P)
    tol = 32 * torch.finfo(torch.float64).eps * float(q.abs().max()) / min(P.dx, P.dy) ** 2
    at = REGIONS[region]
    for name, a, b in zip(("x", "y", "Q_xx", "Q_yy", "Q_xy", "J"), full, dev):
        gap = float((a[at] - b[at]).abs().max())
        assert gap <= tol, (region, name, gap, tol)


@pytest.fixture(scope="module")
def two_steps(cell):
    """A chain of two steps from the prepared state: the cell's segment."""
    state, steps = cell.initial, []
    for _ in range(2):
        new, info = cell.step(state)
        steps.append((state, new, info))
        state = new
    return steps


def test_two_program_steps_pass_every_reading(cell, two_steps):
    limits = cell.limits()
    for before, after, info in two_steps:
        assert info["converged"] and info["newton_iters"] == 3
        readings = cell.readings((before, after))
        for name, value in readings.items():
            lim, rule = limits[name]
            assert RULES[rule](value, lim), (name, value)
        # the program's own residual norm beside the reference's (the two sum
        # the stencils' edge rows in other orders)
        gap = abs(info["f_norm"] - readings["step_residual_max"]) / readings["step_residual_max"]
        assert gap < 1e-6


def test_the_reference_rejects_a_perturbed_answer(cell, two_steps):
    before, (u, q), _ = two_steps[0]
    limits = cell.limits()

    def passes(after):
        got = cell.readings((before, after))
        return {k: bool(RULES[limits[k][1]](v, limits[k][0])) for k, v in got.items()}

    bad_u, bad_q = u.clone(), q.clone()
    bad_u[30, 45] += 1e-6
    bad_q[30, 45] += 1e-6
    got = passes((bad_u, q))
    assert not got["step_residual_max"] and got["pma_increment_error"]
    got = passes((u, bad_q))
    assert got["step_residual_max"] and not got["pma_increment_error"]


def test_the_controls_fail_their_numbers(root):
    _, summary = control_readings(root, CELL, [11, 2 ** 31 + 5], 1, device="cpu")
    limits, upper = summary["limits"], summary["upper"]
    for k, v in summary["lower"].items():
        assert RULES[limits[k][1]](v, limits[k][0]), (k, v)
    assert upper["float32"]["step_residual_max"] > limits["step_residual_max"][0]
    assert upper["float32"]["pma_increment_error"] > limits["pma_increment_error"][0]
    assert upper["tf32_pma"]["pma_increment_error"] > limits["pma_increment_error"][0]
    assert set(upper["tf32_pma"]) == {"pma_increment_error"}


def test_the_published_size_passes_its_limits_and_its_controls_fail_them():
    """One step at the published 400 sub-steps: the sound readings under
    the configuration's limits (the PMA number 4.5-5.7e-6 on the CPU), the
    float32 state above both (6.2e-5 for the PMA number), TF32 DCT operands
    above the PMA number's (1.2e-3)."""
    full = system.build(CONFIG, TRAFFIC, 2 ** 31 + 2323, torch.device("cpu"))
    limits, before = full.limits(), full.initial
    after, info = full.step(before)
    assert info["converged"] and info["newton_iters"] == 3
    for name, value in full.readings((before, after)).items():
        assert RULES[limits[name][1]](value, limits[name][0]), (name, value)
    failed = {}
    for name, (fn, only) in full.controls().items():
        got = full.readings((before, fn(before)))
        failed[name] = {k for k, v in got.items() if (only is None or k in only)
                        and not RULES[limits[k][1]](v, limits[k][0])}
    assert failed == {"float32": {"step_residual_max", "pma_increment_error"},
                      "tf32_pma": {"pma_increment_error"}}


def _unchanged(real):
    dp = importlib.import_module("iterative_solvers_tpu_torch.models.droplet")
    return lambda *a, **k: (lambda u, q, dt: dp.DropletStepResult(u, q, 3, 0.0, True))


def _altered(field):
    def wrap(real):
        def make(*a, **k):
            step = real(*a, **k)

            def broken(u, q, dt):
                out = step(u, q, dt)
                bad = getattr(out, field).clone()
                bad[30, 45] += 1e-6
                return out._replace(**{field: bad})
            return broken
        return make
    return wrap


@pytest.mark.parametrize("fault", ["unchanged", "altered_u", "altered_q"])
def test_a_run_with_the_program_broken_is_not_correct(root, monkeypatch, fault):
    dp = importlib.import_module("iterative_solvers_tpu_torch.models.droplet")
    wrap = _unchanged if fault == "unchanged" else _altered(fault[-1])
    monkeypatch.setattr(dp, "make_step", wrap(dp.make_step))
    result, checks, run = run_small(root, CELL, seconds=0.2)
    assert run.steps > 0 and result["correct"] is False
    assert any(not c["ok"] for c in checks)
    json.dumps(result)


def test_a_traced_run_is_correct_with_its_readings(root):
    result, checks, run = run_small(root, CELL, seconds=0.5, trace=True, seed=2 ** 31 + 5)
    assert result["correct"] and all(c["ok"] for c in checks)
    assert set(run.meta["own_gap"]) == {"step_residual_max"}
    m = {k: v["value"] for k, v in result["metrics"].items()}
    loops = SMALL["pma_loops"]
    prog = run.meta["program"]
    assert prog["spans"]["pma.substep"][0] == TRAFFIC["segment_steps"] * loops
    for phase in ("geometry", "monitor", "solve"):
        assert prog["spans"][f"pma.{phase}"][0] == TRAFFIC["segment_steps"] * loops
    assert m["newton.iters.bench91"] == 3.0
    assert m["droplet.residual_evals"] > 4 * m["newton.iters.bench91"]
    assert m["host.syncs.bench91"] > m["newton.iters.bench91"]
    assert 0 < m["pma.share.bench91"] < 1
    assert 0 < m["pma.geometry_ms"] + m["pma.monitor_ms"] + m["pma.solve_ms"] \
        < m["pma.substep_ms.bench91"] < m["step_ms.bench91"]
    # the accepted droplet metrics this cell reports too: on the CPU no kernel
    # launches, and no sub-step takes the fused kernels
    assert m["stencil.kernel_share"] == m["flux.kernel_share"] == m["pma.fused_share"] == 0.0
    assert 0 < m["newton.self_ms.droplet"] < m["step_ms.bench91"]
    assert 0 < m["host.wait_ms.droplet"] < m["step_ms.bench91"]
    # read from the device trace: none on the CPU
    assert "host.launches.bench91" not in m and "device.idle.bench91" not in m


def _reading(spans, counters, wall_s=1.0):
    from iterative_solvers_tpu_torch.utils.trace import Span, Trace

    run = Run()
    run.program_reading = program.reduce_traced(
        [Trace([Span(*s) for s in spans], counters)], wall_s)
    return run


def test_the_new_readers_on_a_synthetic_run():
    ms = 1_000_000
    spans = [("step", 0, None, 0, 1000 * ms), ("newton.solve", 0, 0, 0, 100 * ms),
             ("pma.loop", 0, 0, 100 * ms, 900 * ms)]
    for k in range(4):   # 4 sub-steps of 200 ms: geometry 20, monitor 150, solve 25
        t = 100 + 200 * k
        spans += [("pma.substep", 0, 2, t * ms, (t + 200) * ms),
                  ("pma.geometry", 0, 3 + 4 * k, t * ms, (t + 20) * ms),
                  ("pma.monitor", 0, 3 + 4 * k, (t + 20) * ms, (t + 170) * ms),
                  ("pma.solve", 0, 3 + 4 * k, (t + 170) * ms, (t + 195) * ms)]
    run = _reading(spans, {0: {"droplet.residual_evals": 43, "host.syncs": 55}})
    read = {name: load_reader(ROOT, name).read for name in (
        "pma.geometry_ms", "pma.monitor_ms", "pma.solve_ms", "pma.share.bench91",
        "pma.substep_ms.bench91", "droplet.residual_evals", "step_ms.bench91",
        "host.syncs.bench91", "pma.substep_ms", "host.syncs")}
    assert read["pma.geometry_ms"](run) == pytest.approx(20.0)
    assert read["pma.monitor_ms"](run) == pytest.approx(150.0)
    assert read["pma.solve_ms"](run) == pytest.approx(25.0)
    assert read["pma.share.bench91"](run) == pytest.approx(0.8)
    assert read["pma.substep_ms.bench91"](run) == read["pma.substep_ms"](run) == pytest.approx(200.0)
    assert read["droplet.residual_evals"](run) == 43
    assert read["step_ms.bench91"](run) == pytest.approx(1000.0)
    assert read["host.syncs.bench91"](run) == read["host.syncs"](run) == 55
    # a program without the spans and the counter: nothing read
    bare = _reading([("step", 0, None, 0, 1000 * ms)], {0: {"host.syncs": 55}})
    for name in ("pma.geometry_ms", "pma.monitor_ms", "pma.solve_ms", "pma.share.bench91",
                 "pma.substep_ms.bench91", "droplet.residual_evals"):
        assert read[name](bare) is None, name
        assert read[name](Run()) is None, name
    for name in ("host.launches.bench91", "device.idle.bench91", "newton.iters.bench91"):
        assert load_reader(ROOT, name).read(Run()) is None


@pytest.mark.gpu
def test_a_traced_run_of_the_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "bench91.pma400",
                          "--seed", str(2 ** 31 + 2323), "--seconds", "5", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert {"droplet.residual_evals", "pma.geometry_ms", "pma.monitor_ms", "pma.solve_ms",
            "host.launches.bench91", "device.idle.bench91"} <= set(result["metrics"])
    assert result["metrics"]["stencil.kernel_share"]["value"] == 1.0
    assert result["metrics"]["flux.kernel_share"]["value"] == 1.0
    assert result["device"]["busy_s"] > 0
