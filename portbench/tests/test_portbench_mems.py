"""The MEMS touchdown cell (``mems51.touchdown``) on the CPU at its own size,
51^2 (a step takes about half a second here): the plain reference against
scipy's own numbers of ``PMA2_nk.py``, the program's functions against the
reference on the prepared state, two whole program steps under every
reading with the float32 control failing them, the prepared state against
the published run's record, the harness's run of the cell, and one traced
run of the cell on the card (``python -m pytest -m gpu portbench/tests``)."""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.reference import mems as ref
from portbench.systems import mems as system
from portbench.tests.helpers import PKG, ROOT, run_small, small_root

CONFIG = json.loads((PKG / "configs" / "mems51.json").read_text())
TRAFFIC = json.loads((PKG / "traffic" / "touchdown.json").read_text())
P = ref.Params.of(CONFIG)
# outside the benchmark's folder: read by these tests only, never by a run
GOLDEN = ROOT / "tests" / "fixtures" / "golden_pma2.npz"
RECORD = ROOT / "benchmarks" / "mems_touchdown.jsonl"
SHAPE = (P.n, P.n)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """51 x 51 fields: torch's intra-op threads cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    d = np.load(GOLDEN)
    p = ref.Params(n=int(d["n"]), p=int(d["p"]), m=int(d["m"]), alpha=float(d["alpha"]),
                   gamma=float(d["gamma"]), epsilon=float(d["epsilon"]),
                   beta=float(d["beta"]), lambd=float(d["lambd"]), smoothing_iters=4, k=1e-4)
    return d, p, {k: torch.tensor(d[k].reshape(SHAPE)) for k in d.files if d[k].size == P.n ** 2}


# scipy's own numbers (``tests/test_models_parity.py``'s tolerances: rtol, atol)
GOLDEN_CASES = {"cn_term": (1e-8, 1e-6), "residual": (1e-8, 1e-5), "monitor": (1e-10, 1e-9),
                "q_dt": (1e-9, 1e-7)}


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_reference_matches_scipy(golden, name):
    d, p, f = golden
    geom = ref.geometry(f["q"], p)
    got = {"cn_term": lambda: ref.rhs(f["u"], geom, p),
           "residual": lambda: ref.cn_residual(f["u_probe"], f["u"], f["cn_term"],
                                               float(d["dt"]), geom, p),
           "monitor": lambda: ref.monitor(f["u"], geom, p),
           "q_dt": lambda: ref.q_dt(f["u"], f["q"], p)}[name]()
    rtol, atol = GOLDEN_CASES[name]
    np.testing.assert_allclose(got.numpy(), f[name].numpy(), rtol=rtol, atol=atol)


def test_reference_step_factor_matches_scipy(golden):
    d, p, f = golden
    assert abs(ref.step_dt(f["u"], p) / p.k - float(d["g"])) < 1e-12


@pytest.fixture(scope="module")
def cell():
    return system.build(CONFIG, TRAFFIC, 2 ** 31 + 19, torch.device("cpu"))


def test_prepared_state_matches_the_record(cell):
    rows = [json.loads(line) for line in RECORD.read_text().splitlines()]
    last = max((r for r in rows if "step" in r), key=lambda r: r["step"])
    with np.load(system.DATA) as d:
        u, q, t, step = d["u"], d["q"], float(d["t"]), int(d["step"])
    assert u.shape == q.shape == SHAPE and u.dtype == q.dtype == np.float64
    assert step == last["step"] == 39500
    assert abs(u.min() - last["u_min"]) <= 1e-9 and abs(t - last["t"]) <= 1e-9 * t
    assert abs(ref.min_spacing(torch.tensor(q), P) - last["min_spacing"]) <= 1e-9
    # the seed moves u by at most its amplitude, and not on the boundary
    du = cell.initial[0].numpy() - u
    assert 0 < np.abs(du).max() <= CONFIG["seed_amplitude"]
    assert not du[0].any() and not du[-1].any() and not du[:, 0].any() and not du[:, -1].any()


def test_seeds_draw_other_perturbations():
    a, b = (system.seeded_perturbation(P.n, 1.0, s, torch.float64, "cpu") for s in (1, 2))
    assert not torch.equal(a, b) and float(a.abs().max()) <= 1.0


# The program's functions against the reference on the prepared state, each
# held to a bound on its largest gap relative to the reference's largest value.
# The two sum in other orders, so the bounds are float64 rounding as each
# operator amplifies it: the biharmonic's one-sided edge columns difference
# ``lap u`` at 1/h^2 twice, and there the two read 5.6e-8 apart on values of
# 36.5 (1.5e-9): ``rhs_pde`` 1e-8; the CN residual is (u - u_old)/dt, 1e4 at
# the probe, plus half of that gap: 1e-10; the monitor is pointwise and
# filtered (3e-16): 1e-12; the spectral velocity adds the floor's sum and two
# cosine products (7e-13): 1e-11; the step factor is one pointwise min: 1e-14.
# The program's float32 evaluation reads 1.2e-7 (the step factor) to 165 (the
# biharmonic), and fails each.
PORT_CASES = {"rhs_pde": 1e-8, "cn_residual": 1e-10, "monitor": 1e-12, "q_dt": 1e-11,
              "compute_g": 1e-14}


def _port_and_ref(name, u, q, dtype):
    from iterative_solvers_tpu_torch.meshmove.monitor import smooth_and_regularise
    from iterative_solvers_tpu_torch.meshmove.pma import solve_pma
    from iterative_solvers_tpu_torch.models import mems as tm
    from iterative_solvers_tpu_torch.ops import curvilinear

    cfg = tm.MEMSConfig()
    grid = cfg.grid
    geom = ref.geometry(q, P)
    uc, qc = u.to(dtype), q.to(dtype)
    pg = curvilinear.mesh_geometry(qc, grid)
    u_probe = u * (1.0 + 1e-3)
    dt = ref.step_dt(u, P)
    mon = smooth_and_regularise(tm.monitor_source(uc, pg, grid, cfg), pg.jac, grid.dx,
                                grid.dy, cfg.smoothing_iters, 1.0)
    port = {"rhs_pde": lambda: tm.rhs_pde(uc, pg, cfg),
            "cn_residual": lambda: tm.cn_residual(u_probe.to(dtype), uc,
                                                  tm.rhs_pde(uc, pg, cfg), dt, pg, cfg),
            "monitor": lambda: mon,
            "q_dt": lambda: solve_pma(mon, pg.jac, grid, cfg.pma),
            "compute_g": lambda: tm.compute_g(uc, cfg)}[name]()
    want = {"rhs_pde": lambda: ref.rhs(u, geom, P),
            "cn_residual": lambda: ref.cn_residual(u_probe, u, ref.rhs(u, geom, P), dt, geom, P),
            "monitor": lambda: ref.monitor(u, geom, P),
            "q_dt": lambda: ref.q_dt(u, q, P),
            "compute_g": lambda: torch.tensor(dt / P.k, dtype=torch.float64)}[name]()
    return float(torch.max(torch.abs(port.double() - want)) / torch.max(torch.abs(want)))


@pytest.mark.parametrize("name", sorted(PORT_CASES))
def test_program_matches_the_reference_near_touchdown(cell, name):
    u, q, _ = cell.initial
    assert _port_and_ref(name, u, q, torch.float64) <= PORT_CASES[name]
    assert _port_and_ref(name, u, q, torch.float32) > PORT_CASES[name]


@pytest.fixture(scope="module")
def two_steps(cell):
    state, steps = cell.initial, []
    for _ in range(TRAFFIC["segment_steps"]):
        new, info = cell.step(state)
        steps.append((state, new, info))
        state = new
    return steps


def test_two_program_steps_pass_every_reading(cell, two_steps):
    limits = cell.limits()
    for before, after, info in two_steps:
        assert info["converged"] and info["newton_iters"] >= 1
        readings = cell.readings((before, after))
        for name, value in readings.items():
            lim, rule = limits[name]
            assert value <= lim if rule == "<=" else value > lim, (name, value)
        assert after[2] == info["dt"] and 9e-8 < info["dt"] < 1e-7


def test_the_float32_control_fails(cell):
    (fn, only), = cell.controls().values()
    before = cell.initial
    readings = cell.readings((before, fn(before)))
    assert only is None and readings["step_residual_max"] > 100 * CONFIG["solver"]["f_tol"]


def test_a_float32_spectral_pma_fails_the_mesh_number(cell, two_steps):
    """The reason for the mesh number's limit: the droplet's float32
    spectral solve in the place of the configured float64 one reads ~1e-7."""
    from iterative_solvers_tpu_torch.meshmove.monitor import smooth_and_regularise
    from iterative_solvers_tpu_torch.meshmove.pma import solve_pma
    from iterative_solvers_tpu_torch.models import mems as tm
    from iterative_solvers_tpu_torch.ops import curvilinear

    (u, q, _), (_, q_new, dt), _ = two_steps[0]
    cfg = tm.MEMSConfig()
    geom = curvilinear.mesh_geometry(q, cfg.grid)
    mon = smooth_and_regularise(tm.monitor_source(u, geom, cfg.grid, cfg), geom.jac,
                                cfg.grid.dx, cfg.grid.dy, cfg.smoothing_iters, 1.0)
    f32 = solve_pma(mon, geom.jac, cfg.grid, dataclasses.replace(cfg.pma, spectral_dtype="float32"))
    limit = CONFIG["limits"]["mesh_update_error"]
    assert ref.mesh_update_error(q_new, q, u, dt, P) <= limit
    assert ref.mesh_update_error(q + dt * f32, q, u, dt, P) > 10 * limit


def test_the_cell_runs_on_the_cpu_with_its_readings(tmp_path):
    root = small_root(tmp_path)
    result, checks, run = run_small(root, "mems51_cpu.touchdown", seconds=0.5, trace=True)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    prog = run.meta["program"]
    assert prog["spans"]["step"][0] == TRAFFIC["segment_steps"]
    assert m["newton.iters.mems"] >= 1 and m["mems.residual_evals"] > m["newton.iters.mems"]
    assert 0 < m["mems.mesh_ms"] < m["step_ms.mems"]
    assert m["host.syncs.mems"] > m["newton.iters.mems"]
    assert run.meta["state_step"] == 39500 and run.meta["min_spacing"] > 0


@pytest.mark.gpu
def test_a_traced_run_of_the_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "mems51.touchdown",
                          "--seed", str(2 ** 31 + 1919), "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert {"step_ms.mems", "mems.mesh_ms", "mems.residual_evals", "newton.iters.mems",
            "host.launches.mems", "host.syncs.mems", "device.idle.mems"} <= set(result["metrics"])
    assert result["device"]["busy_s"] > 0
