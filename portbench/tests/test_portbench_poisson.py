"""The Poisson cell against its plain reference on the CPU at 47^2
unknowns (``tests/small/poisson999.json``): a sound run is correct with the
program's own residual beside the reference's, perturbed answers fail,
the float32 control fails a number, whole runs with the solve broken
underneath come out not correct, the reference's exact solve is the
discrete solution, and the seeded forcing stays within its 1%."""
import importlib

import numpy as np
import pytest
import torch

from portbench.control import control_readings
from portbench.reference import poisson as ref
from portbench.run import RULES, load_cell, load_system
from portbench.systems.poisson import seeded_forcing
from portbench.tests.helpers import run_small, small_root

CELL = "poisson48.cg_dia"
DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("root"))


def build(root, seed=3):
    _, config, traffic, _ = load_cell(root, CELL, False)
    return load_system(root, config["system"]).build(config, traffic, seed, DEV)


def passes(cell, readings):
    limits = cell.limits()
    return {k: bool(RULES[limits[k][1]](v, limits[k][0])) for k, v in readings.items()}


def test_a_sound_run_is_correct(root):
    result, checks, run = run_small(root, CELL, seconds=0.3)
    assert result["correct"] and all(c["ok"] for c in checks)
    assert result["attempted"] == run.steps > 0 and result["failed"] == 0
    assert set(run.meta["own_gap"]) == {"cg_residual_rel"}
    assert run.meta["own_gap"]["cg_residual_rel"] < 1e-6
    assert run.meta["flow_rate"] == pytest.approx(run.meta["flow_rate_exact"], rel=1e-6)


def test_a_perturbed_answer_fails_both_numbers(root):
    cell = build(root)
    before = cell.initial
    after, info = cell.step(before)
    assert info["converged"] and all(passes(cell, cell.readings((before, after))).values())
    b, x = after
    x = x.clone()
    x[7, 11] += 1e-6
    assert not any(passes(cell, cell.readings((before, (b, x)))).values())


def test_the_float32_control_fails_a_number(root):
    _, summary = control_readings(root, CELL, [11, 2 ** 31 + 5], 1, device="cpu")
    limits = summary["limits"]
    for k, v in summary["lower"].items():
        assert RULES[limits[k][1]](v, limits[k][0]), (k, v)
    failed = [k for k, v in summary["upper"]["float32"].items()
              if not RULES[limits[k][1]](v, limits[k][0])]
    assert failed, summary


def _unchanged(real):
    cg = importlib.import_module("iterative_solvers_tpu_torch.solvers.cg")
    return lambda matvec, b, x0=None, **kw: cg.CGResult(torch.zeros_like(b), 1, 0.0, True)


def _altered(real):
    def solve(*a, **kw):
        res = real(*a, **kw)
        x = res.x.clone()
        x[7, 11] += 1e-6
        return res._replace(x=x)
    return solve


@pytest.mark.parametrize("fault", [_unchanged, _altered])
def test_a_run_with_the_solve_broken_is_not_correct(root, monkeypatch, fault):
    cg = importlib.import_module("iterative_solvers_tpu_torch.solvers.cg")
    monkeypatch.setattr(cg, "cg", fault(cg.cg))
    result, checks, run = run_small(root, CELL, seconds=0.2)
    assert run.steps > 0 and result["correct"] is False
    assert {c["name"] for c in checks if not c["ok"]} >= {"cg_residual_rel", "field_error_rel"}


def test_the_exact_solve_is_the_discrete_solution():
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve

    n = 16
    m, h = n - 1, 1.0 / n
    t = sp.diags([np.ones(m - 1), -2.0 * np.ones(m), np.ones(m - 1)], [-1, 0, 1])
    lap = ((sp.kron(sp.identity(m), t) + sp.kron(t, sp.identity(m))) / (h * h)).tocsc()
    b = torch.randn(m, m, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    want = spsolve(lap, b.numpy().reshape(-1)).reshape(m, m)
    got = ref.solve_exact(b, n).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    x = torch.from_numpy(want)
    assert np.abs(ref.laplacian(x, h).numpy() - (lap @ want.reshape(-1)).reshape(m, m)).max() \
        <= 1e-12 * np.abs(b.numpy()).max()
    assert ref.residual_rel(x, b, h) < 1e-12


def test_the_seeded_forcing_stays_within_one_percent():
    got = [seeded_forcing(48, 0.01, seed, torch.float64, DEV) for seed in (1, 2, 2 ** 31 + 7)]
    assert torch.equal(got[0], seeded_forcing(48, 0.01, 1, torch.float64, DEV))
    assert not torch.equal(got[0], got[1]) and not torch.equal(got[1], got[2])
    for b in got:
        assert b.shape == (47, 47) and 1e-3 < (b + 1.0).abs().max() <= 0.01


def test_every_seed_brings_the_same_cg_work(root):
    """The seeds change the forcing's signs, not the weight of any mode in
    it: CG takes the same iterations on each."""
    iters = set()
    for seed in (1, 2, 3, 2 ** 31 + 7):
        cell = build(root, seed)
        iters.add(cell.step(cell.initial)[1]["krylov_iters"])
    assert len(iters) == 1
