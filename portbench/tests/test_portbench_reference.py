"""The plain references against the program on the CPU at small sizes
(Swift–Hohenberg n = 24, the droplet at the fixture's 91x61): sound steps
pass, perturbed answers fail, the controls (the nearest precision below
the configuration's) fail a number, and whole runs with the program broken
underneath come out not correct."""
import importlib
import json

import pytest
import torch

from portbench.control import control_readings
from portbench.run import RULES, load_cell
from portbench.tests.helpers import run_small, small_root

CELLS = ["sh24.cn", "sh24.semi", "droplet91.newton", "droplet91.mesh"]
DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("root"))


def build(root, cell, seed=3):
    _, config, traffic, _ = load_cell(root, cell, False)
    system = importlib.import_module(f"portbench.systems.{config['system']}")
    return system.build(config, traffic, seed, DEV)


def passes(cell, readings):
    limits = cell.limits()
    return {k: bool(RULES[limits[k][1]](v, limits[k][0])) for k, v in readings.items()}


def bump(t, at=(7, 11), by=1e-3):
    t = t.clone()
    t[at] += by
    return t


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_and_rejects_a_perturbed_answer(root, name):
    cell = build(root, name)
    before = cell.initial
    after, info = cell.step(before)
    assert info["converged"]
    assert all(passes(cell, cell.readings((before, after))).values())
    if name.startswith("sh24"):
        u = after if name.endswith("cn") else after[0]
        bad = bump(u) if name.endswith("cn") else (bump(u, by=1e-6), after[1])
        assert not any(passes(cell, cell.readings((before, bad))).values())
    else:
        u, phi = after
        got = passes(cell, cell.readings((before, (bump(u), phi))))
        assert not got["step_residual_max"] and got["pma_increment_error"]
        got = passes(cell, cell.readings((before, (u, bump(phi, by=1e-6)))))
        assert got["step_residual_max"] and not got["pma_increment_error"]


def test_sh_reference_matches_the_program_operator():
    from portbench.reference import sh as ref
    sh = importlib.import_module("iterative_solvers_tpu_torch.models.swift_hohenberg")
    cfg = sh.SHConfig(n=24, d=15.0)
    u = torch.randn(24, 24, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    assert torch.allclose(ref.sh_L(u, cfg.h, cfg.r), sh.apply_L(u, cfg), rtol=0, atol=1e-12)
    u_old = u.flip(0)
    assert torch.allclose(ref.cn_residual(u, u_old, {"h": cfg.h, "k": cfg.k, "r": cfg.r,
                                                     "g": cfg.g}),
                          sh.cn_residual(u, u_old, sh.apply_L(u_old, cfg), cfg),
                          rtol=0, atol=1e-11)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_number(root, name):
    steps = 1 if name.startswith("droplet") else 2
    _, summary = control_readings(root, name, [11, 2 ** 31 + 5], steps, device="cpu")
    limits = summary["limits"]
    for k, v in summary["lower"].items():
        assert RULES[limits[k][1]](v, limits[k][0]), (k, v)
    failed = [k for c in summary["upper"].values() for k, v in c.items()
              if not RULES[limits[k][1]](v, limits[k][0])]
    assert failed, summary


def _unchanged(name):
    """The program's step replaced by one that returns its state unchanged."""
    sh = importlib.import_module("iterative_solvers_tpu_torch.models.swift_hohenberg")
    dp = importlib.import_module("iterative_solvers_tpu_torch.models.droplet")
    newton = importlib.import_module("iterative_solvers_tpu_torch.solvers.newton")
    gm = importlib.import_module("iterative_solvers_tpu_torch.solvers.gmres")
    if name.endswith(".cn"):
        return sh, "make_cn_step", lambda real: lambda *a, **k: (
            lambda u: (u, newton.NewtonResult(u, 0.0, 1, 1, True)))
    if name.endswith(".semi"):
        return sh, "semi_implicit_step", lambda real: lambda u, *a, **k: (
            u, gm.GmresResult(u, 1, 0.0, True))
    return dp, "make_step", lambda real: lambda *a, **k: (
        lambda u, q, dt: dp.DropletStepResult(u, q, 1, 0.0, True))


def _altered(name):
    """The program's answer altered where it is produced."""
    sh = importlib.import_module("iterative_solvers_tpu_torch.models.swift_hohenberg")
    dp = importlib.import_module("iterative_solvers_tpu_torch.models.droplet")
    if name.endswith(".cn"):
        def wrap(real):
            def make(*a, **k):
                step = real(*a, **k)
                return lambda u: (lambda out: (bump(out[0]), out[1]))(step(u))
            return make
        return sh, "make_cn_step", wrap
    if name.endswith(".semi"):
        return sh, "semi_implicit_step", lambda real: lambda *a, **k: (
            lambda out: (bump(out[0], by=1e-6), out[1]))(real(*a, **k))

    def wrap(real):
        def make(*a, **k):
            step = real(*a, **k)

            def broken(u, q, dt):
                out = step(u, q, dt)
                return out._replace(u=bump(out.u)) if name.endswith("newton") \
                    else out._replace(q=bump(out.q, by=1e-6))
            return broken
        return make
    return dp, "make_step", wrap


@pytest.mark.parametrize("fault", [_unchanged, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_run_with_the_program_broken_is_not_correct(root, monkeypatch, name, fault):
    module, attr, wrap = fault(name)
    monkeypatch.setattr(module, attr, wrap(getattr(module, attr)))
    result, checks, run = run_small(root, name, seconds=0.2)
    assert run.steps > 0 and result["correct"] is False
    assert any(not c["ok"] for c in checks)
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(root, name):
    result, checks, run = run_small(root, name, seconds=0.2)
    assert result["correct"] and all(c["ok"] for c in checks)
    assert result["attempted"] == run.steps and result["failed"] == 0
    # the program's own residual beside the reference's: the same number
    assert all(gap < 1e-6 for gap in run.meta["own_gap"].values())
    assert set(run.meta["own_gap"]) == ({"step_residual_max"} if name.startswith("droplet")
                                        else {"cn_residual_max"} if name.endswith("cn")
                                        else set())
    # the benchmark's own making of the state is reported, not counted
    split = run.meta["setup_split"]
    assert run.setup_s == pytest.approx(sum(split.values()) - 2 * split["bench_own"])
    assert (split["bench_own"] > 0) == name.startswith("droplet")


def test_the_seed_jitters_the_drops_within_its_amplitude():
    from portbench.systems.droplet import jittered_drops
    drops = [[0.0, 0.0, 1.0, 1.0], [3.0, 0.0, 1.0, 1.0]]
    got = [jittered_drops(drops, 1e-3, seed) for seed in (1, 2, 2 ** 31 + 7)]
    assert got[0] != got[1] != got[2] and got[0] == jittered_drops(drops, 1e-3, 1)
    for d in got:
        assert d[0][0] == 0.0 and abs(d[1][0] / 3.0 - 1.0) <= 1e-3
        assert all(abs(x[2] - 1.0) <= 1e-3 and x[1] == 0.0 and x[3] == 1.0 for x in d)


def test_the_reference_leaves_the_process_tf32_settings_as_it_found_them():
    from portbench.reference import droplet as ref
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with ref.full_float32():
            assert not any(f.allow_tf32 for f in flags)
        assert all(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
