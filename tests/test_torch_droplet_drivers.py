"""Port parity: the droplet drivers, fixture names, radius laws, contact-line
diagnostics and the port's headline bench, on CPU.

Every input comes from the npz fixtures or a numpy seed; a fixture's
configuration comes from its file name alone (``parse_name``).  Gates are
those of the JAX tests each mirrors:

- ``evolve`` over 6 steps against ``golden_droplet_traj.npz`` (the
  scipy-driven reference trajectory): dts rtol 1e-5, u 1e-6, q 1e-7, each
  drop's volume within 5% of 2 pi (``tests/test_models_parity.py``); and
  against the JAX ``evolve`` on the same state;
- one step of the 61x61 rect fixture against ``golden_rect_step.npz`` (u
  1e-6, q 1e-8), the ``fast_solver`` step against ``golden_droplet_step.npz``
  (u 1e-6, q 1e-5: f32 transforms), the bench's step against the JAX step
  (the same gates);
- short ``inflate`` and ``evolve_radius_explicit`` runs against the JAX
  drivers (1e-12 of scale: the same f64 arithmetic);
- radius laws and diagnostics equal to the JAX functions.

The JAX side is imported inside the ``jx`` fixture, so the card-only tests
at the end also run where the port is installed without JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_droplet_drivers.py``.
"""
import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch import bench
from iterative_solvers_tpu_torch.io import fixtures as tfx
from iterative_solvers_tpu_torch.meshmove import pma as tpma
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.ops import curvilinear as tcv
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov

FIX = pathlib.Path(__file__).parent / "fixtures"
COAL = "initdrop_coal_1_91-61_100_0.005_0.01_0.1_0.15.txt"
RECT = "initdrop_rect_1_61-61_100_0.01_0.01_0.1_0.15.txt"
DROPS = [(0.0, 0.0, 1.0, 1.0), (3.0, 0.0, 1.0, 1.0)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.io import fixtures as jfx
    from iterative_solvers_tpu.models import droplet as jdp
    from iterative_solvers_tpu.ops import curvilinear as jcv
    from iterative_solvers_tpu.solvers.newton import NewtonKrylov as JNK

    return types.SimpleNamespace(jnp=jnp, jfx=jfx, jdp=jdp, jcv=jcv, JNK=JNK)


def _jcfg(jx, cfg):
    """The JAX DropletConfig with the port config's fields."""
    return jx.jdp.DropletConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def traj():
    g = np.load(FIX / "golden_droplet_traj.npz")
    cfg = tfx.config_for(tfx.parse_name(COAL))
    shape = cfg.grid.shape
    return cfg, g, g["u0"].reshape(shape), g["q0"].reshape(shape)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


# -- fixture names -------------------------------------------------------------

def test_parse_name_and_load_match_jax(jx, traj, tmp_path):
    """A text fixture written under the coalescence name: the port's and the
    JAX package's ``load`` read the same state and configuration, and
    ``config_for`` of the parsed name alone equals the loaded fixture's."""
    cfg, _, u0, q0 = traj
    path = tmp_path / COAL
    np.savetxt(path, np.stack([u0.reshape(-1), q0.reshape(-1)], axis=1), fmt="%.17e")
    t, j = tfx.load(path), jx.jfx.load(path)
    assert tfx.parse_name(str(path)) == jx.jfx.parse_name(str(path))
    for f in ("kind", "R", "nx", "ny", "a", "epsilon", "alpha", "gamma", "mackenzie_c"):
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_array_equal(t.u, j.u)
    np.testing.assert_array_equal(t.q, j.q)
    np.testing.assert_array_equal(t.u, u0)
    assert tfx.config_for(t) == cfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jx.jfx.config_for(j))
    assert (t.kind, cfg.nx, cfg.ny, cfg.epsilon) == ("coal", 91, 61, 0.005)
    with pytest.raises(ValueError, match="initdrop"):
        tfx.parse_name("golden_droplet_step.npz")
    bad = tmp_path / RECT
    np.savetxt(bad, np.zeros((10, 2)))
    with pytest.raises(ValueError, match="expected 3721"):
        tfx.load(bad)


# -- evolve and the step --------------------------------------------------------

def test_evolve_matches_golden_trajectory_and_jax(jx, traj):
    """Six steps with the adaptive dt law against the reference trajectory
    and against the JAX ``evolve`` from the same npz state."""
    cfg, g, u0, q0 = traj
    kw = dict(dt=float(g["dt"]), nsteps=int(g["dts"].shape[0]),
              dtmesh=float(g["dtmesh"]), pma_loops=int(g["pmaloops"]))
    u, q, t, (iters, f_norms, dts) = tdp.evolve(
        cfg, torch.tensor(u0), torch.tensor(q0),
        solver=NewtonKrylov(f_tol=1e-7, maxiter=20), device="cpu", **kw)
    shape = cfg.grid.shape
    assert iters.shape == f_norms.shape == dts.shape == g["dts"].shape
    assert np.all(f_norms <= 1e-7)
    np.testing.assert_allclose(dts, g["dts"], rtol=1e-5)
    assert t == pytest.approx(float(np.sum(dts)), rel=1e-14)
    np.testing.assert_allclose(u.numpy(), g["u_traj"][-1].reshape(shape), atol=1e-6)
    np.testing.assert_allclose(q.numpy(), g["q_traj"][-1].reshape(shape), atol=1e-7)
    # physical volume: (u - eps) over the mapped area element J dksi deta,
    # two drops of V = 1 each enclosing 2 pi
    geom = tcv.mesh_geometry(q, cfg.grid)
    vol = float(torch.sum((u - cfg.epsilon) * geom.jac)) * cfg.grid.dx * cfg.grid.dy
    assert abs(vol / len(DROPS) - 2 * np.pi) / (2 * np.pi) < 0.05

    jn = jx.jnp
    uj, qj, tj, (itj, fnj, dtj) = jx.jdp.evolve(
        _jcfg(jx, cfg), jn.asarray(u0), jn.asarray(q0),
        solver=jx.JNK(f_tol=1e-7, maxiter=20), **kw)
    np.testing.assert_array_equal(iters, np.asarray(itj))
    np.testing.assert_allclose(dts, np.asarray(dtj), rtol=1e-5)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), atol=1e-7)


def test_rect_fixture_step_matches_golden():
    """The 61x61 single-drop fixture (its state is ``golden_rect_step.npz``'s
    ``u_old``/``q_old``), configured from its name alone."""
    g = np.load(FIX / "golden_rect_step.npz")
    cfg = tfx.config_for(tfx.parse_name(RECT))
    assert (cfg.nx, cfg.ny, cfg.epsilon) == (61, 61, 0.01)
    shape = cfg.grid.shape
    dt = float(g["dt"])
    out = tdp.make_step(cfg, dt=dt, dtmesh=3e-9, pma_loops=5, device="cpu")(
        torch.tensor(g["u_old"].reshape(shape)), torch.tensor(g["q_old"].reshape(shape)), dt)
    assert out.converged
    np.testing.assert_allclose(out.u.numpy(), g["u_new"].reshape(shape), atol=1e-6)
    np.testing.assert_allclose(out.q.numpy(), g["q_new"].reshape(shape), atol=1e-8)


def test_fast_solver_step_matches_golden():
    """The f32 inner Krylov with f32 spectral transforms against the scipy
    golden step; ``spectral_precision="high"`` gives the same step bit for
    bit (both run full-f32 matmuls)."""
    fix, g = tfx.load_golden_step()
    base = dataclasses.replace(tfx.config_for(tfx.parse_name(COAL)),
                               spectral_dtype="float32")
    dt = float(g["dt"])
    u, q = torch.tensor(fix.u), torch.tensor(fix.q)
    solver = tdp.fast_solver()
    assert (solver.f_tol, solver.maxiter, solver.inner_m, solver.outer_k,
            solver.inner_dtype) == (1e-7, 20, 12, 6, "float32")
    outs = {}
    for prec in ("highest", "high"):
        cfg = dataclasses.replace(base, spectral_precision=prec)
        assert cfg.pma.spectral_precision == prec
        outs[prec] = tdp.make_step(cfg, dt=dt, dtmesh=3e-9, pma_loops=5,
                                   solver=solver, device="cpu")(u, q, dt)
    out = outs["highest"]
    assert out.converged
    np.testing.assert_allclose(out.u.numpy(), g["u_new"], atol=1e-6)
    np.testing.assert_allclose(out.q.numpy(), g["q_new"], atol=1e-5)
    assert torch.equal(outs["high"].u, out.u) and torch.equal(outs["high"].q, out.q)
    with pytest.raises(ValueError, match="precision"):
        tdp.make_step(dataclasses.replace(base, spectral_precision="default"),
                      dt=dt, dtmesh=3e-9, pma_loops=1, device="cpu")(u, q, dt)


def test_bench_matches_jax_step(jx, traj):
    """The bench's configuration, state and step on the CPU (5 PMA
    sub-steps, chains of 1 and 2 steps) against the JAX ``make_step`` with
    the same configuration: u 1e-6, q 1e-5 (f32 mesh loop)."""
    cfg, _, u0, q0 = traj
    res = bench.run(device="cpu", reps=1, pma_loops=5, k_short=1, k_long=2)
    line = res.line
    assert line["metric"] == "droplet_full_step_91x61_pma5" and line["unit"] == "ms"
    assert line["device"] == "cpu" and line["worst_f_norm"] <= 1e-7
    assert len(line["newton_iters"]) == 2 and line["pma_ms"] > 0
    assert 0 < line["pma_share"] < 1
    assert tdp.loop_pma is tpma.loop_pma  # the traced chain's span removed
    jcfg = _jcfg(jx, bench.bench_config())
    assert (jcfg.spectral_dtype, jcfg.mesh_dtype) == ("float32", "float32")
    assert dataclasses.replace(cfg, spectral_dtype="float32",
                               mesh_dtype="float32") == bench.bench_config()
    oj = jx.jdp.make_step(jcfg, dt=bench.DT, dtmesh=bench.DTMESH, pma_loops=5,
                          solver=jx.jdp.fast_solver())(
        jx.jnp.asarray(u0), jx.jnp.asarray(q0), bench.DT)
    assert bool(oj.converged)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(oj.u), atol=1e-6)
    np.testing.assert_allclose(res.q.numpy(), np.asarray(oj.q), atol=1e-5)


# -- inflation and the explicit radius evolution -----------------------------------

def test_inflate_matches_jax_and_resumes(jx):
    """Four volume steps of the coalescence pair with 3 PMA sub-steps each,
    against the JAX ``inflate``; the same ramp in two resumed chunks gives
    the same state bit for bit."""
    cfg = tdp.DropletConfig(nx=31, ny=21)
    kw = dict(vsteps=4, dtmesh=5e-9, pma_loops=3)
    q, u = tdp.inflate(cfg, DROPS, device="cpu", **kw)
    qj, uj = jx.jdp.inflate(_jcfg(jx, cfg), DROPS, **kw)
    q_id = tdp.initial_mesh_potential(cfg, device="cpu").numpy()
    _close(q.numpy() - q_id, np.asarray(qj) - q_id, 1e-12)
    _close(u.numpy(), np.asarray(uj), 1e-12)
    assert float(torch.min(tcv.mesh_geometry(q, cfg.grid).jac)) > 0
    assert float(u.max()) > 2 * cfg.epsilon
    q1, u1 = tdp.inflate(cfg, DROPS, count=2, device="cpu", **kw)
    q2, u2 = tdp.inflate(cfg, DROPS, q0=q1, start=2, u_prev=u1, device="cpu", **kw)
    assert torch.equal(q2, q) and torch.equal(u2, u)


def test_evolve_radius_explicit_matches_jax(jx):
    cfg = tdp.DropletConfig(nx=31, ny=21)
    q0 = tdp.initial_mesh_potential(cfg, device="cpu")
    u0 = tdp.seeded_solution(tcv.mesh_geometry(q0, cfg.grid), cfg, [(0.0, 0.0, 1.0, 1.0)])
    kw = dict(r0=1.0, r_final=1.3, tol=5e-2, pma_loops=2, max_steps=100)
    u, q, r, steps = tdp.evolve_radius_explicit(cfg, u0, q0, device="cpu", **kw)
    uj, qj, rj, stepsj = jx.jdp.evolve_radius_explicit(
        _jcfg(jx, cfg), jx.jnp.asarray(u0.numpy()), jx.jnp.asarray(q0.numpy()), **kw)
    assert steps == int(stepsj) and 0 < steps < 100
    assert r == pytest.approx(float(rj), rel=1e-14) and 1.2 < r <= 1.4
    _close(u.numpy(), np.asarray(uj), 1e-12)
    _close(q.numpy() - q0.numpy(), np.asarray(qj) - q0.numpy(), 1e-12)


# -- radius laws and diagnostics ---------------------------------------------------

def test_radius_laws_equal_jax(jx):
    cfg = tdp.DropletConfig()
    jcfg = _jcfg(jx, cfg)
    times = np.concatenate(([0.0], np.logspace(-5, 2, 50)))
    r = tdp.asymptotic_radius_trajectory(cfg, 1.0, times)
    np.testing.assert_array_equal(r, jx.jdp.asymptotic_radius_trajectory(jcfg, 1.0, times))
    assert np.all(np.diff(r) > -1e-12) and 1.9 < r[-1] < 2.1
    for R, V in ((1.0, 1.0), (3.0, 1.0), (1.7, 0.4)):
        assert tdp.rdot(R, V, cfg) == float(jx.jdp.rdot(R, V, jcfg))
        assert tdp.asymptotic_radius_ode(R, 0.0, cfg) == \
            jx.jdp.asymptotic_radius_ode(R, 0.0, jcfg)
    assert tdp.rdot(1.0, 1.0, cfg) > 0 > tdp.rdot(3.0, 1.0, cfg)


def test_contact_line_diagnostics_match_jax(jx):
    """On the adapted fixture mesh, both packages given the same node
    coordinates: equal to rounding, nodes cluster at the contact line and
    the band spacing is of order 1/a."""
    fix, _ = tfx.load_golden_step()
    cfg = tfx.config_for(fix)
    geom = tcv.mesh_geometry(torch.tensor(fix.q), cfg.grid)
    jgeom = jx.jcv.MeshGeometry(*(jx.jnp.asarray(a.numpy()) for a in geom))
    _close(tdp.interior_spacings(geom).numpy(), jx.jdp.interior_spacings(jgeom), 1e-14)
    assert float(tdp.min_spacing(geom)) == float(jx.jdp.min_spacing(jgeom))
    for center in ((0.0, 0.0), (3.0, 0.0)):
        d = tdp.distance_to_contact_line(geom, cfg.R, center)
        _close(d.numpy(), jx.jdp.distance_to_contact_line(jgeom, cfg.R, center), 1e-14)
        st = tdp.contact_line_stats(geom, cfg.R, center, band=0.02)
        sj = jx.jdp.contact_line_stats(jgeom, cfg.R, center, band=0.02)
        assert int(st["band_nodes"]) == int(sj["band_nodes"]) > 0
        assert float(st["min_distance"]) == pytest.approx(float(sj["min_distance"]), rel=1e-14)
        assert float(st["min_band_spacing"]) == pytest.approx(
            float(sj["min_band_spacing"]), rel=1e-14)
        assert float(st["min_band_spacing"]) < 10.0 / cfg.a


def test_drivers_raise_without_cuda(monkeypatch, traj):
    """Without a card, the drivers' default device raises: no silent CPU."""
    cfg, _, u0, q0 = traj
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tdp.inflate(cfg, DROPS, vsteps=1, dtmesh=5e-9, pma_loops=1),
        lambda: tdp.evolve(cfg, u0, q0, dt=1e-5, nsteps=1, pma_loops=1),
        lambda: tdp.evolve_radius_explicit(cfg, u0, q0, r0=1.0, r_final=1.3),
        lambda: bench.run(reps=1, pma_loops=1, k_short=1, k_long=2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the droplet_jvp kernel has no CPU mode")
    return torch.device("cuda")


KERNEL_MODE = dict(jvp_dtype="float32", jvp_kernel=True)


@pytest.mark.gpu
def test_kernel_mode_step_on_card_matches_golden(cuda):
    """The 91x61 step with the inner Krylov through the droplet_jvp kernel
    against the scipy golden step (1.2e-11 on record; gate 1e-9 in u,
    1e-8 in q)."""
    from iterative_solvers_tpu_torch.ops._build import launch_count

    fix, g = tfx.load_golden_step()
    cfg = tfx.config_for(fix)
    dt = float(g["dt"])
    before = launch_count("droplet_jvp")
    out = tdp.make_step(cfg, dt=dt, dtmesh=3e-9, pma_loops=5, **KERNEL_MODE)(
        torch.tensor(fix.u, device=cuda), torch.tensor(fix.q, device=cuda), dt)
    assert out.converged and launch_count("droplet_jvp") > before
    np.testing.assert_allclose(out.u.cpu().numpy(), g["u_new"], atol=1e-9)
    np.testing.assert_allclose(out.q.cpu().numpy(), g["q_new"], atol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("residual_mode", ["f64", "df64"])
def test_kernel_mode_evolve_on_card_matches_cpu(cuda, traj, residual_mode):
    """Three steps of ``evolve`` in kernel mode on the card against the same
    call on the CPU (the plain JVP there): the same Newton counts, dts rtol
    1e-6, u 5e-7 (the f32 inner Krylov's gate), q 1e-8."""
    cfg, _, u0, q0 = traj
    kw = dict(dt=1e-5, nsteps=3, dtmesh=3e-9, pma_loops=5, solver=tdp.fast_solver(),
              residual_mode=residual_mode, **KERNEL_MODE)
    ug, qg, _, (itg, fng, dtg) = tdp.evolve(cfg, u0, q0, device=cuda, **kw)
    uc, qc, _, (itc, fnc, dtc) = tdp.evolve(cfg, u0, q0, device="cpu", **kw)
    assert np.all(fng <= 1e-7) and np.all(fnc <= 1e-7)
    np.testing.assert_array_equal(itg, itc)
    np.testing.assert_allclose(dtg, dtc, rtol=1e-6)
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), atol=5e-7)
    np.testing.assert_allclose(qg.cpu().numpy(), qc.numpy(), atol=1e-8)
