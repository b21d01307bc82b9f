"""Port parity: the MEMS touchdown model and the Grid2D boundary masks, on CPU.

Gates are those of the JAX tests each mirrors:

- ``golden_pma2.npz`` (the reference's PMA2_nk functions on a perturbed
  51x51 state): ``rhs_pde`` rtol 1e-8 / atol 1e-6, ``cn_residual`` atol 1e-5,
  ``compute_g`` 1e-12 (``tests/test_models_parity.py``); the smoothed monitor
  rtol 1e-10 / atol 1e-9 and ``solve_pma``'s q_dt rtol 1e-9 / atol 1e-7
  (``tests/test_curvilinear.py``);
- ``golden_pma2_traj.npz`` (3 steps of the reference's main loop): dts rtol
  1e-10, u 1e-6, q 1e-8;
- against the JAX functions on the same inputs: the monitor's epsilon != 0
  branches and ``lagrangian_term`` to 1e-12 of scale, and 8 steps of
  ``evolve`` at k = 1e-3 with equal Newton counts and u, q to 1e-10.

The JAX side is imported inside the ``jx`` fixture, so the card-only tests
at the end also run where JAX is not installed:
``python -m pytest --noconftest -m gpu tests/test_torch_mems.py``.
"""
import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.core.grid import Grid2D
from iterative_solvers_tpu_torch.meshmove.monitor import smooth_and_regularise
from iterative_solvers_tpu_torch.meshmove.pma import PMAParams, solve_pma
from iterative_solvers_tpu_torch.models import mems as tm
from iterative_solvers_tpu_torch.ops import curvilinear as tcv
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """51x51 fields: torch's intra-op threads cost more than they give
    (8 threads run these drivers ~6x slower than 1 on an 8-core CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.core.grid import Grid2D as JGrid2D
    from iterative_solvers_tpu.models import mems as jm
    from iterative_solvers_tpu.ops import curvilinear as jcv
    from iterative_solvers_tpu.solvers.newton import NewtonKrylov as JNK

    return types.SimpleNamespace(jnp=jnp, JGrid2D=JGrid2D, jm=jm, jcv=jcv, JNK=JNK)


@pytest.fixture(scope="module")
def golden():
    d = np.load(FIX / "golden_pma2.npz")
    cfg = tm.MEMSConfig(
        n=int(d["n"]), p=int(d["p"]), m=int(d["m"]),
        beta=float(d["beta"]), lambd=float(d["lambd"]),
        epsilon=float(d["epsilon"]), alpha=float(d["alpha"]),
        gamma=float(d["gamma"]),
    )
    grid = cfg.grid
    q = torch.tensor(d["q"].reshape(grid.shape))
    return d, cfg, grid, q, tcv.mesh_geometry(q, grid)


def _2d(d, key, grid):
    return d[key].reshape(grid.shape)


def _t(d, key, grid):
    return torch.tensor(_2d(d, key, grid))


# -- Grid2D masks ------------------------------------------------------------------

@pytest.mark.parametrize("ny,nx", [(5, 7), (51, 51)])
def test_grid_masks_match_jax(jx, ny, nx):
    tg = Grid2D(nx=nx, ny=ny)
    jg = jx.JGrid2D(nx=nx, ny=ny)
    for name in ("mask_left", "mask_right", "mask_top", "mask_bottom",
                 "mask_boundary", "mask_interior"):
        got, want = getattr(tg, name), getattr(jg, name)
        assert got.dtype == bool and got.shape == (ny, nx)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tg.mask_interior.sum() == (ny - 2) * (nx - 2)


# -- against golden_pma2.npz ----------------------------------------------------------

def test_rhs_pde_matches_golden(golden):
    d, cfg, grid, q, geom = golden
    got = tm.rhs_pde(_t(d, "u", grid), geom, cfg)
    np.testing.assert_allclose(got.numpy(), _2d(d, "cn_term", grid),
                               rtol=1e-8, atol=1e-6)


def test_cn_residual_matches_golden(golden):
    d, cfg, grid, q, geom = golden
    got = tm.cn_residual(_t(d, "u_probe", grid), _t(d, "u", grid),
                         _t(d, "cn_term", grid), float(d["dt"]), geom, cfg)
    np.testing.assert_allclose(got.numpy(), _2d(d, "residual", grid),
                               rtol=1e-8, atol=1e-5)


def test_compute_g_matches_golden(golden):
    d, cfg, grid, q, geom = golden
    g = tm.compute_g(_t(d, "u", grid), cfg)
    assert g.ndim == 0
    assert abs(g.item() - float(d["g"])) < 1e-12


def test_monitor_and_q_dt_match_golden(golden):
    d, cfg, grid, q, geom = golden
    src = tm.monitor_source(_t(d, "u", grid), geom, grid, cfg)
    mon = smooth_and_regularise(src, geom.jac, grid.dx, grid.dy,
                                cfg.smoothing_iters, 1.0)
    np.testing.assert_allclose(mon.numpy(), _2d(d, "monitor", grid),
                               rtol=1e-10, atol=1e-9)
    q_dt = solve_pma(mon, geom.jac, grid, cfg.pma)
    np.testing.assert_allclose(q_dt.numpy(), _2d(d, "q_dt", grid),
                               rtol=1e-9, atol=1e-7)


# -- against the JAX functions ----------------------------------------------------------

def _jgeom(jx, d, grid):
    return jx.jcv.mesh_geometry(jx.jnp.asarray(_2d(d, "q", grid)),
                                jx.jm.MEMSConfig(n=grid.nx).grid)


@pytest.mark.parametrize("p", [1, 2])
def test_monitor_source_epsilon_branches_match_jax(jx, golden, p):
    """epsilon != 0: 1 + |grad u|^2 (p = 1) and |lap u|^2 (p = 2)."""
    d, cfg, grid, q, geom = golden
    tcfg = dataclasses.replace(cfg, epsilon=0.05, p=p)
    jcfg = jx.jm.MEMSConfig(**dataclasses.asdict(tcfg))
    u = _2d(d, "u", grid)
    got = tm.monitor_source(torch.tensor(u), geom, grid, tcfg).numpy()
    want = np.asarray(jx.jm.monitor_source(jx.jnp.asarray(u), _jgeom(jx, d, grid),
                                           jcfg.grid, jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    # and the branch's step factor and rhs are the JAX ones
    assert tm.compute_g(torch.tensor(u), tcfg).item() == 1.0
    got = tm.rhs_pde(torch.tensor(u), geom, tcfg).numpy()
    want = np.asarray(jx.jm.rhs_pde(jx.jnp.asarray(u), _jgeom(jx, d, grid), jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_lagrangian_term_matches_jax(jx, golden):
    d, cfg, grid, q, geom = golden
    jcfg = jx.jm.MEMSConfig(**dataclasses.asdict(cfg))
    u, q_dt = _2d(d, "u", grid), _2d(d, "q_dt", grid)
    got = tm.lagrangian_term(torch.tensor(u), torch.tensor(q_dt), geom, cfg).numpy()
    want = np.asarray(jx.jm.lagrangian_term(jx.jnp.asarray(u), jx.jnp.asarray(q_dt),
                                            _jgeom(jx, d, grid), jcfg))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_initial_state_and_coupled_rhs_match_jax(jx, golden):
    d, cfg, grid, q, geom = golden
    jcfg = jx.jm.MEMSConfig(**dataclasses.asdict(cfg))
    u0, q0 = tm.initial_state(cfg, device="cpu")
    ju0, jq0 = jx.jm.initial_state(jcfg)
    np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
    np.testing.assert_array_equal(q0.numpy(), np.asarray(jq0))
    y = np.stack([_2d(d, "u", grid), _2d(d, "q", grid)])
    got = tm.coupled_rhs(0.0, torch.tensor(y), cfg).numpy()
    want = np.asarray(jx.jm.coupled_rhs(0.0, jx.jnp.asarray(y), jcfg))
    assert got.shape == (2, cfg.n, cfg.n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


# -- the drivers ---------------------------------------------------------------------

def test_trajectory_matches_golden():
    """Three operator-split steps against the reference's PMA2_nk main loop."""
    g = np.load(FIX / "golden_pma2_traj.npz")
    cfg = tm.MEMSConfig(k=float(g["k"]))
    u, q, t, dts, iters = tm.evolve(cfg, nsteps=3, device="cpu")
    assert isinstance(dts, np.ndarray) and isinstance(iters, np.ndarray)
    np.testing.assert_allclose(dts, g["dts"], rtol=1e-10)
    np.testing.assert_allclose(u.numpy(), g["u"].reshape(cfg.grid.shape), atol=1e-6)
    np.testing.assert_allclose(q.numpy(), g["q"].reshape(cfg.grid.shape), atol=1e-8)
    assert t == pytest.approx(float(np.sum(g["dts"])), rel=1e-10)


def test_evolve_matches_jax(jx):
    """8 steps at k = 1e-3 (the JAX touchdown test's run): equal Newton
    counts, u and q to 1e-10, the deflection and the dt law of that test."""
    cfg = tm.MEMSConfig(k=1e-3)
    kw = dict(f_tol=1e-9, maxiter=40)
    u, q, t, dts, iters = tm.evolve(cfg, 8, solver=NewtonKrylov(**kw), device="cpu")
    ju, jq, jt, jdts, jiters = jx.jm.evolve(jx.jm.MEMSConfig(k=1e-3), 8,
                                            solver=jx.JNK(**kw))
    np.testing.assert_array_equal(iters, np.asarray(jiters))
    np.testing.assert_allclose(dts, np.asarray(jdts), rtol=1e-12)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-10)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-10)
    assert t == pytest.approx(float(jt), rel=1e-12)
    assert -1.0 < u.min().item() < -0.005
    assert np.all(np.diff(dts) <= 1e-12)
    assert tcv.mesh_geometry(q, cfg.grid).jac.min().item() > 0


def test_step_result_fields():
    cfg = tm.MEMSConfig(n=21)
    u, q = tm.initial_state(cfg, device="cpu")
    out = tm.make_step(cfg, NewtonKrylov(f_tol=1e-9), device="cpu")(u, q)
    assert isinstance(out.dt, float) and out.dt == cfg.k
    assert isinstance(out.newton_iters, int) and out.converged is True
    assert torch.all(out.u[torch.as_tensor(cfg.grid.mask_boundary)] == 0)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tm.MEMSConfig(n=11)
    for call in (lambda: tm.initial_state(cfg), lambda: tm.make_step(cfg),
                 lambda: tm.evolve(cfg, 1), lambda: tm.evolve_coupled(cfg, 1e-4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_trajectory_on_card_matches_golden(cuda):
    g = np.load(FIX / "golden_pma2_traj.npz")
    cfg = tm.MEMSConfig(k=float(g["k"]))
    u, q, t, dts, iters = tm.evolve(cfg, nsteps=3, device=cuda)
    np.testing.assert_allclose(dts, g["dts"], rtol=1e-10)
    np.testing.assert_allclose(u.cpu().numpy(), g["u"].reshape(cfg.grid.shape), atol=1e-6)
    np.testing.assert_allclose(q.cpu().numpy(), g["q"].reshape(cfg.grid.shape), atol=1e-8)


@pytest.mark.gpu
def test_evolve_on_card_matches_cpu(cuda):
    """20 steps of the reference configuration on the card against the same
    call on the CPU: equal Newton counts, u and q to 1e-10, and so dts to
    3e-10 relative (dt = k min (1+u)^3 moves by 3 |du| / (1 + u))."""
    cfg = tm.MEMSConfig()
    ug, qg, tg, dtg, itg = tm.evolve(cfg, 20, device=cuda)
    uc, qc, tc, dtc, itc = tm.evolve(cfg, 20, device="cpu")
    np.testing.assert_array_equal(itg, itc)
    np.testing.assert_allclose(dtg, dtc, rtol=3e-10)
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), atol=1e-10)
    np.testing.assert_allclose(qg.cpu().numpy(), qc.numpy(), atol=1e-10)


@pytest.mark.gpu
def test_graphed_coupled_rhs_on_card_equals_eager(cuda, golden):
    """The CUDA-graph right-hand side that ``evolve_coupled`` uses on the
    card gives the eager call's result bit for bit, for every state it is
    handed (the graph reads a static copy of each)."""
    d, cfg, grid, q, geom = golden
    y = torch.tensor(np.stack([_2d(d, "u", grid), _2d(d, "q", grid)]), device=cuda)
    f = tm.graphed_coupled_rhs(cfg, y)
    for yk in (y, y * (1.0 + 1e-3 * torch.cos(y)), torch.stack(tm.initial_state(cfg, device=cuda))):
        got = f(0.0, yk)
        want = tm.coupled_rhs(0.0, yk, cfg)
        assert got.data_ptr() != f(0.0, yk).data_ptr()
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
