"""Port parity: the droplet JFNK step, end to end, on CPU.

- the f64 FD step from the 91x61 coalescence state against the scipy-driven
  golden step (u 1e-6, q 1e-8: the gates of test_models_parity);
- the f32 inner-Krylov steps (JVP matvec and exact JVP) against the JAX
  package's (both converged, Newton count within 1, u within 5e-7: the
  gate of test_pallas_droplet);
- a 128x96 deviation-form, f32-mesh step from the upsampled fixture (the
  large-grid configuration) against the JAX package's.
"""
import dataclasses
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.io import fixtures as jfx
from iterative_solvers_tpu.models import droplet as jdp
from iterative_solvers_tpu.ops import curvilinear as jcv
from iterative_solvers_tpu.solvers.newton import NewtonKrylov as JNK
from iterative_solvers_tpu_torch.io import convert, fixtures as tfx
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.ops import curvilinear as tcv
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov as TNK

FIX = pathlib.Path(__file__).parent / "fixtures"
DROPS = [(0.0, 0.0, 1.0, 1.0), (3.0, 0.0, 1.0, 1.0)]


@pytest.fixture(scope="module")
def golden():
    fix, g = tfx.load_golden_step()
    return fix, g, tfx.config_for(fix), jfx.DropletFixture(**dataclasses.asdict(fix))


def test_step_matches_golden(golden):
    fix, g, cfg, _ = golden
    grid = cfg.grid
    u, q = convert.state_from_numpy(fix.u, fix.q, "cpu")
    F = tdp.pde_rhs(u, tcv.mesh_geometry(q, grid), cfg)
    np.testing.assert_allclose(F.numpy(), g["F"], rtol=1e-7, atol=1e-7)

    dt = float(g["dt"])
    out = tdp.make_step(cfg, dt=dt, dtmesh=3e-9, pma_loops=5, device="cpu")(u, q, dt)
    assert out.converged
    np.testing.assert_allclose(out.u.numpy(), g["u_new"], atol=1e-6)
    np.testing.assert_allclose(out.q.numpy(), g["q_new"], atol=1e-8)
    # diagnostic-level agreement only (the reference's SE/SW spacing
    # expressions mix row offsets, a quirk not reproduced)
    spc = float(tdp.min_spacing(tcv.mesh_geometry(out.q, grid)))
    assert abs(spc - float(g["min_spacing"])) / float(g["min_spacing"]) < 0.05


@pytest.mark.parametrize("jvp_kernel", [True, False], ids=["kernel", "jvp"])
def test_f32_mode_step_matches_jax(golden, jvp_kernel):
    """The f32 inner-Krylov step through the JVP matvec (``kernel``: the
    wrapper, on CPU its plain version) or through an exact JVP of the f32
    residual (``jvp``: torch.func.jvp against jax.jvp)."""
    fix, g, cfg, jfix = golden
    dt = float(g["dt"])
    jcfg = jfx.config_for(jfix)
    oj = jdp.make_step(jcfg, dt=dt, dtmesh=3e-9, pma_loops=5,
                       jvp_dtype="float32", jvp_kernel=jvp_kernel)(
        jnp.asarray(fix.u), jnp.asarray(fix.q), dt)
    u, q = convert.state_from_numpy(fix.u, fix.q, "cpu")
    ot = tdp.make_step(cfg, dt=dt, dtmesh=3e-9, pma_loops=5,
                       jvp_dtype="float32", jvp_kernel=jvp_kernel,
                       device="cpu")(u, q, dt)
    assert bool(oj.converged) and ot.converged
    assert abs(int(oj.newton_iters) - ot.newton_iters) <= 1
    np.testing.assert_allclose(ot.u.numpy(), np.asarray(oj.u), atol=5e-7)
    np.testing.assert_allclose(ot.q.numpy(), np.asarray(oj.q), atol=1e-8)
    np.testing.assert_allclose(ot.u.numpy(), g["u_new"], atol=1e-6)


def test_deviation_step_128x96_matches_jax(golden):
    """Upsampled fixture, deviation-form mesh, f32 PMA and DCTs, f32
    kernel-mode inner Krylov with the large-grid solver settings; the drops
    re-seeded on the upsampled mesh as the large-grid preparation does.
    The f32 mesh increment agrees to 1e-4 of its own scale (f32 sums in
    another order)."""
    fix, _, _, jfix = golden
    bj, bt = jfx.upsample(jfix, 128, 96), tfx.upsample(fix, 128, 96)
    np.testing.assert_allclose(bt.q, bj.q, rtol=1e-14)
    np.testing.assert_allclose(bt.u, bj.u, rtol=1e-14)
    f32 = dict(spectral_dtype="float32", mesh_dtype="float32")
    jcfg = dataclasses.replace(jfx.config_for(bj), **f32)
    tcfg = dataclasses.replace(tfx.config_for(bt), **f32)
    phi_j = jcv.to_deviation(jnp.asarray(bj.q), jcfg.grid)
    phi_t = tcv.to_deviation(torch.tensor(bt.q), tcfg.grid)
    u_j = jdp.seeded_solution(jcv.mesh_geometry_dev(phi_j, jcfg.grid), jcfg, DROPS)
    u_t = tdp.seeded_solution(tcv.mesh_geometry_dev(phi_t, tcfg.grid), tcfg, DROPS)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-13)

    kw = dict(f_tol=1e-8, maxiter=14, inner_m=12, outer_k=6,
              inner_dtype="float32", max_backtracks=4)
    step_kw = dict(dt=1e-5, dtmesh=1e-9, pma_loops=2, deviation_form=True,
                   jvp_dtype="float32", jvp_kernel=True)
    oj = jdp.make_step(jcfg, solver=JNK(**kw), **step_kw)(u_j, phi_j, 1e-5)
    ot = tdp.make_step(tcfg, solver=TNK(**kw), device="cpu", **step_kw)(
        u_t, phi_t, 1e-5)
    assert bool(oj.converged) and ot.converged
    assert int(oj.newton_iters) > 1
    assert abs(int(oj.newton_iters) - ot.newton_iters) <= 1
    np.testing.assert_allclose(ot.u.numpy(), np.asarray(oj.u), atol=5e-7)
    inc = np.asarray(oj.q) - np.asarray(phi_j)
    np.testing.assert_allclose(ot.q.numpy() - phi_t.numpy(), inc, rtol=0,
                               atol=1e-4 * np.abs(inc).max())


def test_physics_matches_golden():
    """pressure, pde_rhs and the CN residual against the reference goldens
    (the tolerances of test_models_parity)."""
    d = np.load(FIX / "golden_droplet.npz")
    cfg = tdp.DropletConfig(
        R=float(d["R"]), a=float(d["a"]), epsilon=float(d["epsilon"]),
        Bo=float(d["Bo"]), incline=float(d["alpha2"]), nx=int(d["nx"]),
        ny=int(d["ny"]), xl=float(d["endl"]), xr=float(d["endr"]),
        yb=float(d["endb"]), yt=float(d["endt"]), alpha=float(d["alpha"]),
        gamma=float(d["gamma"]), mackenzie_c=float(d["C"]))
    grid = cfg.grid
    f = lambda k: torch.tensor(d[k].reshape(grid.shape))  # noqa: E731
    geom = tcv.mesh_geometry(f("q"), grid)
    p = tdp.pressure(f("u"), f("u_xx"), f("u_yy"), cfg)
    np.testing.assert_allclose(p.numpy(), d["p_val"].reshape(grid.shape), atol=1e-9)
    p_dx, p_dy = tdp.pressure_grad_xy(p, geom, grid)
    np.testing.assert_allclose(p_dx.numpy(), d["p_dx"].reshape(grid.shape), atol=1e-8)
    np.testing.assert_allclose(p_dy.numpy(), d["p_dy"].reshape(grid.shape), atol=1e-8)
    np.testing.assert_allclose(tdp.pde_rhs(f("u"), geom, cfg).numpy(),
                               d["pde_rhs"].reshape(grid.shape), rtol=1e-8, atol=1e-7)
    res = tdp.cn_residual(f("u_probe"), f("u"), f("pde_rhs"), 1e-4, geom, cfg)
    np.testing.assert_allclose(res.numpy(), d["residual"].reshape(grid.shape),
                               rtol=1e-8, atol=1e-9)


def test_config_and_state_convert(golden):
    _, _, _, jfix = golden
    jcfg = jfx.config_for(jfix)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError):
        convert.config_from_dict({**dataclasses.asdict(jcfg), "bogus": 1})
    u, q = convert.state_from_numpy(jfix.u, jfix.q, "cpu", torch.float32)
    assert u.dtype == q.dtype == torch.float32 and u.shape == jfix.u.shape


def test_entry_point_raises_without_cuda(golden, monkeypatch):
    """No silent CPU fallback: without a card, the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdp.make_step(golden[2], dt=1e-5, dtmesh=3e-9, pma_loops=1)
