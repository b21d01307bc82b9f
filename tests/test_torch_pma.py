"""Port parity: DCTs, monitor smoothing and the PMA mesh loop against the
JAX package on the 91x61 coalescence fixture (``golden_droplet_step.npz``),
on CPU.

Tolerances: the DCTs and the f64 loop agree to rounding (1e-12 of scale).
With ``mesh_dtype="float32"`` both sides accumulate the f32 increment with
different summation orders, so the increment agrees to f32 rounding of
the increment (1e-4 of its own scale), which is ~1e-10 of ``q``.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.io.fixtures import config_for as jconfig_for
from iterative_solvers_tpu.meshmove import pma as jpma
from iterative_solvers_tpu.meshmove.monitor import smooth_and_regularise as jsmooth
from iterative_solvers_tpu.models import droplet as jdp
from iterative_solvers_tpu.ops import curvilinear as jcv, dct as jdct
from iterative_solvers_tpu_torch.io import fixtures as tfx
from iterative_solvers_tpu_torch.meshmove import pma as tpma
from iterative_solvers_tpu_torch.meshmove.monitor import smooth_and_regularise as tsmooth
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.ops import curvilinear as tcv, dct as tdct

DTMESH = 1e-7   # the config default: moves the mesh visibly in 5 loops


@pytest.fixture(scope="module")
def state():
    fix, _ = tfx.load_golden_step()
    return fix, tfx.config_for(fix)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dct_matches_jax(dtype):
    u = np.random.default_rng(5).standard_normal((61, 91)).astype(dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for jf, tf in ((jdct.dct2, tdct.dct2), (jdct.idct2, tdct.idct2)):
        want = np.asarray(jf(jnp.asarray(u)))
        got = tf(torch.tensor(u)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max())
    back = tdct.idct2(tdct.dct2(torch.tensor(u))).numpy()
    np.testing.assert_allclose(back, u, atol=10 * tol * np.abs(u).max())


def test_monitor_matches_jax(state):
    fix, cfg = state
    grid = cfg.grid
    jgeom = jcv.mesh_geometry(jnp.asarray(fix.q), jconfig_for(fix).grid)
    tgeom = tcv.mesh_geometry(torch.tensor(fix.q), grid)
    jsrc = jdp.monitor_source(jnp.asarray(fix.u), jgeom, jconfig_for(fix).grid)
    tsrc = tdp.monitor_source(torch.tensor(fix.u), tgeom, grid)
    jsrc_np = np.asarray(jsrc)
    np.testing.assert_allclose(tsrc.numpy(), jsrc_np, rtol=0,
                               atol=1e-11 * np.abs(jsrc_np).max())
    want = np.asarray(jsmooth(jsrc, jgeom.jac, grid.dx, grid.dy,
                              mackenzie_c=cfg.mackenzie_c))
    got = tsmooth(tsrc, tgeom.jac, grid.dx, grid.dy,
                  mackenzie_c=cfg.mackenzie_c).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11)


@pytest.mark.parametrize("mesh_dtype", [None, "float32"])
@pytest.mark.parametrize("form", ["full", "dev"])
def test_loop_pma_matches_jax(state, form, mesh_dtype):
    fix, cfg = state
    jcfg = dataclasses.replace(jconfig_for(fix), mesh_dtype=mesh_dtype,
                               spectral_dtype=mesh_dtype)
    tcfg = dataclasses.replace(cfg, mesh_dtype=mesh_dtype,
                               spectral_dtype=mesh_dtype)
    grid = tcfg.grid
    q = torch.tensor(fix.q)
    jgeo, tgeo = jcv.mesh_geometry, tcv.mesh_geometry
    if form == "dev":
        q = tcv.to_deviation(q, grid)
        jgeo, tgeo = jcv.mesh_geometry_dev, tcv.mesh_geometry_dev
    q0 = q.numpy()
    want = np.asarray(jpma.loop_pma(
        jnp.asarray(q0), jnp.asarray(fix.u), DTMESH, 5, jcfg.grid, jcfg.pma,
        jdp.monitor_source, jgeo))
    got = tpma.loop_pma(q, torch.tensor(fix.u), DTMESH, 5, grid, tcfg.pma,
                        tdp.monitor_source, tgeo).numpy()
    inc_want = want - q0
    assert np.abs(inc_want).max() > 1e-6  # the mesh moved
    tol = 1e-12 if mesh_dtype is None else 1e-4
    np.testing.assert_allclose(got - q0, inc_want, rtol=0,
                               atol=tol * np.abs(inc_want).max())
