"""Port parity: curvilinear geometry and Laplacian, f64 on CPU, against
the JAX package (1e-11 of the result's scale: same arithmetic, other
summation order in the edge contractions) and against the reference
goldens of ``golden_droplet.npz`` (the tolerances of test_curvilinear)."""
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.core.grid import Grid2D as JGrid
from iterative_solvers_tpu.ops import curvilinear as jcv
from iterative_solvers_tpu_torch.core.grid import Grid2D as TGrid
from iterative_solvers_tpu_torch.ops import curvilinear as tcv, stencils as tst

FIX = pathlib.Path(__file__).parent / "fixtures"
TOL = 1e-11


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def golden():
    d = np.load(FIX / "golden_droplet.npz")
    kw = dict(nx=int(d["nx"]), ny=int(d["ny"]), xl=float(d["endl"]),
              xr=float(d["endr"]), yb=float(d["endb"]), yt=float(d["endt"]))
    shape = (kw["ny"], kw["nx"])
    return {k: d[k].reshape(shape) for k in ("q", "u", "q_dksi", "jac",
                                              "lap_raw_xx", "lap_raw_yy")}, kw


def _perturbed(kw, seed=3):
    """A genuinely curvilinear mesh potential and a smooth field on it."""
    g = TGrid(**kw)
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(0.02, 0.06, 2)
    q = 0.5 * (g.xx ** 2 + g.yy ** 2) + a * np.sin(g.xx) * np.cos(b * 10 * g.yy)
    u = 0.01 + np.exp(-(g.xx ** 2 + g.yy ** 2))
    return q, u


@pytest.mark.parametrize("form", ["full", "dev"])
def test_mesh_geometry_matches_jax(golden, form):
    _, kw = golden
    q, _ = _perturbed(kw)
    jg, tg = JGrid(**kw), TGrid(**kw)
    if form == "full":
        want = jcv.mesh_geometry(jnp.asarray(q), jg)
        got = tcv.mesh_geometry(torch.tensor(q), tg)
    else:
        phi = q - 0.5 * (tg.xx ** 2 + tg.yy ** 2)
        want = jcv.mesh_geometry_dev(jnp.asarray(phi), jg)
        got = tcv.mesh_geometry_dev(torch.tensor(phi), tg)
    for name, w, t in zip(want._fields, want, got):
        _close(t.numpy(), w)


@pytest.mark.parametrize("quirk", [True, False])
def test_laplace_matches_jax(golden, quirk):
    _, kw = golden
    q, u = _perturbed(kw)
    jg, tg = JGrid(**kw), TGrid(**kw)
    jgeom = jcv.mesh_geometry(jnp.asarray(q), jg)
    tgeom = tcv.mesh_geometry(torch.tensor(q), tg)
    ju, tu = jnp.asarray(u), torch.tensor(u)
    jk, je = jcv.grad_ksi_neumann(ju, jg, quirk=quirk)
    tk, te = tcv.grad_ksi_neumann(tu, tg, quirk=quirk)
    _close(tk.numpy(), jk)
    _close(te.numpy(), je)
    for w, t in zip(jcv.laplace(ju, jk, je, jgeom, jg),
                    tcv.laplace(tu, tk, te, tgeom, tg)):
        _close(t.numpy(), w)
    for w, t in zip(jcv.grad_xy(jk, je, jgeom), tcv.grad_xy(tk, te, tgeom)):
        _close(t.numpy(), w)


def test_to_deviation_matches_jax(golden):
    d, kw = golden
    _close(tcv.to_deviation(torch.tensor(d["q"]), TGrid(**kw)).numpy(),
           jcv.to_deviation(jnp.asarray(d["q"]), JGrid(**kw)))


def test_mesh_geometry_matches_golden(golden):
    d, kw = golden
    grid = TGrid(**kw)
    geom = tcv.mesh_geometry(torch.tensor(d["q"]), grid)
    np.testing.assert_allclose(geom.x.numpy(), d["q_dksi"], atol=1e-11)
    np.testing.assert_allclose(geom.jac.numpy(), d["jac"], atol=1e-9)
    u = torch.tensor(d["u"])
    vxx, vyy = tcv.laplace(u, tst.d1_x(u, grid.dx), tst.d1_y(u, grid.dy),
                           geom, grid)
    np.testing.assert_allclose(vxx.numpy(), d["lap_raw_xx"], atol=1e-8)
    np.testing.assert_allclose(vyy.numpy(), d["lap_raw_yy"], atol=1e-8)


def test_laplace_edge_dtype_matches_jax(golden):
    """f32 inputs (the f64 geometry cast to f32, as the f32 inner Krylov
    takes it) with the one-sided columns evaluated in f64 and cast back,
    against the JAX package's ``edge_dtype`` path: f32 rounding, 1e-5 of
    the result's scale (the gate of the f32 kernel comparisons); the edge
    columns then sit closer to the f64 Laplacian than plain f32 ones do."""
    _, kw = golden
    q, u = _perturbed(kw)
    jg, tg = JGrid(**kw), TGrid(**kw)
    jgeom = jcv.MeshGeometry(*(a.astype(jnp.float32) for a in
                               jcv.mesh_geometry(jnp.asarray(q), jg)))
    tgeom = tcv.MeshGeometry(*(a.float() for a in
                               tcv.mesh_geometry(torch.tensor(q), tg)))
    ju, tu = jnp.asarray(u, jnp.float32), torch.tensor(u, dtype=torch.float32)
    jk, je = jcv.grad_ksi_neumann(ju, jg)
    tk, te = tcv.grad_ksi_neumann(tu, tg)
    want = jcv.laplace(ju, jk, je, jgeom, jg, edge_dtype=jnp.float64)
    got = tcv.laplace(tu, tk, te, tgeom, tg, edge_dtype=torch.float64)
    f32 = tcv.laplace(tu, tk, te, tgeom, tg)
    geom64 = tcv.mesh_geometry(torch.tensor(q), tg)
    u64 = torch.tensor(u)
    exact = tcv.laplace(u64, *tcv.grad_ksi_neumann(u64, tg), geom64, tg)
    for w, t, plain, ex in zip(want, got, f32, exact):
        assert t.dtype == torch.float32
        _close(t.numpy(), w, tol=1e-5)
        edge = np.r_[0:3, -3:0]
        err_wide = np.abs(t.numpy()[:, edge] - ex.numpy()[:, edge]).max()
        err_plain = np.abs(plain.numpy()[:, edge] - ex.numpy()[:, edge]).max()
        assert err_wide <= err_plain


def test_laplacian_xy_matches_jax(golden):
    _, kw = golden
    q, u = _perturbed(kw)
    jg, tg = JGrid(**kw), TGrid(**kw)
    want = jcv.laplacian_xy(jnp.asarray(u), jcv.mesh_geometry(jnp.asarray(q), jg), jg)
    got = tcv.laplacian_xy(torch.tensor(u), tcv.mesh_geometry(torch.tensor(q), tg), tg)
    _close(got.numpy(), want)
