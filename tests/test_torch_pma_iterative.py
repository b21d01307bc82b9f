"""Port parity: the iterative PMA solves, the steady-mesh iteration, the DCT
precision argument and ``square`` against the JAX package on CPU.

Inputs are ``golden_pma2.npz``'s 51x51 MEMS state (``q`` the mesh
potential, ``u`` the solution) on ``square(51)``, as in
``tests/test_pma_iterative.py``.  Tolerances: the stencil and the solves
agree to f64 rounding (1e-12 of scale); Chebyshev and CG reproduce the
consistent spectral solve to 1e-8 of scale (the JAX test's gate).
"""
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.core.grid import Grid2D as JGrid, square as jsquare
from iterative_solvers_tpu.meshmove import pma as jpma
from iterative_solvers_tpu_torch.core.grid import Grid2D, square as tsquare
from iterative_solvers_tpu_torch.meshmove import pma as tpma
from iterative_solvers_tpu_torch.ops import dct as tdct

FIX = pathlib.Path(__file__).parent / "fixtures"
TOL = 1e-12
PARAMS = dict(alpha=0.1, gamma=0.1, mackenzie_c=1.0)


def _mems_monitor(u, geom, grid):
    """PMA2's monitor with epsilon = 0 (the JAX ``models/mems.py``); plain
    arithmetic, so it serves both packages."""
    return 1.0 / (1.0 + u) ** 6


@pytest.fixture(scope="module")
def pma2():
    d = np.load(FIX / "golden_pma2.npz")
    n = int(d["n"])
    return n, d["q"].reshape(n, n), d["u"].reshape(n, n)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_square_matches_jax():
    for args in ((51,), (17, 0.0, 2.5)):
        j, t = jsquare(*args), tsquare(*args)
        assert (t.nx, t.ny, t.xl, t.xr, t.yb, t.yt) == (j.nx, j.ny, j.xl, j.xr, j.yb, j.yt)
        assert (t.dx, t.dy) == (j.dx, j.dy)


def test_dct_precision_high_is_full_f32():
    """``"high"`` runs the same full-f32 matmuls as ``"highest"`` and None
    (bit for bit); a lower precision raises."""
    u = torch.tensor(np.random.default_rng(3).standard_normal((61, 91)),
                     dtype=torch.float32)
    for f in (tdct.dct2, tdct.idct2):
        ref = f(u)
        assert torch.equal(f(u, precision="high"), ref)
        assert torch.equal(f(u, precision="highest"), ref)
        with pytest.raises(ValueError, match="precision"):
            f(u, precision="default")


def test_solve_pma_rejects_a_low_precision(pma2):
    n, q, u = pma2
    grid = tsquare(n)
    mon = torch.tensor(1.0 + u ** 2)
    jac = torch.ones(grid.shape, dtype=torch.float64)
    high = tpma.solve_pma(mon, jac, grid, tpma.PMAParams(spectral_precision="high"))
    assert torch.equal(high, tpma.solve_pma(mon, jac, grid, tpma.PMAParams()))
    with pytest.raises(ValueError, match="precision"):
        tpma.solve_pma(mon, jac, grid, tpma.PMAParams(spectral_precision="default"))


@pytest.mark.parametrize("field", ["q", "u"])
def test_neumann_laplacian_matches_jax(pma2, field):
    n, q, u = pma2
    v = {"q": q, "u": u}[field]
    want = jpma.neumann_laplacian(jnp.asarray(v), jsquare(n))
    _close(tpma.neumann_laplacian(torch.tensor(v), tsquare(n)).numpy(), want)


def test_eig_bounds_match_jax_and_bound_the_spectrum():
    for grid, jgrid, gamma in ((tsquare(51), jsquare(51), 0.1),
                               (Grid2D(nx=13, ny=9), JGrid(nx=13, ny=9), 0.25)):
        assert tpma.shifted_neumann_eig_bounds(grid, gamma) == \
            jpma.shifted_neumann_eig_bounds(jgrid, gamma)
    grid, gamma = Grid2D(nx=13, ny=9), 0.25
    lo, hi = tpma.shifted_neumann_eig_bounds(grid, gamma)
    eye = torch.eye(grid.nx * grid.ny, dtype=torch.float64)
    cols = [(e - gamma * tpma.neumann_laplacian(e.reshape(grid.shape), grid)
             .reshape(-1)) for e in eye]
    a = torch.stack(cols, dim=1).numpy()
    w = np.linalg.eigvalsh(0.5 * (a + a.T))
    assert w.min() >= lo - 1e-10 and w.max() <= hi + 1e-10


def _consistent_spectral_solve(rhs, grid, gamma):
    """The DCT-II inverse of ``I - gamma neumann_laplacian`` (``pi k / N``
    frequencies)."""
    ey = 2.0 * np.cos(np.pi * np.arange(grid.ny) / grid.ny) - 2.0
    ex = 2.0 * np.cos(np.pi * np.arange(grid.nx) / grid.nx) - 2.0
    leig = torch.tensor((ey[:, None] + ex[None, :]) / (grid.dx * grid.dy))
    return tdct.idct2(tdct.dct2(rhs) / (1.0 - gamma * leig))


@pytest.mark.parametrize("method", ["chebyshev", "cg"])
@pytest.mark.parametrize("field", ["q", "u"])
def test_shifted_neumann_solve_matches_jax(pma2, method, field):
    """Chebyshev (its static count) and CG through the port's ``cg``: the
    same iterate as the JAX solve, and the consistent spectral solution to
    1e-8 of scale; ``lap=`` takes the place of the built-in stencil."""
    n, q, u = pma2
    rhs = {"q": q, "u": u}[field]
    params = tpma.PMAParams(**PARAMS)
    jparams = jpma.PMAParams(**PARAMS)
    got = tpma.solve_shifted_neumann(torch.tensor(rhs), tsquare(n), params,
                                     method=method, tol=1e-10)
    want = jpma.solve_shifted_neumann(jnp.asarray(rhs), jsquare(n), jparams,
                                      method=method, tol=1e-10)
    _close(got.numpy(), want, tol=1e-10)
    spectral = _consistent_spectral_solve(torch.tensor(rhs), tsquare(n), params.gamma)
    _close(got.numpy(), spectral.numpy(), tol=1e-8)
    calls = []

    def lap(v):
        calls.append(1)
        return tpma.neumann_laplacian(v, tsquare(n))

    over = tpma.solve_shifted_neumann(torch.tensor(rhs), tsquare(n), params,
                                      method=method, tol=1e-10, lap=lap)
    assert calls and torch.equal(over, got)


def test_shifted_neumann_rejects_an_unknown_method(pma2):
    n, _, u = pma2
    with pytest.raises(ValueError, match="method"):
        tpma.solve_shifted_neumann(torch.tensor(u), tsquare(n),
                                   tpma.PMAParams(), method="jacobi")


def test_mesh_steady_state_matches_jax(pma2):
    """The steady-mesh iteration: the same number of sub-steps, the same
    verdict and the same potential as the JAX loop (1e-12 of the
    increment's scale), once to convergence and once stopped by
    ``max_iters``."""
    n, q, u = pma2
    kw = dict(dt=1e-4, atol=1e-6)
    for max_iters in (10000, 3):
        qt, it_t, ok_t = tpma.mesh_steady_state(
            torch.tensor(q), torch.tensor(u), grid=tsquare(n),
            params=tpma.PMAParams(**PARAMS), monitor_source=_mems_monitor,
            max_iters=max_iters, **kw)
        qj, it_j, ok_j = jpma.mesh_steady_state(
            jnp.asarray(q), jnp.asarray(u), grid=jsquare(n),
            params=jpma.PMAParams(**PARAMS), monitor_source=_mems_monitor,
            max_iters=max_iters, **kw)
        assert (it_t, ok_t) == (int(it_j), bool(ok_j))
        inc = np.asarray(qj) - q
        assert np.abs(inc).max() > 0
        _close(qt.numpy() - q, inc)
    assert ok_t is False and it_t == 3
