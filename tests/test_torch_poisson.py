"""Port parity: CG, the DST fast solvers, the preconditioners, the 1-D
transforms and the Poisson duct-flow model against the JAX package, on the
same seeded numpy inputs, f64 on the CPU.

The port's ``cg`` makes the JAX loop's decisions in the same order, so
iteration counts are equal and solutions agree to 1e-10; the direct
solvers are four matmuls on either side and agree to 1e-12 of the
solution's scale.  The preconditioned GMRES runs take the same number of
iterations as the JAX package's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve

from iterative_solvers_tpu.models import poisson as jpoisson
from iterative_solvers_tpu.ops import dct as jdct
from iterative_solvers_tpu.ops import stencils as jst
from iterative_solvers_tpu.solvers import fast_poisson as jfp
from iterative_solvers_tpu.solvers import preconditioners as jpc
from iterative_solvers_tpu.solvers.cg import cg as jax_cg
from iterative_solvers_tpu.solvers.gmres import gmres as jax_gmres
from iterative_solvers_tpu_torch.models import poisson as tpoisson
from iterative_solvers_tpu_torch.ops import dct as tdct
from iterative_solvers_tpu_torch.ops import sparse as ts
from iterative_solvers_tpu_torch.ops import spmv
from iterative_solvers_tpu_torch.ops import stencils as tst
from iterative_solvers_tpu_torch.solvers import cg as torch_cg
from iterative_solvers_tpu_torch.solvers import gmres as torch_gmres
from iterative_solvers_tpu_torch.solvers import fast_poisson as tfp
from iterative_solvers_tpu_torch.solvers import preconditioners as tpc

RNG = np.random.default_rng(5)


def _close(got, want, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


# -- transforms ------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("name", ["dct1d", "idct1d"])
def test_dct1d_matches_jax(name, axis):
    u = RNG.standard_normal((9, 14))
    _close(getattr(tdct, name)(torch.tensor(u), axis=axis),
           getattr(jdct, name)(jnp.asarray(u), axis=axis))


def test_dct1d_round_trip_and_dst2_match_jax():
    u = RNG.standard_normal((9, 14))
    t = torch.tensor(u)
    _close(tdct.idct1d(tdct.dct1d(t, axis=0), axis=0), u)
    _close(tdct.dst2(t), jdct.dst2(jnp.asarray(u)))
    _close(tdct.dst2(tdct.dst2(t)), u)  # the DST-I basis is its own inverse
    u32 = u.astype(np.float32)
    _close(tdct.dst2(torch.tensor(u32)), jdct.dst2(jnp.asarray(u32)), rel=1e-6)


# -- CG ------------------------------------------------------------------------

@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches_jax_on_the_poisson_system(precond):
    n, h = 31, 1 / 32
    b = RNG.standard_normal((n, n))
    diag = 4.0 / (h * h) * (1.0 + 0.5 * RNG.random((n, n)))  # an SPD diagonal scaling
    Mj = (lambda v: v / jnp.asarray(diag)) if precond else None
    Mt = (lambda v: v / torch.tensor(diag)) if precond else None
    rj = jax_cg(lambda u: -jst.lap_dirichlet_5pt(u, h), jnp.asarray(b), tol=1e-12, M=Mj)
    rt = torch_cg(lambda u: -tst.lap_dirichlet_5pt(u, h), torch.tensor(b), tol=1e-12, M=Mt)
    assert bool(rj.converged) and rt.converged
    assert rt.iters == int(rj.iters)
    assert isinstance(rt.iters, int) and isinstance(rt.resnorm, float)
    _close(rt.x, rj.x, rel=1e-10)
    np.testing.assert_allclose(rt.resnorm, float(rj.resnorm), rtol=1e-3, atol=1e-13)
    np.testing.assert_allclose((-tst.lap_dirichlet_5pt(rt.x, h)).numpy(), b, atol=1e-9)


def test_cg_stops_at_maxiter_and_takes_x0():
    n, h = 15, 1 / 16
    b = RNG.standard_normal((n, n))
    mvj = lambda u: -jst.lap_dirichlet_5pt(u, h)  # noqa: E731
    mvt = lambda u: -tst.lap_dirichlet_5pt(u, h)  # noqa: E731
    x0 = RNG.standard_normal((n, n))
    rj = jax_cg(mvj, jnp.asarray(b), jnp.asarray(x0), tol=1e-14, maxiter=7)
    rt = torch_cg(mvt, torch.tensor(b), torch.tensor(x0), tol=1e-14, maxiter=7)
    assert rt.iters == int(rj.iters) == 7 and not rt.converged and not bool(rj.converged)
    _close(rt.x, rj.x, rel=1e-11)
    exact = torch_cg(mvt, torch.tensor(b), rt.x, tol=1e-10)
    again = torch_cg(mvt, torch.tensor(b), exact.x, tol=1e-10)
    assert again.iters == 0 and again.converged  # already below tol: no update


# -- fast solvers ------------------------------------------------------------------

def test_fast_poisson_matches_jax_and_sparse_direct():
    n = 32
    h, m = 1.0 / n, n - 1
    f = RNG.standard_normal((m, m))
    got = tfp.poisson_dirichlet_solve(torch.tensor(f), h)
    _close(got, jfp.poisson_dirichlet_solve(jnp.asarray(f), h))
    want = spsolve(ts.laplacian_5pt_dirichlet(n, h).tocsc(), f.reshape(-1))
    np.testing.assert_allclose(got.numpy().reshape(-1), want, atol=1e-10)


def test_fast_helmholtz_matches_jax_and_sparse_direct_on_a_rectangle():
    my, mx, hy, hx, shift = 17, 23, 1 / 18, 1 / 24, 7.5
    f = RNG.standard_normal((my, mx))
    got = tfp.helmholtz_dirichlet_solve(torch.tensor(f), shift, hx, hy)
    _close(got, jfp.helmholtz_dirichlet_solve(jnp.asarray(f), shift, hx, hy))
    lx = sp.diags([np.ones(mx - 1), -2 * np.ones(mx), np.ones(mx - 1)], [-1, 0, 1]) / hx ** 2
    ly = sp.diags([np.ones(my - 1), -2 * np.ones(my), np.ones(my - 1)], [-1, 0, 1]) / hy ** 2
    a = shift * sp.identity(my * mx) - (sp.kron(sp.identity(my), lx)
                                        + sp.kron(ly, sp.identity(mx)))
    np.testing.assert_allclose(got.numpy().reshape(-1), spsolve(a.tocsc(), f.reshape(-1)),
                               atol=1e-10)


# -- the duct-flow model -------------------------------------------------------------

@pytest.fixture(scope="module", params=[32, 64])
def duct(request):
    n = request.param
    return n, np.asarray(jpoisson.solve_direct(n)), tpoisson.solve_direct(n, device="cpu")


def test_poisson_direct_matches_jax(duct):
    n, uj, ut = duct
    assert ut.shape == (n + 1, n + 1) and ut.dtype == torch.float64
    _close(ut, uj)
    q = float(tpoisson.flow_rate(ut, 1.0 / n))
    np.testing.assert_allclose(q, float(jpoisson.flow_rate(jnp.asarray(uj), 1.0 / n)),
                               rtol=1e-12)
    assert tpoisson.flow_rate_exact() == jpoisson.flow_rate_exact()
    assert abs(q - tpoisson.flow_rate_exact()) / tpoisson.flow_rate_exact() < 4.0 / n


@pytest.mark.parametrize("route", ["stencil", "grid_dia", "dia_flat"])
def test_poisson_cg_routes_match_jax_and_the_direct_solve(duct, route):
    """Matrix-free CG and CG on the assembled operator through the two SpMV
    wrappers: the JAX run's iteration count (the assembled operator rounds
    like the stencil to ~1e-16, so the count may differ by one), and the
    direct solve's field to 1e-8."""
    n, uj, ut = duct
    uj_cg, rj = jpoisson.solve_cg(n, tol=1e-12)
    if route == "stencil":
        u, res = tpoisson.solve_cg(n, tol=1e-12, device="cpu")
        assert res.iters == int(rj.iters)
    else:
        m, h = n - 1, 1.0 / n
        lap = ts.laplacian_5pt_dirichlet(n, h)
        b = torch.full((m, m), -1.0, dtype=torch.float64)
        if route == "grid_dia":
            a = ts.GridDIA.from_scipy(lap, (m, m), device="cpu")
            res = torch_cg(lambda v: spmv.grid_dia_matvec(a, v), b, tol=1e-12,
                           maxiter=20 * n)
        else:
            a = ts.DIA.from_scipy(lap, device="cpu")
            res = torch_cg(lambda v: spmv.dia_flat_matvec(a, (m, m), v), b, tol=1e-12,
                           maxiter=20 * n)
        u = torch.nn.functional.pad(res.x, (1, 1, 1, 1))
        assert abs(res.iters - int(rj.iters)) <= 1
    assert res.converged
    np.testing.assert_allclose(u.numpy(), np.asarray(uj_cg), atol=1e-9)
    np.testing.assert_allclose(u.numpy(), ut.numpy(), atol=1e-8)


def test_cg_reports_the_true_residual_as_the_jax_loop_does():
    """At n = 384, tol 1e-10 the recurrence residual passes the tolerance
    while the recomputed true residual floors just above it: both loops
    stop at the same iteration and both report ``converged`` False."""
    n = 384
    _, rj = jpoisson.solve_cg(n, tol=1e-10)
    _, rt = tpoisson.solve_cg(n, tol=1e-10, device="cpu")
    assert rt.iters == int(rj.iters) < 20 * n
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(rt.resnorm, float(rj.resnorm), rtol=0.2)
    assert rt.resnorm <= 1e-9 * (n - 1)


def test_poisson_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    for call in (lambda: tpoisson.solve_direct(8), lambda: tpoisson.solve_cg(8),
                 lambda: tpc.block_jacobi_dense(sp.identity(4).tocsr(), 2),
                 lambda: tpc.ILU0(sp.identity(4).tocsr())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# -- preconditioners -----------------------------------------------------------------

@pytest.fixture(scope="module")
def shifted_system():
    n = 24            # intervals -> 23^2 unknowns
    h = 1.0 / n
    a = (sp.identity((n - 1) ** 2) * 5.0 - ts.laplacian_5pt_dirichlet(n, h)).tocsr()
    b = np.random.default_rng(23).standard_normal((n - 1) ** 2)
    return a, b, n, h


def _gmres_iters(a, b, Mj, Mt):
    dj, dt = jnp.asarray(a.toarray()), torch.tensor(a.toarray())
    rj = jax_gmres(lambda v: dj @ v, jnp.asarray(b), tol=1e-10, restart=30,
                   maxiter=600, M=Mj)
    rt = torch_gmres(lambda v: dt @ v, torch.tensor(b), tol=1e-10, restart=30,
                     maxiter=600, M=Mt)
    assert bool(rj.converged) and rt.converged
    np.testing.assert_allclose(a @ rt.x.numpy(), b, atol=1e-7)
    return int(rj.iters), rt.iters


@pytest.mark.parametrize("kind", ["none", "jacobi", "block_jacobi", "ilu0"])
def test_preconditioned_gmres_takes_the_jax_iteration_count(shifted_system, kind):
    a, b, n, h = shifted_system
    if kind == "none":
        Mj = Mt = None
    elif kind == "jacobi":
        Mj, Mt = jpc.jacobi(jnp.asarray(a.diagonal())), tpc.jacobi(torch.tensor(a.diagonal()))
    elif kind == "block_jacobi":
        Mj = jpc.block_jacobi_dense(a, block=n - 1)
        Mt = tpc.block_jacobi_dense(a, block=n - 1, device="cpu")
    else:
        Mj, Mt = jpc.ILU0(a, sweeps=8), tpc.ILU0(a, sweeps=8, device="cpu")
    if Mj is not None:
        v = np.random.default_rng(1).standard_normal(b.shape)
        _close(Mt(torch.tensor(v)), Mj(jnp.asarray(v)))
    ij, it = _gmres_iters(a, b, Mj, Mt)
    assert it == ij
    if kind != "none":
        assert it <= _gmres_iters(a, b, None, None)[1]


def test_ilu0_is_exact_on_a_triangular_matrix():
    n = 30
    rng = np.random.default_rng(23)
    a = sp.csr_matrix(np.tril(rng.standard_normal((n, n))) + 5 * np.eye(n))
    v = rng.standard_normal(n)
    z = tpc.ILU0(a, sweeps=40, device="cpu")(torch.tensor(v))
    np.testing.assert_allclose(a @ z.numpy(), v, atol=1e-8)
    _close(z, jpc.ILU0(a, sweeps=40)(jnp.asarray(v)), rel=1e-11)


def test_spectral_preconditioner_converges_in_one_shot(shifted_system):
    a, b, n, h = shifted_system
    m = n - 1
    dj, dt = jnp.asarray(a.toarray()), torch.tensor(a.toarray())
    rj = jax_gmres(lambda v: (dj @ v.reshape(-1)).reshape(m, m), jnp.asarray(b.reshape(m, m)),
                   tol=1e-10, restart=10, M=jpc.spectral_helmholtz(5.0, h, h))
    rt = torch_gmres(lambda v: (dt @ v.reshape(-1)).reshape(m, m),
                     torch.tensor(b.reshape(m, m)),
                     tol=1e-10, restart=10, M=tpc.spectral_helmholtz(5.0, h, h))
    assert rt.converged and rt.iters == int(rj.iters) and rt.iters <= 3
