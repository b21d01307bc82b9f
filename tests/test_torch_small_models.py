"""Port parity: the tridiagonal solver and the heat / wave models against
the JAX package on the cases of ``tests/test_small_models.py`` and
``tests/test_sparse_solvers.py``, f64 on the CPU.  Both sides run the same
recurrences in the same order: 1e-12 of the result's scale."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.models import heat as jheat
from iterative_solvers_tpu.models import wave as jwave
from iterative_solvers_tpu.solvers import tridiag as jtri
from iterative_solvers_tpu_torch.models import heat as theat
from iterative_solvers_tpu_torch.models import wave as twave
from iterative_solvers_tpu_torch.solvers import tridiag as ttri

RNG = np.random.default_rng(5)


def _close(got, want, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_tridiag_matches_jax_and_dense_solve():
    n = 50
    alpha = RNG.standard_normal(n - 1) * 0.3
    gamma = RNG.standard_normal(n - 1) * 0.3
    beta = 2.0 + RNG.random(n)
    b = RNG.standard_normal(n)
    got = ttri.tridiag_solve(*(torch.tensor(a) for a in (alpha, beta, gamma, b)))
    _close(got, jtri.tridiag_solve(*(jnp.asarray(a) for a in (alpha, beta, gamma, b))))
    dense = np.diag(beta) + np.diag(alpha, -1) + np.diag(gamma, 1)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(dense, b), atol=1e-10)


def test_tridiag_lu_is_reused_and_takes_a_batch():
    n = 30
    alpha = torch.full((n - 1,), -1.0, dtype=torch.float64)
    beta = torch.full((n,), 4.0, dtype=torch.float64)
    lu = ttri.trilu(alpha, beta, alpha)
    luj = jtri.trilu(jnp.full(n - 1, -1.0), jnp.full(n, 4.0), jnp.full(n - 1, -1.0))
    _close(lu.l, luj.l)
    _close(lu.v, luj.v)
    dense = 4.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    B = RNG.standard_normal((n, 3))
    got = ttri.trisolve(lu, torch.tensor(B))
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(dense, B), atol=1e-12)
    for j in range(3):
        _close(ttri.trisolve(lu, torch.tensor(B[:, j])), jtri.trisolve(luj, jnp.asarray(B[:, j])))


@pytest.mark.parametrize("insulated", [True, False])
def test_ftcs_heat_matches_jax_and_the_exact_kernel(insulated):
    n, k, a, nsteps = 23, 5e-4, 1.0, 1000
    x = np.linspace(0, 1, n + 1)
    u0 = np.cos(np.pi * x / 2) if insulated else np.sin(np.pi * x)
    got = theat.ftcs_evolve(torch.tensor(u0), nsteps, a, k, insulated_left=insulated)
    _close(got, jheat.ftcs_evolve(jnp.asarray(u0), nsteps, a, k, insulated_left=insulated))
    exact = (theat.exact_insulated if insulated else theat.exact_dirichlet)(
        torch.tensor(x), nsteps * k, a)
    assert float((got - exact).abs().max()) < 2e-3
    assert theat.stability_parameter(1.0, 5e-4, 23) < 0.5 <= theat.stability_parameter(1.0, 1e-3, 32)


def test_cn_heat_matches_jax_and_the_exact_kernel():
    n, k, a, nsteps = 10, 0.025, 1.0, 100
    x = np.linspace(0, 1, n + 1)
    u0 = np.sin(np.pi * x)
    got = theat.cn_evolve(torch.tensor(u0), nsteps, a, k)
    _close(got, jheat.cn_evolve(jnp.asarray(u0), nsteps, a, k))
    assert float((got - theat.exact_dirichlet(torch.tensor(x), nsteps * k, a)).abs().max()) < 2e-2
    _close(theat.exact_dirichlet(torch.tensor(x), 0.3), jheat.exact_dirichlet(jnp.asarray(x), 0.3))
    _close(theat.exact_insulated(torch.tensor(x), 0.3), jheat.exact_insulated(jnp.asarray(x), 0.3))


def test_damped_wave_inlet_matches_jax():
    n, k, nsteps = 50, 1e-2, 500
    uj, trajj = jwave.damped_wave_1d(
        n, k, nsteps, lambda t: 2 * jnp.exp(-t) * jnp.sin(10 * t) / 5)
    ut, trajt = twave.damped_wave_1d(
        n, k, nsteps, lambda t: 2 * torch.exp(-t) * torch.sin(10 * t) / 5, device="cpu")
    assert trajt.shape == (nsteps + 1, n + 1)
    _close(trajt, trajj)
    _close(ut, uj)
    traj = trajt.numpy()
    assert np.abs(traj).max() < 0.5 and np.abs(traj[-1]).max() < 0.1
    assert np.abs(traj[150:, n // 2]).max() > 1e-4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            twave.damped_wave_1d(n, k, 2, lambda t: t)


@pytest.mark.parametrize("nsteps", [0, 1, 200, 600])
def test_tank_wave_matches_jax(nsteps):
    k, p, c = 1e-2, 0.4, 1.0
    n = int(np.sqrt(p) / c / k)
    xx = np.arange(n + 1) / n
    x, y = np.meshgrid(xx, xx)
    u0 = -0.4 * np.exp(-100 * (x - 0.3) ** 2 - 100 * (y - 0.4) ** 2)
    got = twave.tank_wave_2d(torch.tensor(u0), nsteps, k, p)
    _close(got, jwave.tank_wave_2d(jnp.asarray(u0), nsteps, k, p))
    assert bool(torch.isfinite(got).all())
    if nsteps == 600:
        assert float(got.abs().max()) < np.abs(u0).max()
