"""Port parity: the restarted ``gmres()`` and ``lgmres()`` solvers and the
functional ``newton_krylov`` against the JAX package, f64 on CPU.

Same algorithm, same decisions: iteration counts are equal and solutions
agree to 1e-10 (the Gram–Schmidt sums run in another order, so the last
digits differ)."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.solvers.newton import newton_krylov as j_nk
from iterative_solvers_tpu_torch.solvers.newton import newton_krylov as t_nk

# both packages' solvers/__init__ re-export the gmres and lgmres
# functions under their modules' names
jgm = importlib.import_module("iterative_solvers_tpu.solvers.gmres")
jlg = importlib.import_module("iterative_solvers_tpu.solvers.lgmres")
tgm = importlib.import_module("iterative_solvers_tpu_torch.solvers.gmres")
tlg = importlib.import_module("iterative_solvers_tpu_torch.solvers.lgmres")

SHAPE = (8, 10)
N = SHAPE[0] * SHAPE[1]


def _system(seed=5):
    """A nonsymmetric, non-normal system that needs several restarts."""
    rng = np.random.default_rng(seed)
    A = 2.0 * np.eye(N) + rng.standard_normal((N, N)) / np.sqrt(N) \
        + np.diag(np.linspace(0.0, 3.0, N))
    b = rng.standard_normal(SHAPE)
    return A, b


def _ops(A):
    Aj, At = jnp.asarray(A), torch.tensor(A)
    d = np.diag(A).reshape(SHAPE)
    mvj = lambda v: (Aj @ v.reshape(-1)).reshape(v.shape)  # noqa: E731
    mvt = lambda v: (At @ v.reshape(-1)).reshape(v.shape)  # noqa: E731
    Mj = lambda v: v / jnp.asarray(d)  # noqa: E731
    Mt = lambda v: v / torch.tensor(d)  # noqa: E731
    return (mvj, Mj), (mvt, Mt)


def _x0(b, seed=9):
    return 0.1 * np.random.default_rng(seed).standard_normal(b.shape)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("restart", [5, 12])
def test_gmres_matches_jax(restart, precond):
    A, b = _system()
    (mvj, Mj), (mvt, Mt) = _ops(A)
    x0 = _x0(b)
    kw = dict(tol=1e-11, restart=restart, maxiter=400)
    oj = jgm.gmres(mvj, jnp.asarray(b), jnp.asarray(x0), M=Mj if precond else None, **kw)
    ot = tgm.gmres(mvt, torch.tensor(b), torch.tensor(x0), M=Mt if precond else None, **kw)
    assert bool(oj.converged) and ot.converged
    assert int(oj.iters) == ot.iters
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), atol=1e-10)
    np.testing.assert_allclose(ot.resnorm, float(oj.resnorm), rtol=1e-3)
    want = np.linalg.solve(A, b.reshape(-1)).reshape(SHAPE)
    np.testing.assert_allclose(ot.x.numpy(), want, atol=1e-9)


def test_gmres_maxiter_counts_inner_iterations():
    A, b = _system()
    (mvj, _), (mvt, _) = _ops(A)
    oj = jgm.gmres(mvj, jnp.asarray(b), tol=1e-14, restart=4, maxiter=10)
    ot = tgm.gmres(mvt, torch.tensor(b), tol=1e-14, restart=4, maxiter=10)
    assert not bool(oj.converged) and not ot.converged
    assert int(oj.iters) == ot.iters == 12  # checked between restarts
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), atol=1e-10)


@pytest.mark.parametrize("store_av", [True, False])
@pytest.mark.parametrize("precond", [False, True])
def test_lgmres_matches_jax(precond, store_av):
    A, b = _system(seed=6)
    (mvj, Mj), (mvt, Mt) = _ops(A)
    kw = dict(tol=1e-11, inner_m=6, outer_k=3, store_av=store_av)
    (oj, recj) = jlg.lgmres(mvj, jnp.asarray(b), M=Mj if precond else None, **kw)
    (ot, rect) = tlg.lgmres(mvt, torch.tensor(b), M=Mt if precond else None, **kw)
    assert bool(oj.converged) and ot.converged
    assert int(oj.iters) == ot.iters
    assert int(recj.count) == rect.count
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), atol=1e-10)
    # a second, related solve reuses the returned recycle buffer
    b2 = b + 0.01 * np.random.default_rng(1).standard_normal(SHAPE)
    (oj2, _) = jlg.lgmres(mvj, jnp.asarray(b2), recycle=recj, **kw)
    (ot2, _) = tlg.lgmres(mvt, torch.tensor(b2), recycle=rect, **kw)
    assert int(oj2.iters) == ot2.iters
    np.testing.assert_allclose(ot2.x.numpy(), np.asarray(oj2.x), atol=1e-10)


@pytest.mark.parametrize("jvp_mode", ["fd", "exact"])
def test_newton_krylov_jvp_modes_match_jax(jvp_mode):
    """The JAX test's system ``tanh(x) + 0.3 roll(x) - 0.1 = 0`` through
    both functional solvers, FD and exact JVPs."""
    def fj(x):
        return jnp.tanh(x) + 0.3 * jnp.roll(x, 1) - 0.1

    def ft(x):
        return torch.tanh(x) + 0.3 * torch.roll(x, 1) - 0.1

    oj = j_nk(fj, jnp.zeros(50), f_tol=1e-11, jvp_mode=jvp_mode)
    ot = t_nk(ft, torch.zeros(50, dtype=torch.float64), f_tol=1e-11,
              jvp_mode=jvp_mode)
    assert bool(oj.converged) and ot.converged
    assert int(oj.iters) == ot.iters
    assert int(oj.func_evals) == ot.func_evals
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), atol=1e-10)
    assert float(ft(ot.x).abs().max()) <= 1e-10


def test_newton_krylov_rejects_unknown_jvp_mode():
    with pytest.raises(ValueError, match="jvp_mode"):
        t_nk(torch.sin, torch.zeros(4, dtype=torch.float64), jvp_mode="ad")
