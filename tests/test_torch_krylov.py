"""Port parity: the LGMRES cycle and NewtonKrylov against the JAX package
on small seeded systems, f64 on CPU.  Same algorithm and same decisions,
so iteration counts are equal and solutions agree to 1e-10."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.solvers.newton import NewtonKrylov as JNK
from iterative_solvers_tpu_torch.solvers import lgmres as tlg
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov as TNK

# the JAX package's solvers/__init__ re-exports the lgmres function under
# the module's name
jlg = importlib.import_module("iterative_solvers_tpu.solvers.lgmres")

SHAPE = (6, 8)
N = SHAPE[0] * SHAPE[1]


def _system(seed=2):
    rng = np.random.default_rng(seed)
    A = 4.0 * np.eye(N) + rng.standard_normal((N, N)) / np.sqrt(N)
    b = rng.standard_normal(N)
    return A, b


def _mv_j(A):
    Aj = jnp.asarray(A)
    return lambda v: (Aj @ v.reshape(-1)).reshape(v.shape)


def _mv_t(A):
    At = torch.tensor(A)
    return lambda v: (At @ v.reshape(-1)).reshape(v.shape)


def test_lgmres_cycles_with_recycling_match_jax():
    A, b = _system()
    b = b.reshape(SHAPE)
    inner_m, outer_k, tol = 3, 3, 1e-12
    mvj, mvt = _mv_j(A), _mv_t(A)
    ident = lambda v: v  # noqa: E731
    xj, xt = jnp.zeros(SHAPE), torch.zeros(SHAPE, dtype=torch.float64)
    recj = jlg.init_recycle(SHAPE, outer_k, jnp.float64)
    rect = tlg.init_recycle(SHAPE, outer_k, torch.float64)
    for cycle in range(4):  # fills and then rolls the recycle buffer
        rj = jnp.asarray(b) - mvj(xj)
        rt = torch.tensor(b) - mvt(xt)
        xj, resj, jj, recj = jlg._lgmres_cycle(
            mvj, ident, xj, rj, jnp.linalg.norm(rj), tol, inner_m, recj, False)
        xt, rest, jt, rect = tlg._lgmres_cycle(
            mvt, ident, xt, rt, torch.linalg.norm(rt).item(), tol, inner_m,
            rect)
        assert int(jj) == jt, f"cycle {cycle}"
        assert int(recj.count) == rect.count
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10)
        np.testing.assert_allclose(rest, float(resj), rtol=1e-6, atol=1e-13)
        # a recycled direction is dx/||dx||: its rounding grows like
        # eps |x| / |dx| as the cycles converge (dx ~ 1e-7 by cycle 4)
        np.testing.assert_allclose(rect.z.numpy(), np.asarray(recj.z),
                                   atol=1e-9)
    assert rect.count == outer_k


CASES = {
    "fd": dict(),
    "restarts": dict(inner_m=4, outer_k=2, inner_maxiter=3),
    "no_line_search": dict(line_search=False),
    "analytic": dict(analytic=True),
    "preconditioned": dict(jacobi=True),
}


def _factories(A, ops, analytic, jacobi):
    """matvec/psolve factories for F(x) = A x + x^3/2 - b in one
    framework's ops (jnp or torch): the analytic Jacobian
    ``A v + 1.5 x^2 v`` and the Jacobi (diagonal) preconditioner of it."""
    mv, asarray = ops
    d = asarray(np.diag(A)).reshape(SHAPE)
    out = {}
    if analytic:
        out["matvec_factory"] = lambda x, fx: (lambda v: mv(v) + 1.5 * x ** 2 * v)
    if jacobi:
        out["psolve_factory"] = lambda x, fx: (lambda v: v / (d + 1.5 * x ** 2))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_newton_krylov_matches_jax(case):
    A, b = _system(seed=4)
    opts = dict(CASES[case])
    flags = opts.pop("analytic", False), opts.pop("jacobi", False)
    opts.setdefault("inner_m", 10)
    opts.setdefault("outer_k", 3)
    jops, tops = (_mv_j(A), jnp.asarray), (_mv_t(A), torch.tensor)

    def res_j(x):
        return jops[0](x) + 0.5 * x ** 3 - jnp.asarray(b).reshape(SHAPE)

    def res_t(x):
        return tops[0](x) + 0.5 * x ** 3 - torch.tensor(b).reshape(SHAPE)

    jsolver = JNK(f_tol=1e-10, **opts, **_factories(A, jops, *flags))
    tsolver = TNK(f_tol=1e-10, **opts, **_factories(A, tops, *flags))
    x0 = np.full(SHAPE, 0.1)
    oj = jsolver.solve(res_j, jnp.asarray(x0))
    ot = tsolver.solve(res_t, torch.tensor(x0))
    assert bool(oj.converged) and ot.converged
    assert int(oj.iters) == ot.iters
    assert int(oj.func_evals) == ot.func_evals
    np.testing.assert_allclose(ot.x.numpy(), np.asarray(oj.x), atol=1e-10)
    assert ot.f_norm <= 1e-10
