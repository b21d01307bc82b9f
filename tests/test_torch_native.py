"""The port's native API (``iterative_solvers_tpu_torch/native``) on the CPU.

Each entry point against scipy, as ``tests/test_native.py`` holds the JAX
package's C++ library, and against that library where ``cmake`` can build
it (skipped otherwise):

- ``spmv_csr`` against scipy's product, 1e-13;
- ``lgmres_csr`` against ``scipy.sparse.linalg.lgmres`` (1e-6) and the
  true residual (1e-8); its outer cycles and matvecs are reported beside
  the library's, which counts them its own way, and not gated;
- ``nonlin_solve`` on a numpy residual against ``scipy.optimize.newton_krylov``
  (1e-6) and the library (1e-10: the same Newton–Krylov arithmetic);
- ``sh_evolve`` against the scipy-driven CN/NK trajectory (2e-5, the
  library's gate) and the library (1e-9), 3 converged steps in each;
- ``sh_operator_nnz`` against the JAX ``ops.sparse.sh_operator``'s nnz;
- ``python -m iterative_solvers_tpu_torch.native 32 40 0.2 1.0 0.01 1.0
  <out> device=cpu`` prints ``converged=5`` and writes 1024 finite values.

The ``gpu``-marked test runs ``sh_evolve`` on the card (the ``sh_operator``
kernel in f64) against the CPU:
``python -m pytest --noconftest -m gpu tests/test_torch_native.py``.
"""
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import newton_krylov as scipy_nk
from scipy.sparse.linalg import lgmres as scipy_lgmres

from iterative_solvers_tpu_torch import native
from iterative_solvers_tpu_torch.ops import periodic_stencil as ps
from iterative_solvers_tpu_torch.ops._build import launch_count

CPU = {"device": "cpu"}


def _rng():
    return np.random.default_rng(17)


def _tridiag(n):
    return sp.diags([np.full(n, 4.0), np.full(n - 1, -1.0), np.full(n - 1, -2.0)],
                    [0, 1, -1]).tocsr()


def _residual(x):
    return np.tanh(x) + 0.4 * np.roll(x, 3) ** 2 - 0.2


@pytest.fixture(scope="module")
def clib():
    """The JAX package's C++ library, or a skip where cmake is absent."""
    if shutil.which("cmake") is None:
        pytest.skip("cmake unavailable")
    from iterative_solvers_tpu import native as jn

    jn.ensure_built()
    return jn


def test_spmv_matches_scipy():
    m = sp.random(200, 200, density=0.1, random_state=np.random.RandomState(2),
                  format="csr")
    x = _rng().standard_normal(200)
    got = native.spmv_csr(m, x, **CPU)
    assert got.dtype == np.float64 and got.shape == (200,)
    np.testing.assert_allclose(got, m @ x, atol=1e-13)


def test_lgmres_matches_scipy_and_counts():
    n = 150
    a = _tridiag(n)
    b = _rng().standard_normal(n)
    x_sp, info = scipy_lgmres(a, b, rtol=1e-10, atol=0.0, inner_m=15, outer_k=3,
                              maxiter=200)
    assert info == 0
    x, st = native.lgmres_csr(a, b, tol=1e-10, inner_m=15, outer_k=3, maxiter=200, **CPU)
    assert st["converged"] and st["residual"] <= 1e-10 * np.linalg.norm(b)
    assert st["residual"] == pytest.approx(np.linalg.norm(b - a @ x), rel=1e-6)
    np.testing.assert_allclose(x, x_sp, atol=1e-6)
    np.testing.assert_allclose(a @ x, b, atol=1e-8)
    assert st["outer_cycles"] >= 1 and st["matvecs"] > st["outer_cycles"]


def test_lgmres_maxiter_counts_cycles():
    """``maxiter`` bounds the outer cycles; an unconverged solve says so."""
    a = _tridiag(120)
    b = _rng().standard_normal(120)
    x, st = native.lgmres_csr(a, b, tol=1e-14, inner_m=4, outer_k=2, maxiter=3, **CPU)
    assert st["outer_cycles"] == 3 and not st["converged"]
    assert st["residual"] > 1e-14 * np.linalg.norm(b)
    x0 = np.linalg.solve(a.toarray(), b)
    x, st = native.lgmres_csr(a, b, x0, tol=1e-10, **CPU)
    assert st["converged"] and st["outer_cycles"] == 0


def test_lgmres_matches_native_library(clib):
    n = 150
    a = _tridiag(n)
    b = _rng().standard_normal(n)
    kw = dict(tol=1e-10, inner_m=15, outer_k=3, maxiter=200)
    x, st = native.lgmres_csr(a, b, **kw, **CPU)
    xc, stc = clib.lgmres_csr(a, b, **kw)
    assert st["converged"] and stc["converged"]
    np.testing.assert_allclose(x, xc, atol=1e-10)
    # the counts side by side (the library adds its final residual to its
    # matvecs); reported, not gated
    print({"port": st, "native_library": stc})


def test_nonlin_solve_matches_scipy():
    x_scipy = scipy_nk(_residual, np.zeros(40), f_tol=1e-10)
    x, info = native.nonlin_solve(_residual, np.zeros(40), f_tol=1e-10, **CPU)
    assert info["converged"] and info["f_norm"] <= 1e-10
    assert info["iterations"] >= 1 and info["func_evals"] > info["iterations"]
    np.testing.assert_allclose(x, x_scipy, atol=1e-6)
    np.testing.assert_allclose(_residual(x), 0, atol=1e-9)


def test_nonlin_solve_matches_native_library(clib):
    x, info = native.nonlin_solve(_residual, np.zeros(40), f_tol=1e-10, **CPU)
    xc, infoc = clib.nonlin_solve(_residual, np.zeros(40), f_tol=1e-10)
    assert info["converged"] and infoc["converged"]
    assert info["iterations"] == infoc["iterations"]
    np.testing.assert_allclose(x, xc, atol=1e-10)


def test_nonlin_solve_stops_at_maxiter():
    x, info = native.nonlin_solve(_residual, np.zeros(40), f_tol=1e-14, maxiter=1, **CPU)
    assert info["iterations"] == 1 and not info["converged"] and info["f_norm"] > 1e-14


def _scipy_sh(u0, n, d, k, r, g, nsteps):
    from tests.reference_oracles import sh_L

    L = sh_L(n, d / n, r)
    u = u0.copy()
    for _ in range(nsteps):
        uo = u.copy()
        uo2, uo3 = uo * uo, uo ** 3

        def residual(v):
            vv = v * v
            return (v - uo) / k - (L @ v + g * vv - v * vv + L @ uo + g * uo2 - uo3) / 2

        u = scipy_nk(residual, uo, f_tol=6e-6)
    return u


def test_sh_evolve_matches_scipy_trajectory():
    n, d, k, r, g = 24, 40.0, 0.2, 0.01, 1.0
    u0 = _rng().standard_normal(n * n)
    u, converged = native.sh_evolve(u0, 3, n=n, d=d, k=k, r=r, g=g, **CPU)
    assert converged == 3 and u.shape == (n * n,)
    np.testing.assert_allclose(u, _scipy_sh(u0, n, d, k, r, g, 3), atol=2e-5)


def test_sh_evolve_matches_native_library(clib):
    n = 24
    u0 = _rng().standard_normal(n * n)
    u, converged = native.sh_evolve(u0, 3, n=n, **CPU)
    uc, convc = clib.sh_evolve(u0, 3, n=n)
    assert converged == convc == 3
    np.testing.assert_allclose(u, uc, atol=1e-9)


@pytest.mark.parametrize("n, d, r", [(16, 40.0, 0.01), (24, 30.0, 0.2), (7, 40.0, 0.5)])
def test_sh_operator_nnz_matches_jax(n, d, r):
    pytest.importorskip("jax")
    from iterative_solvers_tpu.ops.sparse import sh_operator

    assert native.sh_operator_nnz(n, d, r) == sh_operator(n, d / n, r).nnz


def test_sh_driver_module(tmp_path):
    out = tmp_path / "out.txt"
    res = subprocess.run(
        [sys.executable, "-m", "iterative_solvers_tpu_torch.native",
         "32", "40", "0.2", "1.0", "0.01", "1.0", str(out), "device=cpu"],
        capture_output=True, text=True, check=True, timeout=120)
    assert "steps=5 converged=5 func_evals=" in res.stdout
    data = np.loadtxt(out)
    assert data.shape == (32 * 32,) and np.isfinite(data).all()


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _tridiag(8)
    for call in (lambda: native.spmv_csr(a, np.ones(8)),
                 lambda: native.lgmres_csr(a, np.ones(8)),
                 lambda: native.nonlin_solve(_residual, np.zeros(8)),
                 lambda: native.sh_evolve(np.zeros(64), 1, n=8),
                 native.ensure_built):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sh_operator kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_sh_evolve_on_card_matches_cpu(cuda):
    """``sh_evolve`` at n = 64 on the card, where every residual is the
    ``sh_operator`` kernel in f64, against the CPU run: the same converged
    count, u within 1e-8 (two JFNK solves to f_tol 6e-6 of one problem
    whose operators agree to f64 rounding), and the kernel launched."""
    assert native.ensure_built().exists()
    u0 = np.random.default_rng(0).standard_normal(64 * 64)
    before = launch_count("sh_operator", dtype="f64")
    ug, cg = native.sh_evolve(u0, 3, device=cuda)
    launched = launch_count("sh_operator", dtype="f64") - before
    uc, cc = native.sh_evolve(u0, 3, **CPU)
    assert cg == cc == 3 and launched > 0
    np.testing.assert_allclose(ug, uc, atol=1e-8)
