"""Port parity: the Swift–Hohenberg model against the JAX package and the
scipy reference, f64 on CPU at n = 24.

- the CN step with the default FD solver: within 1e-8 of JAX with an equal
  Newton count, and within 1e-6 of ``scipy.optimize.newton_krylov`` on the
  assembled operator (the gate of test_newton_sh);
- the ``fast_solver`` step (analytic f32 Jacobian, f32 inner Krylov):
  within 2e-6 of JAX, Newton counts within 1 (f32 rounding may move one
  iteration across f_tol);
- ``evolve_cn`` over 5 steps within 1e-6 of JAX;
- ``semi_implicit_step`` within 1e-8 of JAX and of ``spsolve``;
- the exact-JVP solver through the SH residual (plain stencils on CPU).

The ``gpu``-marked test runs the step on the card through the
``sh_operator`` kernel and holds it against the CPU step:
``python -m pytest --noconftest -m gpu tests/test_torch_sh.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.io import convert
from iterative_solvers_tpu_torch.models import swift_hohenberg as tsh
from iterative_solvers_tpu_torch.ops import periodic_stencil as ps
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov as TNK

N = 24


def _cfg(**kw):
    return tsh.SHConfig(d=40.0, n=N, k=0.2, **kw)


def _u0(seed=11):
    return np.random.default_rng(seed).standard_normal((N, N))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.models import swift_hohenberg as jsh
    from tests.reference_oracles import sh_L

    def jcfg(cfg):
        return jsh.SHConfig(**dataclasses.asdict(cfg))

    return types.SimpleNamespace(sh=jsh, jnp=jnp, cfg=jcfg, sh_L=sh_L)


def _scipy_step(U, cfg, L_sp):
    """One reference CN/NK step (sh_scipy_nk.py:53-61) via scipy."""
    from scipy.optimize import newton_krylov

    Uo = U.copy()
    UoUo = Uo * Uo

    def residual(u):
        uu = u * u
        return (u - Uo) / cfg.k - (L_sp @ u + cfg.g * uu - u * uu
                                   + L_sp @ Uo + cfg.g * UoUo - Uo * UoUo) / 2

    return newton_krylov(residual, Uo, f_tol=6e-6)


def test_cn_step_matches_jax_and_scipy(jx):
    cfg, u0 = _cfg(), _u0()
    u_t, res_t = tsh.make_cn_step(cfg, device="cpu")(torch.tensor(u0))
    u_j, res_j = jx.sh.make_cn_step(jx.cfg(cfg))(jx.jnp.asarray(u0))
    assert res_t.converged and bool(res_j.converged)
    assert res_t.iters == int(res_j.iters)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-8)
    want = _scipy_step(u0.reshape(-1), cfg, jx.sh_L(N, cfg.h, cfg.r))
    np.testing.assert_allclose(u_t.numpy().reshape(-1), want, rtol=0, atol=1e-6)


def test_fast_solver_step_matches_jax(jx):
    cfg, u0 = _cfg(), _u0()
    jcfg = jx.cfg(cfg)
    u_t, res_t = tsh.make_cn_step(cfg, tsh.fast_solver(cfg), device="cpu")(
        torch.tensor(u0))
    u_j, res_j = jx.sh.make_cn_step(jcfg, jx.sh.fast_solver(jcfg))(jx.jnp.asarray(u0))
    assert res_t.converged and bool(res_j.converged)
    assert abs(res_t.iters - int(res_j.iters)) <= 1
    assert u_t.dtype == torch.float64 and res_t.f_norm <= 6e-6
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=2e-6)


def test_evolve_cn_matches_jax(jx):
    cfg, u0 = _cfg(), _u0(seed=12)
    u_t, it_t, fn_t = tsh.evolve_cn(torch.tensor(u0), 5, cfg, device="cpu")
    u_j, it_j, fn_j = jx.sh.evolve_cn(jx.jnp.asarray(u0), 5, jx.cfg(cfg))
    assert it_t.shape == fn_t.shape == (5,)
    np.testing.assert_array_equal(it_t, np.asarray(it_j))
    assert np.all(fn_t <= 6.1e-6)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-6)


def test_semi_implicit_step_matches_jax_and_spsolve(jx):
    from scipy.sparse import diags, identity
    from scipy.sparse.linalg import spsolve

    # the reference's linearised variant runs at r = 0.2, g = 0
    cfg = _cfg(r=0.2, g=0.0)
    rng = np.random.default_rng(13)
    U = rng.standard_normal((N, N))
    Uo = U + 0.1 * rng.standard_normal((N, N))
    got, res = tsh.semi_implicit_step(torch.tensor(U), torch.tensor(Uo), cfg,
                                      tol=1e-12, device="cpu")
    want_j, res_j = jx.sh.semi_implicit_step(
        jx.jnp.asarray(U), jx.jnp.asarray(Uo), jx.cfg(cfg), tol=1e-12)
    assert res.converged and bool(res_j.converged)
    assert res.iters == int(res_j.iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j), rtol=0, atol=1e-8)

    L_sp = jx.sh_L(N, cfg.h, cfg.r)
    u, uo = U.reshape(-1), Uo.reshape(-1)
    eye = identity(N * N, format="csc")
    D = diags((5 * u - uo) ** 2 * cfg.k / 16 - cfg.g * cfg.k * u)
    want = spsolve((eye + D - L_sp * cfg.k / 2).tocsc(), (eye + L_sp * cfg.k / 2) @ u)
    np.testing.assert_allclose(got.numpy().reshape(-1), want, rtol=0, atol=1e-8)

    # evolve_semi_implicit: u_old lags one step behind
    two = tsh.evolve_semi_implicit(torch.tensor(U), 2, cfg, device="cpu", tol=1e-12)
    u1, _ = tsh.semi_implicit_step(torch.tensor(U), torch.tensor(U), cfg,
                                   tol=1e-12, device="cpu")
    u2, _ = tsh.semi_implicit_step(u1, torch.tensor(U), cfg, tol=1e-12, device="cpu")
    np.testing.assert_array_equal(two.numpy(), u2.numpy())


def test_exact_jvp_step_matches_fd_step(jx):
    """jvp_mode='exact' through the SH residual (plain stencils on CPU)
    against JAX's exact-JVP step."""
    cfg, u0 = _cfg(), _u0()
    u_t, res_t = tsh.make_cn_step(cfg, TNK(jvp_mode="exact"), device="cpu")(
        torch.tensor(u0))
    jsolver = jx.sh.NewtonKrylov(jvp_mode="exact")
    u_j, res_j = jx.sh.make_cn_step(jx.cfg(cfg), jsolver)(jx.jnp.asarray(u0))
    assert res_t.converged and res_t.iters == int(res_j.iters)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-8)


def test_sh_config_from_jax(jx):
    jcfg = jx.sh.SHConfig(d=80.0, n=128, k=0.1, r=0.3, g=0.5)
    cfg = convert.sh_config_from_jax(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.h == jcfg.h

    @dataclasses.dataclass
    class Wider:
        d: float = 40.0
        extra: int = 1

    with pytest.raises(ValueError, match="extra"):
        convert.sh_config_from_jax(Wider())
    u = convert.field_from_numpy(_u0(), "cpu", torch.float32)
    assert u.dtype == torch.float32 and u.shape == (N, N)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u0 = torch.tensor(_u0())
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.make_cn_step(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.evolve_cn(u0, 1, _cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.semi_implicit_step(u0, u0, _cfg())


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True], ids=["fd", "fast"])
def test_cuda_step_matches_cpu_step(fast):
    """The step on the card, through the sh_operator kernel in f64 (outer
    residuals) and, with fast_solver, f32 (inner Krylov), against the same
    step on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sh_operator kernel has no CPU mode")
    cfg, u0 = _cfg(), torch.tensor(_u0())
    solver = tsh.fast_solver(cfg) if fast else None
    u_c, res_c = tsh.make_cn_step(cfg, solver, device="cpu")(u0)
    ps.reset_launches()
    u_g, res_g = tsh.make_cn_step(cfg, solver)(u0)
    torch.cuda.synchronize()
    assert res_g.converged and abs(res_g.iters - res_c.iters) <= int(fast)
    assert ps.sh_operator_kernel.launches_by_dtype["f64"] > 0
    assert (ps.sh_operator_kernel.launches_by_dtype["f32"] > 0) == fast
    np.testing.assert_allclose(u_g.cpu().numpy(), u_c.numpy(), rtol=0,
                               atol=2e-6 if fast else 1e-8)
