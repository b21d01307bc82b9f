"""Port parity: the backoff stepper of ``solvers/adaptive.py``, on CPU.

The four cases of ``tests/test_utils_adaptive.py`` go through the JAX
functions and the port's with the same step function: ``attempts``, ``ok``,
``dt_used`` and ``dt_next`` are equal (the same f64 products of the same
factors), and so are the states.  Plus the loop's edges: a dt already at
``dt_min`` makes no attempt, and an f32 state backs off in f32.
"""
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.solvers.adaptive import (
    check_finite, evolve_with_backoff, step_with_backoff,
)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.solvers import adaptive as ja

    return types.SimpleNamespace(jnp=jnp, ja=ja)


def _same(out, jout):
    assert out.attempts == int(jout.attempts)
    assert out.ok == bool(jout.ok)
    assert out.dt_used == float(jout.dt_used)
    assert out.dt_next == float(jout.dt_next)
    np.testing.assert_array_equal(out.u.numpy(), np.asarray(jout.u))


CASES = {
    # converges at once: one attempt, dt grows by 1.5
    "accepts": (lambda xp: lambda u, dt: (u + dt, True), {}),
    # converges only at dt <= 0.03: two halvings from 0.1
    "halves": (lambda xp: lambda u, dt: (u + dt, dt <= 0.03), {}),
    # NaN at every dt: all retries rejected, the old state kept
    "rejects_nan": (lambda xp: lambda u, dt: (u + float("nan") * dt, True),
                    {"max_retries": 3}),
    # never converges: stops at the retry cap
    "cap": (lambda xp: lambda u, dt: (u + dt, False), {"max_retries": 4}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_with_backoff_matches_jax(jx, case):
    make, kw = CASES[case]
    out = step_with_backoff(make(torch), torch.zeros(3, dtype=torch.float64), 0.1,
                            device="cpu", **kw)
    jout = jx.ja.step_with_backoff(make(jx.jnp), jx.jnp.zeros(3), 0.1, **kw)
    _same(out, jout)
    assert bool(check_finite(out.u))
    if case == "halves":
        assert out.attempts == 3 and out.dt_used == pytest.approx(0.025)


def test_evolve_with_backoff_matches_jax(jx):
    def step(u, dt):
        return u + dt, dt <= 0.5

    u, dt, (dts, attempts, oks) = evolve_with_backoff(
        step, torch.zeros(2, dtype=torch.float64), 0.1, nsteps=5, device="cpu")
    ju, jdt, (jdts, jatt, joks) = jx.ja.evolve_with_backoff(
        step, jx.jnp.zeros(2), 0.1, nsteps=5)
    assert all(isinstance(a, np.ndarray) for a in (dts, attempts, oks))
    np.testing.assert_array_equal(dts, np.asarray(jdts))
    np.testing.assert_array_equal(attempts, np.asarray(jatt))
    np.testing.assert_array_equal(oks, np.asarray(joks))
    assert dt == float(jdt) and bool(np.all(oks))
    assert dt <= 0.5 * 1.5 + 1e-9
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


def test_no_attempt_below_dt_min(jx):
    """dt <= dt_min: the loop's condition fails before the first attempt."""
    step = lambda u, dt: (u + dt, True)  # noqa: E731
    out = step_with_backoff(step, torch.ones(2, dtype=torch.float64), 1e-3,
                            dt_min=1e-3, device="cpu")
    jout = jx.ja.step_with_backoff(step, jx.jnp.ones(2), 1e-3, dt_min=1e-3)
    _same(out, jout)
    assert out.attempts == 0 and not out.ok


def test_f32_state_backs_off_in_f32():
    out = step_with_backoff(lambda u, dt: (u + dt, dt <= 0.03),
                            torch.zeros(3, dtype=torch.float32), 0.1, device="cpu")
    assert out.dt_used.dtype == np.float32
    assert out.dt_used == np.float32(0.1) * np.float32(0.5) * np.float32(0.5)


def test_backoff_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        step_with_backoff(lambda u, dt: (u, True), torch.zeros(2), 0.1)
