"""Port parity: double-float (two-f32) arithmetic and the df64 droplet
residual.

- The error-free transforms are exact: ``float64(s) + float64(e)`` is the
  exact f64 sum or product of the f32 inputs.
- Primitives and stencils against f64 and against the JAX package's
  ``ops/df64.py``, at the gates of ``tests/test_df64.py`` (1e-13 relative
  for the primitives, 1e-10 of scale for the stencils).
- The df64 CN residual against the port's f64 residual and the JAX
  ``make_cn_residual_df`` on ``golden_droplet.npz``, 1e-10 absolute (the
  Newton f_tol of the workload is 1e-7), and the whole step with
  ``residual_mode="df64"`` against ``"f64"``: the same Newton count, u
  within 2e-8.

The JAX side is imported inside the ``jx`` fixture, so the card-only test
at the end also runs where the port is installed without JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_df64.py``.
"""
import pathlib
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.core.grid import Grid2D
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.ops import curvilinear as tcv, df64 as df
from iterative_solvers_tpu_torch.ops import stencils

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.core.grid import Grid2D as JGrid
    from iterative_solvers_tpu.models import droplet as jdp
    from iterative_solvers_tpu.ops import curvilinear as jcv, df64 as jdf

    return types.SimpleNamespace(jnp=jnp, JGrid=JGrid, jdp=jdp, jcv=jcv, jdf=jdf)


def _mixed(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3, n)


def test_error_free_transforms_are_exact():
    a = torch.tensor(_mixed(4000, 1), dtype=torch.float32)
    b = torch.tensor(_mixed(4000, 2), dtype=torch.float32)
    a64, b64 = a.double(), b.double()
    s, e = df._two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a64 + b64)
    p, e = df._two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a64 * b64)
    c = float(np.float32(1.0 / 3.0))
    p, e = df._two_prod(a, c)
    assert torch.equal(p.double() + e.double(), a64 * c)


def test_primitives_match_f64_and_jax(jx):
    a64 = torch.tensor(_mixed(1000, 7))
    b64 = torch.tensor(_mixed(1000, 8))
    a, b = df.from64(a64), df.from64(b64)
    ja, jb = jx.jdf.from64(jx.jnp.asarray(a64.numpy())), jx.jdf.from64(
        jx.jnp.asarray(b64.numpy()))
    s = a64.abs() + b64.abs()
    for name, got, want, jgot, den in [
        ("add", df.add(a, b), a64 + b64, jx.jdf.add(ja, jb), s),
        ("sub", df.sub(a, b), a64 - b64, jx.jdf.sub(ja, jb), s),
        ("mul", df.mul(a, b), a64 * b64, jx.jdf.mul(ja, jb), None),
        ("recip", df.recip(a), 1.0 / a64, jx.jdf.recip(ja), None),
        ("div", df.div(a, b), a64 / b64, jx.jdf.div(ja, jb), None),
        ("scale", df.scale(a, 1.0 / 3.0), a64 / 3.0, jx.jdf.scale(ja, 1.0 / 3.0), None),
        ("mul_pow2", df.mul_pow2(a, 0.5), a64 * 0.5, jx.jdf.mul_pow2(ja, 0.5), None),
        ("add_f", df.add_f(a, 0.1), a64 + float(np.float32(0.1)),
         jx.jdf.add_f(ja, np.float32(0.1)), a64.abs() + 0.1),
        ("sq", df.sq(a), a64 * a64, jx.jdf.sq(ja), None),
    ]:
        d = want.abs() if den is None else den
        rel = float(((df.to64(got) - want).abs() / d).max())
        assert rel < 1e-13, (name, rel)
        jrel = float(((df.to64(got) - torch.tensor(np.asarray(jx.jdf.to64(jgot))))
                      .abs() / d).max())
        assert jrel < 1e-13, (name, jrel)


def test_roundtrip_and_conversions():
    x = torch.tensor(np.random.default_rng(9).standard_normal(100))
    assert float((df.to64(df.from64(x)) - x).abs().max()) < 1e-14
    h = torch.ones(4, dtype=torch.float32)
    assert torch.equal(df.to64(df.from32(h)), h.double())
    hi, lo = df.const(0.1)
    assert abs((np.float64(hi) + np.float64(lo)) - 0.1) < 1e-16
    u = df.from64(torch.arange(12.0, dtype=torch.float64).reshape(3, 4))
    df.set_row(df.set_col(u, -1, 5.0), 0)
    assert torch.equal(df.to64(u), torch.tensor(
        [[0, 0, 0, 0], [4, 5, 6, 5], [8, 9, 10, 5]], dtype=torch.float64))


def test_stencils_match_f64():
    rng = np.random.default_rng(7)
    u64 = torch.tensor(rng.standard_normal((40, 56)))
    a64 = torch.tensor(1.0 + 0.1 * rng.standard_normal((40, 56)))
    for got, want in [
        (df.d1_x_df(df.from64(u64), 0.01), stencils.d1_x(u64, 0.01)),
        (df.d1_y_df(df.from64(u64), 0.02), stencils.d1_y(u64, 0.02)),
        (df.flux_div_x_df(df.from64(a64), df.from64(u64), 123.4),
         stencils.flux_div_x(a64, u64, 123.4)),
    ]:
        assert float((df.to64(got) - want).abs().max()) < 1e-10 * float(want.abs().max())


def _golden_state(device="cpu"):
    d = np.load(FIX / "golden_droplet.npz")
    shape = (int(d["ny"]), int(d["nx"]))
    cfg = tdp.DropletConfig(epsilon=float(d["epsilon"]), nx=shape[1], ny=shape[0])
    u = torch.tensor(d["u"].reshape(shape), device=device)
    q = torch.tensor(d["q"].reshape(shape), device=device)
    geom = tcv.mesh_geometry(q, cfg.grid)
    F = tdp.pde_rhs(u, geom, cfg)
    x = u * (1.0 + 1e-5 * torch.cos(0.13 * torch.arange(u.numel(), device=device,
                                                        dtype=u.dtype)).reshape(shape))
    return cfg, u, q, geom, F, x


def test_residual_df_matches_f64_and_jax(jx):
    cfg, u, q, geom, F, x = _golden_state()
    want = tdp.cn_residual(x, u, F, 1e-5, geom, cfg).numpy()
    got = tdp.make_cn_residual_df(u, F, geom, cfg)(x, 1e-5).numpy()
    assert np.abs(got - want).max() < 1e-10
    jcfg = jx.jdp.DropletConfig(epsilon=cfg.epsilon, nx=cfg.nx, ny=cfg.ny)
    jgeom = jx.jcv.mesh_geometry(jx.jnp.asarray(q.numpy()), jcfg.grid)
    ju = jx.jnp.asarray(u.numpy())
    jF = jx.jdp.pde_rhs(ju, jgeom, jcfg)
    jres = np.asarray(jx.jdp.make_cn_residual_df(ju, jF, jgeom, jcfg)(
        jx.jnp.asarray(x.numpy()), 1e-5))
    assert np.abs(got - jres).max() < 1e-10


def test_step_df64_matches_f64():
    """``residual_mode="df64"`` against ``"f64"`` on the golden state with the
    f32 inner Krylov: both converge with the same Newton count, the iterates
    within 2e-8 (the inexact-Newton stopping slack, far below f_tol)."""
    cfg, u, q, *_ = _golden_state()
    kw = dict(dt=1e-5, dtmesh=3e-9, pma_loops=5, jvp_dtype="float32", device="cpu")
    o64 = tdp.make_step(cfg, **kw)(u, q, 1e-5)
    odf = tdp.make_step(cfg, residual_mode="df64", **kw)(u, q, 1e-5)
    assert o64.converged and odf.converged
    assert o64.newton_iters == odf.newton_iters
    assert float((odf.u - o64.u).abs().max()) < 2e-8
    with pytest.raises(ValueError, match="residual_mode"):
        tdp.make_step(cfg, residual_mode="f32", **kw)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the df64 residual on the device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_residual_df_on_card_matches_f64(cuda):
    """On the card, where each f32 operation is its own launch as on the
    CPU: the df64 residual against the f64 residual, 1e-10 absolute."""
    cfg, u, q, geom, F, x = _golden_state(cuda)
    want = tdp.cn_residual(x, u, F, 1e-5, geom, cfg)
    got = tdp.make_cn_residual_df(u, F, geom, cfg)(x, 1e-5)
    assert got.device.type == "cuda" and got.dtype == torch.float64
    assert float((got - want).abs().max()) < 1e-10
