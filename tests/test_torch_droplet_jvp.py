"""Port parity: the droplet JVP matvec (plain version, CPU wrapper, CUDA
kernel) against the JAX package.

Built on ``golden_droplet_step.npz`` (the 91x61 coalescence state) and on a
128x64 perturbed mesh.  f32 throughout, compared at 2e-5 of max|J v| —
the gate of test_pallas_droplet: the linearisation is exact, and what
differs is f32 rounding through ~25 stencil passes.

The JAX side is imported inside the ``jx`` fixture, so the card-only test
at the end also runs on a machine that has the port and no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_droplet_jvp.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.io import convert, fixtures as tfx
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.ops import curvilinear as tcv
from iterative_solvers_tpu_torch.ops.droplet_jvp import jvp_apply_ref, jvp_matvec

DT = 1e-5
TOL = 2e-5


def _golden_case():
    fix, _ = tfx.load_golden_step()
    return tfx.config_for(fix), fix.q, fix.u


def _perturbed_case():
    cfg = dataclasses.replace(_golden_case()[0], nx=128, ny=64)
    g = cfg.grid
    q = 0.5 * (g.xx ** 2 + g.yy ** 2) + 0.05 * np.sin(g.xx) * np.cos(g.yy)
    x = cfg.epsilon + np.exp(-(g.xx ** 2 + g.yy ** 2))
    return cfg, q, x


CASES = {"golden_91x61": _golden_case, "perturbed_128x64": _perturbed_case}


def _v(shape):
    return np.random.default_rng(7).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.models import droplet as jdp
    from iterative_solvers_tpu.ops import curvilinear as jcv
    from iterative_solvers_tpu.ops.pallas_droplet import jvp_apply_ref as j_ref

    def build(case):
        """JAX-side config, f32 geometry, iterate and coefficient stack."""
        tcfg, q, x = CASES[case]()
        jcfg = jdp.DropletConfig(**dataclasses.asdict(tcfg))
        geom = jcv.mesh_geometry(jnp.asarray(q), jcfg.grid)
        geom32 = jcv.MeshGeometry(*(a.astype(jnp.float32) for a in geom))
        x32 = jnp.asarray(x, jnp.float32)
        stack = jdp.jvp_field_stack(x32, geom32, jcfg, jnp.float32(DT))
        return jcfg, geom32, x32, stack

    def jvp(jcfg, geom32, x32, v):
        """jax.jvp of the f32 CN residual at x32 (F = 0, u_old = x32)."""
        res = lambda w: jdp.cn_residual(  # noqa: E731
            w, u_old=x32, F=jnp.zeros_like(x32), dt=jnp.float32(DT),
            geom=geom32, cfg=jcfg)
        return jax.jvp(res, (x32,), (jnp.asarray(v),))[1]

    return types.SimpleNamespace(build=build, jvp=jvp, j_ref=j_ref, jnp=jnp)


@pytest.mark.parametrize("case", list(CASES))
def test_field_stack_matches_jax(jx, case):
    tcfg, q, x = CASES[case]()
    _, _, _, jstack = jx.build(case)
    tgeom = tcv.mesh_geometry(torch.tensor(q), tcfg.grid)
    tgeom32 = tcv.MeshGeometry(*(a.float() for a in tgeom))
    tstack = tdp.jvp_field_stack(torch.tensor(x, dtype=torch.float32), tgeom32,
                                 tcfg, torch.tensor(DT, dtype=torch.float32))
    for k in range(8):
        _close(tstack[k].numpy(), jstack[k], tol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_ref_matches_jax_ref_and_jvp(jx, case):
    tcfg, _, x = CASES[case]()
    jcfg, geom32, x32, jstack = jx.build(case)
    v = _v(x.shape)
    stack = convert.stack_from_numpy(jstack, "cpu")
    got = jvp_apply_ref(torch.tensor(v), stack, tcfg.grid).numpy()
    _close(got, jx.j_ref(jx.jnp.asarray(v), jstack, jcfg.grid))
    _close(got, jx.jvp(jcfg, geom32, x32, v))


def test_torch_func_jvp_matches_jax_jvp(jx):
    """The non-kernel f32 path of make_step: torch.func.jvp of the port's
    residual against jax.jvp of the JAX residual."""
    tcfg, _, x = CASES["golden_91x61"]()
    jcfg, geom32, x32, _ = jx.build("golden_91x61")
    v = _v(x.shape)
    tgeom = tcv.MeshGeometry(*(torch.tensor(np.asarray(a)) for a in geom32))
    tx = torch.tensor(np.asarray(x32))

    def tres(w):
        return tdp.cn_residual(w, u_old=tx, F=torch.zeros_like(tx),
                               dt=torch.tensor(DT, dtype=torch.float32),
                               geom=tgeom, cfg=tcfg)
    got = torch.func.jvp(tres, (tx,), (torch.tensor(v),))[1].numpy()
    _close(got, jx.jvp(jcfg, geom32, x32, v))


def _port_stack(case, device):
    """The port's own f32 coefficient stack for ``case`` on ``device``."""
    cfg, q, x = CASES[case]()
    geom = tcv.mesh_geometry(torch.tensor(q, device=device), cfg.grid)
    geom32 = tcv.MeshGeometry(*(a.float() for a in geom))
    stack = tdp.jvp_field_stack(
        torch.tensor(x, dtype=torch.float32, device=device), geom32, cfg,
        torch.tensor(DT, dtype=torch.float32, device=device))
    return cfg, stack, torch.tensor(_v(x.shape), device=device)


def test_wrapper_takes_plain_version_on_cpu():
    cfg, stack, v = _port_stack("perturbed_128x64", "cpu")
    before = jvp_matvec.launches
    got = jvp_matvec(v, stack, cfg.grid)
    assert jvp_matvec.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  jvp_apply_ref(v, stack, cfg.grid).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_matches_plain(case):
    """The CUDA kernel against the plain version on the card, at 1e-5 of
    max|plain| (the two contract their sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the droplet_jvp kernel has no CPU mode")
    cfg, stack, v = _port_stack(case, "cuda")
    before = jvp_matvec.launches
    got = jvp_matvec(v, stack, cfg.grid)
    torch.cuda.synchronize()
    assert jvp_matvec.launches == before + 1
    _close(got.cpu().numpy(), jvp_apply_ref(v, stack, cfg.grid).cpu().numpy(),
           tol=1e-5)
