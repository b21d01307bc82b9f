"""Port parity: the explicit-halo distributed droplet operators
(``iterative_solvers_tpu_torch/dist/droplet.py``) against the JAX
package's ``dist.droplet.make_sharded_ops`` on a JAX ``Mesh`` of the same
shape, f64 on the CPU, at the JAX tests' tolerances (operators rtol 1e-7 /
atol 1e-12, steps rtol 1e-8 / atol 1e-11).

Worlds of gloo ranks (``tests/torch_dist_world.py``): 4 ranks as rows
(mesh ``("y",)`` of 4, a 128 x 48 grid: 32-row blocks, the least the
depth-12 chains take), 2 x 2 blocks (``x_axis_name="x"``, 64 x 64: 32 x 32
blocks), and 1 rank (against the single-device JAX step).

- the CN residual, ``pde_rhs`` and the smoothed monitor with its
  Mackenzie all-reduce;
- the spectral ``pma_dqdt`` (all-gather, whole-grid solve, keep the block);
- the full step with FD Newton, with the production f32 JVP (the lifted
  JVP: tangent halos exchanged, ``torch.func.jvp`` of the local chain),
  and with the Chebyshev PMA solve; rows-only and 2-D.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.dist import halo as th
from iterative_solvers_tpu_torch.dist import mesh as tm
from iterative_solvers_tpu_torch.dist.droplet import make_sharded_ops
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.ops import curvilinear as tcv
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov as TNK
from tests.torch_dist_world import World

CASES = {
    # name: (grid (ny, nx), mesh shape, axis names, x_axis_name)
    "rows4": ((128, 48), (4,), ("y",), None),
    "2x2": ((64, 64), (2, 2), ("y", "x"), "x"),
    "one": ((128, 48), (1,), ("y",), None),
}
SOLVER = dict(f_tol=1e-9, maxiter=6, inner_m=10, outer_k=5)
DT, DTMESH, LOOPS = 1e-6, 1e-9, 3


def _cfg(ny, nx):
    return dataclasses.replace(tdp.DropletConfig(), nx=nx, ny=ny, epsilon=0.05, a=10.0)


def _state(cfg):
    """The JAX tests' smooth deviation potential and seeded solution."""
    grid = cfg.grid
    xn = (grid.xx - grid.xl) / (grid.xr - grid.xl)
    yn = (grid.yy - grid.yb) / (grid.yt - grid.yb)
    phi = 0.02 * np.sin(2 * np.pi * xn) * np.cos(np.pi * yn)
    geom = tcv.mesh_geometry_dev(torch.tensor(phi), grid)
    u = tdp.seeded_solution(geom, cfg, [(1.0, 0.0, 1.0, 0.8)])
    return phi, u.numpy()


def _ops(case, **kw):
    (ny, nx), shape, names, x_axis = CASES[case]
    mesh = tm.make_mesh(shape, names, device="cpu")
    return mesh, make_sharded_ops(_cfg(ny, nx), mesh, x_axis_name=x_axis, **kw)


def _gather(ops, block):
    names = tuple(a for a in ops.sharding.spec if a is not None)
    return th.gather_field(block, ops.sharding.mesh, names).numpy()


def _blocks(ops, *fields):
    idx = ops.sharding.index(fields[0].shape)
    return [torch.tensor(f[idx]).contiguous() for f in fields]


# -- tasks -------------------------------------------------------------------------

def _t_operators(case, u, u_eval, F, phi, dt):
    _, ops = _ops(case)
    ub, uevb, Fb, pb = _blocks(ops, u, u_eval, F, phi)
    return {"residual": _gather(ops, ops.residual(uevb, ub, Fb, pb, dt)),
            "pde_rhs": _gather(ops, ops.pde_rhs(ub, pb)),
            "monitor": _gather(ops, ops.monitor(ub, pb)[0]),
            "dqdt": _gather(ops, ops.pma_dqdt(pb, ub))}


def _t_step(case, u, phi, pma_solver, jvp_dtype):
    solver = TNK(**SOLVER, inner_dtype=jvp_dtype)
    _, ops = _ops(case, solver=solver, pma_solver=pma_solver, jvp_dtype=jvp_dtype)
    ub, pb = _blocks(ops, u, phi)
    out = ops.step(ub, pb, DT, DTMESH, LOOPS)
    return (_gather(ops, out.u), _gather(ops, out.q), out.newton_iters,
            out.converged)


# -- fixtures ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world4"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    w = World(1, tmp_path_factory.mktemp("world1"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from iterative_solvers_tpu.dist.droplet import make_sharded_ops as jops
    from iterative_solvers_tpu.models import droplet as jdp
    from iterative_solvers_tpu.ops import curvilinear as jcv
    from iterative_solvers_tpu.solvers.newton import NewtonKrylov

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")

    def cfg(case):
        (ny, nx) = CASES[case][0]
        return dataclasses.replace(jdp.DropletConfig(), nx=nx, ny=ny,
                                   epsilon=0.05, a=10.0)

    def ops(case, **kw):
        _, shape, names, x_axis = CASES[case]
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axis_names=names)
        return jops(cfg(case), mesh, x_axis_name=x_axis, **kw)

    return types.SimpleNamespace(jax=jax, jnp=jnp, dp=jdp, cv=jcv, NK=NewtonKrylov,
                                 cfg=cfg, ops=ops)


def _inputs(jx, case):
    """Port-made state, and the residual's inputs from the JAX
    single-device functions (as the JAX tests build them)."""
    (ny, nx) = CASES[case][0]
    phi, u = _state(_cfg(ny, nx))
    cfg = jx.cfg(case)
    geom = jx.cv.mesh_geometry_dev(jx.jnp.asarray(phi), cfg.grid)
    F = np.asarray(jx.dp.pde_rhs(jx.jnp.asarray(u), geom, cfg))
    u_eval = u * (1.0 + 1e-3 * np.cos(cfg.grid.yy))
    return u, u_eval, F, phi


def _put(jx, ops, *fields):
    return [jx.jax.device_put(jx.jnp.asarray(f), ops.sharding) for f in fields]


@pytest.mark.parametrize("case", ["rows4", "2x2"])
def test_sharded_operators_match_jax(world4, jx, case):
    u, u_eval, F, phi = _inputs(jx, case)
    jops = jx.ops(case, pma_solver="spectral")
    ju, juev, jF, jphi = _put(jx, jops, u, u_eval, F, phi)
    want = {"residual": jx.jax.jit(jops.residual)(juev, ju, jF, jphi, DT),
            "pde_rhs": jx.jax.jit(jops.pde_rhs)(ju, jphi),
            "monitor": jx.jax.jit(lambda a, b: jops.monitor(a, b)[0])(ju, jphi),
            "dqdt": jx.jax.jit(jops.pma_dqdt)(jphi, ju)}
    for got in world4.run(_t_operators, case, u, u_eval, F, phi, DT):
        for k, w in want.items():
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-7, atol=1e-12,
                                       err_msg=k)


@pytest.fixture(scope="module")
def jax_steps(jx):
    """The JAX sharded steps the port's are held against, cached."""
    cache = {}

    def get(case, pma_solver="spectral", jvp_dtype=None):
        key = (case, pma_solver, jvp_dtype)
        if key not in cache:
            u, _, _, phi = _inputs(jx, case)
            solver = jx.NK(**SOLVER, inner_dtype=jvp_dtype)
            if case == "one":
                step = jx.dp.make_step(jx.cfg(case), dt=DT, dtmesh=DTMESH,
                                       pma_loops=LOOPS, solver=solver,
                                       deviation_form=True, jvp_dtype=jvp_dtype)
                out = step(jx.jnp.asarray(u), jx.jnp.asarray(phi), DT)
            else:
                ops = jx.ops(case, solver=solver, pma_solver=pma_solver,
                             jvp_dtype=jvp_dtype)
                ju, jphi = _put(jx, ops, u, phi)
                out = jx.jax.jit(lambda a, b: ops.step(a, b, DT, DTMESH, LOOPS))(ju, jphi)
            cache[key] = (u, phi, np.asarray(out.u), np.asarray(out.q),
                          int(out.newton_iters), bool(out.converged))
        return cache[key]

    return get


@pytest.mark.parametrize("case,pma_solver,jvp_dtype", [
    ("rows4", "spectral", None),
    ("rows4", "spectral", "float32"),
    ("rows4", "chebyshev", None),
    ("2x2", "spectral", None),
    ("one", "spectral", "float32"),
])
def test_sharded_step_matches_jax(world4, world1, jax_steps, case, pma_solver, jvp_dtype):
    """The full step: FD Newton, the production f32 JVP, the Chebyshev PMA;
    rows-only, 2-D and one rank (against the single-device JAX step)."""
    u, phi, want_u, want_q, want_iters, want_conv = jax_steps(case, pma_solver, jvp_dtype)
    world = world1 if case == "one" else world4
    for got_u, got_q, iters, conv in world.run(_t_step, case, u, phi, pma_solver, jvp_dtype):
        assert conv and want_conv
        assert iters == want_iters
        np.testing.assert_allclose(got_u, want_u, rtol=1e-8, atol=1e-11)
        np.testing.assert_allclose(got_q, want_q, rtol=1e-8, atol=1e-11)
