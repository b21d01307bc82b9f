"""Port parity: the sharded checkpoint pair (``io/checkpoint.save_sharded``
/ ``load_sharded``) in worlds of gloo ranks (``tests/torch_dist_world.py``),
and across the two packages.

- round trip on a 2 x 2 mesh: every rank gets its own block back
  bit-exactly, with step and time;
- restart continuity: the sharded droplet step, step -> save -> load ->
  step, equals two steps without the checkpoint bit-exactly;
- loud mismatches: config, partition spec, a block no file holds;
- a checkpoint the JAX package writes (a 2 x 2 ``Mesh`` of the suite's
  virtual devices, and a single-device array) loads in the port, and one
  the port writes (4 ranks, and one whole array as the long-run driver
  saves it) loads in the JAX package, bit-exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.dist import halo as th
from iterative_solvers_tpu_torch.dist import mesh as tm
from iterative_solvers_tpu_torch.io import checkpoint as ck
from iterative_solvers_tpu_torch.models import droplet as tdp
from tests.torch_dist_world import World

N = 64


def _cfg():
    return dataclasses.replace(tdp.DropletConfig(), nx=N, ny=N, epsilon=0.05, a=10.0)


def _fields():
    rng = np.random.default_rng(12)
    return rng.standard_normal((N, N)), rng.standard_normal((N, N))


def _sharding(shape=(2, 2), spec=("y", "x")):
    return th.GridSharding(tm.make_mesh(shape, device="cpu"), spec)


# -- tasks -------------------------------------------------------------------------

def _t_save(path, u, q, step, time):
    sh = _sharding()
    ck.save_sharded(path, {"u": th.shard_field(u, sh.mesh), "q": th.shard_field(q, sh.mesh)},
                    config=_cfg(), step=step, time=time, shardings={"u": sh, "q": sh})
    return sh.index(u.shape)


def _t_load(path):
    sh = _sharding()
    out, meta = ck.load_sharded(path, {"u": sh, "q": sh}, config=_cfg())
    return sh.index((N, N)), out["u"].numpy(), out["q"].numpy(), meta


def _t_mismatch(path, which):
    if which == "config":
        target, cfg = _sharding(), dataclasses.replace(_cfg(), epsilon=0.01)
    elif which == "spec":
        target, cfg = _sharding(spec=("y", None)), _cfg()
    else:  # same spec on a (4, 1) mesh: blocks no file holds
        target, cfg = _sharding(shape=(4, 1)), _cfg()
    try:
        ck.load_sharded(path, {"u": target}, config=cfg)
    except ck.CheckpointMismatch as e:
        return str(e)
    return None


def _t_restart(path, u, phi):
    from iterative_solvers_tpu_torch.dist.droplet import make_sharded_ops
    from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov

    mesh = tm.make_mesh((2, 2), device="cpu")
    ops = make_sharded_ops(_cfg(), mesh, x_axis_name="x",
                           solver=NewtonKrylov(f_tol=1e-9, maxiter=6, inner_m=10, outer_k=5))
    sh = ops.sharding

    def step(a, b):
        out = ops.step(a, b, 1e-7, 1e-9, 2)
        return out.u, out.q

    u1, q1 = step(th.shard_field(u, mesh), th.shard_field(phi, mesh))
    u2, q2 = step(u1, q1)
    ck.save_sharded(path, {"u": u1, "q": q1}, config=_cfg(), step=1,
                    shardings={"u": sh, "q": sh})
    back, _ = ck.load_sharded(path, {"u": sh, "q": sh}, config=_cfg())
    u2r, q2r = step(back["u"], back["q"])
    return (torch.equal(back["u"], u1) and torch.equal(back["q"], q1),
            torch.equal(u2r, u2) and torch.equal(q2r, q2))


# -- fixtures ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world4"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from iterative_solvers_tpu.io import checkpoint as jck
    from iterative_solvers_tpu.models import droplet as jdp

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("y", "x"))
    cfg = dataclasses.replace(jdp.DropletConfig(), nx=N, ny=N, epsilon=0.05, a=10.0)
    return jax, jck, NamedSharding(mesh, P("y", "x")), cfg


def test_round_trip_restores_every_block(world4, tmp_path):
    u, q = _fields()
    idx = world4.run(_t_save, tmp_path / "ck", u, q, 7, 1.5e-4)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "meta.json", "proc0.npz", "proc1.npz", "proc2.npz", "proc3.npz"]
    for i, (idx_l, ul, ql, meta) in zip(idx, world4.run(_t_load, tmp_path / "ck")):
        assert idx_l == i
        np.testing.assert_array_equal(ul, u[i])
        np.testing.assert_array_equal(ql, q[i])
        assert meta["step"] == 7 and meta["time"] == 1.5e-4
        assert meta["num_processes"] == 4
        assert meta["layout"]["u"] == {"shape": [N, N], "dtype": "float64",
                                       "spec": "PartitionSpec('y', 'x')"}


def test_restart_trajectory_continuity(world4, tmp_path):
    from iterative_solvers_tpu_torch.ops import curvilinear as tcv

    grid = _cfg().grid
    xn = (grid.xx - grid.xl) / (grid.xr - grid.xl)
    yn = (grid.yy - grid.yb) / (grid.yt - grid.yb)
    phi = 0.02 * np.sin(2 * np.pi * xn) * np.cos(np.pi * yn)
    u = tdp.seeded_solution(tcv.mesh_geometry_dev(torch.tensor(phi), grid), _cfg(),
                            [(0.0, 0.0, 1.0, 0.5)]).numpy()
    assert world4.run(_t_restart, tmp_path / "mid", u, phi) == [(True, True)] * 4


@pytest.mark.parametrize("which,match", [("config", "config mismatch"),
                                         ("spec", "stored partition"),
                                         ("chunk", "no stored chunk")])
def test_mismatches_fail_loudly(world4, tmp_path, which, match):
    u, q = _fields()
    world4.run(_t_save, tmp_path / "ck", u, q, 0, 0.0)
    for msg in world4.run(_t_mismatch, tmp_path / "ck", which):
        assert msg is not None and match in msg


def test_jax_written_loads_in_port(world4, jx, tmp_path):
    jax, jck, sharding, jcfg = jx
    u, q = _fields()
    jck.save_sharded(tmp_path / "jax", {"u": jax.device_put(u, sharding),
                                        "q": jax.device_put(q, sharding)},
                     config=jcfg, step=3, time=2e-5)
    for idx, ul, ql, meta in world4.run(_t_load, tmp_path / "jax"):
        np.testing.assert_array_equal(ul, u[idx])
        np.testing.assert_array_equal(ql, q[idx])
        assert meta["step"] == 3 and meta["num_processes"] == 1
    # a single-device array, as the JAX long-run driver saves it
    jck.save_sharded(tmp_path / "one", {"u": jax.device_put(u, jax.devices()[0])},
                     config=jcfg)
    out, _ = ck.load_sharded(tmp_path / "one", {"u": "cpu"}, config=_cfg())
    np.testing.assert_array_equal(out["u"].numpy(), u)


def test_port_written_loads_in_jax(world4, jx, tmp_path):
    jax, jck, sharding, jcfg = jx
    u, q = _fields()
    world4.run(_t_save, tmp_path / "port", u, q, 5, 1e-3)
    out, meta = jck.load_sharded(tmp_path / "port", {"u": sharding, "q": sharding},
                                 config=jcfg)
    np.testing.assert_array_equal(np.asarray(out["u"]), u)
    np.testing.assert_array_equal(np.asarray(out["q"]), q)
    assert meta["step"] == 5 and meta["num_processes"] == 4
    # one whole array (the port's long-run checkpoint), in a single device
    ck.save_sharded(tmp_path / "whole", {"u": torch.tensor(u)}, config=_cfg(), step=2)
    single = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    out, meta = jck.load_sharded(tmp_path / "whole", {"u": single}, config=jcfg)
    np.testing.assert_array_equal(np.asarray(out["u"]), u)
    assert meta["step"] == 2
