"""Port parity: the distribution layer (``iterative_solvers_tpu_torch/dist``)
against the JAX package's sharded functions, f64 on the CPU.

The port runs in worlds of gloo ranks (``tests/torch_dist_world.py``: one
process a rank, started with ``spawn``, a deadline on every task); the
JAX side runs ``shard_map`` on a ``Mesh`` of the same shape from the
suite's 8 virtual devices.  Meshes: 1 rank, 4 ranks as rows (4, 1), as
columns (1, 4), and 2 x 2.

- the mesh factorisation, block shape and rank layout;
- ``gmres``, ``lgmres`` and ``cg`` with the ``group`` reduction on a
  sharded system against the single-device solve (equal iterations,
  atol 1e-10);
- ``sharded_lap_periodic`` (atol 1e-12) and ``sharded_sh_operator``
  (atol 1e-10) against JAX's and the dense operator;
- non-periodic halos: zeros at the global edges, the neighbours' strips
  elsewhere, equal to JAX's extended blocks;
- ``pdot`` against the global sum (rtol 1e-12);
- the sharded SH step in both halo modes against JAX's sharded step and
  the single-device step (atol 1e-9, equal Newton counts), and with the
  analytic f32 Jacobian of ``fast_solver`` rebound to the sharded operator;
- ``CommStats`` from the counters: one width-2 exchange per
  ``sharded_sh_operator`` (the permute count and bytes JAX's compiled
  program shows), the all-gathers of the implicit path;
- the halo models' byte counts against JAX's.

The ``gpu``-marked test holds the kernel-backed local bodies against the
plain ones on the card (one NCCL rank):
``python -m pytest --noconftest -m gpu tests/test_torch_dist.py``.
"""
import socket
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.dist import comm
from iterative_solvers_tpu_torch.dist import halo as th
from iterative_solvers_tpu_torch.dist import mesh as tm
from iterative_solvers_tpu_torch.models import swift_hohenberg as tsh
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov as TNK
from iterative_solvers_tpu_torch.utils import roofline as trl
from tests.torch_dist_world import World

MESHES = {"rows4": (4, 1), "cols4": (1, 4), "2x2": (2, 2)}
SOLVER = dict(f_tol=1e-10, maxiter=40, inner_m=20, outer_k=5)


def _field(n, seed):
    return np.random.default_rng(seed).standard_normal((n, n))


# -- tasks: run on every rank of a world ------------------------------------------

def _t_mesh(shape):
    mesh = tm.make_mesh(shape, device="cpu")
    return tuple(mesh.shape), tm.local_block_shape((32, 32), mesh)


def _t_operator(shape, name, u, h, r):
    mesh = tm.make_mesh(shape, device="cpu")
    block = th.shard_field(u, mesh)
    comm.reset_counts()
    if name == "lap":
        out = th.sharded_lap_periodic(block, h, mesh)
    else:
        out = th.sharded_sh_operator(block, h, r, mesh)
    stats = trl.comm_stats()
    return th.gather_field(out, mesh).numpy(), stats


def _t_halo(shape, u, width):
    mesh = tm.make_mesh(shape, device="cpu")
    ext = th.with_halo(th.shard_field(u, mesh), width, mesh, periodic=False)
    iy, ix = th.grid_sharding(mesh).index(u.shape)
    return iy.start // (u.shape[0] // shape[0]), ix.start // (u.shape[1] // shape[1]), ext.numpy()


def _t_mesh_devices(order):
    mesh = tm.make_mesh((2, 2), devices=order, device="cpu")
    return tuple(mesh.get_coordinate())


def _t_krylov(shape, b, solver):
    """gmres / lgmres / cg on the rank's block of a sharded SPD system
    (I - 0.1 Lap, periodic), reduced over the mesh, against the same solve
    on one device."""
    from iterative_solvers_tpu_torch.solvers import cg, gmres, lgmres

    mesh = tm.make_mesh(shape, device="cpu")
    group = tm.mesh_group(mesh)
    block = th.shard_field(b, mesh)

    def sharded(v):
        return v - 0.1 * th.sharded_lap_periodic(v, 1.0, mesh)

    def local(v):
        from iterative_solvers_tpu_torch.ops.stencils import lap_periodic
        return v - 0.1 * lap_periodic(v, 1.0)

    run = {"gmres": lambda mv, r, g: gmres(mv, r, tol=1e-10, restart=10, group=g),
           "lgmres": lambda mv, r, g: lgmres(mv, r, tol=1e-10, inner_m=10, group=g)[0],
           "cg": lambda mv, r, g: cg(mv, r, tol=1e-10, group=g)}[solver]
    got = run(sharded, block, group)
    want = run(local, torch.tensor(b), None)
    return (th.gather_field(got.x, mesh).numpy(), got.iters, got.converged,
            want.x.numpy(), want.iters)


def _t_pdot(shape, a, b):
    mesh = tm.make_mesh(shape, device="cpu")
    return float(th.pdot(th.shard_field(a, mesh), th.shard_field(b, mesh), mesh))


def _t_sh_step(shape, u0, explicit, fast):
    from iterative_solvers_tpu_torch.dist.solvers import make_sharded_sh_step

    mesh = tm.make_mesh(shape, device="cpu")
    cfg = tsh.SHConfig(n=u0.shape[0])
    solver = tsh.fast_solver(cfg) if fast else TNK(**SOLVER)
    step = make_sharded_sh_step(cfg, mesh, solver=solver, explicit_halos=explicit)
    comm.reset_counts()
    u, res = step(th.shard_field(u0, mesh))
    stats = trl.comm_stats()
    return th.gather_field(u, mesh).numpy(), res.iters, res.converged, stats


def _t_foreign_factory(shape):
    from iterative_solvers_tpu_torch.dist.solvers import make_sharded_sh_step

    mesh = tm.make_mesh(shape, device="cpu")
    solver = TNK(matvec_factory=lambda x, fx: (lambda v: v))
    try:
        make_sharded_sh_step(tsh.SHConfig(n=16), mesh, solver=solver)
    except ValueError as e:
        return str(e)
    return None


# -- fixtures ---------------------------------------------------------------------

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
    """The JAX package's side: sharded functions on a Mesh of 4 (or 1) of
    the suite's virtual devices."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from iterative_solvers_tpu.dist import halo as jh
    from iterative_solvers_tpu.dist import mesh as jm
    from iterative_solvers_tpu.dist.solvers import make_sharded_sh_step
    from iterative_solvers_tpu.models import swift_hohenberg as jsh
    from iterative_solvers_tpu.ops import stencils as jst
    from iterative_solvers_tpu.solvers.newton import NewtonKrylov
    from iterative_solvers_tpu.utils import roofline as jrl

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")

    def mesh(shape):
        n = shape[0] * shape[1]
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("y", "x"))

    return types.SimpleNamespace(jax=jax, jnp=jnp, mesh=mesh, halo=jh, jm=jm,
                                 sh=jsh, st=jst, rl=jrl, NK=NewtonKrylov,
                                 sharded_step=make_sharded_sh_step)


# -- tests --------------------------------------------------------------------------

def test_mesh_factorisation(world4, world1, jx):
    shapes = world4.run(_t_mesh, None)
    assert all(s == ((2, 2), (16, 16)) for s in shapes)
    assert world1.run(_t_mesh, None) == [((1, 1), (32, 32))]
    jmesh = jx.jm.make_mesh(devices=jx.jax.devices()[:4])
    assert jmesh.devices.shape == (2, 2)
    assert jx.jm.local_block_shape((32, 32), jmesh) == (16, 16)
    assert world4.run(_t_mesh, (4, 1))[0] == ((4, 1), (8, 32))
    # ``devices`` lays the ranks out row-major
    assert world4.run(_t_mesh_devices, [3, 2, 1, 0]) == [(1, 1), (1, 0), (0, 1), (0, 0)]


@pytest.mark.parametrize("solver", ["gmres", "lgmres", "cg"])
def test_sharded_krylov_matches_single_device(world4, solver):
    """The ``group`` reductions of the Krylov solvers: the sharded solve
    takes the single-device solve's iteration count and answer."""
    b = _field(32, 10)
    for x, iters, conv, want_x, want_iters in world4.run(_t_krylov, (2, 2), b, solver):
        assert conv and iters == want_iters
        np.testing.assert_allclose(x, want_x, rtol=0, atol=1e-10)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("op", ["lap", "sh"])
def test_sharded_operator_matches_jax(world4, jx, mesh_name, op):
    shape = MESHES[mesh_name]
    n, h, r = 32, 40.0 / 32, 0.01
    u = _field(n, 3)
    outs = world4.run(_t_operator, shape, op, u, h, r)
    jmesh = jx.mesh(shape)
    us = jx.halo.shard_field(jx.jnp.asarray(u), jmesh)
    if op == "lap":
        want_j = jx.halo.sharded_lap_periodic(us, h, jmesh)
        dense = jx.st.lap_periodic(jx.jnp.asarray(u), h)
        atol = 1e-12
    else:
        want_j = jx.halo.sharded_sh_operator(us, h, r, jmesh)
        dense = jx.st.sh_linear_operator(jx.jnp.asarray(u), h, r)
        atol = 1e-10
    for got, _ in outs:
        np.testing.assert_allclose(got, np.asarray(want_j), rtol=0, atol=atol)
        np.testing.assert_allclose(got, np.asarray(dense), rtol=0, atol=atol)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_comm_stats_one_exchange_per_sh_operator(world4, jx, mesh_name):
    """The counters see what JAX's compiled program holds: one width-2
    exchange (two strips an axis with more than one rank) per
    ``sharded_sh_operator``, with the same bytes; and the 2-D halo model's
    bytes of one exchange."""
    shape = MESHES[mesh_name]
    n = 32
    u = _field(n, 4)
    stats = [s for _, s in world4.run(_t_operator, shape, "sh", u, 1.25, 0.01)]
    jmesh = jx.mesh(shape)
    us = jx.halo.shard_field(jx.jnp.asarray(u), jmesh)
    compiled = jx.jax.jit(
        lambda v: jx.halo.sharded_sh_operator(v, 1.25, 0.01, jmesh)).lower(us).compile()
    want = jx.rl.comm_stats_from_compiled(compiled)
    for s in stats:
        assert s.collective_permute_count == want.collective_permute_count
        assert s.permute_bytes == want.permute_bytes
        assert s.all_reduce_count == 0 and s.all_gather_count == 0
    if mesh_name == "2x2":
        model = trl.halo_step_model_2d(n, n, 2, 2, 2, 1, 8, 1, hbm_gbps=1.0, link_gbps=1.0)
        assert stats[0].permute_bytes == model["comm_bytes"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_halo_nonperiodic_zeros(world4, jx, mesh_name):
    """Non-periodic extended blocks: zeros past the global edges, the
    neighbours' strips elsewhere; equal to JAX's ``with_halo`` blocks and
    to the zero-padded global field."""
    from jax.sharding import PartitionSpec as P

    shape, n, w = MESHES[mesh_name], 16, 2
    u = _field(n, 5)
    outs = world4.run(_t_halo, shape, u, w)
    jmesh = jx.mesh(shape)
    ext_j = jx.jax.shard_map(
        lambda b: jx.halo.with_halo(b, w, ("y", "x"), periodic=False),
        mesh=jmesh, in_specs=P("y", "x"), out_specs=P("y", "x"))(
        jx.halo.shard_field(jx.jnp.asarray(u), jmesh))
    ext_j = np.asarray(ext_j)
    padded = np.pad(u, w)
    by, bx = n // shape[0], n // shape[1]
    for iy, ix, ext in outs:
        assert ext.shape == (by + 2 * w, bx + 2 * w)
        jblock = ext_j[iy * (by + 2 * w):(iy + 1) * (by + 2 * w),
                       ix * (bx + 2 * w):(ix + 1) * (bx + 2 * w)]
        np.testing.assert_array_equal(ext, jblock)
        np.testing.assert_array_equal(
            ext, padded[iy * by:iy * by + by + 2 * w, ix * bx:ix * bx + bx + 2 * w])


def test_pdot_matches_global(world4, jx):
    from jax.sharding import PartitionSpec as P

    a, b = _field(32, 6), _field(32, 7)
    got = world4.run(_t_pdot, (2, 2), a, b)
    jmesh = jx.mesh((2, 2))
    want_j = jx.jax.shard_map(
        lambda x, y: jx.halo.pdot(x, y, ("y", "x"))[None], mesh=jmesh,
        in_specs=(P("y", "x"), P("y", "x")), out_specs=P(None))(
        jx.halo.shard_field(jx.jnp.asarray(a), jmesh),
        jx.halo.shard_field(jx.jnp.asarray(b), jmesh))
    for g in got:
        np.testing.assert_allclose(g, float(np.sum(a * b)), rtol=1e-12)
        np.testing.assert_allclose(g, float(want_j[0]), rtol=1e-12)


@pytest.fixture(scope="module")
def sh_case(jx):
    """The JAX tests' SH step case (n = 32): the single-device step and
    the JAX sharded steps on a 2 x 2 mesh in both halo modes."""
    cfg = jx.sh.SHConfig(n=32)
    u0 = np.random.default_rng(3).standard_normal((32, 32))
    solver = jx.NK(**SOLVER)
    want, res = jx.sh.make_cn_step(cfg, solver)(jx.jnp.asarray(u0))
    jmesh = jx.mesh((2, 2))
    sharded = {}
    for explicit in (True, False):
        got, r = jx.sharded_step(cfg, jmesh, solver=solver, explicit_halos=explicit)(
            jx.halo.shard_field(jx.jnp.asarray(u0), jmesh))
        sharded[explicit] = (np.asarray(got), int(r.iters))
    return u0, np.asarray(want), int(res.iters), sharded


@pytest.mark.parametrize("explicit", [True, False])
def test_sharded_sh_step_matches_jax(world4, world1, sh_case, explicit):
    u0, want, iters, sharded = sh_case
    for world, shape in ((world4, (2, 2)), (world1, (1, 1))):
        for got, it, conv, stats in world.run(_t_sh_step, shape, u0, explicit, False):
            assert conv and it == iters == sharded[explicit][1]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
            np.testing.assert_allclose(got, sharded[explicit][0], rtol=0, atol=1e-9)
            assert stats.all_reduce_count > 0
            if world is world4 and explicit:
                assert stats.collective_permute_count > 0 and stats.all_gather_count == 0
            if not explicit:
                assert stats.all_gather_count > 0 and stats.collective_permute_count == 0


def test_sharded_sh_step_modes_agree_fast_solver(world4):
    """The analytic f32 Jacobian rebound to the sharded operator: both halo
    modes agree with each other and with the single-device fast step."""
    cfg = tsh.SHConfig(n=32)
    u0 = np.random.default_rng(8).standard_normal((32, 32))
    want, res = tsh.make_cn_step(cfg, tsh.fast_solver(cfg), device="cpu")(torch.tensor(u0))
    got = {e: world4.run(_t_sh_step, (2, 2), u0, e, True)[0] for e in (True, False)}
    for u, it, conv, _ in got.values():
        assert conv and abs(it - res.iters) <= 1
        np.testing.assert_allclose(u, want.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[True][0], got[False][0], rtol=0, atol=2e-6)
    assert "JacobianMatvec" in world4.run(_t_foreign_factory, (2, 2))[0]


@pytest.mark.parametrize("n_devices,halo_rows,passes", [(4, 2, 6), (8, 12, 30)])
def test_halo_models_match_jax(jx, n_devices, halo_rows, passes):
    """Same byte counts and ratios as the JAX models at the same rates."""
    kw = dict(hbm_gbps=800.0)
    got = trl.halo_step_model(1024, 1024, n_devices, halo_rows, 3, 8, passes,
                              link_gbps=100.0, **kw)
    want = jx.rl.halo_step_model(1024, 1024, n_devices, halo_rows, 3, 8, passes,
                                 ici_gbps=100.0, **kw)
    assert got == pytest.approx(want, rel=1e-15)
    got2 = trl.halo_step_model_2d(1024, 512, 2, n_devices // 2, halo_rows, 3, 8,
                                  passes, link_gbps=100.0, **kw)
    want2 = jx.rl.halo_step_model_2d(1024, 512, 2, n_devices // 2, halo_rows, 3,
                                     8, passes, ici_gbps=100.0, **kw)
    assert got2["block"] == tuple(want2["block"])
    for k in ("compute_bytes", "comm_bytes", "comm_compute_ratio",
              "weak_scaling_efficiency"):
        assert got2[k] == pytest.approx(want2[k], rel=1e-15)


# -- on the card -------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.gpu
def test_kernel_bodies_match_plain_on_gpu():
    """One NCCL rank: the kernel-backed ``sharded_sh_operator`` and
    ``sharded_lap_periodic`` against their plain local bodies (the CPU
    composition) on the same block, f32 and f64, and the kernels
    launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from iterative_solvers_tpu_torch.ops._build import launch_count

    tm.initialize_multihost(f"localhost:{_free_port()}", 1, 0, device="cuda",
                            timeout=60)
    try:
        mesh = tm.make_mesh(device="cuda")
        before = (launch_count("sh_operator"), launch_count("lap_periodic"))
        for dtype, gate in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            u = torch.tensor(_field(256, 9), dtype=dtype, device="cuda")
            for got, plain in (
                    (th.sharded_sh_operator(u, 0.3, 0.01, mesh),
                     th.sharded_sh_operator(u.cpu(), 0.3, 0.01, mesh)),
                    (th.sharded_lap_periodic(u, 0.3, mesh),
                     th.sharded_lap_periodic(u.cpu(), 0.3, mesh))):
                torch.cuda.synchronize()
                scale = float(plain.abs().max())
                assert float((got.cpu() - plain).abs().max()) <= gate * scale
        assert launch_count("sh_operator") == before[0] + 2
        assert launch_count("lap_periodic") == before[1] + 2
    finally:
        dist.destroy_process_group()
