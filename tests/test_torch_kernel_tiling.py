"""CPU rehearsals of the two redesigned CUDA kernels' data movement.

``jvp_apply_tiled_sim`` computes the droplet JVP chain tile by tile from
staged windows that hold only the regions the fused kernel stages (tile + 7
for v, + 6 / + 4 for the coefficients, + 4 for dp, + 2 for dA, dB; clamped
to the domain, indexed globally, NaN elsewhere): a tap outside a region, or
a one-sided edge row missing from a clamped halo, shows as NaN in the tile.
It repeats the plain version's arithmetic on the same values, so it must
equal ``jvp_apply_ref`` to f32 rounding: 1e-6 of max|out| (measured: 0).

``sh_operator_strip_sim`` marches strips of columns down segments of rows
with rolling windows and compare-and-subtract wraps, the taps summed in the
kernel's order: 1e-6 (f32) / 1e-13 (f64) of max|out| against the plain
version, 1e-5 / 1e-12 against the JAX package's (measured: 0 against the
plain version).
"""
import dataclasses

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.core.grid import Grid2D
from iterative_solvers_tpu_torch.io import convert, fixtures as tfx
from iterative_solvers_tpu_torch.ops import periodic_stencil as ps
from iterative_solvers_tpu_torch.ops import stencils as tst
from iterative_solvers_tpu_torch.ops.droplet_jvp import (
    _grow, edge_strip_points, jvp_apply_ref, jvp_apply_tiled_sim, tile_regions)


def _inputs(ny, nx, dtype=np.float32, seed=0):
    """A seeded near-identity metric stack and a random v on an ny x nx grid."""
    rng = np.random.default_rng(seed)
    stack = rng.standard_normal((8, ny, nx))
    stack[:4] *= 0.05
    stack[:3] += 1.0
    grid = Grid2D(nx=nx, ny=ny, xl=-2.0, xr=5.0, yb=-1.5, yt=2.0)
    return (grid, torch.tensor(rng.standard_normal((ny, nx)).astype(dtype)),
            torch.tensor(stack.astype(dtype)))


def _rel(got, want):
    assert not torch.isnan(got).any(), "a staged region misses a tap"
    return float((got - want).abs().max()) / float(want.abs().max())


# (ny, nx), tile, offset: tiles that divide the grid, that do not, that
# exceed it, single rows and columns, and tile edges 1..6 points from the
# domain's (a tile whose halo, not its interior, holds the one-sided rows)
TILINGS = [
    ((8, 8), (32, 32), (0, 0)),
    ((8, 8), (4, 4), (0, 0)),
    ((8, 8), (3, 5), (1, 2)),
    ((9, 23), (8, 8), (0, 0)),
    ((9, 23), (32, 16), (0, 0)),
    ((9, 23), (8, 16), (1, 3)),
    ((9, 23), (1, 1), (0, 0)),
    ((61, 91), (16, 32), (0, 0)),
    ((61, 91), (32, 32), (0, 0)),
    ((61, 91), (16, 16), (5, 6)),
    ((61, 91), (64, 128), (0, 0)),
    ((91, 61), (32, 32), (0, 0)),
    ((91, 61), (13, 61), (0, 0)),
    ((91, 61), (32, 32), (2, 4)),
    ((91, 61), (16, 64), (6, 1)),
    ((128, 64), (32, 32), (0, 0)),
    ((128, 64), (64, 64), (0, 0)),
    ((128, 64), (16, 64), (3, 0)),
    ((128, 64), (32, 16), (4, 5)),
    # rows of whole 16-byte vectors: interior tiles compute groups of 4 columns
    ((64, 96), (16, 32), (0, 0)),
    ((40, 64), (8, 16), (0, 0)),
    ((48, 100), (16, 32), (0, 0)),
]


@pytest.mark.parametrize("shape,tile,offset", TILINGS)
def test_tiled_sim_equals_plain(shape, tile, offset):
    grid, v, stack = _inputs(*shape)
    got = jvp_apply_tiled_sim(v, stack, grid, tile, offset)
    assert _rel(got, jvp_apply_ref(v, stack, grid)) <= 1e-6


@pytest.mark.parametrize("offset", [(k, 7 - k) for k in range(1, 7)])
def test_tiled_sim_tile_edge_near_domain_edge_f64(offset):
    """Tile edges 1..6 points from every domain edge, in f64 at 1e-13."""
    grid, v, stack = _inputs(24, 27, np.float64, seed=3)
    got = jvp_apply_tiled_sim(v, stack, grid, (6, 8), offset)
    flipped = jvp_apply_tiled_sim(v, stack, grid, (6, 8),
                                  (24 - offset[0], 27 - offset[1]))
    want = jvp_apply_ref(v, stack, grid)
    assert _rel(got, want) <= 1e-13 and _rel(flipped, want) <= 1e-13


def test_interior_tiles_of_vector_grids_take_column_groups():
    """On a grid whose rows are whole 16-byte vectors a tile whose regions
    touch no edge stages columns in groups of 4; any other tile does not."""
    inner = tile_regions((16, 32), (32, 64), 64, 96)
    assert inner["v"] == ((9, 39), (24, 72)) and inner["dA"] == ((14, 34), (28, 68))
    assert tile_regions((16, 32), (32, 64), 64, 98)["v"] == ((9, 39), (25, 71))
    assert tile_regions((0, 16), (32, 64), 64, 96)["v"] == ((0, 23), (25, 71))
    assert tile_regions((16, 32), (0, 32), 64, 96)["v"] == ((9, 39), (0, 39))


def test_regions_hold_the_one_sided_taps():
    """A region that touches an edge holds the 5 (d1) or 6 (flux) points
    the one-sided formulas read, however small the tile; regions never
    exceed the tile grown by the interior reach; a clamp that forgets the
    edge points is caught by the rehearsal."""
    assert _grow((8, 9), 9, 2, 5) == (4, 9)      # one output row at the far edge
    assert _grow((0, 1), 9, 3, 6) == (0, 6)
    assert _grow((3, 5), 40, 2, 5) == (1, 7)
    assert _grow((3, 5), 40, 3, 6) == (0, 8)
    for n, t in ((8, 32), (9, 8), (61, 16), (1024, 32)):
        for lo in range(0, n, t):
            regs = tile_regions((lo, min(lo + t, n)), (0, min(t, n)), n, n)
            for name, grown in (("dA", 4), ("dp", 8), ("a22", 12), ("v", 14)):
                (a, b), _ = regs[name]
                assert 0 <= a <= lo and min(lo + t, n) <= b <= n
                assert b - a <= t + grown

    from iterative_solvers_tpu_torch.ops import droplet_jvp as dj

    grid, v, stack = _inputs(9, 23)
    orig, dj._grow = dj._grow, lambda r, n, k, e: (max(r[0] - k, 0), min(r[1] + k, n))
    try:
        assert torch.isnan(jvp_apply_tiled_sim(v, stack, grid, (8, 8))).any()
    finally:
        dj._grow = orig


@pytest.mark.parametrize("ny,nx,tile", [(8, 8, (16, 64)), (40, 16, (16, 64)),
                                        (37, 132, (16, 64)), (128, 64, (16, 64)),
                                        (200, 260, (16, 64)), (64, 96, (32, 32))])
def test_edge_strips_and_column_groups_share_each_stage_region(ny, nx, tile):
    """On a grid of whole 16-byte rows every point of every stage's region
    is computed once: by the 4-column path where all its group's taps are
    interior ones (columns 4 .. nx - 5, rows at least the stage's reach from
    the top and bottom edge), else by exactly one turn of the edge strips."""
    for i0 in range(0, ny, tile[0]):
        for j0 in range(0, nx, tile[1]):
            rows, cols = (i0, min(i0 + tile[0], ny)), (j0, min(j0 + tile[1], nx))
            reg = tile_regions(rows, cols, ny, nx)
            (r4, c6), (r6, c4) = reg["p"], reg["q"]
            (r2, c2) = reg["dA"]
            for box_rows, box_cols, reach, x_edges in (
                    (r4, c6, 2, False), (r6, c4, 0, True), (r4, c4, 3, True),
                    (r2, c2, 2, True), (rows, cols, 2, True)):
                got = edge_strip_points(box_rows, box_cols, ny, nx, reach, x_edges)
                want = {(i, j) for i in range(*box_rows) for j in range(*box_cols)
                        if (x_edges and not 4 <= j < nx - 4)
                        or not reach <= i < ny - reach}
                assert len(got) == len(set(got)) and set(got) == want


def test_tiled_sim_matches_jax_ref_on_golden_state():
    """The rehearsal on the 91x61 coalescence state against the JAX
    package's jvp_apply_ref, at the kernel tests' 2e-5 of max|J v|."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.models import droplet as jdp
    from iterative_solvers_tpu.ops import curvilinear as jcv
    from iterative_solvers_tpu.ops.pallas_droplet import jvp_apply_ref as j_ref

    fix, _ = tfx.load_golden_step()
    tcfg = tfx.config_for(fix)
    jcfg = jdp.DropletConfig(**dataclasses.asdict(tcfg))
    geom = jcv.mesh_geometry(jnp.asarray(fix.q), jcfg.grid)
    geom32 = jcv.MeshGeometry(*(a.astype(jnp.float32) for a in geom))
    jstack = jdp.jvp_field_stack(jnp.asarray(fix.u, jnp.float32), geom32, jcfg,
                                 jnp.float32(1e-5))
    v = np.random.default_rng(7).standard_normal(fix.u.shape).astype(np.float32)
    want = np.asarray(j_ref(jnp.asarray(v), jstack, jcfg.grid))
    stack = convert.stack_from_numpy(jstack, "cpu")
    for tile in ((32, 32), (16, 64)):
        got = jvp_apply_tiled_sim(torch.tensor(v), stack, tcfg.grid, tile).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


# -- the strip-marching sh_operator ---------------------------------------------

SH_SHAPES = [(4, 4), (24, 24), (61, 91), (256, 130)]
H, R = 0.37, 0.01


def _field(shape, dtype):
    return np.random.default_rng(3).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("strip,seg", [(128, 8), (64, 32), (4, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SH_SHAPES)
def test_strip_sim_equals_plain(shape, dtype, strip, seg):
    u = torch.tensor(_field(shape, dtype))
    want = tst.sh_linear_operator(u, H, R)
    got = ps.sh_operator_strip_sim(u, H, R, strip=strip, seg=seg)
    assert _rel(got, want) <= (1e-6 if dtype == np.float32 else 1e-13)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SH_SHAPES)
def test_strip_sim_matches_jax(shape, dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.ops import stencils as jst

    u = _field(shape, dtype)
    want = np.asarray(jst.sh_linear_operator(jnp.asarray(u), H, R))
    assert want.dtype == dtype
    got = ps.sh_operator_strip_sim(torch.tensor(u), H, R).numpy()
    rel = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_sh_operator_path_is_by_shape_and_address():
    """Rows of whole 16-byte vectors at an aligned address take the strip
    kernel, everything else the tiled one."""
    f32, f64 = torch.zeros(24, 24), torch.zeros(24, 26, dtype=torch.float64)
    assert ps.sh_operator_path(f32) == "strip" and ps.sh_operator_path(f64) == "strip"
    assert ps.sh_operator_path(torch.zeros(61, 91)) == "tile"
    assert ps.sh_operator_path(torch.zeros(24, 23, dtype=torch.float64)) == "tile"
    assert ps.sh_operator_path(torch.zeros(24 * 24 + 1)[1:].view(24, 24)) == "tile"
