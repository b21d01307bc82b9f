"""CPU rehearsal of the tiled SpMV kernel (``grid_dia_matvec``): its
per-tile live-term lists, its thread layout and its path choice.

``grid_dia_matvec_tiled_sim`` builds ``y = A x`` tile by tile from what the
kernel reads: each tile's list of live terms (dead ones dropped, whole ones
read at one flat offset with no per-point test, partial ones tested per
point), the list taken a chunk of terms at a time, the points of the
kernel's threads (16-byte vectors on the ``"vector"`` path, single columns
on the ``"scalar"`` one), ragged last tiles, and NaN for every coefficient
and x the kernel must not read and every output it must write.  It is held
against the plain version (``GridDIA._apply``) and against the JAX
package's ``grid_dia_matvec_pallas`` (off the TPU, its ``_apply``) on the
same seeded numpy inputs: 1e-5 of max|y| in f32, 1e-12 in f64 (measured
against the plain version: 0, the same products summed in the same order).

``grid_dia_block_terms`` is checked on the far-shift clamped SH container
(|dy| up to ny - 1): an interior tile keeps exactly the 13 near terms, all
whole; edge tiles keep the far ones they reach, tested per point.
``matvec_path`` is checked by shape and alignment.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from iterative_solvers_tpu_torch.io import convert
from iterative_solvers_tpu_torch.ops import sparse as ts
from iterative_solvers_tpu_torch.ops import spmv
from iterative_solvers_tpu_torch.ops._build import launch_count, reset_launch_counts

CPU = torch.device("cpu")
N = 24


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.ops import pallas_spmv, sparse

    return jnp, sparse, pallas_spmv


def _second_difference(n, periodic):
    d = sp.diags([np.ones(n - 1), -2 * np.ones(n), np.ones(n - 1)], [-1, 0, 1]).tolil()
    if periodic:
        d[0, n - 1] = d[n - 1, 0] = 1.0
    return d.tocsr()


def _operator(kind, ny, nx):
    """Row-major (ny, nx) grid operators, as in ``test_torch_spmv.py``'s
    ``GRID_CASES``: the periodic SH operator -Lap^2 - 2 Lap + (r-1) I
    (h = 0.7, r = 0.01), the Dirichlet 5-point Laplacian and biharmonic
    (h = 2), the 9 x 14-style Dirichlet Laplacian (``rect``) and a random
    matrix (one shift per entry)."""
    if kind == "random":
        return sp.random(ny * nx, ny * nx, density=0.0002, random_state=3, format="csr")
    periodic = kind == "sh"
    h = 0.7 if periodic else 2.0
    lap = (sp.kron(sp.identity(ny), _second_difference(nx, periodic))
           + sp.kron(_second_difference(ny, periodic), sp.identity(nx))) / (h * h)
    if kind == "sh":
        return (-(lap @ lap) - 2.0 * lap + (0.01 - 1.0) * sp.identity(ny * nx)).tocsr()
    if kind == "biharmonic":
        return (lap @ lap).tocsr()
    return lap.tocsr()  # dirichlet, rect


# tests/test_torch_spmv.py's GRID_CASES, on its grids
GRID_CASES = [("sh", True, (N, N)), ("sh", False, (N, N)), ("dirichlet", False, (N, N)),
              ("biharmonic", False, (N, N)), ("rect", False, (9, 14)),
              ("random", True, (N, N)), ("random", False, (N, N))]
# (rows a tile, threads along a row, points a thread, terms a chunk): the
# kernel's own tiling, and small ones that make many tiles with ragged
# last ones and lists of several chunks
TILINGS = [(8, 32, 4, 256), (3, 2, 4, 7), (5, 4, 8, 16)]
DTYPES = {"f32": (np.float32, 1e-5), "f64": (np.float64, 1e-12)}


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert not np.isnan(got).any(), "the rehearsal read what the kernel must not, or missed a point"
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300))


def _inputs(jx, kind, cyclic, grid, npdt, seed=11):
    """The JAX and port containers of one operator with random coefficients
    everywhere (a clamped source outside the grid must add nothing,
    whatever d is), and a seeded x."""
    jnp, jsparse, _ = jx
    aj = jsparse.GridDIA.from_scipy(_operator(kind, *grid), grid, cyclic=cyclic)
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(np.asarray(aj.data).shape).astype(npdt)
    aj = aj._replace(data=jnp.asarray(data))
    at = convert.griddia_from_jax(data, aj.shifts, aj.grid, aj.cyclic, CPU)
    return aj, at, rng.standard_normal(grid).astype(npdt)


def _paths(grid, npdt):
    vector = 16 // np.dtype(npdt).itemsize
    return ["vector", "scalar"] if grid[1] % vector == 0 else ["scalar"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("kind,cyclic,grid", GRID_CASES)
def test_tiled_sim_matches_plain_and_jax(jx, kind, cyclic, grid, tiling, dtype):
    jnp, _, jspmv = jx
    npdt, gate = DTYPES[dtype]
    aj, at, x = _inputs(jx, kind, cyclic, grid, npdt)
    want = at._apply(torch.tensor(x))
    want_j = jspmv.grid_dia_matvec_pallas(aj, jnp.asarray(x))
    rows, tx, points, chunk = tiling
    for path in _paths(grid, npdt):
        got = spmv.grid_dia_matvec_tiled_sim(at, torch.tensor(x), path, rows=rows, tx=tx,
                                             points=points, chunk=chunk)
        assert got.shape == grid and got.dtype == want.dtype
        _close(got, want, gate)
        _close(got, want_j, gate)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,cyclic,grid", [("dirichlet", False, (6, 999)),
                                              ("dirichlet", False, (9, 14)),
                                              ("sh", True, (9, 14)),
                                              ("sh", False, (7, 131)),
                                              ("sh", True, (1, 7))])
def test_tiled_sim_odd_and_tiny_widths(jx, kind, cyclic, grid, dtype):
    """Rows of 999 (the Poisson shape's odd pitch: 7992-byte f64 rows),
    9 x 14, 131 and 7 columns take the scalar path, on the kernel's
    tiling; 9 x 14 f64 also the vector one (7 whole vectors)."""
    jnp, _, jspmv = jx
    npdt, gate = DTYPES[dtype]
    aj, at, x = _inputs(jx, kind, cyclic, grid, npdt, seed=5)
    want = at._apply(torch.tensor(x))
    for path in _paths(grid, npdt):
        got = spmv.grid_dia_matvec_tiled_sim(at, torch.tensor(x), path)
        _close(got, want, gate)
        _close(got, jspmv.grid_dia_matvec_pallas(aj, jnp.asarray(x)), gate)


@pytest.mark.parametrize("cyclic", [True, False])
def test_tiled_sim_lists_longer_than_a_chunk(jx, cyclic):
    """A random container with more terms than one chunk of the kernel's
    list (256; 293 cyclic, 347 clamped terms here): the list is built and
    walked a chunk at a time."""
    jnp, jsparse, jspmv = jx
    m = sp.random(N * N, N * N, density=0.0012, random_state=3, format="csr")
    aj = jsparse.GridDIA.from_scipy(m, (N, N), cyclic=cyclic)
    rng = np.random.default_rng(4)
    data = rng.standard_normal(np.asarray(aj.data).shape)
    at = convert.griddia_from_jax(data, aj.shifts, aj.grid, aj.cyclic, CPU)
    aj = aj._replace(data=jnp.asarray(data))
    nterms = len(spmv._term_rows(at.shifts, at.grid, at.cyclic, False))
    assert nterms > spmv._MV_CHUNK
    x = rng.standard_normal((N, N))
    got = spmv.grid_dia_matvec_tiled_sim(at, torch.tensor(x))
    _close(got, at._apply(torch.tensor(x)), 1e-12)
    # under jit: eager JAX compiles each of the ~300 band slices on its own
    import jax

    want_j = jax.jit(lambda d, v: jspmv.grid_dia_matvec_pallas(aj._replace(data=d), v))(
        aj.data, jnp.asarray(x))
    _close(got, want_j, 1e-12)


def test_tiled_sim_empty_matrix_gives_zero():
    a = ts.GridDIA.from_scipy(sp.csr_matrix((N * N, N * N)), (N, N), device="cpu")
    x = torch.tensor(np.random.default_rng(2).standard_normal((N, N)))
    for path in ("vector", "scalar"):
        got = spmv.grid_dia_matvec_tiled_sim(a, x, path)
        assert got.shape == (N, N) and not got.isnan().any() and not got.any()


def test_tiled_sim_reads_no_coefficient_outside_the_grid():
    """The rehearsal stores NaN in every coefficient whose source lies
    outside the grid, so a tile that took a partial term for whole, or a
    dead one for live, would give NaN: a clamped container whose stored
    zeros there are 1e30 gives the plain version's product."""
    grid = (20, 260)
    a = ts.GridDIA.from_scipy(_operator("biharmonic", *grid), grid, device="cpu")
    data = a.data.clone()
    gr, gc = torch.arange(grid[0])[:, None], torch.arange(grid[1])[None, :]
    for k, (dy, dx) in enumerate(a.shifts):
        data[k][(gr + dy < 0) | (gr + dy >= grid[0]) | (gc + dx < 0) | (gc + dx >= grid[1])] = 1e30
    b = a._replace(data=data)
    x = torch.tensor(np.random.default_rng(3).standard_normal(grid))
    for path in ("vector", "scalar"):
        got = spmv.grid_dia_matvec_tiled_sim(b, x, path, rows=3, tx=4, points=8)
        np.testing.assert_array_equal(got.numpy(), a._apply(x).numpy())


def test_block_terms_of_the_far_shift_container():
    """The non-cyclic container of the periodic SH operator stores 33
    fields (13 near shifts and 20 wrap residues with |dy| or |dx| near the
    grid's size).  An interior tile keeps exactly the 13 near terms, none
    tested; the corner tile keeps far terms, each tested per point; every
    tile keeps the table's order."""
    ny, nx = 32, 384
    rows_a_tile, width = spmv._MV_ROWS, spmv._MV_TX * spmv._MV_POINTS
    a = ts.GridDIA.from_scipy(_operator("sh", ny, nx), (ny, nx), device="cpu")
    assert len(a.shifts) == 33
    terms = spmv._term_rows(a.shifts, a.grid, False, False)
    near = [(k, dy, dx) for k, dy, dx in terms if abs(dy) <= 2 and abs(dx) <= 2]
    assert len(near) == 13
    r0, c0 = rows_a_tile, width  # tile (1, 1) of 4 x 3: no grid edge within reach
    inner = spmv.grid_dia_block_terms(terms, a.grid, False, r0, r0 + rows_a_tile, c0,
                                      c0 + width)
    assert [(k, dy, dx) for _, k, dy, dx, _ in inner] == near
    assert all(kind == "whole" for kind, *_ in inner)
    assert [xoff for *_, xoff in inner] == [dy * nx + dx for _, dy, dx in near]
    corner = spmv.grid_dia_block_terms(terms, a.grid, False, 0, rows_a_tile, 0, width)
    far = [(kind, dy, dx) for kind, _, dy, dx, _ in corner if abs(dy) > 2 or abs(dx) > 2]
    assert far and all(kind == "partial" for kind, _, _ in far)
    assert any(abs(dy) >= ny - 2 for _, dy, _ in far) and any(abs(dx) >= nx - 2
                                                              for _, _, dx in far)
    for live in (inner, corner):  # the table's order
        order = [k for _, k, _, _, _ in live]
        assert order == [k for k, _, _ in terms if k in set(order)]
    # near terms reaching across the corner tile's grid edge are tested too
    assert {(dy, dx) for kind, _, dy, dx, _ in corner if kind == "partial"} >= {(-1, 0), (0, -1)}


def test_block_terms_cyclic_wrap():
    """A cyclic term is whole in a tile where none of its sources wraps,
    at the wrapped offset where all of them do, and partial where the
    wrap falls inside the tile; a cyclic term is never dead."""
    grid = (16, 40)
    rows = ((0, 15, 0), (1, 0, 39), (2, 3, 38))  # one up, one left, (3, -2)
    top = spmv.grid_dia_block_terms(rows, grid, True, 0, 4, 8, 16)
    assert top == [("partial", 0, 15, 0, 15 * 40), ("whole", 1, 0, 39, -1),
                   ("whole", 2, 3, 38, 3 * 40 - 2)]
    low = spmv.grid_dia_block_terms(rows, grid, True, 4, 8, 0, 8)
    assert low == [("whole", 0, 15, 0, -40), ("partial", 1, 0, 39, 39),
                   ("partial", 2, 3, 38, 3 * 40 + 38)]
    bottom = spmv.grid_dia_block_terms(rows, grid, True, 12, 16, 2, 10)
    assert [kind for kind, *_ in bottom] == ["whole", "whole", "partial"]


def _unaligned(shape, dtype):
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:]
    assert flat.data_ptr() % 16
    return flat.view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_matvec_path_by_shape_and_alignment(dtype):
    npdt = np.float32 if dtype == torch.float32 else np.float64
    a = ts.GridDIA.from_scipy(_operator("sh", N, N).astype(npdt), (N, N), cyclic=True,
                              device="cpu")
    x = torch.zeros((N, N), dtype=dtype)
    assert spmv.matvec_path(a, x) == "vector"
    assert spmv.matvec_path(a, _unaligned((N, N), dtype)) == "scalar"
    assert spmv.matvec_path(a._replace(data=_unaligned(a.data.shape, dtype)), x) == "scalar"
    # rows that are not whole 16-byte vectors: 999 f64 (the Poisson shape), 14 f32
    for grid in ((5, 999), (9, 14)):
        b = ts.GridDIA.from_scipy(_operator("dirichlet", *grid).astype(npdt), grid,
                                  device="cpu")
        vector = 16 // x.element_size()
        want = "vector" if grid[1] % vector == 0 else "scalar"
        assert spmv.matvec_path(b, torch.zeros(grid, dtype=dtype)) == want
    with pytest.raises(ValueError, match="whole 16-byte vectors"):
        spmv.grid_dia_matvec_tiled_sim(
            ts.GridDIA.from_scipy(_operator("dirichlet", 5, 999).astype(npdt), (5, 999),
                                  device="cpu"), torch.zeros((5, 999), dtype=dtype), "vector")


def test_cpu_matvec_counts_no_launch_by_path():
    m = _operator("sh", N, N)
    a = ts.GridDIA.from_scipy(m, (N, N), cyclic=True, device="cpu")
    reset_launch_counts()
    spmv.grid_dia_matvec(a, torch.zeros((N, N), dtype=torch.float64))
    assert {p: launch_count("grid_dia_matvec", path=p)
            for p in ("vector", "scalar")} == {"vector": 0, "scalar": 0}
