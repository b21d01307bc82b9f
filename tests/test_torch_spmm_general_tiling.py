"""CPU rehearsal of the tiled SpMM kernel (the ``"general"`` path of
``grid_dia_matmat`` / ``grid_dia_matmat_interleaved``): its per-tile
live-term lists, its register tiles of right-hand sides and its two
layouts.

``grid_dia_matmat_tiled_sim`` builds ``Y = A X`` tile by tile from what
the kernel reads: each tile's list of live terms (dead ones dropped, whole
ones read at one flat x offset with no per-point test, partial ones tested
per point), the list taken a chunk of terms at a time, a register tile of
right-hand sides at a time, ragged last tiles, and NaN for every
coefficient and x the kernel must not read and every output it must
write.  It is held against the plain version (``_matmat_plain``) and
against the JAX package's ``grid_dia_matmat_pallas`` /
``grid_dia_matmat_interleaved_pallas`` (off the TPU, their per-rhs
``_apply``) on the same seeded numpy inputs: 1e-5 of max|Y| in f32, 1e-12
in f64 (measured against the plain version: 0, the same products summed
in the same order).

``tools/emulate_dia_spmv.py --only spmm`` runs the kernel's own CUDA source
on host threads (the host's ``g++``) against its own one-thread-a-point
host loop of FMAs, bit for bit.
"""
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from iterative_solvers_tpu_torch.io import convert
from iterative_solvers_tpu_torch.ops import sparse as ts
from iterative_solvers_tpu_torch.ops import spmv

CPU = torch.device("cpu")
N = 24
ROOT = pathlib.Path(__file__).resolve().parent.parent


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
    """Row-major (ny, nx) grid operators: the periodic 5-point Laplacian and
    SH operator -Lap^2 - 2 Lap + (r-1) I (h = 0.7, r = 0.01), the Dirichlet
    5-point Laplacian and biharmonic (h = 2), a random matrix (one shift per
    entry)."""
    if kind == "random":
        return sp.random(ny * nx, ny * nx, density=0.0012, random_state=3, format="csr")
    periodic = kind in ("sh", "lap")
    h = 0.7 if periodic else 2.0
    lap = (sp.kron(sp.identity(ny), _second_difference(nx, periodic))
           + sp.kron(_second_difference(ny, periodic), sp.identity(nx))) / (h * h)
    if kind == "sh":
        return (-(lap @ lap) - 2.0 * lap + (0.01 - 1.0) * sp.identity(ny * nx)).tocsr()
    if kind == "biharmonic":
        return (lap @ lap).tocsr()
    return lap.tocsr()


# operator, cyclic container: the slab tests' operators and the far-shift
# clamped SH container (the periodic operator stored without wraps: 33
# fields, |dy| up to ny - 1), which takes the general path
OPERATORS = [("sh", True), ("lap", True), ("dirichlet", False), ("biharmonic", False),
             ("sh", False)]
# grid, right-hand sides, (tile rows, tile columns, rhs a register tile,
# terms a chunk) or None for the kernel's tiling: ragged tiles, register
# tiles of 1-8 rhs with a ragged last one, chunks shorter than the list
CASES = [((24, 24), 1, None), ((24, 24), 3, (3, 8, 2, 256)), ((40, 36), 8, (5, 16, 8, 7)),
         ((37, 132), 11, None), ((37, 132), 8, (8, 64, 3, 256))]
DTYPES = {"f32": (np.float32, 1e-5), "f64": (np.float64, 1e-12)}
LAYOUTS = ["stacked", "interleaved"]


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert not np.isnan(got).any(), "the rehearsal read what the kernel must not, or missed a point"
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300))


def _inputs(jx, m, grid, cyclic, nrhs, npdt, seed=11):
    """The JAX and port containers of ``m`` with random coefficients
    everywhere (a clamped source outside the grid must add nothing,
    whatever d is), and a seeded stack ``(nrhs, ny, nx)``."""
    jnp, jsparse, _ = jx
    aj = jsparse.GridDIA.from_scipy(m, grid, cyclic=cyclic)
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(np.asarray(aj.data).shape).astype(npdt)
    aj = aj._replace(data=jnp.asarray(data))
    at = convert.griddia_from_jax(data, aj.shifts, aj.grid, aj.cyclic, CPU)
    return aj, at, rng.standard_normal((nrhs,) + grid).astype(npdt)


def _check(jx, aj, at, x3, layout, gate, **tiling):
    """The rehearsal in ``layout`` against the plain version and the JAX
    wrapper of that layout."""
    jnp, _, jspmv = jx
    if layout == "stacked":
        x = x3
        want_j = jspmv.grid_dia_matmat_pallas(aj, jnp.asarray(x))
        want = spmv._matmat_plain(at, torch.tensor(x3))
    else:
        x = np.ascontiguousarray(np.moveaxis(x3, 0, 1))
        want_j = jspmv.grid_dia_matmat_interleaved_pallas(aj, jnp.asarray(x))
        want = spmv._matmat_plain(at, torch.tensor(x3)).movedim(0, 1)
    got = spmv.grid_dia_matmat_tiled_sim(at, torch.tensor(x), layout, **tiling)
    assert got.shape == x.shape and got.dtype == want.dtype
    _close(got, want, gate)
    _close(got, want_j, gate)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid,nrhs,tiling", CASES)
@pytest.mark.parametrize("kind,cyclic", OPERATORS)
def test_tiled_sim_matches_plain_and_jax(jx, kind, cyclic, grid, nrhs, tiling, dtype, layout):
    npdt, gate = DTYPES[dtype]
    aj, at, x3 = _inputs(jx, _operator(kind, *grid), grid, cyclic, nrhs, npdt)
    kw = {}
    if tiling is not None:
        rows, cols, rhs_tile, chunk = tiling
        kw = dict(rows=rows, cols=cols, rhs_tile=rhs_tile, chunk=chunk)
    _check(jx, aj, at, x3, layout, gate, **kw)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,cyclic,grid", [("dirichlet", False, (6, 999)),
                                              ("sh", True, (9, 130)),
                                              ("sh", False, (7, 131)),
                                              ("sh", True, (1, 7)),
                                              ("dirichlet", False, (1, 1))])
def test_tiled_sim_odd_and_tiny_widths(jx, kind, cyclic, grid, dtype, layout):
    """Rows of 999 (the Poisson shape's odd pitch), 130, 131 and 7 columns
    and a 1 x 1 grid, on the kernel's tiling, with 3 right-hand sides: the
    scalar path's shapes (999 f64 and 130 f32 are not whole 16-byte
    vectors)."""
    npdt, gate = DTYPES[dtype]
    aj, at, x3 = _inputs(jx, _operator(kind, *grid), grid, cyclic, 3, npdt, seed=5)
    _check(jx, aj, at, x3, layout, gate)
    x = torch.tensor(x3)
    vector = 16 // x.element_size()
    assert spmv.matvec_path(at, x) == ("vector" if grid[1] % vector == 0 else "scalar")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cyclic", [True, False])
def test_tiled_sim_lists_longer_than_a_chunk(jx, cyclic, layout):
    """A random container with more terms than one chunk of the kernel's
    list (256): the list is built and walked a chunk at a time, for each
    register tile of the 9 right-hand sides (8 and 1)."""
    import jax

    jnp, _, jspmv = jx
    aj, at, x3 = _inputs(jx, _operator("random", N, N), (N, N), cyclic, 9, np.float64, seed=4)
    assert len(spmv._term_rows(at.shifts, at.grid, at.cyclic, False)) > spmv._MV_CHUNK
    want = spmv._matmat_plain(at, torch.tensor(x3))
    # under jit: eager JAX compiles each of the ~300 band slices on its own
    if layout == "stacked":
        x = x3
        want_j = jax.jit(lambda d, v: jspmv.grid_dia_matmat_pallas(aj._replace(data=d), v))(
            aj.data, jnp.asarray(x))
    else:
        x = np.ascontiguousarray(np.moveaxis(x3, 0, 1))
        want = want.movedim(0, 1)
        want_j = jax.jit(lambda d, v: jspmv.grid_dia_matmat_interleaved_pallas(
            aj._replace(data=d), v))(aj.data, jnp.asarray(x))
    got = spmv.grid_dia_matmat_tiled_sim(at, torch.tensor(x), layout)
    _close(got, want, 1e-12)
    _close(got, want_j, 1e-12)


# 272 shifts at dy -23..-8, |dx| <= 8, ahead of the 5-point stencil's: 256
# and more terms of the table reach no point of the top tiles (rows 0-7)
DEAD_FIRST_SHIFTS = (tuple((dy, dx) for dy in range(-23, -7) for dx in range(-8, 9))
                     + ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype,grid", [("f32", (24, 132)), ("f64", (24, 99))])
def test_tiled_sim_first_chunk_dead_for_the_top_tiles(jx, dtype, grid, layout):
    """A clamped container whose list holds no live term of the top tiles
    in its first chunk and their whole ones in the second, with 11
    right-hand sides (two register tiles): each tile's list, built a chunk
    at a time, gives the plain version's and the JAX wrapper's product."""
    import jax

    jnp, jsparse, jspmv = jx
    npdt, gate = DTYPES[dtype]
    rng = np.random.default_rng(7)
    data = rng.standard_normal((len(DEAD_FIRST_SHIFTS),) + grid).astype(npdt)
    aj = jsparse.GridDIA(data=jnp.asarray(data), shifts=DEAD_FIRST_SHIFTS, grid=grid,
                         cyclic=False)
    at = convert.griddia_from_jax(data, DEAD_FIRST_SHIFTS, grid, False, CPU)
    x3 = rng.standard_normal((11,) + grid).astype(npdt)
    terms = spmv._term_rows(at.shifts, at.grid, at.cyclic, False)
    first, second = (spmv.grid_dia_block_terms(chunk, at.grid, False, 0, 8, 32, 64)
                     for chunk in (terms[:spmv._MV_CHUNK], terms[spmv._MV_CHUNK:]))
    assert first == [] and any(kind == "whole" and abs(dy) <= 1 and abs(dx) <= 1
                               for kind, _, dy, dx, _ in second)
    want = spmv._matmat_plain(at, torch.tensor(x3))
    wrapper = (jspmv.grid_dia_matmat_pallas if layout == "stacked"
               else jspmv.grid_dia_matmat_interleaved_pallas)
    x = x3 if layout == "stacked" else np.ascontiguousarray(np.moveaxis(x3, 0, 1))
    want = want if layout == "stacked" else want.movedim(0, 1)
    # under jit: eager JAX compiles each of the 277 slices on its own
    want_j = jax.jit(lambda d, v: wrapper(aj._replace(data=d), v))(aj.data, jnp.asarray(x))
    got = spmv.grid_dia_matmat_tiled_sim(at, torch.tensor(x), layout)
    _close(got, want, gate)
    _close(got, want_j, gate)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tiled_sim_empty_matrix_gives_zero(layout):
    a = ts.GridDIA.from_scipy(sp.csr_matrix((N * N, N * N)), (N, N), device="cpu")
    x = torch.tensor(np.random.default_rng(2).standard_normal((3, N, N)))
    x = x if layout == "stacked" else x.movedim(0, 1).contiguous()
    got = spmv.grid_dia_matmat_tiled_sim(a, x, layout)
    assert got.shape == x.shape and not got.isnan().any() and not got.any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["biharmonic", "sh"])
def test_tiled_sim_reads_no_coefficient_outside_the_grid(kind, layout):
    """The rehearsal stores NaN in every coefficient whose source lies
    outside the grid, so a tile that took a partial term for whole, or a
    dead one for live, would give NaN: a clamped container (the biharmonic;
    the far-shift SH one) whose stored zeros there are 1e30 gives the plain
    version's product of the untouched container, bit for bit."""
    grid = (20, 68)
    a = ts.GridDIA.from_scipy(_operator(kind, *grid), grid, device="cpu")
    data = a.data.clone()
    gr, gc = torch.arange(grid[0])[:, None], torch.arange(grid[1])[None, :]
    for k, (dy, dx) in enumerate(a.shifts):
        data[k][(gr + dy < 0) | (gr + dy >= grid[0]) | (gc + dx < 0) | (gc + dx >= grid[1])] = 1e30
    assert int((data == 1e30).sum()) > 0
    b = a._replace(data=data)
    x3 = torch.tensor(np.random.default_rng(3).standard_normal((3,) + grid))
    want = spmv._matmat_plain(a, x3)
    x = x3 if layout == "stacked" else x3.movedim(0, 1).contiguous()
    got = spmv.grid_dia_matmat_tiled_sim(b, x, layout, rows=3, cols=16, rhs_tile=2)
    got = got if layout == "stacked" else got.movedim(1, 0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_block_terms_take_the_row_stride_of_x():
    """In the interleaved layout a row of x lies nrhs * nx elements after
    the one above: a whole term's flat offset is dy * nrhs * nx + dx, and
    the classification is the layout's no more than the SpMV's."""
    ny, nx, nrhs = 32, 384, 5
    a = ts.GridDIA.from_scipy(_operator("sh", ny, nx), (ny, nx), device="cpu")
    terms = spmv._term_rows(a.shifts, a.grid, False, False)
    r0, c0 = 8, 128
    flat = spmv.grid_dia_block_terms(terms, a.grid, False, r0, r0 + 8, c0, c0 + 128)
    inter = spmv.grid_dia_block_terms(terms, a.grid, False, r0, r0 + 8, c0, c0 + 128,
                                      row_stride=nrhs * nx)
    assert [t[:4] for t in inter] == [t[:4] for t in flat] and len(inter) == 13
    assert [xoff for *_, xoff in inter] == [dy * nrhs * nx + dx for _, _, dy, dx, _ in inter]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_general_path_of_the_stack_by_shape_and_alignment(dtype):
    """The far-shift container takes the general kernel in either layout,
    on the vector path where the rows are whole, aligned 16-byte vectors
    and on the scalar path where they are not or the stack is unaligned."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    far = ts.GridDIA.from_scipy(_operator("sh", N, N).astype(npdt), (N, N), device="cpu")
    x = torch.zeros((8, N, N), dtype=dtype)
    for stack in (x, x.movedim(0, 1).contiguous()):
        assert spmv.spmm_path(far, stack) == "general"
        assert spmv.matvec_path(far, stack) == "vector"
    unaligned = torch.zeros(8 * N * N + 1, dtype=dtype)[1:].view(8, N, N)
    assert spmv.matvec_path(far, unaligned) == "scalar"
    odd = ts.GridDIA.from_scipy(_operator("dirichlet", 5, 999).astype(npdt), (5, 999),
                                device="cpu")
    assert spmv.matvec_path(odd, torch.zeros((3, 5, 999), dtype=dtype)) == "scalar"


def test_cuda_only_entry_points_refuse_cpu_tensors():
    """The general kernel, reachable for timing in turns, launches on the
    card or raises."""
    a = ts.GridDIA.from_scipy(_operator("sh", N, N), (N, N), device="cpu")
    x = torch.zeros((2, N, N), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA device"):
        spmv._matmat_general(a, x)


def test_emulated_spmm_equals_the_host_loop():
    """The tiled SpMM's CUDA source, compiled by the host's g++ and run on
    host threads, equals the emulator's one-thread-a-point host loop of
    FMAs in table order bit for bit on its SpMM cases (far-shift, 999-wide f64,
    130-wide f32, 1 x 1, empty, lists of several chunks, a first chunk dead
    for the top tiles ahead of whole terms that read the x window, 1e30
    out-of-grid coefficients; nrhs 1, 3, 8, 11; both layouts and both
    paths).  Its cp.async copies land only at the issuing thread's wait, so
    a read of the window before the wait and the barrier after it fails."""
    if shutil.which("g++") is None:
        pytest.skip("needs the host's g++ to compile the kernel source")
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "emulate_dia_spmv.py"),
                          "--only", "spmm"], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "ALL OK"
    assert sum(line.startswith("spmm ") and line.endswith(" OK") for line in lines) >= 50
