"""CPU rehearsal of the row-slab SpMM kernel's data movement, and the
choice between the SpMM kernels.

``grid_dia_matmat_slab_sim`` builds ``Y = A X`` strip by strip and slab by
slab from what the slab kernel stages (the coefficient chunk; the x slab
with the halo rows its terms reach and one halo vector each side, wrapped
or zero-filled, the top halo rows of a slab taken from the previous slab's;
NaN for what is not staged), including the ragged last strip and slab.  It
is held against the plain version (``_matmat_plain``) and against the JAX
package's ``grid_dia_matmat_pallas`` / ``grid_dia_matmat_interleaved_pallas``
(off the TPU their per-rhs ``_apply``) on the same seeded numpy inputs:
1e-5 of max|Y| in f32, 1e-12 in f64 (measured against the plain version:
0, the same products summed in the same order).

``spmm_path`` is checked by shape, terms and alignment: the far-shift
clamped SH container, widths that are not whole 16-byte vectors, unaligned
stacks and stages too large for a block go to the general kernel.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from iterative_solvers_tpu_torch.io import convert
from iterative_solvers_tpu_torch.ops import sparse as ts
from iterative_solvers_tpu_torch.ops import spmv

CPU = torch.device("cpu")


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
    5-point Laplacian and biharmonic (h = 2)."""
    periodic = kind in ("sh", "lap")
    h = 0.7 if periodic else 2.0
    lap = (sp.kron(sp.identity(ny), _second_difference(nx, periodic))
           + sp.kron(_second_difference(ny, periodic), sp.identity(nx))) / (h * h)
    if kind == "sh":
        return (-(lap @ lap) - 2.0 * lap + (0.01 - 1.0) * sp.identity(ny * nx)).tocsr()
    if kind == "biharmonic":
        return (lap @ lap).tocsr()
    return lap.tocsr()


# operator, cyclic container
OPERATORS = [("sh", True), ("lap", True), ("dirichlet", False), ("biharmonic", False)]
# grid, right-hand sides, (strip columns W, slab rows B, staged halo rows Hy):
# the kernel's tilings (64 x 8 f32, 32 x 8 f64) and small ones that make
# many strips and slabs with ragged last ones, a staged halo deeper than
# the reach, a tile of 8 rhs and one past it
CASES = [((24, 24), 1, (64, 8, 2)), ((24, 24), 3, (8, 3, 2)),
         ((40, 36), 8, (16, 5, 3)), ((37, 132), 11, (32, 8, 2)),
         ((37, 132), 8, (64, 16, 8))]
DTYPES = {"f32": (np.float32, 1e-5), "f64": (np.float64, 1e-12)}


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert not np.isnan(got).any(), "a staged window misses a tap"
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("layout", ["stacked", "interleaved"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid,nrhs,tiling", CASES)
@pytest.mark.parametrize("kind,cyclic", OPERATORS)
def test_slab_sim_matches_plain_and_jax(jx, kind, cyclic, grid, nrhs, tiling, dtype, layout):
    jnp, jsparse, jspmv = jx
    npdt, gate = DTYPES[dtype]
    m = _operator(kind, *grid)
    aj = jsparse.GridDIA.from_scipy(m, grid, cyclic=cyclic)
    rng = np.random.default_rng(11)
    # random coefficients everywhere, the stored zeros outside the grid too:
    # a clamped source outside the grid must add nothing whatever d is
    data = rng.standard_normal(np.asarray(aj.data).shape).astype(npdt)
    aj = aj._replace(data=jnp.asarray(data))
    at = convert.griddia_from_jax(data, aj.shifts, aj.grid, aj.cyclic, CPU)
    x3 = rng.standard_normal((nrhs,) + grid).astype(npdt)
    W, B, Hy = tiling
    Hx = 16 // np.dtype(npdt).itemsize
    if layout == "stacked":
        x = x3
        want_j = jspmv.grid_dia_matmat_pallas(aj, jnp.asarray(x))
        want = spmv._matmat_plain(at, torch.tensor(x3))
    else:
        x = np.ascontiguousarray(np.moveaxis(x3, 0, 1))
        want_j = jspmv.grid_dia_matmat_interleaved_pallas(aj, jnp.asarray(x))
        want = spmv._matmat_plain(at, torch.tensor(x3)).movedim(0, 1)
    got = spmv.grid_dia_matmat_slab_sim(at, torch.tensor(x), layout, W=W, B=B, Hy=Hy, Hx=Hx)
    assert got.shape == x.shape and got.dtype == want.dtype
    _close(got, want, gate)
    _close(got, want_j, gate)
    assert spmv.spmm_path(at, torch.tensor(x)) == "slab"


def test_slab_sim_refuses_a_reach_past_its_halo():
    m = ts.sh_operator(24, 0.7, 0.01)
    a = ts.GridDIA.from_scipy(m, (24, 24), cyclic=False, device="cpu")  # |dy| up to 23
    x = torch.zeros((2, 24, 24), dtype=torch.float64)
    with pytest.raises(ValueError, match="reach"):
        spmv.grid_dia_matmat_slab_sim(a, x, Hx=2)
    with pytest.raises(ValueError):
        spmv.grid_dia_matmat_slab_sim(a._replace(cyclic=True), x, Hy=1, Hx=2)


def _container(kind, grid, cyclic, dtype=torch.float32):
    return ts.GridDIA.from_scipy(_operator(kind, *grid).astype(
        np.float32 if dtype == torch.float32 else np.float64), grid, cyclic=cyclic,
        device="cpu")


def _unaligned(shape, dtype):
    """A contiguous tensor whose first element is not 16-byte aligned."""
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:]
    assert flat.data_ptr() % 16
    return flat.view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmm_path_by_shape_terms_and_alignment(dtype):
    a = _container("sh", (24, 24), True, dtype)
    x = torch.zeros((8, 24, 24), dtype=dtype)
    assert spmv.spmm_path(a, x) == "slab"
    assert spmv.spmm_path(a, x.movedim(0, 1).contiguous()) == "slab"  # interleaved
    assert spmv.spmm_path(a, x[:1]) == "slab"
    # the far-shift clamped SH container (|dy| up to ny - 1): general
    far = ts.GridDIA.from_scipy(ts.sh_operator(24, 0.7, 0.01).astype(
        np.float32 if dtype == torch.float32 else np.float64), (24, 24), device="cpu")
    assert max(abs(dy) for dy, _ in far.shifts) == 23
    assert spmv.spmm_path(far, x) == "general"
    # unaligned stacks or coefficients: general
    assert spmv.spmm_path(a, _unaligned(x.shape, dtype)) == "general"
    assert spmv.spmm_path(a._replace(data=_unaligned(a.data.shape, dtype)), x) == "general"
    # stages past a block's shared memory: general
    assert spmv.spmm_path(a, torch.zeros((200, 24, 24), dtype=dtype)) == "general"
    # a dtype the kernels do not take, or one that differs from the matrix's
    assert spmv.spmm_path(a._replace(data=a.data.half()), x.half()) == "general"
    assert spmv.spmm_path(a, x.to(torch.float64 if dtype == torch.float32
                                  else torch.float32)) == "general"


def test_spmm_path_needs_rows_of_whole_vectors():
    # 22 columns: 5.5 f32 vectors, 11 f64 ones
    a32 = _container("lap", (24, 22), True, torch.float32)
    a64 = _container("lap", (24, 22), True, torch.float64)
    assert spmv.spmm_path(a32, torch.zeros((3, 24, 22))) == "general"
    assert spmv.spmm_path(a64, torch.zeros((3, 24, 22), dtype=torch.float64)) == "slab"


@pytest.mark.parametrize("dtype,dx,path", [(torch.float32, 4, "slab"),
                                           (torch.float32, 5, "general"),
                                           (torch.float64, 2, "slab"),
                                           (torch.float64, 3, "general")])
def test_spmm_path_by_column_reach(dtype, dx, path):
    """One halo vector each side: 4 f32 or 2 f64 columns of reach."""
    a = ts.GridDIA(data=torch.ones((2, 16, 16), dtype=dtype), shifts=((0, 0), (0, -dx)),
                   grid=(16, 16))
    assert spmv.spmm_path(a, torch.zeros((2, 16, 16), dtype=dtype)) == path


@pytest.mark.parametrize("dy,path", [(8, "slab"), (9, "general")])
def test_spmm_path_by_row_reach(dy, path):
    a = ts.GridDIA(data=torch.ones((2, 24, 16)), shifts=((0, 0), (dy, 1)), grid=(24, 16))
    assert spmv.spmm_path(a, torch.zeros((2, 24, 16))) == path


def test_slab_terms_are_signed_and_in_the_order_of_apply():
    """Cyclic shifts stored as residues (a shift of nx - 1 is one to the
    left) are taken in (-n/2, n/2]; the table keeps _apply's order (near
    terms, then far), and clamped terms that reach no point leave it."""
    a = ts.GridDIA(data=torch.ones((4, 8, 12), dtype=torch.float64),
                   shifts=((0, 11), (1, 0), (7, 0), (0, 6)), grid=(8, 12), cyclic=True)
    rows, hy, hx = spmv._slab_rows(a.shifts, a.grid, a.cyclic)
    assert rows == ((1, 1, 0), (2, -1, 0), (3, 0, 6), (0, 0, -1))
    assert (hy, hx) == (1, 6)
    assert spmv._slab_terms(a.shifts, a.grid, a.cyclic, CPU).tolist() == [list(r) for r in rows]
    x = torch.tensor(np.random.default_rng(2).standard_normal((3, 8, 12)))
    a2 = a._replace(shifts=((0, 11), (1, 0), (7, 0), (0, 2)))
    _close(spmv.grid_dia_matmat_slab_sim(a2, x, W=4, B=3, Hy=1, Hx=2),
           spmv._matmat_plain(a2, x), 1e-12)
    clamped = ts.GridDIA(data=torch.ones((3, 4, 8)), shifts=((0, 1), (4, 0), (0, -8)),
                         grid=(4, 8))
    assert spmv._slab_rows(clamped.shifts, clamped.grid, False) == (((0, 0, 1),), 0, 1)
