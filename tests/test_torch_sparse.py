"""Port parity: the sparse containers, their assembly helpers and the byte
counts against the JAX package's, on the same seeded numpy inputs, f64 on
the CPU.

Both sides build their containers from the same scipy matrix and sum the
same terms in the same order (``index_add_`` on the CPU adds in index
order, like XLA's CPU scatter), so products agree to 1e-12 of the
result's scale; they are also held against scipy's own product.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from iterative_solvers_tpu.ops import sparse as js
from iterative_solvers_tpu.utils import roofline as jroof
from iterative_solvers_tpu_torch.io import convert
from iterative_solvers_tpu_torch.ops import sparse as ts
from iterative_solvers_tpu_torch.utils import roofline as troof

RNG = np.random.default_rng(5)
SIZE = 48          # rows of the random system (a multiple of the BSR block, 8)
GRID = (6, 8)      # a grid view of it
FORMATS = ["dia", "csr", "coo", "coo_to_csr", "bsr"]


def _close(got, want, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def rand_sparse():
    m = sp.random(SIZE, SIZE, density=0.15, random_state=np.random.RandomState(8),
                  format="csr")
    return (m + sp.identity(SIZE)).tocsr()


def _both(fmt, m):
    """The JAX container and the port's, from the same scipy matrix."""
    if fmt == "dia":
        return js.DIA.from_scipy(m), ts.DIA.from_scipy(m, device="cpu")
    if fmt == "csr":
        return js.CSR.from_scipy(m), ts.CSR.from_scipy(m, device="cpu")
    if fmt == "coo":
        return js.COO.from_scipy(m), ts.COO.from_scipy(m, device="cpu")
    if fmt == "coo_to_csr":
        return (js.COO.from_scipy(m).to_csr(),
                ts.COO.from_scipy(m, device="cpu").to_csr())
    return (js.BSR.from_scipy(m, blocksize=8),
            ts.BSR.from_scipy(m, blocksize=8, device="cpu"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_from_scipy_holds_the_same_arrays(fmt, rand_sparse):
    aj, at = _both(fmt, rand_sparse)
    assert type(at).__name__ == type(aj).__name__ and at._fields == aj._fields
    for name in aj._fields:
        vj, vt = getattr(aj, name), getattr(at, name)
        if isinstance(vt, torch.Tensor):
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        else:
            assert vt == vj


@pytest.mark.parametrize("fmt", FORMATS)
def test_spmv_matches_jax_and_scipy(fmt, rand_sparse):
    aj, at = _both(fmt, rand_sparse)
    x = RNG.standard_normal(SIZE)
    got = at.matvec(torch.tensor(x)).reshape(-1)
    _close(got, np.asarray(aj.matvec(jnp.asarray(x))).reshape(-1))
    _close(got, rand_sparse @ x)


@pytest.mark.parametrize("fmt", ["dia", "csr", "coo_to_csr", "bsr"])
def test_spmm_matches_jax_and_scipy(fmt, rand_sparse):
    aj, at = _both(fmt, rand_sparse)
    X = RNG.standard_normal((SIZE, 7))
    got = at.matmat(torch.tensor(X))
    _close(got, aj.matmat(jnp.asarray(X)))
    _close(got, rand_sparse @ X)


def test_csr_matvec_keeps_a_field_shape_and_nnz(rand_sparse):
    a = ts.CSR.from_scipy(rand_sparse, device="cpu")
    x = torch.tensor(RNG.standard_normal(GRID))
    assert a.matvec(x).shape == GRID
    assert a.nnz == rand_sparse.nnz


def test_coo_to_csr_sorts_stably():
    """Duplicate (row, col) entries keep their order, so the per-row sums
    add in the order the COO lists them."""
    row = np.array([2, 0, 2, 1, 0, 2])
    col = np.array([1, 0, 1, 2, 0, 0])
    val = np.array([1e16, 1.0, -1e16, 3.0, 2.0, 5.0])
    m = sp.coo_matrix((val, (row, col)), shape=(3, 3))
    cj = js.COO(jnp.asarray(val), jnp.asarray(row), jnp.asarray(col), (3, 3)).to_csr()
    ct = convert.coo_from_jax(val, row, col, (3, 3), "cpu").to_csr()
    np.testing.assert_array_equal(ct.data.numpy(), np.asarray(cj.data))
    np.testing.assert_array_equal(ct.indices.numpy(), np.asarray(cj.indices))
    np.testing.assert_array_equal(ct.rows.numpy(), [0, 0, 1, 2, 2, 2])
    x = np.array([1.0, 1.0, 1.0])
    np.testing.assert_array_equal(ct.matvec(torch.tensor(x)).numpy(), m.toarray() @ x)


# -- GridDIA -------------------------------------------------------------------

def _grid_matrix(kind):
    if kind == "sh12":
        return js.sh_operator(12, 0.7, 0.01), (12, 12)
    if kind == "sh16":
        return js.sh_operator(16, 0.7, 0.01), (16, 16)
    if kind == "rect":
        ny, nx = 9, 14
        lx = sp.diags([np.ones(nx - 1), -2 * np.ones(nx), np.ones(nx - 1)], [-1, 0, 1])
        ly = sp.diags([np.ones(ny - 1), -2 * np.ones(ny), np.ones(ny - 1)], [-1, 0, 1])
        return (sp.kron(sp.identity(ny), lx) + sp.kron(ly, sp.identity(nx))).tocsr(), (ny, nx)
    if kind == "random":  # the corner entry keeps scipy's DIA data n columns wide
        m = sp.random(256, 256, density=0.002, random_state=3, format="lil")
        m[255, 255] = 1.0
        return m.tocsr(), (16, 16)
    if kind == "empty":
        return sp.csr_matrix((30, 30)), (5, 6)
    raise KeyError(kind)


GRID_CASES = [("sh12", False), ("sh16", True), ("rect", False), ("rect", True),
              ("random", False), ("random", True), ("empty", False), ("empty", True)]


@pytest.mark.parametrize("kind,cyclic", GRID_CASES)
def test_grid_dia_matches_jax_and_scipy(kind, cyclic):
    m, grid = _grid_matrix(kind)
    aj = js.GridDIA.from_scipy(m, grid, cyclic=cyclic)
    at = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device="cpu")
    assert at.shifts == aj.shifts and at.grid == aj.grid and at.cyclic == aj.cyclic
    np.testing.assert_array_equal(at.data.numpy(), np.asarray(aj.data))
    assert at.nnz == aj.nnz == m.nnz
    n = grid[0] * grid[1]
    x = RNG.standard_normal(n)
    got = at.matvec(torch.tensor(x))
    _close(got, aj.matvec(jnp.asarray(x)))
    _close(got, m @ x)
    X = RNG.standard_normal((n, 5))
    gotm = at.matmat(torch.tensor(X))
    _close(gotm, aj.matmat(jnp.asarray(X)))
    _close(gotm, m @ X)
    # a (ny, nx) field comes back in its shape
    assert at.matvec(torch.tensor(x.reshape(grid))).shape == grid


def test_from_scipy_takes_a_matrix_whose_last_columns_are_empty():
    """scipy's DIA data is only as wide as the last occupied column."""
    m = sp.csr_matrix(([1.0, 2.0, 3.0], ([0, 3, 7], [1, 0, 2])), shape=(12, 12))
    assert m.todia().data.shape[1] < 12
    x = RNG.standard_normal(12)
    for a in (ts.DIA.from_scipy(m, device="cpu"),
              ts.GridDIA.from_scipy(m, (3, 4), device="cpu")):
        _close(a.matvec(torch.tensor(x)), m @ x)


def test_grid_dia_cyclic_stores_the_minimal_fields():
    m, grid = _grid_matrix("sh16")
    a = ts.GridDIA.from_scipy(m, grid, cyclic=True, device="cpu")
    assert len(a.shifts) == 13
    assert max(abs(dy) for dy, _ in a.shifts) == 2
    clamped = ts.GridDIA.from_scipy(m, grid, device="cpu")
    assert len(clamped.shifts) > 13  # the wrap residues are fields of their own
    assert max(abs(dy) for dy, _ in clamped.shifts) >= 14


def test_grid_dia_far_terms_follow_the_near_ones():
    """``term_order`` is the order of summation the kernels reproduce."""
    m, grid = _grid_matrix("sh16")
    for cyclic in (False, True):
        a = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device="cpu")
        near, far = ts.term_order(a.shifts, a.cyclic)
        assert sorted(k for k, _, _ in near + far) == list(range(len(a.shifts)))
        assert all(abs(dx) <= 8 for _, _, dx in near)
        assert all(abs(dx) > 8 or (cyclic and abs(dy) > 8) for _, dy, dx in far)
    assert far == []  # the cyclic 13-point operator has no far term


# -- assembly ------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("laplacian_5pt_periodic", (12, 0.7)), ("sh_operator", (12, 0.7, 0.01)),
    ("biharmonic_dirichlet", (13, 0.5)), ("laplacian_5pt_dirichlet", (13, 0.5))])
def test_assembly_matches_jax_package(name, args):
    got, want = getattr(ts, name)(*args), getattr(js, name)(*args)
    assert got.shape == want.shape and got.format == want.format == "csr"
    assert abs(got - want).max() == 0.0


def test_assembly_matches_reference_oracles():
    from tests.reference_oracles import periodic_laplacian, sh_L

    n, h, r = 12, 0.7, 0.01
    np.testing.assert_allclose(ts.laplacian_5pt_periodic(n, h).toarray(),
                               periodic_laplacian(n, h).toarray(), atol=1e-13)
    np.testing.assert_allclose(ts.sh_operator(n, h, r).toarray(),
                               sh_L(n, h, r).toarray(), atol=1e-11)


def test_dia_spmv_of_the_assembled_sh_operator_is_the_stencil():
    from iterative_solvers_tpu_torch.ops.stencils import sh_linear_operator

    n, h, r = 16, 40.0 / 16, 0.01
    a = ts.DIA.from_scipy(ts.sh_operator(n, h, r), device="cpu")
    u = torch.tensor(RNG.standard_normal((n, n)))
    np.testing.assert_allclose(a.matvec(u).numpy(), sh_linear_operator(u, h, r).numpy(),
                               atol=1e-10)


# -- devices, dtypes, conversion, byte counts -------------------------------------

@pytest.mark.parametrize("fmt", ["dia", "csr", "coo", "bsr", "griddia"])
def test_from_scipy_defaults_to_the_card_and_keeps_the_dtype(fmt, rand_sparse):
    m = rand_sparse.astype(np.float32)
    build = {"dia": ts.DIA.from_scipy, "csr": ts.CSR.from_scipy,
             "coo": ts.COO.from_scipy,
             "bsr": lambda m, **kw: ts.BSR.from_scipy(m, 8, **kw),
             "griddia": lambda m, **kw: ts.GridDIA.from_scipy(m, GRID, **kw)}[fmt]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(m)
    a = build(m, device="cpu")
    assert a.data.dtype == torch.float32 and a.data.device.type == "cpu"
    x = RNG.standard_normal(SIZE).astype(np.float32)
    _close(a.matvec(torch.tensor(x)).reshape(-1), m @ x, rel=1e-5)


def test_convert_builds_the_same_containers(rand_sparse):
    m = rand_sparse
    x = torch.tensor(RNG.standard_normal(SIZE))
    pairs = []
    d = js.DIA.from_scipy(m)
    pairs.append((convert.dia_from_jax(np.asarray(d.data), d.offsets, d.n, "cpu"),
                  ts.DIA.from_scipy(m, device="cpu")))
    c = js.CSR.from_scipy(m)
    pairs.append((convert.csr_from_jax(np.asarray(c.data), np.asarray(c.indices),
                                       np.asarray(c.rows), c.shape, "cpu"),
                  ts.CSR.from_scipy(m, device="cpu")))
    b = js.BSR.from_scipy(m, 8)
    pairs.append((convert.bsr_from_jax(np.asarray(b.data), np.asarray(b.indices),
                                       np.asarray(b.rows), b.shape, b.blocksize, "cpu"),
                  ts.BSR.from_scipy(m, 8, device="cpu")))
    g = js.GridDIA.from_scipy(m, GRID, cyclic=True)
    pairs.append((convert.griddia_from_jax(np.asarray(g.data), g.shifts, g.grid,
                                           g.cyclic, "cpu"),
                  ts.GridDIA.from_scipy(m, GRID, cyclic=True, device="cpu")))
    for got, want in pairs:
        assert type(got) is type(want)
        np.testing.assert_array_equal(got.matvec(x).numpy(), want.matvec(x).numpy())


def test_byte_counts():
    """The format-ideal counts are the JAX package's; the kernel count is
    the coefficients whose source lies in the grid plus 2 nrhs fields,
    without the TPU slab's halo overlap."""
    assert troof.stencil_cost((64, 48), 4, points=13) == \
        troof.KernelCost(**vars(jroof.stencil_cost((64, 48), 4, points=13)))
    for fmt in ("csr", "dia"):
        want = jroof.spmv_cost(1000, 100, 100, 8, fmt=fmt)
        got = troof.spmv_cost(1000, 100, 100, 8, fmt=fmt)
        assert (got.bytes_moved, got.flops) == (want.bytes_moved, want.flops)
    shifts13 = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
                if abs(dy) + abs(dx) <= 2]
    c = troof.spmv_kernel_cost(shifts13, 1024, 1024, 4, cyclic=True)
    assert c.bytes_moved == 15 * 4 * 1024 * 1024 and c.flops == 2 * 13 * 1024 * 1024
    c8 = troof.spmv_kernel_cost(shifts13, 2048, 2048, 4, nrhs=8, cyclic=True)
    assert c8.bytes_moved == (13 + 16) * 4 * 2048 * 2048
    # a clamped shift needs only the points whose source lies in the grid,
    # a flat offset the n - |off| entries of its diagonal
    assert troof.coefficients_read([(0, 0), (1, 0), (0, -3), (9, 0), (-8, 13)], 9, 14) \
        == 9 * 14 + 8 * 14 + 9 * 11 + 0 + 1 * 1
    assert troof.coefficients_read([0, 1, -14, 125, 200], 9, 14) == 126 + 125 + 112 + 1 + 0
    cd = troof.spmv_kernel_cost([(0, 0), (-1, 0), (0, 1)], 9, 14, 8)
    assert cd.bytes_moved == (126 + 112 + 117 + 2 * 126) * 8
    assert cd.flops == 2 * (126 + 112 + 117)
    ms, by = c.bound_ms(3.35e12, 67e12)
    assert by == "bytes" and abs(ms - 62914560 / 3.35e12 * 1e3) < 1e-12
    assert abs(c.roofline_fraction(1e-3, 100.0) - c.achieved_gbps(1e-3) / 100.0) < 1e-12
