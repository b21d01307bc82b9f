"""Port parity: the four diagonal-format SpMV / SpMM wrappers.

On the CPU the wrappers run their plain versions (``GridDIA._apply``,
``DIA.matvec``, the per-rhs stack).  They are held against the JAX
wrappers, which off the TPU take their XLA fallback, on the same seeded
f64 inputs (same terms in the same order: 1e-12 of the result's scale),
and against scipy.  The term tables that the CUDA kernels read are checked
here too, by a numpy emulation of the kernels' index logic.

The ``gpu``-marked tests hold each CUDA kernel against its plain version
on the card, at every row shape of the smoke run's kernel phase (f32 to
1e-5 of max|plain|, f64 to 1e-12: the kernels contract multiply-add into
FMA, the plain versions do not), the tiled SpMV's two paths against each
other (bit for bit, on far-shift, odd-width and many-term containers and
1e30 coefficients where a source lies outside the grid), the tiled
(general) SpMM against a host loop of correctly rounded FMAs over the same
term table in table order (bit for bit, on both of its paths and both
layouts, nrhs 1, 3, 8, 11, 1e30 out-of-grid coefficients included), and
the two SpMM kernels (the
row-slab and the general one) against each other at shapes that take each
path:
``python -m pytest --noconftest -m gpu tests/test_torch_spmv.py``
(the JAX side is imported inside the ``jx`` fixture, so those tests also
run on a machine that has the port and no JAX).
"""
from functools import lru_cache

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from iterative_solvers_tpu_torch.io import convert
from iterative_solvers_tpu_torch.ops import sparse as ts
from iterative_solvers_tpu_torch.ops import spmv
from iterative_solvers_tpu_torch.ops._build import launch_count, reset_launch_counts

N = 24
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.ops import pallas_spmv, sparse

    return jnp, sparse, pallas_spmv


def _rand(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, want, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def _matrix(kind, density=0.0002):
    if kind == "sh":
        return ts.sh_operator(N, 0.7, 0.01), (N, N)
    if kind == "dirichlet":
        return ts.laplacian_5pt_dirichlet(N + 1, 2.0), (N, N)
    if kind == "biharmonic":
        return ts.biharmonic_dirichlet(N + 1, 2.0), (N, N)
    if kind == "rect":  # 9 x 14 Dirichlet Laplacian, no wraps
        ny, nx = 9, 14
        lx = sp.diags([np.ones(nx - 1), -2 * np.ones(nx), np.ones(nx - 1)], [-1, 0, 1])
        ly = sp.diags([np.ones(ny - 1), -2 * np.ones(ny), np.ones(ny - 1)], [-1, 0, 1])
        return (sp.kron(sp.identity(ny), lx) + sp.kron(ly, sp.identity(nx))).tocsr(), (ny, nx)
    if kind == "random":  # one shift per entry: ~65 here, ~650 at density 0.002
        return sp.random(N * N, N * N, density=density, random_state=3, format="csr"), (N, N)
    raise KeyError(kind)


GRID_CASES = [("sh", True), ("sh", False), ("dirichlet", False), ("biharmonic", False),
              ("rect", False), ("random", True), ("random", False)]


@pytest.mark.parametrize("kind,cyclic", GRID_CASES)
def test_grid_dia_matvec_matches_jax_and_scipy(jx, kind, cyclic):
    jnp, jsparse, jspmv = jx
    m, grid = _matrix(kind)
    x = _rand(grid)
    aj = jsparse.GridDIA.from_scipy(m, grid, cyclic=cyclic)
    at = convert.griddia_from_jax(np.asarray(aj.data), aj.shifts, aj.grid, aj.cyclic, CPU)
    got = spmv.grid_dia_matvec(at, torch.tensor(x))
    _close(got, jspmv.grid_dia_matvec_pallas(aj, jnp.asarray(x)))
    _close(got.reshape(-1), m @ x.reshape(-1))


@pytest.mark.parametrize("kind", ["sh", "dirichlet", "biharmonic", "random"])
def test_dia_flat_matvec_matches_jax_and_scipy(jx, kind):
    jnp, jsparse, jspmv = jx
    m, grid = _matrix(kind)
    x = _rand(grid[0] * grid[1])
    aj = jsparse.DIA.from_scipy(m)
    at = convert.dia_from_jax(np.asarray(aj.data), aj.offsets, aj.n, CPU)
    got = spmv.dia_flat_matvec(at, grid, torch.tensor(x))
    _close(got, jspmv.dia_flat_matvec_pallas(aj, grid, jnp.asarray(x)))
    _close(got, m @ x)
    # any shape holding n values is taken, and comes back
    got2 = spmv.dia_flat_matvec(at, grid, torch.tensor(x.reshape(grid)))
    assert got2.shape == grid
    np.testing.assert_array_equal(got2.reshape(-1).numpy(), got.numpy())


@pytest.mark.parametrize("cyclic", [True, False])
@pytest.mark.parametrize("layout", ["stacked", "interleaved"])
def test_grid_dia_matmat_matches_jax_and_scipy(jx, layout, cyclic):
    jnp, jsparse, jspmv = jx
    m, grid = _matrix("sh")
    X = _rand((3, N * N))
    want = (m @ X.T).T.reshape(3, N, N)
    aj = jsparse.GridDIA.from_scipy(m, grid, cyclic=cyclic)
    at = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device="cpu")
    x3 = X.reshape(3, N, N)
    if layout == "stacked":
        got = spmv.grid_dia_matmat(at, torch.tensor(x3))
        wantj = jspmv.grid_dia_matmat_pallas(aj, jnp.asarray(x3))
    else:
        xi = np.ascontiguousarray(np.moveaxis(x3, 0, 1))
        got = spmv.grid_dia_matmat_interleaved(at, torch.tensor(xi))
        wantj = jspmv.grid_dia_matmat_interleaved_pallas(aj, jnp.asarray(xi))
        want = np.moveaxis(want, 0, 1)
    _close(got, wantj)
    _close(got, want)


def test_out_of_grid_terms_add_nothing_whatever_the_coefficient():
    """The plain versions slice and zero-pad, so a container whose stored
    zeros are overwritten with any finite value gives the same product."""
    m, grid = _matrix("dirichlet")
    x = torch.tensor(_rand(grid))
    a = ts.GridDIA.from_scipy(m, grid, device="cpu")
    want = spmv.grid_dia_matvec(a, x)
    data = a.data.clone()
    for k, (dy, dx) in enumerate(a.shifts):  # overwrite what no in-grid source reads
        rows = torch.arange(grid[0])[:, None] + dy
        cols = torch.arange(grid[1])[None, :] + dx
        outside = (rows < 0) | (rows >= grid[0]) | (cols < 0) | (cols >= grid[1])
        data[k][outside] = 1e30
    got = spmv.grid_dia_matvec(a._replace(data=data), x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    d = ts.DIA.from_scipy(m, device="cpu")
    dd = d.data.clone()
    idx = torch.arange(d.n)
    for k, off in enumerate(d.offsets):
        dd[k][(idx + off < 0) | (idx + off >= d.n)] = 1e30
    np.testing.assert_array_equal(
        spmv.dia_flat_matvec(d._replace(data=dd), grid, x).numpy(),
        spmv.dia_flat_matvec(d, grid, x).numpy())


def test_empty_matrix_gives_zero():
    a = ts.GridDIA.from_scipy(sp.csr_matrix((N * N, N * N)), (N, N), device="cpu")
    assert a.shifts == () and a.data.shape == (0, N, N) and a.nnz == 0
    x = torch.tensor(_rand((N, N)))
    assert not spmv.grid_dia_matvec(a, x).any()
    assert not spmv.grid_dia_matmat(a, x[None]).any()
    assert spmv._grid_terms(a.shifts, a.grid, a.cyclic, CPU).shape == (0, 3)


# -- the tables the kernels read -------------------------------------------------

def _emulate_grid_kernel(a, x, terms):
    """The CUDA kernels' index logic in numpy, from the int32 term table."""
    ny, nx = a.grid
    r, c = np.arange(ny)[:, None], np.arange(nx)[None, :]
    y = np.zeros((ny, nx))
    data = a.data.numpy()
    for k, dy, dx in terms.numpy():
        rr, cc = r + dy, c + dx
        if a.cyclic:
            assert 0 <= dy < ny and 0 <= dx < nx
            rr, cc = np.where(rr >= ny, rr - ny, rr), np.where(cc >= nx, cc - nx, cc)
            ok = np.ones((ny, nx), bool)
        else:
            ok = (rr >= 0) & (rr < ny) & (cc >= 0) & (cc < nx)
        src = x[np.clip(rr, 0, ny - 1), np.clip(cc, 0, nx - 1)]
        y += np.where(ok, data[k] * src, 0.0)
    return y


@pytest.mark.parametrize("kind,cyclic", GRID_CASES)
def test_grid_term_table_reproduces_the_plain_version(kind, cyclic):
    m, grid = _matrix(kind)
    a = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device="cpu")
    # random coefficients everywhere: only the index logic can make them agree
    a = a._replace(data=torch.tensor(_rand(tuple(a.data.shape), seed=9)))
    terms = spmv._grid_terms(a.shifts, a.grid, a.cyclic, CPU)
    assert terms.dtype == torch.int32 and terms.shape[1] == 3
    x = _rand(grid)
    _close(_emulate_grid_kernel(a, x, terms), a._apply(torch.tensor(x)))
    # the table follows _apply's order of summation: near terms, then far
    near, far = ts.term_order(a.shifts, a.cyclic)
    order = [k for k, _, _ in near + far]
    assert [k for k in order if k in set(terms[:, 0].tolist())] == terms[:, 0].tolist()


@pytest.mark.parametrize("kind", ["sh", "dirichlet", "random"])
def test_flat_term_table_reproduces_the_plain_version(kind):
    m, grid = _matrix(kind)
    a = ts.DIA.from_scipy(m, device="cpu")
    a = a._replace(data=torch.tensor(_rand(tuple(a.data.shape), seed=9)))
    terms = spmv._flat_terms(a.offsets, a.n, CPU)
    assert terms.dtype == torch.int32 and terms.shape[1] == 2
    x = _rand(a.n)
    i = np.arange(a.n)
    y = np.zeros(a.n)
    for k, off in terms.numpy():
        j = i + off
        ok = (j >= 0) & (j < a.n)
        y += np.where(ok, a.data[k].numpy() * x[np.clip(j, 0, a.n - 1)], 0.0)
    _close(y, a.matvec(torch.tensor(x)))


def test_far_clamped_terms_that_reach_no_point_leave_the_table():
    a = ts.GridDIA(data=torch.ones(3, 4, 5, dtype=torch.float64),
                   shifts=((0, 1), (4, 0), (0, -5)), grid=(4, 5))
    assert spmv._grid_terms(a.shifts, a.grid, False, CPU).tolist() == [[0, 0, 1]]
    x = torch.tensor(_rand((4, 5)))
    want = torch.zeros_like(x)
    want[:, :-1] = x[:, 1:]
    np.testing.assert_array_equal(spmv.grid_dia_matvec(a, x).numpy(), want.numpy())
    d = ts.DIA(data=torch.ones(2, 6, dtype=torch.float64), offsets=(-6, 2), n=6)
    assert spmv._flat_terms(d.offsets, d.n, CPU).tolist() == [[1, 2]]


# -- what the wrappers refuse ----------------------------------------------------

def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    m, grid = _matrix("sh")
    a = ts.GridDIA.from_scipy(m, grid, cyclic=True, device="cpu")
    d = ts.DIA.from_scipy(m, device="cpu")
    x = torch.tensor(_rand(grid))
    reset_launch_counts()
    got = spmv.grid_dia_matvec(a, x)
    spmv.dia_flat_matvec(d, grid, x)
    spmv.grid_dia_matmat(a, x[None])
    spmv.grid_dia_matmat_interleaved(a, x[:, None, :])
    assert all(launch_count(k, dtype=d) == 0 for d in ("f32", "f64")
               for k in ("grid_dia_matvec", "dia_flat_matvec", "grid_dia_matmat",
                         "grid_dia_matmat_interleaved"))
    np.testing.assert_array_equal(got.numpy(), a._apply(x).numpy())


@pytest.mark.parametrize("wrapper", ["grid_dia_matvec", "dia_flat_matvec",
                                     "grid_dia_matmat", "grid_dia_matmat_interleaved"])
def test_wrappers_raise_on_dtype_and_shape_mismatch(wrapper):
    m, grid = _matrix("sh")
    a = ts.GridDIA.from_scipy(m, grid, cyclic=True, device="cpu")
    d = ts.DIA.from_scipy(m, device="cpu")
    x = torch.tensor(_rand(grid))
    call = {
        "grid_dia_matvec": lambda v: spmv.grid_dia_matvec(a, v),
        "dia_flat_matvec": lambda v: spmv.dia_flat_matvec(d, grid, v),
        "grid_dia_matmat": lambda v: spmv.grid_dia_matmat(a, v[None]),
        "grid_dia_matmat_interleaved":
            lambda v: spmv.grid_dia_matmat_interleaved(a, v[:, None, :]),
    }[wrapper]
    call(x)
    with pytest.raises(TypeError):
        call(x.float())
    with pytest.raises(ValueError):
        call(x[:, :-1])
    if wrapper == "dia_flat_matvec":
        with pytest.raises(ValueError):
            spmv.dia_flat_matvec(d, (N, N + 1), x)


def test_launch_refuses_cpu_tensor_and_autodiff():
    a = ts.GridDIA.from_scipy(_matrix("sh")[0], (N, N), device="cpu")
    x = torch.tensor(_rand((N, N)))
    with pytest.raises(ValueError, match="CUDA device"):
        spmv._check("grid_dia_matvec", a.data, x)

    def f(v):
        spmv._check("grid_dia_matvec", a.data, v)
        return v

    with pytest.raises(RuntimeError, match="no derivative rule"):
        torch.func.jvp(f, (x,), (x,))


# -- on the card -------------------------------------------------------------------

H_BENCH = float(np.sqrt(8.0))  # |L| <= 0.5: the kernel bench's contraction


@lru_cache(maxsize=4)
def _bench_matrix(kind, n):
    """The kernel bench's operators: periodic SH at h = sqrt(8), r = 0.5;
    the Dirichlet ones at h = 2 scaled by 0.2; the Poisson 999^2 operator."""
    if kind == "sh":
        return ts.sh_operator(n, H_BENCH, 0.5)
    if kind == "dirichlet":
        return ts.laplacian_5pt_dirichlet(n + 1, 2.0) * 0.2
    if kind == "biharmonic":
        return ts.biharmonic_dirichlet(n + 1, 2.0) * 0.2
    if kind == "poisson":
        return ts.laplacian_5pt_dirichlet(n + 1, 1.0 / (n + 1))
    raise KeyError(kind)


# (operator, grid, cyclic, dtype): the rows of the smoke run's kernel phase
GRID_GPU_CASES = {
    "sh_cyclic_1024_f32": ("sh", (1024, 1024), True, torch.float32),
    "sh_cyclic_2048_f32": ("sh", (2048, 2048), True, torch.float32),
    "sh_cyclic_1024_f64": ("sh", (1024, 1024), True, torch.float64),
    "sh_clamped_1024_f32": ("sh", (1024, 1024), False, torch.float32),
    "dirichlet_1024_f32": ("dirichlet", (1024, 1024), False, torch.float32),
    "dirichlet_4096_f32": ("dirichlet", (4096, 4096), False, torch.float32),
    "poisson_999_f64": ("poisson", (999, 999), False, torch.float64),
    "biharmonic_1024_f32": ("biharmonic", (1024, 1024), False, torch.float32),
    "rect_9x14_f64": ("rect", (9, 14), False, torch.float64),
    "random_24_cyclic_f64": ("random", (N, N), True, torch.float64),
    "random_24_clamped_f64": ("random", (N, N), False, torch.float64),
    "empty_24_f32": ("empty", (N, N), False, torch.float32),
}
FLAT_GPU_CASES = {
    "dirichlet_1024_f32": ("dirichlet", (1024, 1024), torch.float32),
    "poisson_999_f64": ("poisson", (999, 999), torch.float64),
    "biharmonic_1024_f32": ("biharmonic", (1024, 1024), torch.float32),
    "sh_1024_f32": ("sh", (1024, 1024), torch.float32),
    "random_24_f64": ("random", (N, N), torch.float64),
}
MATMAT_GPU_CASES = {
    "sh_1024_x8_f32": ((1024, 1024), 8, torch.float32),
    "sh_2048_x8_f32": ((2048, 2048), 8, torch.float32),
    "sh_24_x3_f64": ((N, N), 3, torch.float64),
    "sh_24_x11_f64": ((N, N), 11, torch.float64),  # more than one register tile
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the diagonal SpMV kernels have no CPU mode")
    return torch.device("cuda")


def _gpu_matrix(kind, grid):
    if kind in ("rect", "random"):
        return _matrix(kind, density=0.002)[0]
    if kind == "empty":
        return sp.csr_matrix((grid[0] * grid[1],) * 2)
    return _bench_matrix(kind, grid[0])


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _gate(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GRID_GPU_CASES))
def test_cuda_grid_dia_matvec_matches_plain(case):
    dev = _cuda()
    kind, grid, cyclic, dtype = GRID_GPU_CASES[case]
    m = _gpu_matrix(kind, grid).astype(_np_dtype(dtype))
    a = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device=dev)
    assert a.data.dtype == dtype
    x = torch.tensor(_rand(grid, seed=0), dtype=dtype, device=dev)
    before = launch_count("grid_dia_matvec")
    got, want = spmv.grid_dia_matvec(a, x), a._apply(x)
    torch.cuda.synchronize()
    assert launch_count("grid_dia_matvec") == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got.cpu(), want.cpu(), _gate(dtype))
    if grid[0] <= 1024:  # and with coefficients where the containers store zeros
        b = a._replace(data=torch.randn_like(a.data))
        _close(spmv.grid_dia_matvec(b, x).cpu(), b._apply(x).cpu(), _gate(dtype))


# (operator, grid, cyclic container, dtype, matvec_path): the smoke run's
# far-shift, Poisson, Dirichlet 4096^2 and cyclic rows, ragged tiles on both
# paths (37 x 132, 37 x 130), odd pitches (999 f64, 130 f32, 9 x 14 f32) and
# the random containers of 536 / 391 terms (lists of several chunks)
MATVEC_PATH_GPU_CASES = {
    "sh_clamped_1024_f32": ("sh", (1024, 1024), False, torch.float32, "vector"),
    "sh_cyclic_2048_f32": ("sh", (2048, 2048), True, torch.float32, "vector"),
    "dirichlet_4096_f32": ("dirichlet", (4096, 4096), False, torch.float32, "vector"),
    "poisson_999_f64": ("poisson", (999, 999), False, torch.float64, "scalar"),
    "sh_cyclic_1024_f64": ("sh", (1024, 1024), True, torch.float64, "vector"),
    "biharmonic_37x132_f32": ("biharmonic", (37, 132), False, torch.float32, "vector"),
    "sh_cyclic_37x130_f32": ("sh", (37, 130), True, torch.float32, "scalar"),
    "sh_far_37x130_f64": ("sh", (37, 130), False, torch.float64, "vector"),
    "dirichlet_37x999_f64": ("dirichlet", (37, 999), False, torch.float64, "scalar"),
    "rect_9x14_f32": ("rect", (9, 14), False, torch.float32, "scalar"),
    "random_24_cyclic_f64": ("random", (N, N), True, torch.float64, "vector"),
    "random_24_clamped_f32": ("random", (N, N), False, torch.float32, "vector"),
}


def _matvec_case_matrix(kind, grid):
    if kind in ("sh", "dirichlet", "biharmonic") and grid[0] != grid[1]:
        return _grid_operator(kind, *grid)
    return _gpu_matrix(kind, grid)


def _unaligned_copy(x):
    """A contiguous copy of ``x`` whose first element is not 16-byte
    aligned: the tiled kernels take their scalar path on it."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    assert flat.data_ptr() % 16
    return flat.view(x.shape).copy_(x)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MATVEC_PATH_GPU_CASES))
def test_cuda_grid_dia_matvec_paths_match_plain(case):
    """The tiled kernel takes the path ``matvec_path`` names and lies within
    the gate of the plain version, on the container's coefficients and on
    random ones everywhere; each point sums its live terms in table order
    with one FMA a term on either path, so where the vector path runs, an
    unaligned copy of x (the scalar path) gives the same product bit for
    bit."""
    dev = _cuda()
    kind, grid, cyclic, dtype, path = MATVEC_PATH_GPU_CASES[case]
    m = _matvec_case_matrix(kind, grid).astype(_np_dtype(dtype))
    a = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device=dev)
    x = torch.tensor(_rand(grid, seed=3), dtype=dtype, device=dev)
    assert spmv.matvec_path(a, x) == path
    rand = a._replace(data=torch.tensor(_rand(tuple(a.data.shape), seed=8), dtype=dtype,
                                        device=dev))
    for b in (a, rand):
        before = launch_count("grid_dia_matvec", path=path)
        got, want = spmv.grid_dia_matvec(b, x), b._apply(x)
        torch.cuda.synchronize()
        assert launch_count("grid_dia_matvec", path=path) == before + 1
        _close(got.cpu(), want.cpu(), _gate(dtype))
        if path == "vector":
            xs = _unaligned_copy(x)
            assert spmv.matvec_path(b, xs) == "scalar"
            other = spmv.grid_dia_matvec(b, xs)
            assert torch.equal(got, other), float((got - other).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kind,grid,dtype", [("biharmonic", (37, 132), torch.float32),
                                             ("dirichlet", (37, 999), torch.float64),
                                             ("sh", (64, 64), torch.float32)])
def test_cuda_matvec_out_of_grid_coefficients_add_nothing(kind, grid, dtype):
    """The card's version of test_out_of_grid_terms_add_nothing_whatever_the_
    coefficient for the tiled SpMV, on both paths and on the far-shift
    container (the non-cyclic SH operator, |dy| up to 63): 1e30 wherever a
    source lies outside the grid gives the untouched container's product
    bit for bit."""
    dev = _cuda()
    a = ts.GridDIA.from_scipy(_grid_operator(kind, *grid).astype(_np_dtype(dtype)), grid,
                              device=dev)
    data = a.data.clone()
    for k, (dy, dx) in enumerate(a.shifts):
        rows = torch.arange(grid[0], device=dev)[:, None] + dy
        cols = torch.arange(grid[1], device=dev)[None, :] + dx
        data[k][(rows < 0) | (rows >= grid[0]) | (cols < 0) | (cols >= grid[1])] = 1e30
    assert int((data == 1e30).sum()) > 0
    x = torch.tensor(_rand(grid, seed=6), dtype=dtype, device=dev)
    b = a._replace(data=data)
    got = spmv.grid_dia_matvec(b, x)
    assert torch.equal(got, spmv.grid_dia_matvec(a, x))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLAT_GPU_CASES))
def test_cuda_dia_flat_matvec_matches_plain(case):
    dev = _cuda()
    kind, grid, dtype = FLAT_GPU_CASES[case]
    m = _gpu_matrix(kind, grid).astype(_np_dtype(dtype))
    a = ts.DIA.from_scipy(m, device=dev)
    x = torch.tensor(_rand(grid[0] * grid[1], seed=2), dtype=dtype, device=dev)
    before = launch_count("dia_flat_matvec")
    got, want = spmv.dia_flat_matvec(a, grid, x), a.matvec(x)
    torch.cuda.synchronize()
    assert launch_count("dia_flat_matvec") == before + 1
    _close(got.cpu(), want.cpu(), _gate(dtype))
    b = a._replace(data=torch.randn_like(a.data))
    _close(spmv.dia_flat_matvec(b, grid, x).cpu(), b.matvec(x).cpu(), _gate(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("cyclic", [True, False])
@pytest.mark.parametrize("case", list(MATMAT_GPU_CASES))
def test_cuda_grid_dia_matmat_matches_plain(case, cyclic):
    dev = _cuda()
    grid, nrhs, dtype = MATMAT_GPU_CASES[case]
    if not cyclic and grid[0] > 1024:
        pytest.skip("the clamped SpMM is covered at 1024^2 and 24^2")
    m = _bench_matrix("sh", grid[0]).astype(_np_dtype(dtype))
    a = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device=dev)
    x3 = torch.tensor(_rand((nrhs,) + grid, seed=4), dtype=dtype, device=dev)
    xi = x3.movedim(0, 1).contiguous()
    want = spmv._matmat_plain(a, x3)
    b3, bi = launch_count("grid_dia_matmat"), launch_count("grid_dia_matmat_interleaved")
    got3 = spmv.grid_dia_matmat(a, x3)
    goti = spmv.grid_dia_matmat_interleaved(a, xi)
    torch.cuda.synchronize()
    assert launch_count("grid_dia_matmat") == b3 + 1
    assert launch_count("grid_dia_matmat_interleaved") == bi + 1
    assert goti.shape == xi.shape
    _close(got3.cpu(), want.cpu(), _gate(dtype))
    _close(goti.movedim(1, 0).cpu(), want.cpu(), _gate(dtype))


def _grid_operator(kind, ny, nx):
    """The periodic SH operator (h = sqrt(8), r = 0.5) and the Dirichlet
    5-point Laplacian / biharmonic (h = 2) on a row-major ny x nx grid."""
    def second_difference(n, periodic):
        d = sp.diags([np.ones(n - 1), -2 * np.ones(n), np.ones(n - 1)], [-1, 0, 1]).tolil()
        if periodic:
            d[0, n - 1] = d[n - 1, 0] = 1.0
        return d.tocsr()

    periodic = kind == "sh"
    h = H_BENCH if periodic else 2.0
    lap = (sp.kron(sp.identity(ny), second_difference(nx, periodic))
           + sp.kron(second_difference(ny, periodic), sp.identity(nx))) / (h * h)
    if kind == "sh":
        return (-(lap @ lap) - 2.0 * lap - 0.5 * sp.identity(ny * nx)).tocsr()
    return (lap @ lap).tocsr() if kind == "biharmonic" else lap.tocsr()


# (operator, grid, cyclic container, dtype, the SpMM path it takes): the
# bench's shape, ragged last strips (132 = 2 x 64 + 4 f32 columns, 100 =
# 3 x 32 + 4 f64 ones) and slabs (37 rows), clamped containers whose halo
# is zero-filled, a width that is not whole 16-byte vectors and the
# far-shift clamped SH container (|dy| up to ny - 1)
SPMM_PATH_GPU_CASES = {
    "sh_cyclic_1024_f32": ("sh", (1024, 1024), True, torch.float32, "slab"),
    "sh_cyclic_37x132_f32": ("sh", (37, 132), True, torch.float32, "slab"),
    "biharmonic_37x132_f32": ("biharmonic", (37, 132), False, torch.float32, "slab"),
    "sh_cyclic_37x100_f64": ("sh", (37, 100), True, torch.float64, "slab"),
    "dirichlet_24x24_f64": ("dirichlet", (24, 24), False, torch.float64, "slab"),
    "sh_cyclic_37x130_f32": ("sh", (37, 130), True, torch.float32, "general"),
    "sh_far_clamped_24_f64": ("sh", (24, 24), False, torch.float64, "general"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("nrhs", [1, 3, 8, 11])
@pytest.mark.parametrize("case", list(SPMM_PATH_GPU_CASES))
def test_cuda_spmm_paths_match_plain_and_each_other(case, nrhs):
    """Each SpMM wrapper takes the kernel ``spmm_path`` names, in both
    layouts, and agrees with the plain version and with the general kernel
    on random coefficients (those a clamped source outside the grid meets
    included)."""
    dev = _cuda()
    kind, grid, cyclic, dtype, path = SPMM_PATH_GPU_CASES[case]
    m = _grid_operator(kind, *grid).astype(_np_dtype(dtype))
    a = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device=dev)
    a = a._replace(data=torch.tensor(_rand(tuple(a.data.shape), seed=8), dtype=dtype,
                                     device=dev))
    x3 = torch.tensor(_rand((nrhs,) + grid, seed=4), dtype=dtype, device=dev)
    xi = x3.movedim(0, 1).contiguous()
    assert spmv.spmm_path(a, x3) == path and spmv.spmm_path(a, xi) == path
    want = spmv._matmat_plain(a, x3)
    before = (launch_count("grid_dia_matmat", path=path),
              launch_count("grid_dia_matmat_interleaved", path=path))
    got3 = spmv.grid_dia_matmat(a, x3)
    goti = spmv.grid_dia_matmat_interleaved(a, xi).movedim(1, 0)
    torch.cuda.synchronize()
    assert (launch_count("grid_dia_matmat", path=path),
            launch_count("grid_dia_matmat_interleaved", path=path)) == (before[0] + 1,
                                                                        before[1] + 1)
    general3 = spmv._matmat_general(a, x3)
    generali = spmv._matmat_general(a, xi, interleaved=True).movedim(1, 0)
    for got in (got3, goti):
        _close(got.cpu(), want.cpu(), _gate(dtype))
        _close(got.cpu(), general3.cpu(), _gate(dtype))
    _close(generali.cpu(), want.cpu(), _gate(dtype))


# (operator, grid, cyclic container, dtype, matvec_path of the stack): the
# general cases of SPMM_PATH_GPU_CASES (a width that is not whole f32
# vectors; the far-shift clamped SH container), the smoke run's far-shift
# 1024^2 f32 and Poisson 999^2 f64 rows, a random container of 536 terms
# (lists of several chunks), and a list whose first chunk is dead for the
# top tiles while the next one holds whole terms that read the x window
SPMM_GENERAL_GPU_CASES = {
    "sh_cyclic_37x130_f32": ("sh", (37, 130), True, torch.float32, "scalar"),
    "sh_far_clamped_24_f64": ("sh", (24, 24), False, torch.float64, "vector"),
    "sh_far_clamped_1024_f32": ("sh", (1024, 1024), False, torch.float32, "vector"),
    "poisson_999_f64": ("poisson", (999, 999), False, torch.float64, "scalar"),
    "random_24_clamped_f64": ("random", (N, N), False, torch.float64, "vector"),
    "dead_first_chunk_24x132_f32": ("deadfirst", (24, 132), False, torch.float32, "vector"),
    "dead_first_chunk_24x99_f64": ("deadfirst", (24, 99), False, torch.float64, "scalar"),
}


def _dead_first_operator(ny, nx):
    """The Dirichlet 5-point Laplacian behind 272 unit diagonals at dy
    -23..-8, |dx| <= 8: the clamped container's table starts with 256 and
    more terms that reach no point of the top tiles (rows 0-7), ahead of
    the stencil's whole terms."""
    offsets = [dy * nx + dx for dy in range(-23, -7) for dx in range(-8, 9)]
    far = sp.diags([np.ones(ny * nx - abs(o)) for o in offsets], offsets)
    return (far + _grid_operator("dirichlet", ny, nx)).tocsr()


def _spmm_case_matrix(kind, grid):
    if kind in ("poisson", "random"):
        return _gpu_matrix(kind, grid)
    if kind == "deadfirst":
        return _dead_first_operator(*grid)
    return _grid_operator(kind, *grid)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """``a b`` as an unevaluated sum of two floats (Veltkamp's split)."""
    split = a.dtype.type(2.0 ** (27 if a.dtype == np.float64 else 12) + 1.0)

    def halves(v):
        c = split * v
        hi = c - (c - v)
        return hi, v - hi

    p = a * b
    (ah, al), (bh, bl) = halves(a), halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """``a b + c`` rounded once, elementwise, in the arrays' own precision:
    Boldo and Melquiond's emulation, whose one inexact sum before the last
    is rounded to odd (exact without underflow or overflow)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    bits = v.view(np.int64 if v.dtype == np.float64 else np.int32)
    even = (e != 0) & (bits & 1 == 0)
    v = np.where(even, np.nextafter(v, np.where(e > 0, np.inf, -np.inf).astype(v.dtype)), v)
    return th + v


def _host_fma_matmat(a, x3):
    """``Y = A X`` for the ``(nrhs, ny, nx)`` stack on the host, each
    point's terms of the general kernel's table summed in table order, one
    correctly rounded FMA a term a right-hand side, terms whose source lies
    outside the grid skipped: the general kernel's sum."""
    ny, nx = a.grid
    data, x = a.data.cpu().numpy(), x3.cpu().numpy()
    acc = np.zeros_like(x)
    r, c = np.arange(ny)[:, None], np.arange(nx)[None, :]
    for k, dy, dx in spmv._term_rows(a.shifts, a.grid, a.cyclic, False):
        rr, cc = (r + dy) % ny if a.cyclic else r + dy, (c + dx) % nx if a.cyclic else c + dx
        ok = (rr >= 0) & (rr < ny) & (cc >= 0) & (cc < nx)
        src = x[:, np.clip(rr, 0, ny - 1), np.clip(cc, 0, nx - 1)]
        acc = np.where(ok, _fma(data[k], src, acc), acc)
    return torch.from_numpy(acc)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_host_fma_is_rounded_once(dtype):
    """The host loop's FMA against the exact ``a b + c`` rounded to the
    nearest float (ties to even), on values whose product and sum lose bits
    and on sums that cancel."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    a, b = rng.standard_normal(2000).astype(dtype), rng.standard_normal(2000).astype(dtype)
    c = np.concatenate([rng.standard_normal(1000), -(a[1000:].astype(np.float64)
                                                       * b[1000:])]).astype(dtype)
    got = _fma(a, b, c)
    for ai, bi, ci, g in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        near = dtype(float(exact))
        cands = [near, np.nextafter(near, dtype(np.inf)), np.nextafter(near, dtype(-np.inf))]
        best = min(abs(Fraction(float(v)) - exact) for v in cands)
        ties = [v for v in cands if abs(Fraction(float(v)) - exact) == best]
        want = min(ties, key=lambda v: int(np.array(v).view(
            np.int64 if dtype == np.float64 else np.int32)) & 1)
        assert g == want, (ai, bi, ci, g, want)


@pytest.mark.gpu
@pytest.mark.parametrize("nrhs", [1, 3, 8, 11])
@pytest.mark.parametrize("case", list(SPMM_GENERAL_GPU_CASES))
def test_cuda_general_spmm_equals_the_host_fma_loop(case, nrhs):
    """The tiled (general) SpMM sums each point's live terms in table order
    with one FMA a term a right-hand side: in both layouts, on the path
    ``matvec_path`` names (and, where that is the vector path, on an
    unaligned copy of the stack: the scalar path), it equals the host loop
    of correctly rounded FMAs bit for bit, on random coefficients
    everywhere, and lies within the gate of the plain version."""
    dev = _cuda()
    kind, grid, cyclic, dtype, path = SPMM_GENERAL_GPU_CASES[case]
    m = _spmm_case_matrix(kind, grid).astype(_np_dtype(dtype))
    a = ts.GridDIA.from_scipy(m, grid, cyclic=cyclic, device=dev)
    a = a._replace(data=torch.tensor(_rand(tuple(a.data.shape), seed=8), dtype=dtype,
                                     device=dev))
    x3 = torch.tensor(_rand((nrhs,) + grid, seed=4), dtype=dtype, device=dev)
    xi = x3.movedim(0, 1).contiguous()
    want = spmv._matmat_plain(a, x3)
    host = _host_fma_matmat(a, x3)
    for x, kernel, inter in ((x3, "grid_dia_matmat", False),
                             (xi, "grid_dia_matmat_interleaved", True)):
        assert spmv.spmm_path(a, x) == "general" and spmv.matvec_path(a, x) == path
        before = launch_count(kernel, path="general")
        got = getattr(spmv, kernel)(a, x)
        torch.cuda.synchronize()
        assert launch_count(kernel, path="general") == before + 1
        got = (got.movedim(1, 0) if inter else got).cpu()
        assert torch.equal(got, host), float((got - host).abs().max())
        _close(got, want.cpu(), _gate(dtype))
        if path == "vector":
            xs = _unaligned_copy(x)
            assert spmv.matvec_path(a, xs) == "scalar"
            other = spmv._matmat_general(a, xs, interleaved=inter)
            assert torch.equal((other.movedim(1, 0) if inter else other).cpu(), host)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,grid,dtype", [("biharmonic", (37, 132), torch.float32),
                                             ("dirichlet", (37, 999), torch.float64),
                                             ("sh", (64, 64), torch.float32)])
def test_cuda_general_spmm_out_of_grid_coefficients_add_nothing(kind, grid, dtype):
    """The card's version of test_out_of_grid_terms_add_nothing_whatever_the_
    coefficient for the general SpMM, in both layouts, on both paths and on
    the far-shift container (the non-cyclic SH operator, |dy| up to 63):
    1e30 wherever a source lies outside the grid gives the untouched
    container's product bit for bit, and the host loop of FMAs."""
    dev = _cuda()
    a = ts.GridDIA.from_scipy(_grid_operator(kind, *grid).astype(_np_dtype(dtype)), grid,
                              device=dev)
    data = a.data.clone()
    for k, (dy, dx) in enumerate(a.shifts):
        rows = torch.arange(grid[0], device=dev)[:, None] + dy
        cols = torch.arange(grid[1], device=dev)[None, :] + dx
        data[k][(rows < 0) | (rows >= grid[0]) | (cols < 0) | (cols >= grid[1])] = 1e30
    assert int((data == 1e30).sum()) > 0
    b = a._replace(data=data)
    x3 = torch.tensor(_rand((3,) + grid, seed=6), dtype=dtype, device=dev)
    for x, inter in ((x3, False), (x3.movedim(0, 1).contiguous(), True)):
        got = spmv._matmat_general(b, x, interleaved=inter)
        assert torch.equal(got, spmv._matmat_general(a, x, interleaved=inter))
        host = _host_fma_matmat(b, x3)
        assert torch.equal((got.movedim(1, 0) if inter else got).cpu(), host)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dirichlet", "biharmonic"])
def test_cuda_slab_out_of_grid_coefficients_add_nothing(kind):
    """The card's version of test_out_of_grid_terms_add_nothing_whatever_the_
    coefficient: on the slab path, a clamped container whose out-of-grid
    coefficients are 1e30 gives the untouched container's product bit for
    bit."""
    dev = _cuda()
    grid = (37, 132)
    a = ts.GridDIA.from_scipy(_grid_operator(kind, *grid).astype(np.float32), grid,
                              device=dev)
    data = a.data.clone()
    for k, (dy, dx) in enumerate(a.shifts):
        rows = torch.arange(grid[0], device=dev)[:, None] + dy
        cols = torch.arange(grid[1], device=dev)[None, :] + dx
        outside = (rows < 0) | (rows >= grid[0]) | (cols < 0) | (cols >= grid[1])
        data[k][outside] = 1e30
    assert int((data == 1e30).sum()) > 0
    x3 = torch.tensor(_rand((3,) + grid, seed=6), dtype=torch.float32, device=dev)
    xi = x3.movedim(0, 1).contiguous()
    b = a._replace(data=data)
    assert spmv.spmm_path(b, x3) == "slab" and spmv.spmm_path(b, xi) == "slab"
    assert torch.equal(spmv.grid_dia_matmat(b, x3), spmv.grid_dia_matmat(a, x3))
    assert torch.equal(spmv.grid_dia_matmat_interleaved(b, xi),
                       spmv.grid_dia_matmat_interleaved(a, xi))


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda()
    m, grid = _matrix("sh")
    a = ts.GridDIA.from_scipy(m, grid, cyclic=True, device=dev)
    x = torch.zeros(grid, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        spmv.grid_dia_matvec(a, x.float())
    with pytest.raises(TypeError):
        spmv.grid_dia_matvec(a._replace(data=a.data.half()), x.half())
    with pytest.raises(ValueError):
        spmv.grid_dia_matvec(a, x.t())
    with pytest.raises(ValueError):
        spmv.grid_dia_matvec(a, x.cpu())  # the matrix lies on the card
    with pytest.raises(ValueError):
        spmv.grid_dia_matmat(a, torch.zeros((2, N, N + 1), dtype=torch.float64, device=dev))
    with pytest.raises(RuntimeError, match="no derivative rule"):
        torch.func.jvp(lambda v: spmv.grid_dia_matvec(a, v), (x,), (x,))
