"""Port parity: the periodic, upwind and Dirichlet stencils against the JAX
package's, and the ``lap_periodic`` / ``sh_operator`` kernel wrappers.

The stencils take the same seeded f64 field on both sides and reorder no
arithmetic, so they agree to 1e-12 of the result's scale.  On the CPU the
wrappers run their plain versions; the ``gpu``-marked tests hold each CUDA
kernel against its plain version on the card:
``python -m pytest --noconftest -m gpu tests/test_torch_periodic_stencil.py``
(the JAX side is imported inside the ``jst`` fixture, so those tests also
run on a machine that has the port and no JAX).
"""
import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.ops import periodic_stencil as ps
from iterative_solvers_tpu_torch.ops._build import check, launch_count
from iterative_solvers_tpu_torch.ops import stencils as tst

SHAPES = [(24, 24), (32, 48)]
H, R = 0.37, 0.01


@pytest.fixture(scope="module")
def jst():
    pytest.importorskip("jax")
    from iterative_solvers_tpu.ops import stencils

    return stencils


def _field(shape, dtype=np.float64, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _call(mod, name, u):
    fn = getattr(mod, name)
    if name == "sh_linear_operator":
        return fn(u, H, R)
    return fn(u, H)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", [
    "lap_periodic", "sh_linear_operator", "lap_dirichlet_5pt",
    "d1_x_forward", "d1_x_backward", "d1_y_forward", "d1_y_backward"])
def test_stencil_matches_jax(jst, name, shape):
    import jax.numpy as jnp

    u = _field(shape)
    want = _call(jst, name, jnp.asarray(u))
    _close(_call(tst, name, torch.tensor(u)).numpy(), want, 1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrappers_take_plain_version_on_cpu(shape):
    u = torch.tensor(_field(shape))
    before = (launch_count("lap_periodic"), launch_count("sh_operator"))
    lap = ps.lap_periodic_kernel(u, H)
    sh = ps.sh_operator_kernel(u, H, R)
    assert (launch_count("lap_periodic"), launch_count("sh_operator")) == before
    np.testing.assert_array_equal(lap.numpy(), tst.lap_periodic(u, H).numpy())
    np.testing.assert_array_equal(sh.numpy(), tst.sh_linear_operator(u, H, R).numpy())


def test_kernel_refuses_autodiff():
    """Under torch.func.jvp the CUDA wrapper would lose the tangent: the
    check that runs before every launch raises instead."""
    u = torch.tensor(_field((8, 8)))

    def f(x):
        check("sh_operator", x)
        return x

    with pytest.raises(RuntimeError, match="no derivative rule"):
        torch.func.jvp(f, (u,), (u,))
    with pytest.raises(ValueError, match="CUDA device"):  # a plain tensor gets past autodiff
        check("sh_operator", u)


def test_launch_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA device"):
        ps._launch("sh_operator", 4, torch.zeros(8, 8), 1.0, 0.0)


# -- on the card ---------------------------------------------------------------

# (shape, dtype, h, relative gate): the kernel bench's parity inputs at
# 4096^2, the SH path's 2048^2 fields (h = 40 n/64 / n), the 24^2 parity
# state and one odd shape.  f32 rounds Lap-of-Lap differently at small h,
# so it is held to 1e-5 of max|plain|, as the kernel bench holds the TPU
# kernels; f64 to 1e-12.
GPU_CASES = {
    "4096_f32": ((4096, 4096), torch.float32, 40.0 / 4096, 1e-5),
    "2048_f32": ((2048, 2048), torch.float32, 0.625, 1e-5),
    "2048_f64": ((2048, 2048), torch.float64, 0.625, 1e-12),
    "24_f64": ((24, 24), torch.float64, 40.0 / 24, 1e-12),
    "4_f32": ((4, 4), torch.float32, 0.37, 1e-5),
    "24x23_f64": ((24, 23), torch.float64, 0.37, 1e-12),
    "61x91_f32": ((61, 91), torch.float32, 0.37, 1e-5),
    "61x91_f64": ((61, 91), torch.float64, 0.37, 1e-12),
    "257x130_f64": ((257, 130), torch.float64, 0.37, 1e-12),
    "257x132_f32": ((257, 132), torch.float32, 0.37, 1e-5),
}


@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the periodic stencil kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GPU_CASES))
@pytest.mark.parametrize("kernel", ["lap_periodic", "sh_operator"])
def test_cuda_kernel_matches_plain(cuda, kernel, case):
    dev = cuda
    shape, dtype, h, rel = GPU_CASES[case]
    u = torch.tensor(_field(shape), dtype=dtype, device=dev)
    wrapper = getattr(ps, f"{kernel}_kernel")
    before = launch_count(kernel)
    if kernel == "lap_periodic":
        got, want = wrapper(u, h), tst.lap_periodic(u, h)
    else:
        got, want = wrapper(u, h, R), tst.sh_linear_operator(u, h, R)
    torch.cuda.synchronize()
    assert launch_count(kernel) == before + 1
    assert got.dtype == dtype and got.shape == u.shape
    _close(got.cpu().numpy(), want.cpu().numpy(), rel)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_cuda_sh_operator_matches_earlier_kernel(cuda, case):
    """Whichever kernel the shape takes (strip-marching where rows are whole
    16-byte vectors, tiled elsewhere) against the tiled kernel of the
    earlier design on the same field; a misaligned view takes the tiled one."""
    shape, dtype, h, rel = GPU_CASES[case]
    u = torch.tensor(_field(shape), dtype=dtype, device=cuda)
    vec = 16 // u.element_size()
    assert ps.sh_operator_path(u) == ("strip" if shape[1] % vec == 0 else "tile")
    got, old = ps.sh_operator_kernel(u, h, R), ps._sh_operator_v1(u, h, R)
    torch.cuda.synchronize()
    _close(got.cpu().numpy(), old.cpu().numpy(), rel)
    shifted = torch.zeros(u.numel() + 1, dtype=dtype, device=cuda)[1:].view(shape)
    shifted.copy_(u)
    assert ps.sh_operator_path(shifted) == "tile"
    _close(ps.sh_operator_kernel(shifted, h, R).cpu().numpy(), old.cpu().numpy(), rel)


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    dev = cuda
    u = torch.zeros(16, 16, device=dev)
    with pytest.raises(TypeError):
        ps.sh_operator_kernel(u.half(), H, R)
    with pytest.raises(ValueError):
        ps.sh_operator_kernel(torch.zeros(2, 16, 16, device=dev), H, R)
    with pytest.raises(ValueError):
        ps.sh_operator_kernel(torch.zeros(3, 16, device=dev), H, R)
    with pytest.raises(ValueError):
        ps.lap_periodic_kernel(u.t()[:, :8], H)
    with pytest.raises(RuntimeError, match="no derivative rule"):
        torch.func.jvp(lambda x: ps.sh_operator_kernel(x, H, R), (u,), (u,))
