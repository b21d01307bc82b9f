"""The stencils' kernel (``ops/stencils.fd_stencil_kernel``,
``csrc/fd_stencil.cu``) on the card: each of ``d1_x``, ``d1_y``, ``d2_x``,
``d2_y`` in float32 and float64 against its plain body on the same card.

The plain body takes its one-sided edge rows from a ``(rows, 5 or 6) x
(5 or 6, 2)`` cuBLAS product, which cuBLAS sums as one FMA chain from the
first term at 768 rows and more and in another order below; the kernel
sums each edge point as that chain.  So at every shape the kernel equals
the plain body with its edge rows summed as that chain (float32 emulated in
float64 with a rounding to float32 after each step, float64 exactly with
``fractions.Fraction``), and at 1024^2 and 800 x 1000 the plain body as it
is.  The output's strides are the plain body's, and a call is one launch.
No JAX here, so the card's machine runs them:
``python -m pytest --noconftest -m gpu tests/test_torch_fd_stencil.py``.
"""
from fractions import Fraction

import pytest
import torch

from iterative_solvers_tpu_torch.ops import stencils
from iterative_solvers_tpu_torch.ops._build import launch_count

H = {"x": 0.1, "y": 0.07}
NAMES = ["d1_x", "d1_y", "d2_x", "d2_y"]
DTYPES = [torch.float32, torch.float64]
SHAPES = [(51, 51), (61, 91), (1024, 1024), (800, 1000), (3, 51, 51), "transposed"]


@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fd_stencil kernel has no CPU mode")
    return torch.device("cuda")


def _field(shape, dtype, device, seed=5):
    """A seeded field; ``"transposed"`` is the (61, 91) view of a contiguous
    (91, 61) field."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if shape == "transposed":
        return torch.randn((91, 61), generator=g, dtype=torch.float64).to(device, dtype).T
    return torch.randn(shape, generator=g, dtype=torch.float64).to(device, dtype)


def _chain_f32(strip, c):
    acc = torch.zeros(strip.shape[:-1] + (c.shape[0],), dtype=torch.float64,
                      device=strip.device)
    for k in range(c.shape[1]):
        acc = (strip[..., k:k + 1] * c[:, k] + acc).float().double()
    return acc.float()


def _chain_f64(strip, c):
    rows = strip.reshape(-1, strip.shape[-1]).cpu().tolist()
    coefs = [[Fraction(x) for x in row] for row in c.cpu().tolist()]
    out = []
    for row in rows:
        exact = [Fraction(x) for x in row]
        for cr in coefs:
            acc = 0.0
            for ck, xk in zip(cr, exact):
                acc = float(ck * xk + Fraction(acc))     # one rounding a step: an FMA
            out.append(acc)
    return torch.tensor(out, dtype=torch.float64).reshape(
        strip.shape[:-1] + (c.shape[0],)).to(strip.device)


def edge_rows_as_one_fma_chain(u, name):
    """``stencils._edge_rows`` with each edge point summed as one FMA chain
    from the first term (``chip_smoke.py``'s phase 40 holds the kernel to
    it too)."""
    c = stencils._edge_coefs(name, u.dtype, u.device).double()
    w = c.shape[1]
    strip = (u[..., :w] if name.endswith("_lo") else u[..., -w:]).double()
    return _chain_f32(strip, c) if u.dtype == torch.float32 else _chain_f64(strip, c)


def _plain(name, u):
    return getattr(stencils, f"{name}_plain")(u, H[name[-1]])


def _kernel(name, u):
    before = launch_count("fd_stencil")
    got = getattr(stencils, name)(u, H[name[-1]])
    assert launch_count("fd_stencil") == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_kernel_is_the_plain_body_with_chained_edge_rows(cuda, name, dtype, shape, monkeypatch):
    u = _field(shape, dtype, cuda)
    got = _kernel(name, u)
    monkeypatch.setattr(stencils, "_edge_rows", edge_rows_as_one_fma_chain)
    want = _plain(name, u)
    assert got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (800, 1000)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", NAMES)
def test_kernel_is_the_plain_body_where_cublas_chains(cuda, name, dtype, shape):
    """At 768 rows and more the plain body, unchanged."""
    u = _field(shape, dtype, cuda)
    assert torch.equal(_kernel(name, u), _plain(name, u))


@pytest.mark.gpu
def test_forward_mode_takes_the_kernel_on_the_tangent(cuda):
    u, t = _field((61, 91), torch.float32, cuda), _field((61, 91), torch.float32, cuda, 6)
    before = launch_count("fd_stencil")
    out, tangent = torch.func.jvp(lambda w: stencils.d2_y(w, 0.07), (u,), (t,))
    assert launch_count("fd_stencil") == before + 2
    assert torch.equal(out, stencils.d2_y(u, 0.07))
    assert torch.equal(tangent, stencils.d2_y(t, 0.07))


@pytest.mark.gpu
def test_other_cuda_tensors_raise(cuda):
    with pytest.raises(TypeError):
        stencils.d1_x(torch.ones((8, 8), dtype=torch.float16, device=cuda), 0.1)
    with pytest.raises(ValueError):
        stencils.d2_y(torch.ones((5, 8), device=cuda), 0.1)
