"""Port parity: the PyTorch stencils against the JAX package's, f64 on CPU.

The same seeded field goes through both; the port reorders no arithmetic
in the interiors, so agreement is to rounding (1e-12 of the result's
scale).  On the CPU the port runs the plain bodies, for leading axes and
strided views too; the kernel that the card runs instead is held to them
in ``tests/test_torch_fd_stencil.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.ops import stencils as jst
from iterative_solvers_tpu_torch.ops import stencils as tst
from iterative_solvers_tpu_torch.ops._build import LAUNCHES
from iterative_solvers_tpu_torch.utils import trace

H = (0.1, 0.07)


def _apply(mod, name, u):
    dx, dy = H
    fn = getattr(mod, name)
    return fn(u, dx, dy) if name == "dxy" else fn(u, dx if name.endswith("x") else dy)


@pytest.mark.parametrize("shape", [(13, 17), (61, 91), pytest.param((3, 51, 51), id="batch"),
                                   pytest.param("transposed", id="transposed")])
@pytest.mark.parametrize("name", ["d1_x", "d1_y", "d2_x", "d2_y", "dxy"])
def test_stencil_matches_jax(name, shape):
    """``"transposed"``: the (61, 91) view of a contiguous (91, 61) field."""
    if shape == "transposed":
        base = np.random.default_rng(11).standard_normal((91, 61))
        u, ut = base.T, torch.tensor(base).T
        assert not ut.is_contiguous()
    else:
        u = np.random.default_rng(11).standard_normal(shape)
        ut = torch.tensor(u)
    want = np.asarray(_apply(jst, name, jnp.asarray(u)))
    got = _apply(tst, name, ut).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("launches", [0, 1])
def test_a_call_counts_the_kernel_only_where_it_launched(monkeypatch, launches):
    """``stencil.kernel`` counts a call off the CPU only if the kernel's
    launch count rose in it (a meta tensor stands for the card's, and the
    plain body for the launch)."""
    def launch(u, order, axis, h):
        LAUNCHES["fd_stencil", "f32", None] += launches
        return torch.empty_like(u)

    monkeypatch.setattr(tst, "_launch", launch)
    u = torch.empty((13, 17), device="meta")
    with trace.tracing():
        with trace.span("step"):
            tst.d1_y(u, 0.1)
            tst.d2_x(torch.zeros((13, 17)), 0.1)
    (c,) = trace.take().counters.values()
    assert c["stencil.calls"] == 2
    assert c.get("stencil.kernel", 0) == launches


def test_the_kernels_forward_mode_rule_is_the_launch_on_the_tangent(monkeypatch):
    """The derivative rule's plumbing, with the launch played by the plain
    body on the CPU: ``torch.func.jvp`` through the wrapper gives the
    operator on the primal and on the tangent, a launch each, and each
    launch gets a tensor with storage (a transform's wrapper has none)."""
    plain = {(1, -1): tst.d1_x_plain, (1, -2): tst.d1_y_plain,
             (2, -1): tst.d2_x_plain, (2, -2): tst.d2_y_plain}
    calls = []

    def launch(u, order, axis, h):
        u.data_ptr()
        calls.append((order, axis))
        return plain[order, axis](u, h)

    monkeypatch.setattr(tst, "_launch", launch)
    rng = np.random.default_rng(3)
    u, t = (torch.tensor(rng.standard_normal((13, 17))) for _ in range(2))
    out, tangent = torch.func.jvp(lambda w: tst.fd_stencil_kernel(w, 2, -2, 0.07), (u,), (t,))
    assert calls == [(2, -2), (2, -2)]
    assert torch.equal(out, tst.d2_y_plain(u, 0.07))
    assert torch.equal(tangent, tst.d2_y_plain(t, 0.07))
    calls.clear()
    assert torch.equal(tst.fd_stencil_kernel(u, 1, -1, 0.1), tst.d1_x_plain(u, 0.1))
    assert calls == [(1, -1)]
