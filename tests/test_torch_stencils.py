"""Port parity: the PyTorch stencils against the JAX package's, f64 on CPU.

The same seeded field goes through both; the port reorders no arithmetic
in the interiors, so agreement is to rounding (1e-12 of the result's
scale)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from iterative_solvers_tpu.ops import stencils as jst
from iterative_solvers_tpu_torch.ops import stencils as tst

H = (0.1, 0.07)


def _apply(mod, name, u):
    dx, dy = H
    fn = getattr(mod, name)
    return fn(u, dx, dy) if name == "dxy" else fn(u, dx if name.endswith("x") else dy)


@pytest.mark.parametrize("shape", [(13, 17), (61, 91)])
@pytest.mark.parametrize("name", ["d1_x", "d1_y", "d2_x", "d2_y", "dxy"])
def test_stencil_matches_jax(name, shape):
    u = np.random.default_rng(11).standard_normal(shape)
    want = np.asarray(_apply(jst, name, jnp.asarray(u)))
    got = _apply(tst, name, torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
