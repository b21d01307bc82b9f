"""The curvilinear Laplacian's flux divergence (``ops/stencils.flux_div_x``,
``flux_div_y``) and its kernel (``flux_div_kernel``, ``csrc/flux_div.cu``).

On the CPU: the wrapper takes the plain body; the plain versions that
kernels are held to (``jvp_apply_ref``, ``laplace(..., fd=stencils.PLAIN)``,
the ``edge_dtype`` branch) never reach the kernel, shown on meta tensors
(which stand for the card's) with the launch made to raise; the counters
``flux.calls`` / ``flux.kernel`` of a MEMS step and a droplet residual; the
forward-mode rule's plumbing (bilinear: a launch for each operand that
carries a tangent), no reverse-mode rule, and fields of two dtypes refused.
On the card (``-m gpu``): the kernel equals the plain body bit for bit on
the same card, on both axes, transposed views and leading axes, and its
forward-mode rule equals ``torch.func.jvp`` of the plain body.  No JAX
here, so the card's machine runs them:
``python -m pytest --noconftest -m gpu tests/test_torch_flux_div.py``.
"""
import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.core.grid import Grid2D
from iterative_solvers_tpu_torch.io import convert, fixtures as tfx
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.models import mems as tm
from iterative_solvers_tpu_torch.ops import curvilinear as cv
from iterative_solvers_tpu_torch.ops import droplet_jvp, stencils
from iterative_solvers_tpu_torch.ops._build import LAUNCHES, launch_count
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov
from iterative_solvers_tpu_torch.utils import trace

IH = {"x": 123.4, "y": 87.6}
PLAIN = {"x": stencils.flux_div_x_plain, "y": stencils.flux_div_y_plain}
WRAPPER = {"x": stencils.flux_div_x, "y": stencils.flux_div_y}


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with tracing off and nothing recorded."""
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _fields(shape, dtype=torch.float64, device="cpu", seed=5):
    """A seeded pair (a, v): a positive like the metric coefficients, v
    N(0, 1).  ``"transposed"``: both the (61, 91) views of contiguous
    (91, 61) fields; ``"mixed"``: a contiguous (61, 91), v such a view;
    ``"narrow"``: 6 points along the y axis and 7 along x."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def draw(s):
        return torch.randn(s, generator=g, dtype=torch.float64)

    if shape == "transposed":
        a, v = (1.5 + 0.5 * draw((91, 61))).T, draw((91, 61)).T
    elif shape == "mixed":
        a, v = 1.5 + 0.5 * draw((61, 91)), draw((91, 61)).T
    elif shape == "narrow":
        a, v = 1.5 + 0.5 * draw((6, 7)), draw((6, 7))
    else:
        a, v = 1.5 + 0.5 * draw(shape), draw(shape)
    return a.to(device, dtype), v.to(device, dtype)


def _refuse(monkeypatch):
    """Make every launch of the flux kernel raise."""
    def launch(*args):
        raise AssertionError("the flux_div kernel was launched")

    monkeypatch.setattr(stencils, "_launch_flux", launch)


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(13, 17), (3, 13, 17), "transposed", "mixed", "narrow"])
@pytest.mark.parametrize("axis", ["x", "y"])
def test_the_wrapper_takes_the_plain_body_on_cpu_tensors(monkeypatch, axis, shape):
    _refuse(monkeypatch)
    a, v = _fields(shape)
    with trace.tracing():
        got = WRAPPER[axis](a, v, IH[axis])
    (c,) = trace.take().counters.values()
    assert c["flux.calls"] == 1 and c.get("flux.kernel", 0) == 0
    assert torch.equal(got, PLAIN[axis](a, v, IH[axis]))
    # a batch is its fields one by one
    for k in range(a.shape[0] if a.dim() == 3 else 0):
        assert torch.equal(got[k], PLAIN[axis](a[k], v[k], IH[axis]))


def test_the_plain_versions_never_reach_the_kernel(monkeypatch):
    """On meta tensors (the card's stand-in) with the flux kernel's launch
    made to raise and the stencils' played by an empty result: the
    ``droplet_jvp`` kernel's plain version, the PMA kernels' plain chain
    (``fd=stencils.PLAIN``) and the ``edge_dtype`` branch run and count no
    flux call; the default ``laplace`` reaches the launch."""
    _refuse(monkeypatch)
    monkeypatch.setattr(stencils, "_launch", lambda u, order, axis, h: torch.empty_like(u))
    grid = Grid2D(nx=17, ny=13, xl=-1.0, xr=1.0, yb=-1.0, yt=1.0)
    v64 = torch.empty(grid.shape, dtype=torch.float64, device="meta")
    geom64 = cv.MeshGeometry(*(torch.empty_like(v64) for _ in range(6)))
    v32 = v64.float()
    geom32 = cv.MeshGeometry(*(f.float() for f in geom64))
    stack = torch.empty((8,) + grid.shape, dtype=torch.float64, device="meta")
    with trace.tracing():
        assert droplet_jvp.jvp_apply_ref(v64, stack, grid).shape == grid.shape
        for w in cv.laplace(v64, v64, v64, geom64, grid, fd=stencils.PLAIN):
            assert w.shape == grid.shape
        for w in cv.laplace(v32, v32, v32, geom32, grid, edge_dtype=torch.float64):
            assert w.shape == grid.shape and w.dtype == torch.float32
    assert not any("flux.calls" in c for c in trace.take().counters.values())
    with pytest.raises(AssertionError, match="was launched"):
        cv.laplace(v64, v64, v64, geom64, grid)


def test_a_call_counts_the_kernel_only_where_it_launched(monkeypatch):
    """``flux.kernel`` counts a call off the CPU only if the kernel's launch
    count rose in it; operands that carry a gradient take the launch too
    (through the autodiff rule), never the plain body."""
    launches = []

    def launch(a, v, axis, inv_h2):
        launches.append(axis)
        LAUNCHES["flux_div", "f64", None] += 1
        return torch.empty_like(v)

    monkeypatch.setattr(stencils, "_launch_flux", launch)
    monkeypatch.setattr(stencils, "flux_div_x_plain", _refused)
    monkeypatch.setattr(stencils, "flux_div_y_plain", _refused)
    a, v = (torch.empty((13, 17), dtype=torch.float64, device="meta") for _ in range(2))
    with trace.tracing():
        with trace.span("step"):
            stencils.flux_div_x(a, v, 1.0)
            stencils.flux_div_y(a, v, 1.0)
            stencils.flux_div_x(a.requires_grad_(), v, 1.0)
            stencils.flux_div_y(a.detach(), v.requires_grad_(), 1.0)
    (c,) = trace.take().counters.values()
    assert launches == [-1, -2, -1, -2]
    assert c["flux.calls"] == 4 and c["flux.kernel"] == 4


def _refused(*args):
    raise AssertionError("the plain body ran")


def test_a_with_a_tangent_takes_the_plain_body(monkeypatch):
    """On CPU tensors: a tangent in ``a`` or in both operands goes through
    the plain body, as every CPU call does."""
    _refuse(monkeypatch)
    rng = np.random.default_rng(4)
    a, v, t, s = (torch.tensor(rng.standard_normal((13, 17))) for _ in range(4))
    out, tangent = torch.func.jvp(lambda w: stencils.flux_div_x(w, v, 9.0), (a,), (t,))
    want, want_t = torch.func.jvp(lambda w: stencils.flux_div_x_plain(w, v, 9.0), (a,), (t,))
    assert torch.equal(out, want) and torch.equal(tangent, want_t)
    out, tangent = torch.func.jvp(lambda x, w: stencils.flux_div_y(x, w, 9.0), (a, v), (t, s))
    want, want_t = torch.func.jvp(lambda x, w: stencils.flux_div_y_plain(x, w, 9.0),
                                  (a, v), (t, s))
    assert torch.equal(out, want) and torch.equal(tangent, want_t)


def _plain_launch(calls):
    """A stand-in for the kernel's launch: the plain body on the CPU, which
    records the launch's axis and that both operands have storage (a
    transform's wrapper has none)."""
    def launch(a, v, axis, inv_h2):
        a.data_ptr(), v.data_ptr()
        calls.append(axis)
        return (stencils.flux_div_x_plain if axis == -1 else stencils.flux_div_y_plain)(
            a, v, inv_h2)

    return launch


def test_the_kernels_forward_mode_rule_is_the_launch_on_the_tangent(monkeypatch):
    """The rule's plumbing, with the launch played by the plain body on the
    CPU: ``torch.func.jvp`` in ``v`` through the kernel's wrapper gives the
    flux of the primal and of the tangent, a launch each, and each launch
    gets tensors with storage (a transform's wrapper has none)."""
    calls = []
    monkeypatch.setattr(stencils, "_launch_flux", _plain_launch(calls))
    a, v = _fields((13, 17))
    t = _fields((13, 17), seed=6)[1]
    out, tangent = torch.func.jvp(lambda w: stencils.flux_div_kernel(a, w, -2, 9.0), (v,), (t,))
    assert calls == [-2, -2]
    assert torch.equal(out, stencils.flux_div_y_plain(a, v, 9.0))
    assert torch.equal(tangent, stencils.flux_div_y_plain(a, t, 9.0))


@pytest.mark.parametrize("which", ["a", "both"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_the_kernels_forward_mode_rule_is_bilinear(monkeypatch, axis, which):
    """A tangent in ``a``: the launch on ``(a's tangent, v)``; in both
    operands, that plus the launch on ``(a, v's tangent)``.  No launch for
    an operand without a tangent.  Against ``torch.func.jvp`` of the plain
    body, which sums the product rule's terms in another order."""
    calls = []
    monkeypatch.setattr(stencils, "_launch_flux", _plain_launch(calls))
    plain = stencils.flux_div_x_plain if axis == -1 else stencils.flux_div_y_plain
    a, v = _fields((13, 17))
    ta, tv = _fields((13, 17), seed=6)
    primals, tangents = ((a,), (ta,)) if which == "a" else ((a, v), (ta, tv))

    def through(f):
        return (lambda x: f(x, v, 9.0)) if which == "a" else (lambda x, w: f(x, w, 9.0))

    out, tangent = torch.func.jvp(
        through(lambda x, w, ih: stencils.flux_div_kernel(x, w, axis, ih)), primals, tangents)
    want, want_t = torch.func.jvp(through(plain), primals, tangents)
    assert calls == [axis] * (2 if which == "a" else 3)
    assert torch.equal(out, want)
    assert torch.equal(tangent, plain(ta, v, 9.0) if which == "a"
                       else plain(ta, v, 9.0) + plain(a, tv, 9.0))
    torch.testing.assert_close(tangent, want_t, rtol=1e-12, atol=1e-12 * float(want_t.abs().max()))


def test_the_kernel_has_no_reverse_mode_rule(monkeypatch):
    monkeypatch.setattr(stencils, "_launch_flux", _plain_launch([]))
    a, v = _fields((13, 17))
    out = stencils.flux_div_kernel(a, v.requires_grad_(), -1, 9.0)
    with pytest.raises(NotImplementedError):
        out.sum().backward()


def test_fields_of_two_dtypes_raise():
    """Before any launch: the kernel reads both fields in one dtype."""
    a = torch.empty((13, 17), dtype=torch.float64, device="meta")
    with pytest.raises(TypeError, match="one dtype"):
        stencils.flux_div_kernel(a, a.float(), -1, 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        stencils.flux_div_kernel(a.float(), a, -2, 1.0)


def test_mems_step_counts_its_flux_calls():
    """At 51^2 on the CPU: 4 flux calls a residual evaluation (the
    biharmonic's two curvilinear Laplacians, x and y each) and 4 for the
    step's ``cn_term``; none launched the kernel."""
    torch.set_num_threads(1)
    cfg = tm.MEMSConfig()
    step = tm.make_step(cfg, NewtonKrylov(f_tol=6e-6, maxiter=40, inner_m=20, outer_k=8),
                        device="cpu")
    u, q = tm.initial_state(cfg, device="cpu")
    with trace.tracing():
        out = step(u, q)
    (c,) = trace.take().counters.values()
    assert out.converged and c["mems.residual_evals"] > out.newton_iters
    assert c["flux.calls"] == 4 * c["mems.residual_evals"] + 4
    assert c.get("flux.kernel", 0) == 0


def test_a_droplet_residual_counts_two_flux_calls():
    fix, g = tfx.load_golden_step()
    cfg = tfx.config_for(fix)
    u, q = convert.state_from_numpy(fix.u, fix.q, "cpu")
    geom = cv.mesh_geometry(q, cfg.grid)
    with trace.tracing():
        tdp.cn_residual(u, u, torch.zeros_like(u), float(g["dt"]), geom, cfg)
    (c,) = trace.take().counters.values()
    assert c["flux.calls"] == 2 and c.get("flux.kernel", 0) == 0


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flux_div kernel has no CPU mode")
    return torch.device("cuda")


def _kernel(axis, a, v):
    before = launch_count("flux_div")
    got = WRAPPER[axis](a, v, IH[axis])
    assert launch_count("flux_div") == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(51, 51), (61, 91), (1024, 1024), "narrow", (3, 51, 51),
                                   "transposed", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("axis", ["x", "y"])
def test_kernel_is_the_plain_body(cuda, axis, dtype, shape):
    if shape == "narrow" and axis == "x":
        a, v = (f.transpose(-1, -2).contiguous() for f in _fields(shape, dtype, cuda))
    else:
        a, v = _fields(shape, dtype, cuda)
    got = _kernel(axis, a, v)
    want = PLAIN[axis](a, v, IH[axis])
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("axis", ["x", "y"])
def test_forward_mode_takes_the_kernel_on_the_tangent(cuda, axis):
    a, v = _fields((61, 91), torch.float64, cuda)
    t = _fields((61, 91), torch.float64, cuda, seed=6)[1]
    before = launch_count("flux_div")
    out, tangent = torch.func.jvp(lambda w: WRAPPER[axis](a, w, IH[axis]), (v,), (t,))
    assert launch_count("flux_div") == before + 2
    want, want_t = torch.func.jvp(lambda w: PLAIN[axis](a, w, IH[axis]), (v,), (t,))
    assert torch.equal(out, want) and torch.equal(tangent, want_t)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["a", "both"])
@pytest.mark.parametrize("axis", ["x", "y"])
def test_forward_mode_in_a_takes_the_kernel(cuda, axis, which):
    """The bilinear rule on the card: one launch for each operand that
    carries a tangent, besides the primal's."""
    a, v = _fields((61, 91), torch.float64, cuda)
    ta, tv = _fields((61, 91), torch.float64, cuda, seed=6)
    primals, tangents = ((a,), (ta,)) if which == "a" else ((a, v), (ta, tv))

    def through(f):
        return (lambda x: f(x, v, IH[axis])) if which == "a" else (lambda x, w: f(x, w, IH[axis]))

    before = launch_count("flux_div")
    out, tangent = torch.func.jvp(through(WRAPPER[axis]), primals, tangents)
    assert launch_count("flux_div") == before + (2 if which == "a" else 3)
    want, want_t = torch.func.jvp(through(PLAIN[axis]), primals, tangents)
    assert torch.equal(out, want)
    torch.testing.assert_close(tangent, want_t, rtol=1e-12, atol=1e-12 * float(want_t.abs().max()))


@pytest.mark.gpu
def test_other_cuda_tensors_raise(cuda):
    a = torch.ones((8, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        stencils.flux_div_x(a, a, 1.0)
    with pytest.raises(ValueError):
        stencils.flux_div_y(*(torch.ones((5, 8), device=cuda) for _ in range(2)), 1.0)
    with pytest.raises(ValueError):
        stencils.flux_div_x(torch.ones((8, 8), device=cuda), torch.ones((8, 9), device=cuda), 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        stencils.flux_div_x(torch.ones((8, 8), dtype=torch.float64, device=cuda),
                            torch.ones((8, 8), device=cuda), 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        stencils.flux_div_y(torch.ones((8, 8), device=cuda),
                            torch.ones((8, 8), dtype=torch.float64, device=cuda), 1.0)
