"""The PMA sub-step's fused kernels (``ops/pma_substep.py``,
``csrc/pma_substep.cu``): tiling rehearsal, the rule by which ``loop_pma``
takes them, and the kernels on the card.

CPU: the plain version is the eager chain itself (``mesh_geometry_dev``,
``monitor_source``, ``smooth_pass``, the Mackenzie floor).
``pma_substep_tiled_sim`` runs those functions tile by tile, their
``staged`` hook holding only what the kernels stage (NaN elsewhere), and
matches the eager chain bit for bit but for the Mackenzie sum, which it
takes by tiles (1e-6 relative: f32 rounding of a sum in another order).
The fused loop's own code (``substep``, ``loop_pma``'s fused branch) runs
here with the stage wrappers replaced by their eager counterparts.

Card (``gpu``): every stage equals the eager chain on the card bit for bit,
its stencils the plain bodies (``stencils.PLAIN``: on the card ``d1_x`` and
the others launch a kernel of their own).  The plain bodies take their
one-sided edge rows from a cuBLAS product, summed as one FMA chain at grids
of 768 rows and more and in another order below; the kernels take the
chain.  So at 1024^2 the kernels are held to
the eager chain as it is, and at every grid to the eager chain with its
edge rows summed as that chain (emulated in float64 with a rounding to
float32 after each step).  No JAX here, so the card's machine runs them:
``python -m pytest --noconftest -m gpu tests/test_torch_pma_substep.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.core.grid import Grid2D
from iterative_solvers_tpu_torch.meshmove import pma
from iterative_solvers_tpu_torch.meshmove.monitor import smooth_pass
from iterative_solvers_tpu_torch.models import droplet as dp
from iterative_solvers_tpu_torch.ops import curvilinear as cv, pma_substep as ps, stencils
from iterative_solvers_tpu_torch.ops._build import launch_count
from iterative_solvers_tpu_torch.utils import trace

STAGES = ["source", "smooth", "rhs", "divide", "accumulate"]

SHAPES = [(48, 48), (61, 91), (29, 37)]
ALPHA, GAMMA, C = 0.01, 0.1, 0.15


def _case(ny, nx, device="cpu", seed=3):
    """A droplet-like film on the coalescence domain and a smooth deviation
    potential with a little noise (J near 1), f32: ``(grid, base, s, u)``."""
    grid = Grid2D(nx=nx, ny=ny, xl=-3.0, xr=6.0, yb=-3.0, yt=3.0)
    xx, yy = np.meshgrid(np.linspace(-3.0, 6.0, nx), np.linspace(-3.0, 3.0, ny))
    rng = np.random.default_rng(seed)
    noise = 1e-3 * grid.dx * grid.dy   # second differences of O(1e-3)
    phi = 0.02 * np.sin(xx) * np.cos(yy) + noise * rng.standard_normal((ny, nx))
    u = 0.005 + np.exp(-4.0 * (xx ** 2 + yy ** 2)) + np.exp(-4.0 * ((xx - 3.0) ** 2 + yy ** 2))
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return grid, f(phi), f(1e-6 * rng.standard_normal((ny, nx))), f(u)


def _params(**kw):
    return dataclasses.replace(pma.PMAParams(alpha=ALPHA, gamma=GAMMA, mackenzie_c=C,
                                             spectral_dtype="float32",
                                             mesh_dtype="float32"), **kw)


def _eager_stages(base, s, u, grid):
    """The eager chain's stages: src, J, the metric, the 4 passes, the floor;
    its stencils the plain bodies, on the card too."""
    geom = cv.mesh_geometry_dev(base + s, grid, fd=stencils.PLAIN)
    src = dp.monitor_source(u, geom, grid, fd=stencils.PLAIN)
    j = geom.jac
    metric = ((geom.xy * geom.xy + geom.yy * geom.yy) / j,
              (geom.xy * geom.xy + geom.xx * geom.xx) / j,
              -(geom.xy * (geom.xx + geom.yy)) / j)
    passes, mon = [], src
    for _ in range(4):
        mon = smooth_pass(mon)
        passes.append(mon)
    floor = C * (torch.sum(mon * torch.abs(j)) * grid.dx * grid.dy)
    return {"src": src, "jac": j, "metric": metric, "passes": passes, "floor": floor}


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


# -- the plain version and the tiling rehearsal (CPU) -------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_staged_hooks_change_nothing(shape):
    """The ``staged`` hook of the eager functions the kernels fuse names the
    planes the source kernel keeps in shared memory, and changes nothing."""
    grid, base, s, u = _case(*shape)
    seen = []

    def hook(name, f):
        seen.append(name)
        return f

    geom = cv.mesh_geometry_dev(base + s, grid, staged=hook)
    src = dp.monitor_source(u, geom, grid, staged=hook)
    plain = cv.mesh_geometry_dev(base + s, grid)
    assert all(torch.equal(a, b) for a, b in zip(geom, plain))
    assert torch.equal(src, dp.monitor_source(u, plain, grid))
    # every staged plane but phi, which the caller stages, once
    assert sorted(seen) == sorted(set(ps.source_regions((0, 8), (0, 8), *shape)) - {"phi"})


@pytest.mark.parametrize("name", STAGES)
def test_stage_wrappers_take_only_cuda_tensors(name):
    """No CPU branch: the plain version is the eager chain, which
    ``loop_pma`` runs on the CPU."""
    grid, base, s, u = _case(29, 37)
    uk, ue = ps.film_gradient(u, grid)
    den = torch.ones_like(s)
    call = {"source": lambda: ps.source(base, s, u, uk, ue, grid),
            "smooth": lambda: ps.smooth(s, s),
            "rhs": lambda: ps.rhs(s, s, s.new_zeros(ps.partials_count(grid)), grid, C, ALPHA),
            "divide": lambda: ps.divide(s, den),
            "accumulate": lambda: ps.accumulate(s, s, 1e-9)}[name]
    before = launch_count(f"pma_{name}")
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert launch_count(f"pma_{name}") == before


# (ny, nx), source tile, smoothing tile: the kernels' tiles, and smaller
# ones whose edges fall 1-6 points from the domain's
TILINGS = [((48, 48), ps.SOURCE_TILE, ps.SMOOTH_TILE),
           ((61, 91), ps.SOURCE_TILE, ps.SMOOTH_TILE),
           ((29, 37), ps.SOURCE_TILE, ps.SMOOTH_TILE),
           ((61, 91), (16, 16), (16, 8)),
           ((29, 37), (8, 12), (8, 32)),
           ((37, 29), (13, 7), (5, 9))]


@pytest.mark.parametrize("shape,tile,smooth_tile", TILINGS)
def test_tiled_sim_equals_plain(shape, tile, smooth_tile):
    grid, base, s, u = _case(*shape)
    got = ps.pma_substep_tiled_sim(base, s, u, grid, monitor_source=dp.monitor_source,
                                   smooth_pass=smooth_pass, smoothing_iters=4, mackenzie_c=C,
                                   alpha=ALPHA, source_tile=tile, smooth_tile=smooth_tile)
    want = _eager_stages(base, s, u, grid)
    assert not torch.isnan(got["src"]).any(), "a staged region misses a tap"
    assert torch.equal(got["src"], want["src"]) and torch.equal(got["jac"], want["jac"])
    assert all(torch.equal(a, b) for a, b in zip(got["passes"], want["passes"]))
    assert abs(float(got["floor"] - want["floor"])) <= 1e-6 * float(want["floor"])
    want_rhs = torch.sqrt((want["passes"][-1] + want["floor"]) * torch.abs(want["jac"])) / ALPHA
    assert _rel(got["rhs"], want_rhs) <= 1e-6


# the staged planes each tap reads across: cut one point off the far side
# of a region along an axis it is read along, and the tile reads NaN
NEEDED = [("phi", 0), ("phi", 1), ("u", 0), ("u", 1), ("dxp", 0), ("dxp", 1), ("jac", 0),
          ("jac", 1), ("a11", 1), ("a22", 0), ("p", 1), ("q", 0)]


@pytest.mark.parametrize("name,axis", NEEDED)
def test_tiled_sim_sees_a_region_cut_short(monkeypatch, name, axis):
    grid, base, s, u = _case(61, 91)
    regions = ps.source_regions

    def cut(rows, cols, ny, nx):
        r = regions(rows, cols, ny, nx)
        box = list(r[name])
        lo, hi = box[axis]
        box[axis] = (lo, hi - 1) if hi < (ny, nx)[axis] else (lo + 1, hi)
        r[name] = tuple(box)
        return r

    monkeypatch.setattr(ps, "source_regions", cut)
    got = ps.pma_substep_tiled_sim(base, s, u, grid, monitor_source=dp.monitor_source,
                                   smooth_pass=smooth_pass, smoothing_iters=1, mackenzie_c=C,
                                   alpha=ALPHA)
    assert torch.isnan(got["src"]).any() or torch.isnan(got["jac"]).any()


@pytest.mark.parametrize("ny,nx", [(8, 8), (9, 23), (29, 37), (61, 91), (100, 33), (1024, 1024)])
def test_source_regions_fit_the_kernels_shared_planes(ny, nx):
    """The kernel's static planes: phi (TY + 8) x (TX + 8), d1_x(phi)
    (TY + 8) x (TX + 4), the metric (TY + 4) x (TX + 4), u (TY + 6) x (TX + 6)."""
    ty, tx = ps.SOURCE_TILE
    bound = {"phi": (8, 8), "dxp": (8, 4), "u": (6, 6), "jac": (4, 4), "a11": (4, 4),
             "a22": (4, 4), "p": (4, 4), "q": (4, 4)}
    for i0 in range(0, ny, ty):
        for j0 in range(0, nx, tx):
            regions = ps.source_regions((i0, min(i0 + ty, ny)), (j0, min(j0 + tx, nx)), ny, nx)
            for name, ((a, b), (c, d)) in regions.items():
                assert b - a <= ty + bound[name][0] and d - c <= tx + bound[name][1], name


# -- when loop_pma takes the kernels (CPU) -------------------------------------

def _droplet_cfg(ny, nx, **kw):
    return dp.DropletConfig(nx=nx, ny=ny, xl=-3.0, xr=6.0, yb=-3.0, yt=3.0, alpha=ALPHA,
                            gamma=GAMMA, mackenzie_c=C, **kw)


def _eager_loop(q, u, dt, loops, grid, params, monitor, geometry_fn, md):
    """Today's eager sub-loop, written out."""
    if md is None:
        for _ in range(loops):
            q = q + dt * pma.pma_dqdt(q, u, grid, params, monitor, geometry_fn)
        return q
    q0, um = q.to(md), u.to(md)
    acc = torch.zeros_like(q0)
    for _ in range(loops):
        acc = acc + dt * pma.pma_dqdt(q0 + acc, um, grid, params, monitor, geometry_fn)
    return q + acc.to(q.dtype)


@pytest.mark.parametrize("mesh_dtype,dtype", [("float32", torch.float64),
                                              (None, torch.float32)])
def test_cpu_loop_is_the_eager_loop(mesh_dtype, dtype):
    grid, base, _, u = _case(29, 37)
    params = _params(mesh_dtype=mesh_dtype)
    q, uu = base.to(dtype), u.to(dtype)
    got = pma.loop_pma(q, uu, 1e-9, 3, grid, params, dp.monitor_source, cv.mesh_geometry_dev)
    want = _eager_loop(q, uu, 1e-9, 3, grid, params, dp.monitor_source,
                       cv.mesh_geometry_dev, getattr(torch, mesh_dtype) if mesh_dtype else None)
    assert torch.equal(got, want)


def test_the_forms_the_kernels_compute_are_declared():
    assert cv.mesh_geometry_dev.pma_kernel == ps.GEOMETRY
    assert dp.monitor_source.pma_kernel == ps.MONITOR
    assert not hasattr(cv.mesh_geometry, "pma_kernel")


def _own_monitor(u, geom, grid):
    return dp.monitor_source(u, geom, grid)


# what each case changes from the fused case: (s dtype, u dtype, params, monitor, geometry)
RULE = {
    "fused": (torch.float32, torch.float32, {}, dp.monitor_source, cv.mesh_geometry_dev, True),
    "f64 state": (torch.float64, torch.float64, {}, dp.monitor_source, cv.mesh_geometry_dev,
                  False),
    "f64 film": (torch.float32, torch.float64, {}, dp.monitor_source, cv.mesh_geometry_dev,
                 False),
    "full geometry": (torch.float32, torch.float32, {}, dp.monitor_source, cv.mesh_geometry,
                      False),
    "no geometry": (torch.float32, torch.float32, {}, dp.monitor_source, None, False),
    "monitor without a kernel form": (torch.float32, torch.float32, {}, _own_monitor,
                                      cv.mesh_geometry_dev, False),
    "f64 spectral solve": (torch.float32, torch.float32, {"spectral_dtype": "float64"},
                           dp.monitor_source, cv.mesh_geometry_dev, False),
    "monitor cap": (torch.float32, torch.float32, {"monitor_cap": 10.0}, dp.monitor_source,
                    cv.mesh_geometry_dev, False),
    "no smoothing": (torch.float32, torch.float32, {"smoothing_iters": 0}, dp.monitor_source,
                     cv.mesh_geometry_dev, False),
    "state requires grad": ("grad", torch.float32, {}, dp.monitor_source,
                            cv.mesh_geometry_dev, False),
    "film requires grad": (torch.float32, "grad", {}, dp.monitor_source,
                           cv.mesh_geometry_dev, False),
}


def _field(grid, dtype):
    """Zeros of ``dtype``; ``"grad"``: f32 zeros that require a gradient."""
    if dtype == "grad":
        return torch.zeros(grid.shape, dtype=torch.float32, requires_grad=True)
    return torch.zeros(grid.shape, dtype=dtype)


@pytest.mark.parametrize("case", list(RULE))
def test_the_rule_reads_only_the_inputs(case):
    sd, ud, kw, monitor, geometry_fn, fused = RULE[case]
    grid = Grid2D(nx=37, ny=29)
    s, u = _field(grid, sd), _field(grid, ud)
    params = _params(**kw)
    assert pma._fused_form(s, u, grid, params, monitor, geometry_fn) is fused
    assert pma._fused(s, u, grid, params, monitor, geometry_fn) is False  # CPU tensors


@pytest.fixture
def cpu_stages(monkeypatch):
    """The fused loop on the CPU: the device test lifted and the five stage
    wrappers replaced by their eager counterparts, so that ``substep`` and
    ``loop_pma``'s fused branch run here as they do on the card."""
    def source(base, s, u, u_ksi, u_eta, grid, stages=None):
        assert all(torch.equal(a, b) for a, b in zip((u_ksi, u_eta),
                                                     ps.film_gradient(u, grid)))
        geom = cv.mesh_geometry_dev(s if base is None else base + s, grid)
        return dp.monitor_source(u, geom, grid), geom.jac

    def smooth(t, jac=None):
        mon = smooth_pass(t)
        return mon if jac is None else (mon, torch.sum(mon * torch.abs(jac)).reshape(1))

    def rhs(mon, jac, partials, grid, mackenzie_c, alpha, floor_out=None):
        floor = mackenzie_c * (torch.sum(partials) * grid.dx * grid.dy)
        return torch.sqrt((mon + floor) * torch.abs(jac)) / alpha

    monkeypatch.setattr(pma, "_fused", pma._fused_form)
    for name, fn in (("source", source), ("smooth", smooth), ("rhs", rhs),
                     ("divide", lambda spec, den: spec / den),
                     ("accumulate", lambda s, dqdt, dt: s + dt * dqdt)):
        monkeypatch.setattr(ps, name, fn)


def _spans_of(fn):
    trace.take()
    with trace.tracing():
        out = fn()
    return out, trace.take().spans


@pytest.mark.parametrize("mesh_dtype,dtype", [("float32", torch.float64),
                                              (None, torch.float32)])
def test_a_fused_substep_opens_one_fused_span(cpu_stages, mesh_dtype, dtype):
    """One ``pma.fused`` span inside each ``pma.substep`` span, and the
    eager loop's result bit for bit."""
    grid, base, _, u = _case(29, 37)
    params = _params(mesh_dtype=mesh_dtype)
    q, uu = base.to(dtype), u.to(dtype)
    got, spans = _spans_of(lambda: pma.loop_pma(q, uu, 1e-9, 3, grid, params,
                                                dp.monitor_source, cv.mesh_geometry_dev))
    fused = [sp for sp in spans if sp.name == "pma.fused"]
    assert len(fused) == 3 and len([sp for sp in spans if sp.name == "pma.substep"]) == 3
    assert all(spans[sp.parent].name == "pma.substep" for sp in fused)
    want = _eager_loop(q, uu, 1e-9, 3, grid, params, dp.monitor_source,
                       cv.mesh_geometry_dev, getattr(torch, mesh_dtype) if mesh_dtype else None)
    assert torch.equal(got, want)
    _, spans = _spans_of(lambda: pma.loop_pma(q, uu, 1e-9, 3, grid, params, _own_monitor,
                                              cv.mesh_geometry_dev))
    assert not [sp for sp in spans if sp.name == "pma.fused"]


@pytest.mark.parametrize("mesh_dtype,dtype", [("float32", torch.float64),
                                              (None, torch.float32)])
def test_a_state_that_requires_grad_takes_the_eager_loop(cpu_stages, mesh_dtype, dtype):
    """The kernels have no derivative rule: such a state runs the eager
    loop, as before the kernels, with its graph."""
    grid, base, _, u = _case(29, 37)
    params = _params(mesh_dtype=mesh_dtype)
    q = base.to(dtype).requires_grad_()
    got, spans = _spans_of(lambda: pma.loop_pma(q, u.to(dtype), 1e-9, 2, grid, params,
                                                dp.monitor_source, cv.mesh_geometry_dev))
    assert not [sp for sp in spans if sp.name == "pma.fused"]
    assert got.requires_grad
    want = _eager_loop(q, u.to(dtype), 1e-9, 2, grid, params, dp.monitor_source,
                       cv.mesh_geometry_dev, getattr(torch, mesh_dtype) if mesh_dtype else None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision,fine", [("high", True), ("highest", True),
                                            ("default", False), ("medium", False)])
def test_the_fused_loop_takes_the_spectral_precision(cpu_stages, precision, fine):
    """``spectral_precision`` reaches the DCT of the fused sub-step: what
    the eager loop takes it takes, what the eager loop refuses it refuses."""
    grid, base, _, u = _case(29, 37)
    params = _params(spectral_precision=precision)
    q = base.double()

    def run():
        return pma.loop_pma(q, u.double(), 1e-9, 2, grid, params, dp.monitor_source,
                            cv.mesh_geometry_dev)
    if not fine:
        with pytest.raises(ValueError, match="precision"):
            run()
        with pytest.raises(ValueError, match="precision"):
            _eager_loop(q, u.double(), 1e-9, 2, grid, params, dp.monitor_source,
                        cv.mesh_geometry_dev, torch.float32)
        return
    got, spans = _spans_of(run)
    assert len([sp for sp in spans if sp.name == "pma.fused"]) == 2
    want = _eager_loop(q, u.double(), 1e-9, 2, grid, params, dp.monitor_source,
                       cv.mesh_geometry_dev, torch.float32)
    assert torch.equal(got, want)


# -- the kernels on the card ---------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pma_substep kernels have no CPU mode")
    return torch.device("cuda")


def _edge_rows_as_one_fma_chain(u, name):
    """``stencils._edge_rows`` with each row's products summed as one FMA
    chain from the first term (float64 products, rounded to float32 after
    each step): cuBLAS's order at 768 rows and more, at any grid."""
    c = stencils._edge_coefs(name, torch.float32, u.device).double()
    w = c.shape[1]
    strip = (u[..., :w] if name.endswith("_lo") else u[..., -w:]).double()
    acc = torch.zeros(strip.shape[:-1] + (2,), dtype=torch.float64, device=u.device)
    for k in range(w):
        acc = (strip[..., k:k + 1] * c[:, k] + acc).float().double()
    return acc.float()


def _card_stages(base, s, u, grid):
    uk, ue = ps.film_gradient(u, grid)
    stages = torch.empty((3, *grid.shape), dtype=torch.float32, device=s.device)
    src, jac = ps.source(base, s, u, uk, ue, grid, stages=stages)
    return src, jac, stages


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (800, 1000)])
def test_source_kernel_is_the_eager_chain_bit_for_bit(cuda, shape):
    """At grids of 768 rows and more the eager chain itself, unchanged."""
    grid, base, s, u = _case(*shape, device=cuda)
    before = launch_count("pma_source")
    src, jac, stages = _card_stages(base, s, u, grid)
    assert launch_count("pma_source") == before + 1
    want = _eager_stages(base, s, u, grid)
    assert torch.equal(jac, want["jac"])
    for got, w in zip(stages, want["metric"]):
        assert torch.equal(got, w)
    assert torch.equal(src, want["src"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (61, 91), (29, 37), (48, 48), (8, 8),
                                   (9, 23), (100, 33)])
def test_source_kernel_is_the_chained_edge_rows_chain_bit_for_bit(cuda, monkeypatch, shape):
    monkeypatch.setattr(stencils, "_edge_rows", _edge_rows_as_one_fma_chain)
    grid, base, s, u = _case(*shape, device=cuda)
    src, jac, stages = _card_stages(base, s, u, grid)
    want = _eager_stages(base, s, u, grid)
    assert torch.equal(jac, want["jac"])
    for got, w in zip(stages, want["metric"]):
        assert torch.equal(got, w)
    assert torch.equal(src, want["src"])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (61, 91), (29, 37), (8, 8), (65, 33)])
def test_smoothing_passes_floor_and_pointwise_kernels(cuda, shape):
    grid, base, s, u = _case(*shape, device=cuda)
    want = _eager_stages(base, s, u, grid)
    before = launch_count("pma_smooth")
    mon = want["src"]
    for k in range(4):
        mon = ps.smooth(mon) if k < 3 else ps.smooth(mon, want["jac"])[0]
        assert torch.equal(mon, want["passes"][k]), k
    assert launch_count("pma_smooth") == before + 4
    _, partials = ps.smooth(want["passes"][2], want["jac"])
    assert partials.numel() == ps.partials_count(grid)

    floors = [torch.empty(1, dtype=torch.float32, device=cuda) for _ in range(2)]
    rhs = [ps.rhs(mon, want["jac"], partials, grid, C, ALPHA, floor_out=f) for f in floors]
    assert torch.equal(floors[0], floors[1]) and torch.equal(rhs[0], rhs[1])
    floor = float(floors[0])
    assert abs(floor - float(want["floor"])) <= 4 * np.spacing(np.float32(floor))
    assert torch.equal(rhs[0], torch.sqrt((mon + floors[0]) * torch.abs(want["jac"])) / ALPHA)

    den = 1.0 - GAMMA * torch.as_tensor(pma.pma_leig(grid), dtype=torch.float32, device=cuda)
    assert torch.equal(ps.divide(rhs[0], den), rhs[0] / den)
    assert torch.equal(ps.accumulate(s, rhs[0], 1e-9), s + 1e-9 * rhs[0])


def _eager_geometry(q, grid):
    """mesh_geometry_dev without its kernel form: the eager sub-loop."""
    return cv.mesh_geometry_dev(q, grid)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (61, 91), (29, 37)])
def test_fused_loop_against_the_eager_loop(cuda, shape):
    """The increment after 1 and 20 sub-steps within 1e-6 of its max of the
    eager sub-loop's (the Mackenzie sum's order apart, the same numbers),
    and the main path through the kernels: 12 launches a sub-step."""
    ny, nx = shape
    cfg = _droplet_cfg(ny, nx, spectral_dtype="float32", mesh_dtype="float32")
    grid, base, _, u = _case(ny, nx, device=cuda)
    q, uu = base.double(), u.double()
    for loops in (1, 20):
        counts = [launch_count(f"pma_{k}") for k in STAGES]
        got = pma.loop_pma(q, uu, 1e-9, loops, grid, cfg.pma, dp.monitor_source,
                           cv.mesh_geometry_dev)
        assert [launch_count(f"pma_{k}") for k in STAGES] == [
            c + k * loops for c, k in zip(counts, (1, 4, 1, 1, 1))]
        want = pma.loop_pma(q, uu, 1e-9, loops, grid, cfg.pma, dp.monitor_source,
                            _eager_geometry)
        inc, inc_want = got - q, want - q
        assert float(inc_want.abs().max()) > 0
        assert _rel(inc, inc_want) <= 1e-6, (loops, _rel(inc, inc_want))


@pytest.mark.gpu
def test_fused_loop_runs_twelve_kernels_a_substep(cuda):
    """The device's kernels in a profile at 1024^2, 6 sub-steps less 2: the
    8 of ``csrc/pma_substep.cu`` and the DCT matmuls' (4, and a split-K
    reduction where cuBLAS takes one), nothing else."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _droplet_cfg(1024, 1024, spectral_dtype="float32", mesh_dtype="float32")
    grid, base, _, u = _case(1024, 1024, device=cuda)
    args = (base.double(), u.double(), 1e-10)
    pma.loop_pma(*args, 2, grid, cfg.pma, dp.monitor_source, cv.mesh_geometry_dev)
    torch.cuda.synchronize()
    kernels = []
    for loops in (2, 6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pma.loop_pma(*args, loops, grid, cfg.pma, dp.monitor_source, cv.mesh_geometry_dev)
            torch.cuda.synchronize()
        kernels.append({e.key: e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
    per_substep = {k: (n - kernels[0].get(k, 0)) / 4 for k, n in kernels[1].items()}
    ours = sum(n for k, n in per_substep.items() if "pma_" in k)
    others = {k: n for k, n in per_substep.items() if "pma_" not in k and n}
    assert ours == 8, per_substep
    assert 4 <= sum(others.values()) <= 5, others
    assert all("gemm" in k.lower() or "splitk" in k.lower() for k in others), others


@pytest.mark.gpu
def test_kernels_raise_on_what_they_do_not_take(cuda):
    grid, base, s, u = _case(16, 24, device=cuda)
    uk, ue = ps.film_gradient(u, grid)
    with pytest.raises(TypeError):
        ps.source(base, s.double(), u, uk, ue, grid)
    with pytest.raises(ValueError):
        ps.source(base, s[:, :16], u, uk, ue, grid)
    with pytest.raises(ValueError, match="contiguous"):
        ps.source(base, s.t().contiguous().t(), u, uk, ue, grid)
    with pytest.raises(ValueError, match="same device"):
        ps.source(base, s, u.cpu(), uk, ue, grid)
    with pytest.raises(ValueError):
        ps.smooth(s[:4].contiguous())
    with pytest.raises(ValueError):   # one partial sum a smoothing block
        ps.rhs(s, s, s.new_zeros(3), grid, C, ALPHA)
    with pytest.raises(RuntimeError, match="no derivative rule"):
        ps.accumulate(s.clone().requires_grad_(), s, 1e-9)
    r = ps.source_resources()
    assert r["threads"] == 256 and r["blocks_per_sm"] >= 1, r


# -- the benchmark's reader of the engagement ----------------------------------

def test_pma_fused_share_reads_the_program_spans():
    """``portbench/metrics/pma.fused_share.py``: the calls of ``pma.fused``
    over those of ``pma.substep``; 0.0 without ``pma.fused`` (a program
    without the kernels); nothing where no PMA ran or nothing was read."""
    from portbench import program
    from portbench.run import ROOT, Run, load_reader

    read = load_reader(ROOT, "pma.fused_share").read
    ms = 1_000_000

    def run_of(names):
        spans = [trace.Span("step", 0, None, 0, 100 * ms)]
        spans += [trace.Span(n, 0, 0, k * ms, (k + 1) * ms) for k, n in enumerate(names)]
        run = Run()
        run.program_reading = program.reduce_traced([trace.Trace(spans, {})], wall_s=0.1)
        return run

    assert read(run_of(["pma.substep", "pma.fused"] * 3)) == 1.0
    assert read(run_of(["pma.substep", "pma.fused", "pma.substep", "pma.substep"])) == 1 / 3
    assert read(run_of(["pma.substep"] * 4)) == 0.0
    assert read(run_of(["krylov.cycle"])) is None
    assert read(Run()) is None   # outside a benchmark run: nothing read
