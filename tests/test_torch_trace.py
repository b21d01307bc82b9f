"""The port's tracing (``utils/trace``): spans, step ids and counters, the
switch, the profiler's view, the host-sync counter's identities on CPU
solves, and results bit for bit equal with tracing on and off."""
import dataclasses
from collections import Counter
from functools import partial

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.io import convert, fixtures as tfx
from iterative_solvers_tpu_torch.meshmove import pma as tpma
from iterative_solvers_tpu_torch.meshmove.monitor import smooth_and_regularise
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.models import mems as tm
from iterative_solvers_tpu_torch.models import swift_hohenberg as sh
from iterative_solvers_tpu_torch.ops import curvilinear
from iterative_solvers_tpu_torch.solvers import newton as tnewton
from iterative_solvers_tpu_torch.solvers.cg import cg
from iterative_solvers_tpu_torch.solvers.gmres import gmres
from iterative_solvers_tpu_torch.solvers.lgmres import lgmres
from iterative_solvers_tpu_torch.solvers.newton import NewtonKrylov
from iterative_solvers_tpu_torch.utils import trace
from iterative_solvers_tpu_torch.utils.trace import Span

SH = sh.SHConfig(n=32, d=20.0)
MEMS = tm.MEMSConfig(n=21)


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with tracing off and nothing recorded."""
    torch.set_num_threads(1)
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def sh_field(seed=3):
    return torch.randn((SH.n, SH.n), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def droplet():
    fix, g = tfx.load_golden_step()
    cfg = tfx.config_for(fix)
    u, q = convert.state_from_numpy(fix.u, fix.q, "cpu")
    return cfg, u, q, float(g["dt"])


def syncs(t):
    return sum(c.get("host.syncs", 0) for c in t.counters.values())


def test_spans_nest_with_parent_and_step_id():
    with trace.tracing():
        trace.count("outside")
        with trace.span("step"):
            with trace.span("newton.solve"):
                trace.count("k", 2)
                with trace.span("krylov.cycle"):
                    trace.count("k")
                with trace.span("step"):        # a step inside a step: its own id
                    trace.count("k", 5)
            with trace.span("pma.loop"):
                pass
        with trace.span("step"):
            trace.count("k")
    assert trace.span("a") is trace.span("b")          # off again after the block
    t = trace.take()
    names = [s.name for s in t.spans]
    assert names == ["step", "newton.solve", "krylov.cycle", "step", "pma.loop", "step"]
    assert [s.parent for s in t.spans] == [None, 0, 1, 1, 0, None]
    a, b, c = t.spans[0].step, t.spans[3].step, t.spans[5].step
    assert [s.step for s in t.spans] == [a, a, a, b, a, c] and b == a + 1 and c == a + 2
    assert t.counters == {None: {"outside": 1}, a: {"k": 3}, b: {"k": 5}, c: {"k": 1}}
    for s in t.spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = t.spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    assert trace.take() == trace.Trace([], {})


def test_self_time_on_a_synthetic_nest():
    spans = [Span("step", 0, None, 0, 100),
             Span("newton.solve", 0, 0, 10, 90),
             Span("newton.residual", 0, 1, 10, 15),
             Span("krylov.cycle", 0, 1, 20, 50),
             Span("newton.jacobian", 0, 1, 50, 52),
             Span("krylov.cycle", 0, 1, 55, 80),
             Span("newton.solve", 1, None, 200, 240),
             Span("krylov.cycle", 1, 6, 210, 230),
             Span("krylov.cycle", 1, None, 300, 310)]   # not under a solve
    assert trace.self_ns(spans, "newton.solve", ("krylov.cycle",)) == (80 - 30 - 25) + (40 - 20)
    assert trace.self_ns(spans, "newton.solve", ()) == 120
    assert trace.self_ns(spans, "step", ("newton.solve",)) == 20
    assert trace.self_ns(spans, "newton.solve",
                         ("krylov.cycle", "newton.residual", "newton.jacobian")) == 18 + 20


def test_take_inside_an_open_span_raises():
    with trace.tracing(), trace.span("step"):
        with pytest.raises(RuntimeError, match="open span 'step'"):
            trace.take()


def _raise(*a, **k):
    raise AssertionError("record_function entered")


def test_off_records_nothing_and_enters_no_annotation(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(trace, "trace_annotation", _raise)
    step = sh.make_cn_step(SH, sh.fast_solver(SH), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(sh_field())
    assert trace.span("step") is trace.span("newton.solve")   # the one shared no-op
    assert trace.take() == trace.Trace([], {})


def test_on_without_a_profiler_enters_no_annotation(monkeypatch):
    monkeypatch.setattr(trace, "trace_annotation", _raise)
    with trace.tracing():
        sh.make_cn_step(SH, sh.fast_solver(SH), device="cpu")(sh_field())
    assert Counter(s.name for s in trace.take().spans)["step"] == 1


def test_every_span_lies_in_the_profile(droplet):
    cfg, u, q, dt = droplet
    step = sh.make_cn_step(SH, sh.fast_solver(SH), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            trace.tracing():
        step(sh_field())
        sh.semi_implicit_step(sh_field(), sh_field(), SH, device="cpu")
        tpma.loop_pma(q, u, 1e-7, 3, cfg.grid, cfg.pma, tdp.monitor_source)
    spans = Counter(s.name for s in trace.take().spans)
    annotated = Counter(e.name for e in prof.events() if e.is_user_annotation)
    assert set(spans) == {"step", "newton.solve", "newton.residual", "newton.jacobian",
                          "krylov.cycle", "pma.loop", "pma.substep", "pma.geometry",
                          "pma.monitor", "pma.solve"}
    assert all(annotated[name] == n for name, n in spans.items())
    assert spans["pma.substep"] == 3 and spans["step"] == 2
    assert spans["pma.geometry"] == spans["pma.monitor"] == spans["pma.solve"] == 3


def _sh_newton(kind):
    """An SH CN solve set up three ways: the analytic f32 Jacobian, f64 FD
    matvecs, FD matvecs with an f32 inner cycle."""
    if kind == "analytic":
        solver = sh.fast_solver(SH)
    else:
        solver = NewtonKrylov(f_tol=6e-6, inner_m=10, outer_k=5,
                              inner_dtype="float32" if kind == "fd_f32" else None)
    u_old = sh_field()
    res = partial(sh.cn_residual, u_old=u_old, L_uold=sh.apply_L(u_old, SH), cfg=SH)
    return solver, res, u_old


@pytest.mark.parametrize("kind", ["analytic", "fd_f64", "fd_f32"])
def test_newton_sync_identity(kind):
    """With the line search on and one LGMRES cycle a Newton iteration the
    solve reads the device 1 + 5 a iteration + one an Arnoldi step + one a
    backtrack: ``func_evals + 4 iters``."""
    solver, res, u_old = _sh_newton(kind)
    assert solver.line_search and solver.inner_maxiter == 1
    with trace.tracing():
        out = solver.solve(res, u_old)
    t = trace.take()
    assert out.converged and out.iters >= 2
    assert syncs(t) == out.func_evals + 4 * out.iters
    names = Counter(s.name for s in t.spans)
    assert names["krylov.cycle"] == names["newton.jacobian"] == out.iters
    assert names["newton.solve"] == 1
    wait = sum(c.get("host.wait_ns", 0) for c in t.counters.values())
    assert 0 < wait <= t.spans[0].t1_ns - t.spans[0].t0_ns


def _system(n=60, seed=2):
    rng = np.random.default_rng(seed)
    a = torch.tensor(2.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n))
    return a, torch.tensor(rng.standard_normal(n))


@pytest.mark.parametrize("solver", ["gmres", "lgmres", "cg"])
def test_krylov_sync_identity(solver):
    """``gmres``: 2 + iterations + cycles reads; ``lgmres``: one more a
    cycle (the recycle push); ``cg``: one a test of the residual,
    iterations + 1 of them, and one each for the tolerance and the final
    residual."""
    a, b = _system()
    if solver == "cg":
        a = a @ a.T
    with trace.tracing():
        if solver == "gmres":
            out = gmres(lambda v: a @ v, b, tol=1e-10, restart=8)
        elif solver == "lgmres":
            out, _ = lgmres(lambda v: a @ v, b, tol=1e-10, inner_m=8, outer_k=3)
        else:
            out = cg(lambda v: a @ v, b, tol=1e-10)
    t = trace.take()
    cycles = sum(1 for s in t.spans if s.name == "krylov.cycle")
    assert out.converged and (solver == "cg" or cycles >= 2)
    want = {"gmres": 2 + out.iters + cycles, "lgmres": 2 + out.iters + 2 * cycles,
            "cg": out.iters + 3}[solver]
    assert syncs(t) == want


def test_pma_loop_reads_nothing_and_the_steady_iteration_once_a_substep(droplet):
    cfg, u, q, _ = droplet
    with trace.tracing():
        tpma.loop_pma(q, u, 1e-7, 4, cfg.grid, cfg.pma, tdp.monitor_source)
    t = trace.take()
    assert syncs(t) == 0
    phases = ["pma.geometry", "pma.monitor", "pma.solve"]
    assert [s.name for s in t.spans] == ["pma.loop"] + (["pma.substep"] + phases) * 4
    subs = [i for i, s in enumerate(t.spans) if s.name == "pma.substep"]
    assert all(t.spans[i].parent == 0 for i in subs)
    assert all(t.spans[i + k].parent == i for i in subs for k in (1, 2, 3))
    with trace.tracing():
        _, iters, _ = tpma.mesh_steady_state(q, u, 1e-7, cfg.grid, cfg.pma,
                                             tdp.monitor_source, atol=0.0, max_iters=3)
    assert iters == 3 and syncs(trace.take()) == 3


def _mems_steps(nsteps=2):
    """``nsteps`` MEMS steps from the flat state with the published solver."""
    step = tm.make_step(MEMS, NewtonKrylov(f_tol=6e-6, maxiter=40, inner_m=20, outer_k=8),
                        device="cpu")
    u, q = tm.initial_state(MEMS, device="cpu")
    outs = []
    for _ in range(nsteps):
        outs.append(step(u, q))
        u, q = outs[-1].u, outs[-1].q
    return outs


def test_mems_step_spans_its_mesh_half_counts_its_residuals_and_its_dt_read(monkeypatch):
    calls = []

    def counted(*args, **kw):
        calls.append(trace._state.step)
        return cn_residual(*args, **kw)

    cn_residual = tm.cn_residual
    monkeypatch.setattr(tm, "cn_residual", counted)
    with trace.tracing():
        outs = _mems_steps()
    t = trace.take()
    roots = [i for i, s in enumerate(t.spans) if s.parent is None]
    assert [t.spans[i].name for i in roots] == ["step", "step"]
    for i, out in zip(roots, outs):
        sid = t.spans[i].step
        inside = Counter(s.name for s in t.spans if s.parent == i)
        assert inside["mems.mesh"] == 1 and inside["newton.solve"] == 1
        assert out.converged and out.newton_iters >= 1
        assert t.counters[sid]["mems.residual_evals"] == calls.count(sid) > out.newton_iters
    assert sum(c["mems.residual_evals"] for c in t.counters.values()) == len(calls)
    # the dt read is counted under host.syncs: one read a step more than with
    # the same read made directly
    monkeypatch.setattr(tm, "to_host", lambda v, form: v.item())
    with trace.tracing():
        again = _mems_steps()
    t2 = trace.take()
    assert [o.newton_iters for o in again] == [o.newton_iters for o in outs]
    assert syncs(t) == syncs(t2) + 2


def test_mems_step_counts_its_stencil_calls():
    """At 51^2 on the CPU: 8 stencil calls a residual evaluation (the
    biharmonic's two curvilinear Laplacians, 4 each), 8 for the step's
    ``cn_term`` and 6 for the geometry; none launched the kernel."""
    cfg = tm.MEMSConfig()
    step = tm.make_step(cfg, NewtonKrylov(f_tol=6e-6, maxiter=40, inner_m=20, outer_k=8),
                        device="cpu")
    u, q = tm.initial_state(cfg, device="cpu")
    with trace.tracing():
        out = step(u, q)
    (c,) = trace.take().counters.values()
    assert out.converged and c["mems.residual_evals"] > out.newton_iters
    assert c["stencil.calls"] == 8 * c["mems.residual_evals"] + 14
    assert c.get("stencil.kernel", 0) == 0


def _full_form(cfg):
    """The headline bench's configuration of the golden state: float32
    spectral solve and mesh sub-loop, the mesh potential Q itself."""
    return dataclasses.replace(cfg, spectral_dtype="float32", mesh_dtype="float32")


_STEP_KW = {"fd_f32": {"solver": tdp.fast_solver()},
            "jvp_kernel": {"jvp_dtype": "float32", "jvp_kernel": True},
            "df64": {"jvp_dtype": "float32", "residual_mode": "df64"}}


@pytest.mark.parametrize("kind", sorted(_STEP_KW))
def test_droplet_step_counts_newton_evaluations_and_fd_matvecs(kind, droplet, monkeypatch):
    """``droplet.residual_evals`` is Newton's own evaluations (its
    ``newton.residual`` spans) plus one a finite-difference matvec; the JVP
    paths' matvecs evaluate no residual, under either residual mode."""
    cycle, matvecs = tnewton._lgmres_cycle, []

    def counted(mv, *args):
        def mv_counted(v):
            matvecs.append(trace._state.step)
            return mv(v)
        return cycle(mv_counted, *args)

    monkeypatch.setattr(tnewton, "_lgmres_cycle", counted)
    cfg, u, q, dt = droplet
    step = tdp.make_step(_full_form(cfg), dt=dt, dtmesh=3e-9, pma_loops=1, device="cpu",
                         **_STEP_KW[kind])
    with trace.tracing():
        out = step(u, q, dt)
    t = trace.take()
    (sid, c), = t.counters.items()
    own = sum(1 for s in t.spans if s.name == "newton.residual")
    assert out.converged and out.newton_iters >= 1 and matvecs.count(sid) == len(matvecs) > 0
    want = own + (len(matvecs) if kind == "fd_f32" else 0)
    assert c["droplet.residual_evals"] == want


def test_pma_phase_spans_enter_once_an_eager_substep_and_never_the_fused_loop(droplet,
                                                                            monkeypatch):
    cfg, u, q, dt = droplet
    step = tdp.make_step(_full_form(cfg), dt=dt, dtmesh=3e-9, pma_loops=3,
                         solver=tdp.fast_solver(), device="cpu")
    with trace.tracing():
        step(u, q, dt)
    spans = trace.take().spans
    names = Counter(s.name for s in spans)
    assert names["pma.substep"] == names["pma.geometry"] == names["pma.monitor"] == 3
    assert names["pma.solve"] == 3 and names["pma.loop"] == 1
    phases = [s for s in spans if s.name in ("pma.geometry", "pma.monitor", "pma.solve")]
    assert all(spans[s.parent].name == "pma.substep" for s in phases)
    # the fused loop: no eager sub-step, so none of the three
    monkeypatch.setattr(tpma, "_fused", lambda *a: True)
    monkeypatch.setattr(tpma.pma_substep, "film_gradient", lambda u, grid: (u, u))
    monkeypatch.setattr(tpma.pma_substep, "substep", lambda base, s, *a, **k: s + 1e-9)
    monkeypatch.setattr(tpma, "pma_dqdt", _raise)
    with trace.tracing():
        tpma.loop_pma(q, u, 1e-9, 3, cfg.grid, _full_form(cfg).pma, tdp.monitor_source)
    assert [s.name for s in trace.take().spans] == ["pma.loop"] + ["pma.substep",
                                                                   "pma.fused"] * 3


def test_full_form_step_untraced_is_the_written_out_chain(droplet):
    """With tracing off the published step's numbers are those of its
    operations written out in their order: the geometry of Q, the CN/JFNK
    solve, then the float32 sub-loop of geometry, monitor, smoothing and
    spectral solve, bit for bit."""
    cfg0, u, q, dt = droplet
    cfg = _full_form(cfg0)
    grid, params = cfg.grid, cfg.pma
    out = tdp.make_step(cfg, dt=dt, dtmesh=3e-9, pma_loops=3, solver=tdp.fast_solver(),
                        device="cpu")(u, q, dt)
    geom = curvilinear.mesh_geometry(q, grid)
    F = tdp.pde_rhs(u, geom, cfg)
    res = tdp.fast_solver().solve(partial(tdp.cn_residual, u_old=u, F=F, dt=dt, geom=geom,
                                          cfg=cfg), u)
    q0, um = q.float(), u.float()
    acc = torch.zeros_like(q0)
    for _ in range(3):
        g = curvilinear.mesh_geometry(q0 + acc, grid)
        mon = smooth_and_regularise(tdp.monitor_source(um, g, grid), g.jac, grid.dx, grid.dy,
                                    smoothing_iters=params.smoothing_iters,
                                    mackenzie_c=params.mackenzie_c, cap=params.monitor_cap)
        acc = acc + 3e-9 * tpma.solve_pma(mon, g.jac, grid, params)
    assert torch.equal(out.u, res.x) and out.f_norm == res.f_norm
    assert out.newton_iters == res.iters == 3 and out.converged
    assert torch.equal(out.q, q + acc.to(q.dtype))


def _run(case, droplet):
    if case == "mems":
        out = _mems_steps(1)[0]
        return (out.u, out.q), out
    if case == "sh_cn":
        return sh.make_cn_step(SH, sh.fast_solver(SH), device="cpu")(sh_field())
    if case == "sh_semi":
        return sh.semi_implicit_step(sh_field(), sh_field(4), SH, device="cpu")
    cfg, u, q, dt = droplet
    if case == "droplet_full":
        out = tdp.make_step(_full_form(cfg), dt=dt, dtmesh=3e-9, pma_loops=5,
                            solver=tdp.fast_solver(), device="cpu")(u, q, dt)
        return (out.u, out.q), out
    out = tdp.make_step(cfg, dt=dt, dtmesh=3e-9, pma_loops=5, jvp_dtype="float32",
                        jvp_kernel=True, device="cpu")(u, q, dt)
    return (out.u, out.q), out


@pytest.mark.parametrize("case", ["sh_cn", "sh_semi", "droplet", "mems", "droplet_full"])
def test_results_bit_for_bit_with_tracing_on_and_off(case, droplet):
    off = _run(case, droplet)
    with trace.tracing():
        on = _run(case, droplet)
    t = trace.take()
    assert syncs(t) > 0 and sum(1 for s in t.spans if s.name == "step") == 1
    for a, b in zip(torch.utils._pytree.tree_leaves(off), torch.utils._pytree.tree_leaves(on)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
