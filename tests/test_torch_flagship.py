"""The port's flagship droplet driver (``examples/droplet_flagship.py``) on
the CPU.

- n = 0, the reference's 91x61 grid: ``main`` with a cut inflation (5
  volume steps of 20 PMA sub-steps) and 2 evolve steps (400 PMA sub-steps
  each) against the JAX package's ``inflate``, ``make_step`` and the JAX
  driver's attempt / backoff / scale-law body under ``lax.scan``, on the
  same configuration: the inflation within 1e-12 of scale (the gate of
  ``test_torch_droplet_drivers.py``), then step by step equal Newton
  counts and ok flags, dt and t within rtol 1e-9 (the scale law's norm,
  read in Python floats), R_eff and the min spacing within 1e-10, u within
  1e-6 and q within 1e-5 (the bench step's gates against JAX); the record
  in the JAX driver's format, the asymptotic radius equal to the JAX law's;
- n = 256: 10 steps in 2 chunks of 5 with the sharded-checkpoint splice
  after the first (20 PMA sub-steps a step) against the same 10 steps in one
  chunk without it: the reload bit-exact, the records and the final state
  equal bit for bit, Newton iterating in the late steps; the same run and
  its inflation against the JAX driver's n >= 256 composition, step by
  step (tolerances in the test);
- the chunked inflation of n >= 2048 against one call, bit for bit;
- the settings at every grid against the JAX driver's formulas;
- without a card, every driver's default device raises.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.examples import droplet_flagship as fl
from iterative_solvers_tpu_torch.examples.droplet_longrun import H_WET
from iterative_solvers_tpu_torch.examples import mems_bdf_touchdown as mb
from iterative_solvers_tpu_torch.examples import mems_touchdown as mt
from iterative_solvers_tpu_torch.examples import sh_full_experiment as se
from iterative_solvers_tpu_torch.io import checkpoint as ck
from iterative_solvers_tpu_torch.models import mems as tm

VSTEPS, STEPS = 5, 2
SPLICE_STEPS, SPLICE_PMA = 10, 20   # n = 256: Newton first iterates at step 9


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _jax_flagship(s, vsteps: int, steps: int, pma_loops: int):
    """The JAX driver composed from the JAX package's functions as its
    ``main`` composes them at ``s.n``: ``inflate``, then its ``body`` (up to
    4 attempts under ``lax.while_loop``, the scale law) under ``lax.scan``.
    At n >= 256 the deviation-form mesh from q0 = 0, the f32-inner solver
    and ``make_step(jvp_dtype="float32", jvp_kernel=True,
    deviation_form=True)``, whose kernel runs its jnp mirror off the TPU."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from iterative_solvers_tpu.models import droplet as jdp
    from iterative_solvers_tpu.ops import curvilinear as jcv
    from iterative_solvers_tpu.solvers.newton import NewtonKrylov

    cfg = jdp.DropletConfig(**dataclasses.asdict(s.cfg))
    grid = cfg.grid
    if s.n == 0:
        geometry_fn, q0, solver, step_kw = (
            jcv.mesh_geometry, jdp.initial_mesh_potential(cfg, jnp.float64),
            jdp.fast_solver(), {})
    else:
        geometry_fn, q0 = jcv.mesh_geometry_dev, jnp.zeros(grid.shape, jnp.float64)
        solver = NewtonKrylov(f_tol=1e-5, maxiter=14, inner_m=12, outer_k=6,
                              inner_dtype="float32", max_backtracks=4)
        step_kw = {"jvp_dtype": "float32", "jvp_kernel": True, "deviation_form": True}
    q, u = jdp.inflate(cfg, fl.DROPS, vsteps=vsteps, dtmesh=s.dtmesh_inf, pma_loops=20,
                       q0=q0, geometry_fn=geometry_fn)
    q_inf, u_inf = np.asarray(q), np.asarray(u)
    step = jdp.make_step(cfg, dt=s.dt, dtmesh=s.dtmesh_ev, pma_loops=pma_loops,
                         solver=solver, **step_kw)

    def body(carry, _):
        uu, qq, scale, t = carry

        def attempt_cond(st):
            return (~st[3]) & (st[2] < 4)

        def attempt_body(st):
            _, sc, k, _ = st
            sc = jnp.where(k > 0, sc * 0.5, sc)
            out = step(uu, qq, s.dt * sc)
            ok = (out.converged & jnp.all(jnp.isfinite(out.u))
                  & jnp.all(jnp.isfinite(out.q)))
            return (out, sc, k + 1, ok)

        out0 = jdp.DropletStepResult(u=uu, q=qq, newton_iters=jnp.int32(0),
                                     f_norm=jnp.asarray(jnp.inf, uu.dtype),
                                     converged=jnp.bool_(False))
        out, scale_t, _, ok = lax.while_loop(
            attempt_cond, attempt_body, (out0, scale, jnp.int32(0), jnp.bool_(False)))
        dt_n = s.dt * scale_t
        u_n = jnp.where(ok, out.u, uu)
        q_n = jnp.where(ok, out.q, qq)
        geom_n = geometry_fn(q_n, grid)
        area = jnp.sum((u_n > H_WET) * jnp.abs(geom_n.jac)) * grid.dx * grid.dy
        scale_new = jnp.where(
            ok, scale_t + jnp.exp(-10.0 * s.norm_scale * jnp.sqrt(jnp.sum((u_n - uu) ** 2))),
            scale_t * 0.5)
        t_new = t + jnp.where(ok, dt_n, 0.0)
        return (u_n, q_n, scale_new, t_new), (
            out.newton_iters, out.f_norm, ok, dt_n, t_new, jnp.sqrt(area / np.pi),
            jdp.min_spacing(geom_n))

    carry, aux = jax.jit(lambda c: lax.scan(body, c, None, length=steps))(
        (u, q, jnp.asarray(1.0, u.dtype), jnp.asarray(0.0, u.dtype)))
    aux = [np.asarray(a) for a in aux]
    r_asym = jdp.asymptotic_radius_trajectory(cfg, float(aux[5][0]),
                                              np.concatenate(([0.0], aux[4])))[1:]
    return (q_inf, u_inf), carry, aux, np.asarray(r_asym)


def test_flagship_91x61_matches_jax(tmp_path, capsys):
    pytest.importorskip("jax")
    got = fl.main(["0", str(STEPS), str(VSTEPS), "device=cpu", f"out_dir={tmp_path}"])
    s = fl.setup(0)
    (q_inf, u_inf), carry, aux, r_asym = _jax_flagship(s, VSTEPS, STEPS, s.pma_loops)

    # the inflation, from the port's own call
    q, u, min_jac = fl.inflate(s, VSTEPS, "cpu")
    np.testing.assert_allclose(q.numpy(), q_inf, rtol=0, atol=1e-12 * np.abs(q_inf).max())
    np.testing.assert_allclose(u.numpy(), u_inf, rtol=0, atol=1e-12 * np.abs(u_inf).max())
    assert min_jac > 0

    iters, f_norms, oks, dts, ts, reffs, msps = aux
    recs = got["records"]
    assert [r["step"] for r in recs] == list(range(1, STEPS + 1))
    assert [r["newton_iters"] for r in recs] == iters.tolist()
    assert [r["converged"] for r in recs] == oks.tolist() == [True] * STEPS
    np.testing.assert_allclose([r["dt"] for r in recs], dts, rtol=1e-9, atol=0)
    np.testing.assert_allclose([r["t"] for r in recs], ts, rtol=1e-9, atol=0)
    np.testing.assert_allclose([r["r_eff"] for r in recs], reffs, rtol=0, atol=1e-10)
    np.testing.assert_allclose([r["min_spacing"] for r in recs], msps, rtol=0, atol=1e-10)
    assert all(r["f_norm"] <= 1e-7 for r in recs)
    assert got["final_scale"] == pytest.approx(float(carry[2]), rel=1e-9)
    assert got["splice"] is None

    lines = [json.loads(x) for x in got["path"].read_text().splitlines()]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["flagship_droplet_91x61.jsonl"]
    summary = lines[0]
    assert set(summary) == {"summary", "tag", "vsteps", "steps", "dt_base", "inflate_s",
                            "evolve_s", "ms_per_step", "all_converged", "n_converged",
                            "final_scale", "final_time", "r_eff_first", "r_eff_final",
                            "r_asym_final", "max_fnorm"}
    assert (summary["tag"], summary["vsteps"], summary["steps"]) == ("91x61", VSTEPS, STEPS)
    assert summary["all_converged"] and summary["n_converged"] == STEPS
    assert [set(x) for x in lines[1:]] == [{
        "step", "t", "dt", "newton_iters", "f_norm", "converged", "r_eff",
        "r_asymptotic", "min_spacing"}] * STEPS
    np.testing.assert_allclose([x["r_asymptotic"] for x in lines[1:]], r_asym,
                               rtol=1e-9, atol=0)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-2]) == summary

    # the final state against the JAX carry, at the bench step's gates
    np.testing.assert_allclose(got["u"].numpy(), np.asarray(carry[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["q"].numpy(), np.asarray(carry[1]), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def run256(tmp_path_factory):
    """The n = 256 driver path: the inflation, then SPLICE_STEPS steps in 2
    chunks with the splice after the first, at SPLICE_PMA PMA sub-steps."""
    s = fl.setup(256)
    q, u, min_jac = fl.inflate(s, VSTEPS, "cpu")
    out = tmp_path_factory.mktemp("spliced")
    recs, c, spliced = fl.evolve(s, u, q, SPLICE_STEPS, SPLICE_STEPS // 2, device="cpu",
                                 pma_loops=SPLICE_PMA, out_dir=out)
    return s, (q, u, min_jac), (recs, c, spliced)


def test_flagship_256_splice_is_bit_exact(run256, tmp_path):
    s, (q, u, min_jac), (recs, c, spliced) = run256
    assert min_jac > 0 and u.dtype == torch.float64
    kw = dict(device="cpu", pma_loops=SPLICE_PMA)
    recs1, c1, none = fl.evolve(s, u, q, SPLICE_STEPS, SPLICE_STEPS,
                                out_dir=tmp_path / "whole", **kw)
    assert none is None and not (tmp_path / "whole").exists()
    assert spliced["step"] == spliced["meta_step"] == 5
    assert spliced["du"] == spliced["dq"] == 0.0
    back, meta = ck.load_sharded(spliced["path"], {"u": "cpu", "q": "cpu"}, config=s.cfg)
    assert meta["step"] == 5 and meta["time"] == recs[4]["t"]
    assert recs == recs1
    assert torch.equal(c.u, c1.u) and torch.equal(c.q, c1.q) and c.scale == c1.scale
    assert all(r["converged"] for r in recs)
    assert sum(r["newton_iters"] for r in recs[5:]) > 0   # the f32 JVP after the splice
    with pytest.raises(ValueError, match="multiple"):
        fl.evolve(s, u, q, 10, 3, **kw)


def test_flagship_256_matches_jax(run256):
    """The n >= 256 branch against the JAX driver's composition at n = 256:
    the deviation-form inflation from q0 = 0 with f32 mesh and spectral
    transforms, then the spliced run step by step.  Tolerances: equal
    Newton counts and ok flags; dt, t, the final scale and the asymptotic
    radius within rtol 1e-9 and R_eff and the min spacing within 1e-10, as
    at n = 0 (measured 3e-13, 4e-12, 1.4e-12); u within 1e-8 (measured
    2.6e-10 of |u| <= 4) and the deviation potential q within 5e-6 of
    max|q| (f32 mesh transforms on a q of ~9e-6; measured 4.4e-7)."""
    pytest.importorskip("jax")
    s, (q, u, _), (recs, c, _) = run256
    (q_inf, u_inf), carry, aux, r_asym = _jax_flagship(s, VSTEPS, SPLICE_STEPS, SPLICE_PMA)
    np.testing.assert_allclose(q.numpy(), q_inf, rtol=0, atol=5e-6 * np.abs(q_inf).max())
    np.testing.assert_allclose(u.numpy(), u_inf, rtol=0, atol=1e-8)

    iters, f_norms, oks, dts, ts, reffs, msps = aux
    assert [r["newton_iters"] for r in recs] == iters.tolist()
    assert iters.sum() > 0        # the f32 JVP iterates on both sides
    assert [r["converged"] for r in recs] == oks.tolist() == [True] * SPLICE_STEPS
    np.testing.assert_allclose([r["dt"] for r in recs], dts, rtol=1e-9, atol=0)
    np.testing.assert_allclose([r["t"] for r in recs], ts, rtol=1e-9, atol=0)
    np.testing.assert_allclose([r["r_eff"] for r in recs], reffs, rtol=0, atol=1e-10)
    np.testing.assert_allclose([r["min_spacing"] for r in recs], msps, rtol=0, atol=1e-10)
    assert c.scale == pytest.approx(float(carry[2]), rel=1e-9)
    _, r_asym_port = fl.summarize(s, recs, c, VSTEPS, SPLICE_STEPS, 0.0, 0.0)
    np.testing.assert_allclose(r_asym_port, r_asym, rtol=1e-9, atol=0)
    np.testing.assert_allclose(c.u.numpy(), np.asarray(carry[0]), rtol=0, atol=1e-8)
    q_j = np.asarray(carry[1])
    np.testing.assert_allclose(c.q.numpy(), q_j, rtol=0, atol=5e-6 * np.abs(q_j).max())


def test_flagship_inflation_chunks_equal_one_call():
    """The n >= 2048 inflation in calls of ``INFLATE_CHUNK`` volume steps
    through ``dp.inflate(start=, count=, u_prev=)``: at n = 256 and 4
    volume steps, calls of 1 and of 2 equal one call bit for bit; at
    n >= 2048 the chunk is INFLATE_CHUNK by default."""
    s = fl.setup(256)
    whole = fl.inflate(s, 4, "cpu")
    for chunk in (1, 2):
        part = fl.inflate(s, 4, "cpu", chunk=chunk)
        assert torch.equal(part[0], whole[0]) and torch.equal(part[1], whole[1])
        assert part[2] == whole[2]
    with pytest.raises(ValueError, match=f"multiple of {fl.INFLATE_CHUNK}"):
        fl.inflate(fl.setup(2048), fl.INFLATE_CHUNK + 1, "cpu")
    with pytest.raises(ValueError, match="multiple of 3"):
        fl.inflate(s, 4, "cpu", chunk=3)


@pytest.mark.parametrize("n", [0, 256, 1024, 2048, 4096])
def test_settings_follow_the_jax_driver(n):
    """``examples/droplet_flagship.py:83-139, 204``, evaluated here."""
    s = fl.setup(n)
    if n == 0:
        assert (s.dt, s.dtmesh_inf, s.dtmesh_ev, s.pma_loops, s.norm_scale) == (
            1e-5, 5e-9, 3e-10, 400, 1.0)
        assert s.cfg == fl.fx.config_for(fl.fx.parse_name(fl.FIXTURE))
        assert not s.deviation_form and s.solver() == fl.dp.fast_solver()
    else:
        loops = 400 if n <= 1024 else 50
        assert s.dtmesh_inf == 1e-11 * min(1.0, (1024.0 / n) ** 2)
        assert s.pma_loops == loops
        assert s.dt == 1e-9 * min(1.0, 2048.0 / n)
        assert s.dtmesh_ev == 1.2e-2 * (1e-9 * min(1.0, 2048.0 / n)) / loops
        assert s.norm_scale == np.sqrt(5551.0 / (n * n))
        assert (s.cfg.nx, s.cfg.ny, s.cfg.spectral_dtype, s.cfg.mesh_dtype) == (
            n, n, "float32", "float32")
        assert s.cfg.spectral_precision == ("high" if n >= 2048 else "highest")
        assert s.solver().inner_dtype == "float32" and s.solver().max_backtracks == 4
    assert fl.chunk_for(n, 1000) == (100 if n == 0 else 25 if n <= 1024 else 10)
    assert fl.chunk_for(n, 2) == 2


def test_drivers_raise_without_cuda(monkeypatch, tmp_path):
    """Without a card, every driver's default device raises: no silent CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: fl.main(["0", "1", "1", f"out_dir={tmp_path}"]),
        lambda: fl.inflate(fl.setup(0), 1),
        lambda: se.main(["1"]),
        lambda: mt.main(["max_steps=1", "chunk=1", f"out_dir={tmp_path}"]),
        lambda: mb.main(["1e-4", "1", f"out_dir={tmp_path}"]),
        lambda: mb.run(tm.MEMSConfig(), 1e-4, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
