"""The port's drivers (``iterative_solvers_tpu_torch/examples``) on the CPU.

- ``large_scale_droplet.prepare`` at n = 48 against the JAX package's own
  functions composed on the same npz state (``io.fixtures.upsample``,
  ``config_for``, ``to_deviation``, three rounds of ``seeded_solution`` and
  60 f32 ``loop_pma`` sub-steps): u and phi within the f32 mesh loop's
  rounding (``tests/test_torch_pma.py``); ``main`` in each mode converges.
- the long-run controller's decisions against the JAX driver's rules
  (``examples/droplet_longrun.py:188-225``): growth by Newton comfort,
  halving retries, the clip, the mesh pseudo-step, the extrapolated
  guess, and a step that fails every attempt;
- a chunked long run (3 steps, then a fresh call that resumes from its
  checkpoint) against an uninterrupted 6-step run from the same seeded
  checkpoint: the first chunk equal, the checkpoint bit-exact, then the
  same dts and attempts, every step converged, and u within the Newton
  tolerance (the checkpoint does not hold the extrapolation history, as
  in the JAX package, so the resumed step starts Newton from u itself).

The JAX examples' ``main`` is never called: it writes into ``benchmarks/``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.examples import droplet_longrun as lr
from iterative_solvers_tpu_torch.examples import large_scale_droplet as ls
from iterative_solvers_tpu_torch.io import checkpoint as ck
from iterative_solvers_tpu_torch.io import fixtures as tfx
from iterative_solvers_tpu_torch.models import droplet as tdp

N = 48


@pytest.fixture(scope="module")
def prepared():
    torch.set_num_threads(4)
    return ls.prepare(N, "cpu")


def test_prepare_matches_jax(prepared):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.io import fixtures as jfx
    from iterative_solvers_tpu.meshmove.pma import loop_pma
    from iterative_solvers_tpu.models import droplet as jdp
    from iterative_solvers_tpu.ops import curvilinear as jcv

    fix, _ = tfx.load_golden_step()
    jfix = jfx.DropletFixture(**{f.name: getattr(fix, f.name)
                                 for f in dataclasses.fields(jfx.DropletFixture)})
    big = jfx.upsample(jfix, N, N)
    cfg = dataclasses.replace(jfx.config_for(big), spectral_dtype="float32",
                              mesh_dtype="float32")
    phi = jcv.to_deviation(jnp.array(big.q), cfg.grid)
    phi0 = np.asarray(phi)
    for _ in range(3):
        u = jdp.seeded_solution(jcv.mesh_geometry_dev(phi, cfg.grid), cfg, ls.DROPS)
        phi = loop_pma(phi, u, ls.mesh_dt(N), 60, cfg.grid, cfg.pma,
                       jdp.monitor_source, jcv.mesh_geometry_dev)
    u = jdp.seeded_solution(jcv.mesh_geometry_dev(phi, cfg.grid), cfg, ls.DROPS)

    tcfg, tu, tphi = prepared
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    inc = np.asarray(phi) - phi0
    assert np.abs(inc).max() > 1e-6  # the mesh moved
    np.testing.assert_allclose(tphi.numpy() - phi0, inc, rtol=0,
                               atol=1e-4 * np.abs(inc).max())
    # the drops seeded on the port's mesh as the JAX package seeds them (u
    # itself follows phi's f32 rounding through the 1/a interface)
    u_on_port_mesh = jdp.seeded_solution(
        jcv.mesh_geometry_dev(jnp.asarray(tphi.numpy()), cfg.grid), cfg, ls.DROPS)
    np.testing.assert_allclose(tu.numpy(), np.asarray(u_on_port_mesh), rtol=0, atol=1e-12)
    assert np.abs(tu.numpy() - np.asarray(u)).max() < 1e-6


@pytest.mark.parametrize("mode", ["kernel", "jvp", "fd"])
def test_large_scale_main_converges(mode, capsys):
    line = ls.main([str(N), "1", mode, "cpu"])
    assert line["converged"] and line["f_norm"] <= 1e-5 and line["n"] == N
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n"] == N


# -- the controller -------------------------------------------------------------------

class _Script:
    """A step that answers from a script of (converged, newton_iters,
    finite) and records its calls."""

    def __init__(self, script):
        self.script, self.calls = list(script), []

    def __call__(self, u, q, dt, dtmesh, x0):
        conv, iters, finite = self.script.pop(0)
        self.calls.append({"dt": dt, "dtmesh": dtmesh, "x0": x0})
        un = u + 1.0 if finite else u * float("nan")
        return tdp.DropletStepResult(u=un, q=q + dtmesh, newton_iters=iters,
                                     f_norm=1e-6, converged=conv)


def _carry(dt=1e-8, dt_prev=0.0):
    grid = lr.longrun_config(16, {}).grid
    u = torch.full(grid.shape, 0.5, dtype=torch.float64)
    q = torch.zeros(grid.shape, dtype=torch.float64)
    return grid, lr.Carry(u=u, q=q, dt=dt, t=1e-6, u_prev=u - 0.1, dt_prev=dt_prev)


CTL = lr.Controller(maxiter=20, growth=1.25, dt_max=2e-3, pma_loops=400,
                    dtmesh_cap=1e-11, epsilon=0.005)


def test_controller_rules():
    # growth by Newton comfort: <= maxiter // 2, <= 3 maxiter // 4, else hold
    assert [CTL.growth_factor(k) for k in (0, 10, 11, 15, 16, 20)] == \
        [1.25, 1.25, 1.125, 1.125, 1.0, 1.0]
    assert CTL.next_dt(True, 1e-8, 3) == 1.25e-8
    assert CTL.next_dt(False, 1e-8, 3) == 1e-8
    assert CTL.next_dt(True, 1.9e-3, 0) == 2e-3          # clipped at dt_max
    assert CTL.next_dt(False, 1e-13, 0) == 1e-12         # and below
    # the mesh pseudo-step: 1.2e-2 dt over the sub-steps, capped
    assert CTL.mesh_dt(1e-10) == pytest.approx(1.2e-2 * 1e-10 / 400, rel=1e-15)
    assert CTL.mesh_dt(1e-3) == 1e-11
    # the guess: u itself without history, extrapolated with it, floored
    _, c = _carry(dt_prev=0.0)
    assert torch.equal(CTL.guess(c, 2e-8), c.u)
    _, c = _carry(dt_prev=1e-8)
    assert torch.allclose(CTL.guess(c, 2e-8), c.u + 2.0 * 0.1, rtol=0, atol=1e-15)
    c = c._replace(u_prev=c.u + 10.0)
    assert torch.equal(CTL.guess(c, 1e-8), torch.full_like(c.u, 0.25 * 0.005))


def test_advance_halves_until_converged():
    grid, c = _carry(dt=4e-8, dt_prev=2e-8)
    step = _Script([(False, 20, True), (True, 5, False), (True, 12, True)])
    new, rec = lr.advance(step, c, CTL, grid)
    assert [k["dt"] for k in step.calls] == [4e-8, 2e-8, 1e-8]
    assert [k["dtmesh"] for k in step.calls] == [CTL.mesh_dt(d) for d in (4e-8, 2e-8, 1e-8)]
    assert rec["attempts"] == 3 and rec["converged"] and rec["dt"] == 1e-8
    assert rec["newton_iters"] == 12 and new.t == c.t + 1e-8
    assert new.dt == 1e-8 * 1.125          # 12 iterations: halfway growth
    assert torch.equal(new.u, c.u + 1.0) and torch.equal(new.u_prev, c.u)
    assert new.dt_prev == 1e-8
    # the third attempt extrapolated with r = 1e-8 / 2e-8
    assert torch.allclose(step.calls[2]["x0"], c.u + 0.5 * 0.1, rtol=0, atol=1e-15)


def test_advance_keeps_state_when_every_attempt_fails():
    grid, c = _carry(dt=4e-8, dt_prev=2e-8)
    step = _Script([(False, 20, True)] * 4)
    new, rec = lr.advance(step, c, CTL, grid)
    assert rec["attempts"] == 4 and not rec["converged"] and rec["dt"] == 5e-9
    assert new.t == c.t and new.dt == 5e-9
    assert torch.equal(new.u, c.u) and torch.equal(new.q, c.q)
    assert torch.equal(new.u_prev, c.u_prev) and new.dt_prev == c.dt_prev


# -- chunked and resumed --------------------------------------------------------------

def test_chunked_run_resumes(prepared, tmp_path):
    _, u, phi = prepared
    opts = {"pma_loops": "20", "dt0": "5e-8"}
    cfg = lr.longrun_config(N, opts)
    for tag in ("full", "parts"):
        lr.save_chunk(tmp_path / f"longrun_{tag}_ckpt", cfg, u, phi, 0, 0.0, 5e-8)
    common = [f"{k}={v}" for k, v in opts.items()] + [
        "chunk=3", f"out_dir={tmp_path}", "device=cpu"]
    full = lr.main([str(N), "6", "tag=full", *common])
    first = lr.main([str(N), "3", "tag=parts", *common])
    back, meta = ck.load_sharded(tmp_path / "longrun_parts_ckpt",
                                 {"u": "cpu", "q": "cpu"}, config=cfg)
    carry = json.loads((tmp_path / "longrun_parts_ckpt" / "carry.json").read_text())
    rest = lr.main([str(N), "6", "tag=parts", *common])

    assert full["records"][:3] == first["records"]
    assert torch.equal(back["u"], first["u"]) and torch.equal(back["q"], first["q"])
    assert (meta["step"], carry["step"], carry["t"], carry["dt"]) == (
        3, 3, first["t"], first["dt"])
    resumed = rest["records"]
    assert [r["step"] for r in resumed] == [4, 5, 6]
    for a, b in zip(full["records"][3:], resumed):
        assert (a["dt"], a["attempts"], a["converged"]) == (b["dt"], b["attempts"], True)
    f_tol = 1e-5
    assert float((rest["u"] - full["u"]).abs().max()) <= 3 * 2 * f_tol
    dq = float((rest["q"] - full["q"]).abs().max())
    moved = float((full["q"] - first["q"]).abs().max())
    assert dq <= 1e-3 * moved, (dq, moved)
    lines = (tmp_path / "longrun_droplet_parts.jsonl").read_text().splitlines()
    assert [json.loads(s)["step"] for s in lines] == [1, 2, 3, 4, 5, 6]
