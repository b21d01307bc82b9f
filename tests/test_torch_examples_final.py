"""Three of the port's drivers on the CPU, against the JAX package's
functions composed as the JAX drivers compose them (the JAX drivers' own
``main`` is never called: it writes into ``benchmarks/``):

- ``sh_full_experiment``: 5 steps against the JAX ``evolve_cn`` with the
  same ``fast_solver`` and u0: equal Newton counts, u within 1e-6 (the
  gate of ``test_torch_sh.py::test_evolve_cn_matches_jax``), every printed
  field present;
- ``mems_touchdown``: 21 steps in chunks of 7 against rows 1 and 21 of
  ``benchmarks/mems_touchdown.jsonl`` (the JAX run): u_min and dt within
  1e-10, the smoke run's touchdown gates; the record's thinning rule; the
  record written under ``out_dir`` and nothing else written;
- ``mems_bdf_touchdown``: tf = 2e-3 in 2 segments against the JAX
  ``evolve_coupled`` run the same way: equal accepted and rejected counts,
  u_min within 1e-10, the last step size within 1e-5, ``u_min_split``
  equal to ``np.interp`` on the record.
"""
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.examples import OUT_DIR
from iterative_solvers_tpu_torch.examples import mems_bdf_touchdown as mb
from iterative_solvers_tpu_torch.examples import mems_touchdown as mt
from iterative_solvers_tpu_torch.examples import sh_full_experiment as se

BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
TOUCHDOWN_GATE = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """64² and 51² fields: torch's intra-op threads cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def bench_untouched():
    """Fails the test if any file under ``benchmarks/`` changed."""
    def digest():
        return {p: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(BENCH.rglob("*")) if p.is_file()}
    before = digest()
    yield
    assert digest() == before


def test_default_out_dir_is_runs():
    assert OUT_DIR == pathlib.Path(__file__).resolve().parents[1] / "runs"


# -- sh_full_experiment ------------------------------------------------------------

def test_sh_full_experiment_matches_jax(capsys):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.models import swift_hohenberg as jsh

    got = se.main(["5", "device=cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"steps", "t_final", "wall_s", "ms_per_step", "all_converged",
                         "worst_fnorm", "mean_newton_iters",
                         "scipy_reference_estimate_s"}
    assert line["steps"] == 5 and line["t_final"] == 5 * 0.2 and line["all_converged"]
    assert line["worst_fnorm"] <= se.F_TOL and line["scipy_reference_estimate_s"] == 0.2

    cfg = jsh.SHConfig(n=64)
    u0 = np.random.default_rng(0).standard_normal((64, 64))
    uj, itj, fnj = jsh.evolve_cn(jnp.asarray(u0), 5, cfg,
                                 jsh.fast_solver(cfg, f_tol=6e-6, inner_m=10, outer_k=5))
    np.testing.assert_array_equal(got["newton_iters"], np.asarray(itj))
    assert line["mean_newton_iters"] == round(float(np.mean(np.asarray(itj))), 2)
    np.testing.assert_allclose(got["u"].numpy(), np.asarray(uj), rtol=0, atol=1e-6)


# -- mems_touchdown ------------------------------------------------------------------

def test_mems_touchdown_matches_record(tmp_path, bench_untouched):
    got = mt.main(["max_steps=21", "chunk=7", "cpu=1", f"out_dir={tmp_path}"])
    with open(BENCH / "mems_touchdown.jsonl") as f:
        record = {r["step"]: r for r in map(json.loads, f) if "step" in r}
    rows = got["rows"]
    assert [r["step"] for r in rows] == list(range(1, 22))
    assert all(r["converged"] and r["newton_iters"] == 3 for r in rows)
    for s in (1, 21):
        assert abs(rows[s - 1]["u_min"] - record[s]["u_min"]) <= TOUCHDOWN_GATE
        assert abs(rows[s - 1]["dt"] - record[s]["dt"]) <= TOUCHDOWN_GATE * record[s]["dt"]
        assert rows[s - 1]["newton_iters"] == record[s]["newton_iters"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["mems_touchdown.jsonl"]
    lines = [json.loads(s) for s in got["path"].read_text().splitlines()]
    assert lines[0]["summary"] and lines[0]["steps"] == 21 and not lines[0]["reached"]
    assert lines[0]["u_min_final"] == rows[-1]["u_min"] and lines[0]["parity"] is None
    assert lines[1:] == rows   # 21 rows: all inside the kept tail


def test_mems_touchdown_thinning_and_stop():
    rows = [{"step": i + 1} for i in range(250)]
    kept = [r["step"] - 1 for r in mt.thin(rows)]
    assert kept == list(range(0, 150, 20)) + list(range(150, 250))
    # u_stop is read at chunk ends only: a stop above u = 0 ends the first chunk
    rows, _, _ = mt.run_ours(mt.mems.MEMSConfig(), 0.0, 10, 2, "cpu")
    assert len(rows) == 2


def test_mems_touchdown_oracle_needs_reference():
    """``oracle=1`` loads ``tools/make_golden.py``'s loader, which reads the
    reference sources: where they are absent it raises."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_golden",
                                                  mt.TOOLS / "make_golden.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    if (tool.REF / "PMA2_nk.py").exists():
        assert callable(mt._load_patched())
    else:
        with pytest.raises(FileNotFoundError, match="PMA2_nk.py"):
            mt._load_patched()


# -- mems_bdf_touchdown --------------------------------------------------------------

def test_mems_bdf_touchdown_matches_jax(tmp_path, bench_untouched):
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from iterative_solvers_tpu.models import mems as jm
    from iterative_solvers_tpu.solvers.bdf import BDF as JBDF
    from iterative_solvers_tpu.solvers.newton import NewtonKrylov as JNK

    tf, segments = 2e-3, 2
    got = mb.main([str(tf), str(segments), "device=cpu", f"out_dir={tmp_path}"])
    rows = got["rows"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["mems_bdf_touchdown.jsonl"]
    lines = [json.loads(s) for s in got["path"].read_text().splitlines()]
    assert lines[0]["summary"] and lines[0]["accepted_steps"] == rows[-1]["steps_cum"]
    assert lines[1:] == rows

    bdf = JBDF(rtol=1e-3, atol=1e-6, dt0=1e-6, max_steps=200000,
               newton=JNK(f_tol=1e-10, maxiter=12, inner_m=20, outer_k=5))
    cfg = jm.MEMSConfig()
    # one compiled segment for both (the same tf / segments each time)
    seg = jax.jit(lambda u, q: jm.evolve_coupled(cfg, tf / segments, bdf=bdf, u0=u, q0=q))
    u, q = jm.initial_state(cfg)
    os_t, os_umin = mb.split_curve()
    t, total = 0.0, 0
    for row in rows:
        u, q, res = seg(u, q)
        assert bool(res.success)
        t += float(res.t)
        total += int(res.steps)
        assert row["t"] == t
        assert (row["steps_cum"], row["rejected"]) == (total, int(res.rejected))
        assert abs(row["u_min_bdf"] - float(jnp.min(u))) <= 1e-10
        # the last step's size is a power of the error estimate, which
        # carries the stage solves' Newton noise: 2e-6 apart on the CPU
        assert row["dt_final"] == pytest.approx(float(res.dt_final), rel=1e-5)
        assert row["u_min_split"] == float(np.interp(t, os_t, os_umin))
        assert row["diff"] == row["u_min_bdf"] - row["u_min_split"]
