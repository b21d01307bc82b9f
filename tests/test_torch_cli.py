"""Port parity: the CLI and the modules it calls (checkpoint, metrics,
timing, render), on CPU.

``cli.main`` runs in process with ``--device cpu``; each printed JSON line
is held against the JAX package on the same inputs where the JAX side is
cheap to run (``sh`` against ``evolve_cn`` on the same seed: u to 1e-10,
the printed numbers to 1e-10 relative, equal Newton counts; ``mems`` against
``evolve``: u_min and t to 1e-12; ``poisson`` to 1e-12), and against the
port's own driver otherwise (the coupled MEMS run and the droplet step,
whose drivers ``tests/test_torch_bdf.py`` and
``tests/test_torch_droplet_drivers.py`` hold against JAX).  Checkpoints
written by either package load in the other.  Render tests skip without
matplotlib.
"""
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch import cli
from iterative_solvers_tpu_torch.io import checkpoint as ck
from iterative_solvers_tpu_torch.io import fixtures as tfx
from iterative_solvers_tpu_torch.models import droplet as tdp
from iterative_solvers_tpu_torch.models import mems as tm
from iterative_solvers_tpu_torch.models.swift_hohenberg import SHConfig
from iterative_solvers_tpu_torch.solvers.bdf import BDF
from iterative_solvers_tpu_torch.utils import render, timing
from iterative_solvers_tpu_torch.utils.metrics import MetricsLogger

FIX = pathlib.Path(__file__).parent / "fixtures"
COAL = "initdrop_coal_1_91-61_100_0.005_0.01_0.1_0.15.txt"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small fields: torch's intra-op threads cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from iterative_solvers_tpu.io import checkpoint as jck
    from iterative_solvers_tpu.models import mems as jm
    from iterative_solvers_tpu.models import poisson as jpo
    from iterative_solvers_tpu.models import swift_hohenberg as jsh
    from iterative_solvers_tpu.solvers.newton import NewtonKrylov as JNK

    return types.SimpleNamespace(jnp=jnp, jck=jck, jm=jm, jpo=jpo, jsh=jsh, JNK=JNK)


def _main(capsys, *argv):
    assert cli.main([*argv, "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def coal():
    """The coalescence fixture's state and configuration."""
    g = np.load(FIX / "golden_droplet_traj.npz")
    cfg = tfx.config_for(tfx.parse_name(COAL))
    return cfg, g["u0"].reshape(cfg.grid.shape), g["q0"].reshape(cfg.grid.shape)


# -- the subcommands ------------------------------------------------------------

def test_cli_sh_matches_jax(jx, capsys, tmp_path):
    ckp, met = tmp_path / "sh.npz", tmp_path / "m.jsonl"
    out = _main(capsys, "sh", "--n", "24", "--steps", "3", "--x64",
                "--checkpoint", str(ckp), "--metrics", str(met))
    cfg = jx.jsh.SHConfig(n=24)
    u0 = jx.jnp.array(np.random.default_rng(0).standard_normal((24, 24)))
    ju, jiters, jf = jx.jsh.evolve_cn(u0, 3, cfg, jx.JNK(f_tol=6e-6))
    assert out["steps"] == 3 and out["final_fnorm"] <= 6e-6
    assert out["final_fnorm"] == pytest.approx(float(jf[-1]), rel=1e-10)
    assert out["mean_newton_iters"] == float(np.mean(np.asarray(jiters)))
    arrays, meta = ck.load(ckp, config=SHConfig(n=24))
    assert arrays["u"].dtype == np.float64 and meta["step"] == 3
    np.testing.assert_allclose(arrays["u"], np.asarray(ju), rtol=0, atol=1e-10)
    recs = [json.loads(line) for line in met.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert recs[-1]["f_norm"] == out["final_fnorm"]


def test_cli_sh_default_is_f32(capsys, tmp_path):
    ckp = tmp_path / "sh32.npz"
    out = _main(capsys, "sh", "--n", "16", "--steps", "1", "--checkpoint", str(ckp))
    assert np.isfinite(out["final_fnorm"])
    assert ck.load(ckp)[0]["u"].dtype == np.float32


def test_cli_mems_matches_jax(jx, capsys):
    out = _main(capsys, "mems", "--n", "31", "--steps", "3")
    ju, jq, jt, jdts, _ = jx.jm.evolve(jx.jm.MEMSConfig(n=31), 3)
    assert out["steps"] == 3
    assert out["u_min"] == pytest.approx(float(jx.jnp.min(ju)), rel=1e-12)
    assert out["t"] == pytest.approx(float(jt), rel=1e-12)
    assert out["dt_final"] == pytest.approx(float(jdts[-1]), rel=1e-12)
    assert -1.0 < out["u_min"] < 0


def test_cli_mems_coupled(capsys):
    out = _main(capsys, "mems", "--coupled", "--tf", "1e-3", "--n", "31")
    u, q, res = tm.evolve_coupled(tm.MEMSConfig(n=31), 1e-3, bdf=BDF(), device="cpu")
    assert out == {"t": res.t, "steps": res.steps,
                   "u_min": u.min().item(), "success": True}
    assert out["t"] == pytest.approx(1e-3) and -1.0 < out["u_min"] < 0


def test_cli_poisson_matches_jax(jx, capsys):
    out = _main(capsys, "poisson", "--n", "64")
    want = float(jx.jpo.flow_rate(jx.jpo.solve_direct(64), 1.0 / 64))
    assert out["flow_rate"] == pytest.approx(want, rel=1e-12)
    assert out["exact"] == pytest.approx(jx.jpo.flow_rate_exact(), rel=1e-15)
    assert out["rel_err"] < 5e-3


@pytest.mark.parametrize("fast", [False, True])
def test_cli_droplet_restart(jx, capsys, tmp_path, coal, fast):
    """From a checkpoint of the coalescence state: the printed line is the
    port's ``evolve`` from that state, and the written checkpoint loads in
    both packages with its configuration checked."""
    cfg, u0, q0 = coal
    start, end = tmp_path / "start.npz", tmp_path / "end.npz"
    ck.save(start, {"u": u0, "q": q0}, config=cfg)
    argv = ["droplet", "--restart", str(start), "--steps", "1", "--pma-loops", "5",
            "--checkpoint", str(end)] + (["--fast"] if fast else [])
    out = _main(capsys, *argv)
    kw = {}
    if fast:
        cfg = dataclasses.replace(cfg, spectral_dtype="float32", mesh_dtype="float32")
        kw = dict(solver=tdp.fast_solver(), jvp_dtype="float32", jvp_kernel=True)
    u, q, t, (iters, f_norms, dts) = tdp.evolve(cfg, u0, q0, 1e-5, 1, dtmesh=3e-9,
                                                pma_loops=5, device="cpu", **kw)
    assert out["steps"] == 1 and out["t"] == t == 1e-5
    assert out["final_fnorm"] == float(f_norms[-1]) <= 1e-7
    assert out["min_spacing"] > 0
    arrays, meta = ck.load(end, config=cfg)
    np.testing.assert_array_equal(arrays["u"], u.numpy())
    np.testing.assert_array_equal(arrays["q"], q.numpy())
    assert meta["time"] == t and meta["step"] == 1
    jarrays, jmeta = jx.jck.load(end, config=cfg)
    np.testing.assert_array_equal(jarrays["q"], arrays["q"])
    with pytest.raises(ck.CheckpointMismatch):
        ck.load(end, config=dataclasses.replace(cfg, mesh_dtype="float16"))


def test_cli_droplet_fixture(capsys, tmp_path, coal):
    """A reference-format text state written by ``export_reference_text``
    under the coalescence fixture's name runs as ``--fixture``."""
    cfg, u0, q0 = coal
    path = tmp_path / COAL
    ck.export_reference_text(path, torch.tensor(u0), q0)
    fix = tfx.load(path)
    np.testing.assert_array_equal(fix.u, u0)
    np.testing.assert_array_equal(fix.q, q0)
    out = _main(capsys, "droplet", "--fixture", str(path), "--steps", "1",
                "--pma-loops", "2")
    assert out["final_fnorm"] <= 1e-7 and out["min_spacing"] > 0


def test_cli_raises_without_cuda(monkeypatch):
    """--device cuda (the default) without a card raises: no silent CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["poisson", "--n", "8"], ["mems", "--n", "11", "--steps", "1"],
                 ["sh", "--n", "8", "--steps", "1", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


# -- checkpoint -------------------------------------------------------------------

def test_checkpoint_roundtrip_and_mismatch(jx, tmp_path, coal):
    cfg = coal[0]
    u = np.random.default_rng(0).standard_normal((4, 5))
    p = tmp_path / "s.npz"
    ck.save(p, {"u": torch.tensor(u), "v": u[:2]}, config=cfg, step=7, time=0.25)
    arrays, meta = ck.load(p, config=cfg)
    np.testing.assert_array_equal(arrays["u"], u)
    assert meta["step"] == 7 and meta["time"] == 0.25
    assert meta["shapes"] == {"u": [4, 5], "v": [2, 5]}
    assert meta["dtypes"]["u"] == "float64"
    assert ck.FORMAT_VERSION == jx.jck.FORMAT_VERSION == meta["format_version"]
    with pytest.raises(ck.CheckpointMismatch, match="epsilon"):
        ck.load(p, config=dataclasses.replace(cfg, epsilon=0.01))
    # the two packages read each other's files, with the same check
    jp = tmp_path / "j.npz"
    jx.jck.save(jp, {"u": u}, config=dataclasses.asdict(cfg), step=3)
    arrays, meta = ck.load(jp, config=cfg)
    np.testing.assert_array_equal(arrays["u"], u)
    with pytest.raises(jx.jck.CheckpointMismatch):
        jx.jck.load(p, config=dict(dataclasses.asdict(cfg), R=2.0))
    # a wrong format version and a bad config type
    z = dict(np.load(p))
    z["__meta__"] = np.frombuffer(json.dumps({"format_version": 99}).encode(), np.uint8)
    np.savez(tmp_path / "bad.npz", **z)
    with pytest.raises(ck.CheckpointMismatch, match="format"):
        ck.load(tmp_path / "bad.npz")
    with pytest.raises(TypeError):
        ck.save(tmp_path / "x.npz", {"u": u}, config=3)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["bad.npz", "j.npz", "s.npz"]


def test_export_reference_text_matches_jax(jx, tmp_path):
    rng = np.random.default_rng(1)
    u, q = rng.standard_normal((3, 4)), rng.standard_normal((3, 4))
    ck.export_reference_text(tmp_path / "t.txt", torch.tensor(u), torch.tensor(q))
    jx.jck.export_reference_text(tmp_path / "j.txt", u, q)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "t.txt")[:, 0], u.reshape(-1))


# -- metrics and timing ---------------------------------------------------------------

def test_metrics_logger(tmp_path):
    p = tmp_path / "m.jsonl"
    log = MetricsLogger(path=p)
    log.log(0, resnorm=1e-3, iters=5)
    log.log(1, resnorm=np.float64(1e-4), iters=torch.tensor(3), v=torch.ones(2))
    lines = [json.loads(line) for line in p.read_text().splitlines()]
    assert lines[1]["resnorm"] == 1e-4 and lines[1]["iters"] == 3
    assert lines[1]["v"] == [1.0, 1.0]
    s = log.summary()
    assert s["resnorm"]["min"] == 1e-4 and s["iters"]["max"] == 5
    assert s["iters"]["last"] == 3.0 and "v" not in s
    assert MetricsLogger().summary() == {}


@pytest.mark.parametrize("kind", ["numpy", "list", "tensor"])
def test_metrics_scan_outputs(kind):
    conv = {"numpy": np.asarray, "list": list, "tensor": torch.tensor}[kind]
    log = MetricsLogger()
    log.log_scan_outputs({"dt": conv([1.0, 2.0]), "it": conv([3, 4])}, start_step=5)
    assert [r["step"] for r in log.records] == [5, 6]
    assert log.records[1]["dt"] == 2.0 and log.records[1]["it"] == 4


def test_timing_on_cpu():
    x = torch.ones(128)
    assert timing.median_ms(lambda v: v * 2 + 1, x, iters=3, warmup=1, device="cpu") >= 0
    res = {}
    with timing.device_timer(res, "a", device="cpu"):
        x.sum()
    with timing.device_timer(res, "a", device="cpu"):
        x.sum()
    assert res["a"] > 0 and list(res) == ["a"]
    with torch.profiler.profile() as prof:
        with timing.trace_annotation("port_span"):
            x * 2
    assert any(e.name == "port_span" for e in prof.events())


def test_timing_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.median_ms(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        with timing.device_timer({}, "a"):
            pass


# -- render -----------------------------------------------------------------------

def test_render_png(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    u = torch.tensor(np.random.default_rng(2).standard_normal((16, 16)))
    render.save_field_image(u, tmp_path / "f.png", title="u")
    xx, yy = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    render.save_surface(u, torch.tensor(xx), yy, tmp_path / "s.png", zlim=(-3, 3))
    render.save_animation([u, 2 * u], tmp_path / "a.gif", fps=2)
    for name in ("f.png", "s.png", "a.gif"):
        assert (tmp_path / name).stat().st_size > 1000, name
    out = _main(capsys, "mems", "--n", "21", "--steps", "1", "--render",
                str(tmp_path / "m.png"))
    assert out["u_min"] < 0 and (tmp_path / "m.png").stat().st_size > 1000


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the droplet_jvp kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cli_droplet_fast_launches_kernel_on_card(cuda, capsys, tmp_path, coal):
    """``droplet --restart ... --fast`` on the card runs its inner Krylov
    through the droplet_jvp kernel, and its step is the CPU run's (the plain
    JVP there): the same Newton count, u within 5e-7 (the f32 inner Krylov's
    gate), q within 1e-8."""
    from iterative_solvers_tpu_torch.ops._build import launch_count

    cfg, u0, q0 = coal
    start = tmp_path / "start.npz"
    ck.save(start, {"u": u0, "q": q0}, config=cfg)
    lines = {}
    for dev in ("cuda", "cpu"):
        before = launch_count("droplet_jvp")
        assert cli.main(["droplet", "--restart", str(start), "--steps", "2", "--fast",
                         "--pma-loops", "20", "--checkpoint", str(tmp_path / f"{dev}.npz"),
                         "--device", dev]) == 0
        lines[dev] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        if dev == "cuda":
            assert launch_count("droplet_jvp") > before
        else:
            assert launch_count("droplet_jvp") == before
    assert lines["cuda"]["final_fnorm"] <= 1e-7
    assert lines["cuda"]["t"] == pytest.approx(lines["cpu"]["t"], rel=1e-6)
    fast = dataclasses.replace(cfg, spectral_dtype="float32", mesh_dtype="float32")
    got, want = (ck.load(tmp_path / f"{dev}.npz", config=fast)[0] for dev in ("cuda", "cpu"))
    np.testing.assert_allclose(got["u"], want["u"], atol=5e-7)
    np.testing.assert_allclose(got["q"], want["q"], atol=1e-8)
