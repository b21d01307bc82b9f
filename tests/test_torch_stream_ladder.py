"""Port parity: the stream kernels of the JAX package's tools against the
port's (``iterative_solvers_tpu_torch/tools``, ``ops/stream_ladder.py``).

On the CPU the port's callables run their plain versions; they are held
against the JAX tool functions themselves, run under
``pltpu.force_tpu_interpret_mode()`` at n = 64 with the bm of the JAX
``main``s cut by 8 (16, 32, 64), on the same seeded numpy inputs:

- ``read_kernel`` within 1e-6 absolute: both sum 4 (bm 16) or 2 (bm 32)
  chunks of standard-normal rows onto the token, in other orders, so
  they differ by a few f32 roundings of values below ~10;
- ``write_kernel``, ``make_pipeline`` and ``grid_copy`` exactly (a
  product by 0.5 is exact and each row is one rounding; copies copy);
- ``copy_kernel`` exactly at ``slots = 4``.  Not at ``slots = 2``: there
  the TPU kernel refills a slot whose out-copy is still in flight
  (prefetch of chunk ``idx + 1`` into slot ``(idx - 1) mod 2``, waited on
  only two chunks later), and in interpret mode rows 0-15 of its output
  hold rows 32-47 of ``u``.  The port computes ``out = u`` at every slots.

The JAX tools are loaded from their files with bytecode writing off (no
``__pycache__`` lands in ``tools/``); the compilation-cache directory they
set on import is put back.  The ``gpu``-marked tests hold each CUDA kernel
against its plain version on the card:
``python -m pytest --noconftest -m gpu tests/test_torch_stream_ladder.py``.
"""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

from iterative_solvers_tpu_torch.ops import stream_ladder as sl
from iterative_solvers_tpu_torch.ops._build import launch_count
from iterative_solvers_tpu_torch.tools import grid_experiment as tge
from iterative_solvers_tpu_torch.tools import pipeline_experiment as tpe
from iterative_solvers_tpu_torch.tools import stream_ladder as tsl

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 64
# tools/pallas_pipeline_experiment.py main's (slots, depth, bm, halos), bm / 8
PIPELINES = [(2, 1, 16, True), (2, 1, 16, False), (2, 1, 32, True), (2, 1, 64, True),
             (3, 2, 16, True), (4, 3, 16, True), (4, 3, 32, True), (4, 2, 32, True),
             (6, 4, 16, True)]


@pytest.fixture(scope="module")
def jtools():
    """The three JAX tool modules and ``force_tpu_interpret_mode``."""
    pytest.importorskip("jax")
    import jax
    from jax.experimental.pallas import tpu as pltpu

    cache_dir = jax.config.jax_compilation_cache_dir
    dont_write = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    mods = {}
    try:
        for name in ("stream_ladder", "pallas_pipeline_experiment", "pallas_grid_experiment"):
            spec = importlib.util.spec_from_file_location(f"_jax_tools_{name}",
                                                          ROOT / "tools" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    finally:
        sys.dont_write_bytecode = dont_write
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return mods, pltpu.force_tpu_interpret_mode


def _inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, N)).astype(dtype),
            rng.standard_normal((8, N)).astype(dtype))


@pytest.mark.parametrize("bm,slots", [(16, 2), (16, 4), (32, 2)])
def test_read_kernel_matches_jax(jtools, bm, slots):
    mods, interpret = jtools
    u, tok = _inputs()
    with interpret():
        want = np.asarray(mods["stream_ladder"].read_kernel(N, N, bm, slots)(u, tok))
    got = tsl.read_kernel(N, N, bm, slots)(torch.tensor(u), torch.tensor(tok))
    assert got.shape == (8, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bm,slots", [(16, 1), (16, 2), (16, 4), (32, 2), (32, 4)])
def test_write_kernel_matches_jax(jtools, bm, slots):
    mods, interpret = jtools
    _, tok = _inputs(1)
    with interpret():
        want = np.asarray(mods["stream_ladder"].write_kernel(N, N, bm, slots)(tok))
    got = tsl.write_kernel(N, N, bm, slots)(torch.tensor(tok))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_copy_kernel_matches_jax_at_four_slots(jtools):
    mods, interpret = jtools
    u, tok = _inputs(2)
    with interpret():
        want = np.asarray(mods["stream_ladder"].copy_kernel(N, N, 16, 4)(u, tok))
    got = tsl.copy_kernel(N, N, 16, 4)(torch.tensor(u), torch.tensor(tok))
    assert np.array_equal(got.numpy(), want) and np.array_equal(want, u)


@pytest.mark.parametrize("slots,depth,bm,halos", PIPELINES)
def test_make_pipeline_matches_jax(jtools, slots, depth, bm, halos):
    import jax.numpy as jnp

    mods, interpret = jtools
    u, _ = _inputs(3)
    with interpret():
        want = np.asarray(mods["pallas_pipeline_experiment"].make_pipeline(
            N, N, bm, jnp.float32, slots, depth, halos)(u))
    got = tpe.make_pipeline(N, N, bm, torch.float32, slots, depth, halos)(torch.tensor(u))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bm", [16, 32, 64])
def test_grid_copy_matches_jax(jtools, bm):
    mods, interpret = jtools
    u, _ = _inputs(4)
    with interpret():
        want = np.asarray(mods["pallas_grid_experiment"].grid_copy(N, bm)(u))
    got = tge.grid_copy(N, bm)(torch.tensor(u))
    assert np.array_equal(got.numpy(), want)


def test_plain_versions_in_f64():
    """The f64 forms the smoke run times on the card, against numpy."""
    u, tok = _inputs(5, np.float64)
    ut, tt = torch.tensor(u), torch.tensor(tok)
    want = tok + u.reshape(4, 16, N)[:, :8].sum(0)
    np.testing.assert_allclose(sl.stream_read(ut, tt, 16, 2).numpy(), want, rtol=0, atol=1e-13)
    rows = sl.stream_write(tt, N, 16, 4).numpy()
    assert np.array_equal(rows, tok[0] * 0.5 + np.repeat(np.arange(4.0), 16)[:, None])
    assert np.array_equal(sl.staged_copy(ut, 16, 3, 2, True).numpy(), u)


@pytest.mark.parametrize("make,args,error", [
    (tsl.read_kernel, (64, 64, 12, 2), "multiple of 8"),      # bm not a multiple of 8
    (tsl.read_kernel, (64, 64, 0, 2), "multiple of 8"),
    (tsl.read_kernel, (64, 64, 24, 2), "must divide"),        # bm does not divide n_rows
    (tsl.write_kernel, (64, 62, 16, 2), "16-byte"),           # rows not whole vectors
    (tsl.write_kernel, (64, 64, 16, 9), "slots"),             # more than 8 stages
    (tsl.read_kernel, (64, 64, 16, 0), "slots"),
    (tsl.copy_kernel, (64, 64, 16, 1), "depth"),              # a copy needs a second slot
    (tsl.read_kernel, (8192, 64, 4096, 8), "16 bytes"),       # the ring holds no tile
])
def test_factories_reject_what_the_kernels_do_not_take(make, args, error):
    with pytest.raises(ValueError, match=error):
        make(*args)


def test_factory_argument_checks_on_depth_dtype_and_inputs():
    with pytest.raises(ValueError, match="depth"):
        tpe.make_pipeline(64, 64, 16, torch.float32, slots=2, depth=2)
    with pytest.raises(ValueError, match="depth"):
        tpe.make_pipeline(64, 64, 16, torch.float32, slots=4, depth=0)
    with pytest.raises(TypeError, match="float32 or float64"):
        tsl.write_kernel(64, 64, 16, 2, dtype=torch.float16)
    with pytest.raises(ValueError, match="must divide"):
        tge.grid_copy(64, 48)
    u, tok = (torch.tensor(a) for a in _inputs())
    with pytest.raises(ValueError, match="shape"):
        tsl.read_kernel(32, 64, 16, 2)(u, tok)
    with pytest.raises(TypeError, match="float"):
        tsl.copy_kernel(64, 64, 16, 2, dtype=torch.float64)(u, tok)
    with pytest.raises(ValueError, match="shape"):
        tsl.copy_kernel(64, 64, 16, 2)(u, tok[:4])
    with pytest.raises(TypeError, match="float"):
        tge.grid_copy(64, 16)(u.double())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sl.staged_copy(u.to("meta"), 16)


@pytest.mark.parametrize("bm,slots,halos,itemsize,width,per", [
    (128, 2, False, 4, 96, 6),      # 452 bytes a ring row: three whole 128-byte lines
    (128, 2, True, 4, 96, 6),       # 144 rows with the halos: 401 bytes, the same
    (128, 4, False, 4, 32, 16),     # 226 bytes: one line
    (512, 4, False, 4, 8, 16),      # 56 bytes: one 32-byte sector
    (512, 2, False, 8, 12, 11),     # 113 bytes: three sectors of f64
    (8, 2, False, 4, 512, 16),      # capped at 512 columns
])
def test_stream_tiling_by_rule(bm, slots, halos, itemsize, width, per):
    t = sl.stream_tiling(8192, 8192, bm, slots, halos, itemsize, 132)
    rows = bm + 16 * halos
    assert (t.width, t.per, t.groups) == (width, per, -(-(8192 // bm) // per))
    assert slots * rows * width * itemsize <= 115712 and width * itemsize % 16 == 0


def test_stream_tiling_narrow_field_takes_its_width():
    t = sl.stream_tiling(64, 64, 16, 2, False, 4, 132)
    assert (t.width, t.per, t.groups) == (64, 1, 4)


def test_ladder_rows_on_the_cpu():
    """The module's ladder at 512^2 on the CPU: the JAX main's rows
    (triad first, then read, write, copy by bm and slots), host times only."""
    rows = tsl.ladder(512, reps=1, device="cpu")
    # host times of microseconds: finite, of either sign
    assert rows[0]["kernel"] == "torch_triad_reference" and np.isfinite(rows[0]["gbps"])
    assert [(r["kernel"], r["bm"], r["slots"]) for r in rows[1:]] == [
        (k, bm, s) for bm in (128, 256, 512) for s in (2, 4, 8) if s * bm <= 2048
        for k in ("read", "write", "copy")]
    assert all("device_ms" not in r and np.isfinite(r["ms"]) for r in rows[1:])


def test_time_chain_counts_the_marginal_calls():
    calls = []
    ms = tsl.time_chain(lambda t: calls.append(1) or t + 1, torch.zeros(8, 4), ks=(2, 5),
                        reps=3)
    assert np.isfinite(ms) and len(calls) == 4 * (2 + 5)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream kernels have no CPU mode")
    return torch.device("cuda")


# shapes with ragged strips (n_cols not a multiple of the strip width),
# one chunk a block or several, a single strip
GPU_SHAPES = [(64, 64), (256, 1000), (1024, 1028), (2048, 2048)]


def _card_inputs(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev),
            torch.tensor(rng.standard_normal((8, shape[1])), dtype=dtype, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("bm,slots", [(8, 1), (16, 2), (32, 4), (64, 8)])
def test_cuda_stream_read_matches_plain(cuda, shape, dtype, bm, slots):
    u, tok = _card_inputs(shape, dtype, cuda)
    before = launch_count("stream_read")
    got = sl.stream_read(u, tok, bm, slots)
    want = sl.read_plain(u, tok, bm)
    torch.cuda.synchronize()
    assert launch_count("stream_read") == before + 1
    nchunks = shape[0] // bm
    scale = float((tok.abs() + u.abs().view(nchunks, bm, -1)[:, :8].sum(0)).max())
    gate = nchunks * torch.finfo(dtype).eps * scale
    assert got.shape == (8, shape[1]) and float((got - want).abs().max()) <= gate


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("bm,slots", [(8, 1), (16, 2), (32, 4), (64, 8)])
def test_cuda_stream_write_equals_plain(cuda, shape, dtype, bm, slots):
    _, tok = _card_inputs(shape, dtype, cuda)
    before = launch_count("stream_write")
    got = sl.stream_write(tok, shape[0], bm, slots)
    torch.cuda.synchronize()
    assert launch_count("stream_write") == before + 1
    assert torch.equal(got, sl.write_plain(tok, shape[0], bm))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("slots,depth,bm,halos", [(2, 1, 8, True), (2, 1, 16, False),
                                                  (3, 2, 16, True), (4, 3, 32, True),
                                                  (6, 4, 16, True), (8, 7, 64, False)])
def test_cuda_staged_copy_equals_input(cuda, shape, dtype, slots, depth, bm, halos):
    u, _ = _card_inputs(shape, dtype, cuda)
    before = launch_count("staged_copy")
    got = sl.staged_copy(u, bm, slots, depth, halos)
    torch.cuda.synchronize()
    assert launch_count("staged_copy") == before + 1
    assert torch.equal(got, u)


@pytest.mark.gpu
def test_cuda_factories_launch_their_kernels(cuda):
    u, tok = _card_inputs((512, 512), torch.float32, cuda)
    kernels = ("stream_read", "stream_write", "staged_copy")
    before = [launch_count(k) for k in kernels]
    acc = tsl.read_kernel(512, 512, 128, 4)(u, tok)
    rows = tsl.write_kernel(512, 512, 128, 4)(tok)
    out = tsl.copy_kernel(512, 512, 128, 2)(u, tok)
    pipe = tpe.make_pipeline(512, 512, 128, torch.float32, 6, 4, True)(u)
    grid = tge.grid_copy(512, 256)(u)
    torch.cuda.synchronize()
    assert [launch_count(k) - b for k, b in zip(kernels, before)] == [1, 1, 3]
    assert torch.equal(out, u) and torch.equal(pipe, u) and torch.equal(grid, u)
    assert torch.equal(rows, sl.write_plain(tok, 512, 128))
    assert float((acc - sl.read_plain(u, tok, 128)).abs().max()) <= 1e-5
