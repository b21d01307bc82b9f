"""Port parity: ``utils/roofline``'s device tables and measured rate
against the JAX package's, on the CPU.

The JAX functions read the first JAX device (the CPU here); the port's
take ``device="cpu"``.  The CPU entries are the JAX package's own: 50 GB/s
and the 16 MiB default.  ``measured_stream_gbps`` runs only at n = 512
here (two 1 MB fields: a rehearsal of its control flow, not a
measurement of any device; at n = 256 the marginal between the chains,
~1 ms, is within a loaded host's timing noise and can read negative), and ``roofline_denominator_gbps``, whose
triad runs at 8192^2, is held to ``max(spec, measured)`` with the
measured rate stubbed.  The card's entries are exercised by the ``gpu``
test and by ``chip_smoke.py``.
"""
import math

import pytest
import torch

from iterative_solvers_tpu_torch.utils import roofline as troof


@pytest.fixture(scope="module")
def jroof():
    pytest.importorskip("jax")
    from iterative_solvers_tpu.utils import roofline

    return roofline


def test_cpu_tables_match_jax(jroof):
    assert troof.device_hbm_gbps("cpu") == jroof.device_hbm_gbps() == 50.0
    assert troof.device_vmem_bytes("cpu") == jroof.device_vmem_bytes() == 16 * 2**20
    assert troof.HBM_GBPS["cpu"] == jroof.HBM_GBPS["cpu"]


@pytest.mark.parametrize("nbytes", [0, 16 * 2**20, 24 * 2**20, 24 * 2**20 + 1, 2**31])
@pytest.mark.parametrize("margin", [1.0, 1.5, 3.0])
def test_working_set_exceeds_vmem_matches_jax(jroof, nbytes, margin):
    assert (troof.working_set_exceeds_vmem(nbytes, margin, device="cpu")
            == jroof.working_set_exceeds_vmem(nbytes, margin))


def test_working_set_default_margin_is_jax_one_and_a_half():
    assert not troof.working_set_exceeds_vmem(24 * 2**20, device="cpu")
    assert troof.working_set_exceeds_vmem(24 * 2**20 + 1, device="cpu")


def test_measured_stream_gbps_small_is_positive_finite_and_cached(monkeypatch):
    first = troof.measured_stream_gbps(n=512, device="cpu")
    assert first > 0 and math.isfinite(first)
    # a second call is the cached value: no field is allocated again
    monkeypatch.setattr(troof.torch, "zeros", None)
    assert troof.measured_stream_gbps(n=512, device="cpu") == first
    assert (512, 5, "cpu") in troof._HBM_MEASURED


@pytest.mark.parametrize("measured", [10.0, 50.0, 123.0])
def test_roofline_denominator_is_max_of_spec_and_measured(monkeypatch, measured):
    seen = []

    def stub(n=8192, reps=5, device="cuda"):
        seen.append((n, reps, device))
        return measured

    monkeypatch.setattr(troof, "measured_stream_gbps", stub)
    assert troof.roofline_denominator_gbps(device="cpu") == max(50.0, measured)
    assert seen == [(8192, 5, "cpu")]


def test_unknown_card_raises(monkeypatch):
    """A GPU absent from the tables has no CPU figure standing in for it."""
    monkeypatch.setattr(troof, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(troof.torch.cuda, "get_device_name", lambda dev: "Some Other GPU")
    with pytest.raises(KeyError, match="some other gpu"):
        troof.device_hbm_gbps()
    with pytest.raises(KeyError, match="some other gpu"):
        troof.working_set_exceeds_vmem(1)
    monkeypatch.setattr(troof.torch.cuda, "get_device_name",
                        lambda dev: "NVIDIA H100 80GB HBM3")
    assert troof.device_hbm_gbps() == 3350.0 and troof.device_vmem_bytes() == 50_000_000


def test_device_defaults_to_the_card():
    """Like every entry point of the port: without a card and without
    ``device="cpu"`` the functions raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        troof.device_hbm_gbps()


@pytest.mark.gpu
def test_cuda_measured_stream_is_a_device_rate():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gbps = troof.measured_stream_gbps(n=4096, reps=3)
    spec = troof.device_hbm_gbps()
    assert 0.3 * spec < gbps < 1.2 * spec
    assert troof.roofline_denominator_gbps() >= spec
    assert troof.working_set_exceeds_vmem(3 * 4096 * 4096 * 4, margin=1.0)
