"""The Poisson cell at its CPU size (47^2) on the card, through the kernel
``grid_dia_matvec``: ``python -m pytest -m gpu portbench/tests``."""
import pytest

from portbench.run import run_cell
from portbench.tests.helpers import small_root


@pytest.mark.gpu
def test_the_small_poisson_cell_is_correct_on_the_card(tmp_path):
    import time

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = small_root(tmp_path)
    result, checks, run = run_cell(root, "poisson48.cg_dia", 2 ** 31 + 48, 1.0, True,
                                   time.perf_counter())
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["host.syncs.cg"] == m["cg.iters"] + 3
    assert 0.0 < m["grid_dia_matvec_roofline"] < 100.0
    assert result["device"]["busy_s"] > 0
