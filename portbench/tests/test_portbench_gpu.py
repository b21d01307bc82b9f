"""One short run of each cell on the card, as the benchmark's command runs
it: ``python -m pytest -m gpu portbench/tests``."""
import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell,
                          "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert list(result)[-1] == "checks"
