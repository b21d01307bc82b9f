"""Nothing of the benchmark loads JAX or the JAX package, compared by whole
top-level module names, and the harness refuses to run without a card."""
import pathlib
import subprocess
import sys

import pytest

from portbench.tests.helpers import PKG, ROOT

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if "metrics" not in p.parts and p.name != "__main__.py" and "tests" not in p.parts)


def test_no_module_of_jax_is_loaded():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "from portbench.run import ROOT, load_reader, forbidden_modules\n"
            "import json\n"
            "b = json.loads((ROOT / 'BENCHMARK.json').read_text())\n"
            "for m in b['end_to_end'] + b['per_layer']: load_reader(ROOT, m['name'])\n"
            "importlib.import_module('iterative_solvers_tpu_torch')\n"
            "print(forbidden_modules())\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'iterative_solvers_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "[]"]


def test_names_are_compared_whole(monkeypatch):
    from portbench.run import forbidden_modules
    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "iterative_solvers_tpu"):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "iterative_solvers_tpu_torch_x.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "iterative_solvers_tpu.ops.dct", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert forbidden_modules() == ["iterative_solvers_tpu", "jax"]


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "sh2048.cn",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_reads_nothing_outside_its_folder():
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for name in ("benchmarks/", "bench.py", "chip_smoke", "tests/fixtures"):
            assert name not in text or path.name == pathlib.Path(__file__).name, (path, name)
