"""Every cell of BENCHMARK.json resolves its files, the file keeps to the
benchmark's contract, and a cell, a traffic mix and a metric can be added
by data alone."""
import importlib
import json
import re

import pytest

from portbench.tests.helpers import PKG, ROOT, run_small, small_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_./%-]{1,16}")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == [PKG.name]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_to_the_contract(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = set(e) - KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert KEYS[section] <= set(e)
        assert NAME.fullmatch(e["name"])
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
        if section == "per_layer":
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files(cell):
    trace_cell, config, traffic, metrics = __import__(
        "portbench.run", fromlist=["load_cell"]).load_cell(ROOT, cell, True)
    assert trace_cell["chips"] == 1
    assert NAME.fullmatch(trace_cell["config"]) and NAME.fullmatch(trace_cell["traffic"])
    importlib.import_module(f"portbench.systems.{config['system']}")
    assert {"stepper", "segment_steps", "warmup_steps", "check_samples"} <= set(traffic)
    assert 1 <= traffic["check_samples"] <= traffic["segment_steps"]
    from portbench.run import reported_in
    e2e = {m["name"] for m in BENCH["end_to_end"] if reported_in(BENCH, m, cell)}
    layers = [m for m in BENCH["per_layer"] if reported_in(BENCH, m, cell)]
    # set-up, one more end-to-end metric, a per-layer one, and each per-layer
    # metric moves an end-to-end metric that the cell reports
    assert "setup_s" in e2e and len(e2e) >= 2 and layers == metrics
    assert all(m["moves"] in e2e for m in layers)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()


def test_configs_state_what_was_cut():
    for entry in BENCH["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
        assert all(k in cfg for k in entry["reduced"]) and cfg["guarantees"]


def test_a_cell_a_mix_and_a_metric_are_added_by_data_alone(tmp_path):
    root = small_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / PKG.name / "traffic" / "cn3.json").write_text(json.dumps(
        {"stepper": "cn", "segment_steps": 3, "warmup_steps": 1, "check_samples": 2}))
    (root / PKG.name / "metrics" / "cycles.per_step.py").write_text(
        "def read(run):\n    span = run.spans.get('krylov')\n"
        "    return span[0] / run.steps if span else None\n")
    bench["workloads"].append({"name": "sh24.cn3", "config": "sh24", "traffic": "cn3",
                               "chips": 1, "why": "a cell added by data alone"})
    bench["per_layer"].append({"name": "cycles.per_step", "unit": "cycles/step",
                               "better": "lower", "source": "program_span",
                               "layer": "inner Krylov (solvers/lgmres, solvers/gmres)",
                               "moves": "step_ms", "workloads": ["sh24.cn3"]})
    for m in bench["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append("sh24.cn3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _, run = run_small(root, "sh24.cn3", trace=True)
    assert result["correct"] and result["attempted"] == run.steps > 0
    assert result["metrics"]["cycles.per_step"]["value"] >= 1.0
    assert list(result)[-1] == "checks"
    result, _, _ = run_small(root, "sh24.cn3")
    assert set(result["metrics"]) == {"setup_s", "step_ms"}   # step_p95_ms: sh2048 only


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (PKG / "traffic").glob("*.json")))
def test_checked_steps_lie_in_the_first_segment(traffic):
    from portbench.run import sample_picks
    mix = json.loads((PKG / "traffic" / f"{traffic}.json").read_text())
    for seed in (0, 7, 2 ** 31 + 11):
        picks = sample_picks(mix, seed)
        assert 0 in picks and len(picks) == mix["check_samples"]
        assert max(picks) < mix["segment_steps"]


DECAY_SYSTEM = '''"""A configuration added by files alone: each step halves a field on
the device and counts itself through the program's own counter, with no
``step`` span."""
import torch


class Cell:
    def __init__(self, config, traffic, seed, dev):
        g = torch.Generator(device=dev).manual_seed(seed)
        n = config["n"]
        self.rate = config["rate"]
        self.initial = torch.randn((n, n), generator=g, dtype=torch.float64, device=dev)
        self.spans, self.own, self.own_s, self.meta = {}, {}, 0.0, {}

    def step(self, x):
        from iterative_solvers_tpu_torch.utils import trace
        trace.count("decay.calls")
        return self.rate * x, {"converged": True}

    def readings(self, sample):
        x, y = sample
        return {"decay_error": float((y - self.rate * x).abs().max())}

    def limits(self):
        return {"decay_error": (0.0, "<=")}

    def controls(self):
        return {}

    def free(self):
        self.initial = None


def build(config, traffic, seed, dev):
    return Cell(config, traffic, seed, dev)
'''


def _src_with_a_new_configuration(src):
    """A copy of the checkout with a configuration ``decay8`` added as new
    files (its configuration, CPU size, traffic, system and metric reader)
    and entries in BENCHMARK.json."""
    import shutil
    shutil.copytree(PKG, src / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
    pkg = src / PKG.name
    (pkg / "configs" / "decay8.json").write_text(json.dumps(
        {"name": "decay8", "system": "decay", "source": "a test", "n": 8, "rate": 0.5,
         "reduced": [], "guarantees": {"decay_error": "exact"}}))
    (pkg / "tests" / "small" / "decay8.json").write_text(json.dumps({"name": "decay4", "n": 4}))
    (pkg / "traffic" / "halve.json").write_text(json.dumps(
        {"stepper": "halve", "segment_steps": 3, "warmup_steps": 1, "check_samples": 2}))
    (pkg / "systems" / "decay.py").write_text(DECAY_SYSTEM)
    (pkg / "metrics" / "decay.calls.py").write_text(
        "from portbench.program import reading\n\n\ndef read(run):\n"
        "    r = reading(run)\n    return r['counters'].get('decay.calls') if r else None\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "decay8", "source": "a test",
                             "file": f"{PKG.name}/configs/decay8.json", "reduced": [],
                             "why": "a configuration added by files alone"})
    bench["workloads"].append({"name": "decay8.halve", "config": "decay8", "traffic": "halve",
                               "chips": 1, "why": "a cell of the added configuration"})
    bench["per_layer"].append({"name": "decay.calls", "unit": "calls/step", "better": "lower",
                               "source": "program_counter", "layer": "decay",
                               "moves": "step_ms", "workloads": ["decay8.halve"]})
    for m in bench["end_to_end"]:
        if m["name"] == "step_ms":
            m["workloads"].append("decay8.halve")
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    return src


def test_a_configuration_is_added_by_files_alone(tmp_path):
    src = _src_with_a_new_configuration(tmp_path / "src")
    root = small_root(tmp_path / "small", src=src)
    result, checks, run = run_small(root, "decay4.halve", seconds=0.2, trace=True)
    assert result["correct"] and run.steps > 0
    assert result["metrics"]["decay.calls"]["value"] == 1.0
    # the program opened no step span: its counters are over the segment's own steps
    assert run.meta["program"]["steps"] == 3 and run.meta["program"]["spans"] == {}
    result, _, _ = run_small(root, "decay4.halve", seconds=0.2)
    assert set(result["metrics"]) == {"setup_s", "step_ms"}


def test_small_root_names_the_missing_cpu_size(tmp_path):
    src = _src_with_a_new_configuration(tmp_path / "src")
    (src / PKG.name / "tests" / "small" / "decay8.json").unlink()
    with pytest.raises(FileNotFoundError, match=r"tests/small/decay8\.json"):
        small_root(tmp_path / "small", src=src)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_has_its_cpu_size(config):
    from portbench.tests.helpers import small_size
    small = small_size(ROOT, config)
    assert NAME.fullmatch(small["name"]) and small["name"] != config
