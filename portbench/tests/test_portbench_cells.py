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
