"""Small-size copies of the benchmark's cells for the CPU tests."""
from __future__ import annotations

import json
import pathlib
import shutil
import time

from portbench import run as harness

PKG = pathlib.Path(harness.__file__).resolve().parent
ROOT = PKG.parent
SMALL = {"sh2048": {"name": "sh24", "n": 24, "d": 15.0},
         "droplet1024": {"name": "droplet91", "nx": 91, "ny": 61}}


def small_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout-like root with the benchmark folder and a BENCHMARK.json
    whose cells are the real ones at small sizes (SH n = 24, the droplet at
    the fixture's 91x61), named ``<small config>.<traffic>``."""
    shutil.copytree(PKG, tmp / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {}
    for entry in bench["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        small = SMALL[entry["name"]]
        cfg.update({k: v for k, v in small.items() if k != "name"})
        path = f"{PKG.name}/configs/{small['name']}.json"
        (tmp / path).write_text(json.dumps(cfg))
        names[entry["name"]] = small["name"]
        entry.update(name=small["name"], file=path)
    for cell in bench["workloads"]:
        cell["config"] = names[cell["config"]]
        cell["name"] = f"{cell['config']}.{cell['traffic']}"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"{names[w.split('.')[0]]}.{w.split('.')[1]}"
                              for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_small(root, workload: str, seconds: float = 0.3, trace: bool = False, seed: int = 5):
    """One run of a small cell on the CPU: ``(result, checks, run)``."""
    return harness.run_cell(root, workload, seed, seconds, trace, time.perf_counter(),
                            device="cpu")
