"""Small-size copies of the benchmark's cells for the CPU tests.

Each configuration's CPU size is a file of its own,
``portbench/tests/small/<config>.json``: the small configuration's name and
the keys it overrides.  A configuration is added with that file beside its
own, and no file here changes."""
from __future__ import annotations

import json
import pathlib
import shutil
import time

from portbench import run as harness

PKG = pathlib.Path(harness.__file__).resolve().parent
ROOT = PKG.parent
SMALL = pathlib.Path(PKG.name) / "tests" / "small"


def small_size(src: pathlib.Path, config: str) -> dict:
    """The CPU size of ``config`` in the checkout ``src``."""
    path = src / SMALL / f"{config}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"no CPU size for the configuration {config!r}: add {SMALL / (config + '.json')} "
            "with the small configuration's name and the keys it overrides")
    return json.loads(path.read_text())


def small_root(tmp: pathlib.Path, src: pathlib.Path = ROOT) -> pathlib.Path:
    """A checkout-like root with the benchmark folder of ``src`` and a
    BENCHMARK.json whose cells are ``src``'s at their CPU sizes
    (``tests/small/``), named ``<small config>.<traffic>``."""
    shutil.copytree(src / PKG.name, tmp / PKG.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    names = {}
    for entry in bench["configs"]:
        cfg = json.loads((src / entry["file"]).read_text())
        small = small_size(src, entry["name"])
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
