"""The controls of each cell's comparison, read at the cell's own size.

    python -m portbench.control --workload <name> --seeds 11,12,13 [--steps 4]

For each seed the cell is built as a run builds it and ``steps`` steps of
the program are taken from the prepared state: their readings are the
sound ones, and the largest over the seeds is a number's lower reading.
On the same inputs each control of the cell (``controls()`` of its system:
the nearest precision below the configuration's) is put in the program's
place; the smallest of its readings over the seeds is the upper reading.
The benchmark's runs never run this.  One JSON line a seed, then a
summary line with the cell's limits beside both readings.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from .run import ROOT, fold_worst, load_cell, load_system


def control_readings(root, workload: str, seeds, steps: int, device: str = "cuda",
                     emit=None):
    """``(per_seed, summary)`` of the sound and the control readings."""
    import torch

    _, config, traffic, _ = load_cell(root, workload, False)
    system = load_system(root, config["system"])
    dev = torch.device(device)
    per_seed = []
    for seed in seeds:
        t0 = time.perf_counter()
        cell = system.build(config, traffic, seed, dev)
        limits = cell.limits()
        controls = cell.controls()
        sound, ctrl, converged = {}, {name: {} for name in controls}, []
        state = cell.initial
        for _ in range(steps):
            new, info = cell.step(state)
            converged.append(info["converged"])
            fold_worst(sound, cell.readings((state, new)), limits)
            for name, (fn, only) in controls.items():
                got = cell.readings((state, fn(state)))
                fold_worst(ctrl[name], {k: v for k, v in got.items()
                                    if only is None or k in only}, limits)
            state = new
        rec = {"seed": seed, "sound": sound, "controls": ctrl, "converged": converged,
               "seconds": time.perf_counter() - t0}
        per_seed.append(rec)
        if emit:
            emit(rec)
        cell.free()
        del cell, state, new
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    lower, upper = {}, {}
    for rec in per_seed:
        fold_worst(lower, rec["sound"], limits)
        for name, readings in rec["controls"].items():
            best = upper.setdefault(name, {})
            for k, v in readings.items():
                pick = min if limits[k][1] == "<=" else max
                best[k] = v if k not in best else pick(best[k], v)
    return per_seed, {"workload": workload, "lower": lower, "upper": upper,
                      "limits": {k: list(v) for k, v in limits.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 3
    importlib.import_module("iterative_solvers_tpu_torch.ops._build").load_library()
    seeds = [int(s) for s in args.seeds.split(",")]
    _, summary = control_readings(ROOT, args.workload, seeds, args.steps,
                                  emit=lambda r: print(json.dumps(r), flush=True))
    summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
