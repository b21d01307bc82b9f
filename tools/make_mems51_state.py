"""Make the near-touchdown MEMS state of the benchmark's ``mems51`` configuration.

    python tools/make_mems51_state.py

Runs the JAX package's own touchdown driver (``examples/mems_touchdown.run_ours``,
on the CPU in float64) with ``MEMSConfig()`` from the flat state until u_min
passes -0.9, in chunks of 500 steps, as the published run
``benchmarks/mems_touchdown.jsonl`` was made (~5.5 min).  The last state is
held against that record's last row, and written only if it matches:
``portbench/data/mems51_touchdown.npz`` with ``u`` and ``q`` (51 x 51 float64),
``t`` and ``step``.  The benchmark itself imports no JAX: it reads this file.
"""
import importlib.util
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECORD = ROOT / "benchmarks" / "mems_touchdown.jsonl"
OUT = ROOT / "portbench" / "data" / "mems51_touchdown.npz"
U_STOP, CHUNK, STEP = -0.9, 500, 39500


def load_driver():
    """``examples/mems_touchdown.py`` as a module (it sets JAX to the CPU and x64)."""
    spec = importlib.util.spec_from_file_location("mems_touchdown_driver",
                                                  ROOT / "examples" / "mems_touchdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_record_row() -> dict:
    rows = [json.loads(line) for line in RECORD.read_text().splitlines()]
    return max((r for r in rows if "step" in r), key=lambda r: r["step"])


def check(step: int, u_min: float, t: float, row: dict) -> list:
    """What disagrees with the record's last row ``row`` (empty when all holds)."""
    bad = []
    if not step == row["step"] == STEP:
        bad.append(f"step {step} != {row['step']} or {STEP}")
    if abs(u_min - row["u_min"]) > 1e-9:
        bad.append(f"u_min {u_min!r} not within 1e-9 of {row['u_min']!r}")
    if abs(t - row["t"]) > 1e-9 * row["t"]:
        bad.append(f"t {t!r} not within 1e-9 relative of {row['t']!r}")
    return bad


def main() -> int:
    row = last_record_row()
    driver = load_driver()
    from iterative_solvers_tpu.models import mems

    rows, (u, q, t), wall = driver.run_ours(mems.MEMSConfig(), U_STOP, 60000, CHUNK)
    u, q, t = np.asarray(u, np.float64), np.asarray(q, np.float64), float(t)
    step = len(rows)
    bad = check(step, float(u.min()), t, row)
    print(json.dumps({"step": step, "t": t, "u_min": float(u.min()),
                      "dt": rows[-1]["dt"], "min_spacing": rows[-1]["min_spacing"],
                      "wall_s": wall, "record": row}), flush=True)
    if bad:
        print("not written: " + "; ".join(bad), file=sys.stderr)
        return 1
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(OUT, u=u, q=q, t=np.float64(t), step=np.int64(step))
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
