"""Structured per-step metrics, decoupled from the step loop
(port of ``iterative_solvers_tpu/utils/metrics.py``).

The drivers return per-step values as arrays (Newton counts, residual
norms, dts); this module turns them into host-side records and JSONL after
the fact.  Rendering (:mod:`.render`) works from saved state, never inside
the loop.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any, Mapping

import numpy as np
import torch

from .. import to_numpy


@dataclasses.dataclass
class MetricsLogger:
    """Append-only JSONL metrics sink."""

    path: str | pathlib.Path | None = None
    records: list = dataclasses.field(default_factory=list)

    def log(self, step: int, **values: Any) -> None:
        rec = {"step": int(step), "wall": time.time()}
        for k, v in values.items():
            if isinstance(v, torch.Tensor):
                v = to_numpy(v)
            if isinstance(v, (np.ndarray, np.generic)):
                v = v.item() if np.ndim(v) == 0 else v.tolist()
            rec[k] = v
        self.records.append(rec)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def log_scan_outputs(self, arrays: Mapping[str, Any],
                         start_step: int = 0) -> None:
        """Expand stacked per-step outputs (numpy arrays, lists or tensors,
        one entry a step) into records."""
        host = {k: to_numpy(v) for k, v in arrays.items()}
        n = len(next(iter(host.values())))
        for i in range(n):
            self.log(start_step + i, **{k: a[i] for k, a in host.items()})

    def summary(self) -> dict:
        out: dict = {}
        if not self.records:
            return out
        keys = set().union(*(r.keys() for r in self.records))
        for k in keys - {"step", "wall"}:
            vals = [r[k] for r in self.records if k in r
                    and isinstance(r[k], (int, float))]
            if vals:
                out[k] = {"mean": float(np.mean(vals)),
                          "min": float(np.min(vals)),
                          "max": float(np.max(vals)),
                          "last": float(vals[-1])}
        return out
