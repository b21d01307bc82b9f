"""Checkpoint/restart with explicit metadata
(port of ``iterative_solvers_tpu/io/checkpoint.py``).

Every checkpoint carries its config, shapes, dtypes and a format version;
:func:`load` validates against the caller's config and raises
:class:`CheckpointMismatch` on any difference (loading a state under
mismatched parameters silently stalls the solver in the reference).

Storage is one ``.npz`` on the host, written atomically through a temporary
file and a rename, so an interrupted write never corrupts a restart point.
Arrays may be tensors (on any device) or numpy arrays; they are written and
read as numpy.  The files are the JAX package's format: either side loads
the other's.  The sharded checkpoint (``save_sharded`` / ``load_sharded``)
belongs to the distribution layer and is not here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Any, Mapping

import numpy as np

from .. import to_numpy

FORMAT_VERSION = 1


class CheckpointMismatch(RuntimeError):
    pass


def _config_dict(config: Any) -> dict:
    if config is None:
        return {}
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    if isinstance(config, Mapping):
        return dict(config)
    raise TypeError(f"unsupported config type: {type(config)}")


def save(path: str | pathlib.Path, arrays: Mapping[str, Any],
         config: Any = None, step: int = 0, time: float = 0.0) -> None:
    """Atomically write arrays + metadata to ``path`` (.npz)."""
    path = pathlib.Path(path)
    payload = {k: to_numpy(v) for k, v in arrays.items()}
    meta = {
        "format_version": FORMAT_VERSION,
        "step": int(step),
        "time": float(time),
        "config": _config_dict(config),
        "shapes": {k: list(v.shape) for k, v in payload.items()},
        "dtypes": {k: str(v.dtype) for k, v in payload.items()},
    }
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str | pathlib.Path, config: Any = None):
    """Load ``(arrays, meta)``; if ``config`` is given, validate every field
    it shares with the stored config and raise :class:`CheckpointMismatch`
    on any difference."""
    path = pathlib.Path(path)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if meta.get("format_version") != FORMAT_VERSION:
        raise CheckpointMismatch(
            f"{path.name}: format {meta.get('format_version')} != {FORMAT_VERSION}"
        )
    if config is not None:
        want = _config_dict(config)
        got = meta.get("config", {})
        diffs = {
            k: (got.get(k), v)
            for k, v in want.items()
            if k in got and got[k] != v
        }
        if diffs:
            raise CheckpointMismatch(
                f"{path.name}: config mismatch {diffs}"
            )
    return arrays, meta


def export_reference_text(path, u, q) -> None:
    """Write a reference-format two-column state file (droplet.py:556-562)."""
    u = to_numpy(u).reshape(-1)
    q = to_numpy(q).reshape(-1)
    with open(path, "w") as f:
        for ui, qi in zip(u, q):
            f.write(f"{float(ui)} {float(qi)}\n")
