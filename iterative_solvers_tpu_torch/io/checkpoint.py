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
the other's.  :func:`save_sharded` / :func:`load_sharded` keep a field
sharded over the ranks of the distribution layer (``dist/``) as one file
a rank, in the JAX package's directory format too.
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
    _atomic_write(path, "wb", lambda f: np.savez(f, **payload))


def _atomic_write(path: pathlib.Path, mode: str, write) -> None:
    """``write(f)`` into a temporary file beside ``path``, then rename it
    over ``path``: an interrupted write leaves the old file whole."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
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
    _check_meta(path, meta, config)
    return arrays, meta


def _check_meta(path: pathlib.Path, meta: dict, config: Any) -> None:
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


_META_FILE = "meta.json"


def _index_key(index) -> str:
    """Stable string key for a shard's global-slice index."""
    return ";".join(f"{s.start or 0}:{s.stop}" for s in index)


def _process():
    """``(rank, world size)`` of this process (0 and 1 without a process
    group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_sharded(path: str | pathlib.Path, arrays: Mapping[str, Any],
                 config: Any = None, step: int = 0, time: float = 0.0, *,
                 shardings: Mapping[str, Any] | None = None) -> None:
    """Multi-process checkpoint of sharded fields.

    ``path`` is a directory: every rank writes ONLY its blocks to
    ``proc{rank}.npz`` under the keys ``name|y0:y1;x0:x1`` (their global
    slices; no rank ever holds a global field), and rank 0 writes
    ``meta.json`` with the metadata checked on load: config, step/time,
    each array's global shape, dtype and partition spec.  ``shardings``
    maps a name to the :class:`..dist.halo.GridSharding` its array is a
    block of; an array without one is whole (spec ``""``), as a host
    array is in the JAX package.  Each file is written atomically
    (temporary file, then rename); with several ranks the call returns
    when every rank has written.
    """
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rank, world = _process()
    shardings = shardings or {}

    payload: dict[str, np.ndarray] = {}
    layout: dict[str, Any] = {}
    for name, arr in arrays.items():
        block = to_numpy(arr)
        sh = shardings.get(name)
        if sh is None:
            shape = block.shape
            idx = tuple(slice(0, s) for s in shape)
            spec = ""
        else:
            shape = sh.global_shape(block.shape)
            idx = sh.index(shape)
            spec = sh.spec_str
        payload[f"{name}|{_index_key(idx)}"] = block
        layout[name] = {"shape": list(shape), "dtype": str(block.dtype), "spec": spec}

    _atomic_write(path / f"proc{rank}.npz", "wb", lambda f: np.savez(f, **payload))
    if rank == 0:
        meta = {
            "format_version": FORMAT_VERSION,
            "step": int(step),
            "time": float(time),
            "config": _config_dict(config),
            "layout": layout,
            "num_processes": world,
        }
        _atomic_write(path / _META_FILE, "w", lambda f: json.dump(meta, f))
    if world > 1:
        import torch.distributed as dist

        dist.barrier()


def load_sharded(path: str | pathlib.Path, shardings: Mapping[str, Any],
                 config: Any = None):
    """Restore fields saved by :func:`save_sharded` (by either package).

    ``shardings`` maps an array name to the :class:`..dist.halo.GridSharding`
    of the block this rank takes (returned on the rank's device), or to a
    device for the whole array there (the JAX package's
    ``SingleDeviceSharding``).  Each rank reads only its own block, from
    whichever ``proc*.npz`` holds it.  Config validation as in
    :func:`load`; the stored partition spec is checked against the target's
    so a layout change raises :class:`CheckpointMismatch` instead of
    silently reshuffling, as does a block no file holds.  Returns
    ``(arrays, meta)``.
    """
    import torch

    path = pathlib.Path(path)
    meta = json.loads((path / _META_FILE).read_text())
    _check_meta(path, meta, config)

    where: dict[str, pathlib.Path] = {}
    for f in sorted(path.glob("proc*.npz")):
        with np.load(f) as z:
            for key in z.files:
                where.setdefault(key, f)

    out = {}
    for name, target in shardings.items():
        lay = meta["layout"][name]
        shape = tuple(lay["shape"])
        stored_spec = lay.get("spec", "")
        sharded = hasattr(target, "spec_str")
        spec = target.spec_str if sharded else ""
        if stored_spec and spec != stored_spec:
            raise CheckpointMismatch(
                f"{name}: stored partition {stored_spec} != target {spec}")
        idx = target.index(shape) if sharded else tuple(slice(0, s) for s in shape)
        key = f"{name}|{_index_key(idx)}"
        if key not in where:
            raise CheckpointMismatch(
                f"{name}: no stored chunk for block {_index_key(idx)} "
                f"(saved on a different layout?)")
        with np.load(where[key]) as z:
            chunk = z[key].astype(lay["dtype"])
        out[name] = torch.as_tensor(chunk, device=target.device if sharded else target)
    return out, meta


def export_reference_text(path, u, q) -> None:
    """Write a reference-format two-column state file (droplet.py:556-562)."""
    u = to_numpy(u).reshape(-1)
    q = to_numpy(q).reshape(-1)
    with open(path, "w") as f:
        for ui, qi in zip(u, q):
            f.write(f"{float(ui)} {float(qi)}\n")
