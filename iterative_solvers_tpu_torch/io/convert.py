"""Carry state across from the JAX package.

This system has no weights: its "parameters" are the configuration, the
mesh potential and the solution.  These helpers take the JAX side's
values as plain Python/numpy (``dataclasses.asdict`` of its
``DropletConfig``, ``np.asarray`` of its arrays) and build the port's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.droplet import DropletConfig


def config_from_dict(d: dict) -> DropletConfig:
    """The port's DropletConfig from ``dataclasses.asdict`` of the JAX one
    (unknown keys raise, so a field added on one side is noticed)."""
    names = {f.name for f in dataclasses.fields(DropletConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"fields the port's DropletConfig lacks: {sorted(unknown)}")
    return DropletConfig(**d)


def state_from_numpy(u, q, device, dtype=torch.float64):
    """Solution ``u`` and mesh potential ``q`` (``(ny, nx)`` arrays) as
    tensors on ``device``."""
    return (torch.tensor(np.asarray(u), dtype=dtype, device=device),
            torch.tensor(np.asarray(q), dtype=dtype, device=device))


def stack_from_numpy(stack, device, dtype=torch.float32):
    """A ``(8, ny, nx)`` JVP coefficient stack as a contiguous tensor."""
    s = np.asarray(stack)
    if s.ndim != 3 or s.shape[0] != 8:
        raise ValueError(f"expected an (8, ny, nx) stack, got {s.shape}")
    return torch.tensor(s, dtype=dtype, device=device)
