"""Carry state across from the JAX package.

This system has no weights: its "parameters" are the configuration, the
mesh potential, the solution and any assembled sparse operator.  These helpers take the JAX side's
values as plain Python/numpy (``dataclasses.asdict`` of its
``DropletConfig``, the fields of its ``SHConfig``, ``np.asarray`` of its
arrays) and build the port's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.droplet import DropletConfig
from ..models.swift_hohenberg import SHConfig
from ..ops.sparse import BSR, COO, CSR, DIA, GridDIA, _index


def _from_dict(cls, d: dict):
    """``cls(**d)``; keys ``cls`` lacks raise, so a field added on one side
    is noticed."""
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"fields the port's {cls.__name__} lacks: {sorted(unknown)}")
    return cls(**d)


def config_from_dict(d: dict) -> DropletConfig:
    """The port's DropletConfig from ``dataclasses.asdict`` of the JAX one."""
    return _from_dict(DropletConfig, d)


def sh_config_from_jax(cfg) -> SHConfig:
    """The port's SHConfig from the JAX package's (any dataclass with the
    same fields; read through ``dataclasses.asdict``)."""
    return _from_dict(SHConfig, dataclasses.asdict(cfg))


def field_from_numpy(a, device, dtype=torch.float64):
    """An ``(ny, nx)`` field (the SH state ``u``, or any array) as a tensor
    on ``device``."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def state_from_numpy(u, q, device, dtype=torch.float64):
    """Solution ``u`` and mesh potential ``q`` (``(ny, nx)`` arrays) as
    tensors on ``device``."""
    return (field_from_numpy(u, device, dtype), field_from_numpy(q, device, dtype))


def stack_from_numpy(stack, device, dtype=torch.float32):
    """A ``(8, ny, nx)`` JVP coefficient stack as a contiguous tensor."""
    s = np.asarray(stack)
    if s.ndim != 3 or s.shape[0] != 8:
        raise ValueError(f"expected an (8, ny, nx) stack, got {s.shape}")
    return torch.tensor(s, dtype=dtype, device=device)


# -- sparse containers ---------------------------------------------------------
# Each takes the JAX container's arrays as numpy (``np.asarray(a.data)``, ...)
# plus its static fields, and keeps the arrays' dtype.

def dia_from_jax(data, offsets, n: int, device) -> DIA:
    return DIA(data=torch.as_tensor(np.asarray(data), device=device),
               offsets=tuple(int(o) for o in offsets), n=int(n))


def csr_from_jax(data, indices, rows, shape, device) -> CSR:
    return CSR(data=torch.as_tensor(np.asarray(data), device=device),
               indices=_index(indices, device),
               rows=_index(rows, device), shape=tuple(shape))


def coo_from_jax(data, row, col, shape, device) -> COO:
    return COO(data=torch.as_tensor(np.asarray(data), device=device),
               row=_index(row, device),
               col=_index(col, device), shape=tuple(shape))


def bsr_from_jax(data, indices, rows, shape, blocksize: int, device) -> BSR:
    return BSR(data=torch.as_tensor(np.asarray(data), device=device),
               indices=_index(indices, device),
               rows=_index(rows, device), shape=tuple(shape),
               blocksize=int(blocksize))


def griddia_from_jax(data, shifts, grid, cyclic: bool, device) -> GridDIA:
    return GridDIA(data=torch.as_tensor(np.asarray(data), device=device),
                   shifts=tuple((int(dy), int(dx)) for dy, dx in shifts),
                   grid=(int(grid[0]), int(grid[1])), cyclic=bool(cyclic))
