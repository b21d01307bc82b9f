"""Process groups and the device mesh (port of
``iterative_solvers_tpu/dist/mesh.py``).

``torch.distributed`` in place of ``jax.distributed``: one process a rank,
NCCL between GPUs (``device="cuda"``) or gloo between CPU processes
(``device="cpu"``), and a ``DeviceMesh`` whose named axes each carry a
process group.  A rank's GPU is ``cuda:(local_rank % device_count)``.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import resolve_device


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` (the local
    rank from ``LOCAL_RANK``, as ``torchrun`` sets it, else the global
    rank), or the CPU.  Raises for ``"cuda"`` without a GPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         device="cuda", timeout: float | None = None) -> None:
    """Start this rank's process group: NCCL for ``device="cuda"`` (raises
    without a GPU), gloo for ``device="cpu"``.

    ``coordinator_address`` is ``host:port`` (TCP) or a full init URL
    (``tcp://...``, ``file://...``); without it, and for the count and
    rank, the ``torchrun`` environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) is read.  ``timeout`` bounds every
    collective, in seconds."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = ("y", "x"),
              devices=None, *, device="cuda") -> DeviceMesh:
    """A device mesh over every rank of the process group, one named axis
    (and process group) a dimension.  With ``shape=None`` a 2-D mesh takes
    the most-square factorisation of the world size (better
    surface-to-volume for halo traffic), a 1-D one all ranks.
    ``devices`` lays the world's ranks out row-major (default: in order)
    and must name each rank once."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_multihost first")
    dev_type = resolve_device(device).type
    n = dist.get_world_size()
    ranks = list(range(n)) if devices is None else [int(r) for r in devices]
    if sorted(ranks) != list(range(n)):
        raise ValueError(f"devices {ranks} must name each of the {n} ranks once")
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            py = int(np.floor(np.sqrt(n)))
            while n % py:
                py -= 1
            shape = (py, n // py)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh {shape} for axes {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} ranks, have {n}")
    if devices is None:
        return init_device_mesh(dev_type, shape, mesh_dim_names=tuple(axis_names))
    return DeviceMesh(dev_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    """Ranks along the mesh axis ``axis_name``."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def mesh_group(mesh: DeviceMesh, axis_names=None):
    """The process group that reduces over ``axis_names`` (default: every
    axis of the mesh, which spans the world)."""
    names = tuple(mesh.mesh_dim_names if axis_names is None else axis_names)
    if set(names) == set(mesh.mesh_dim_names):
        return dist.group.WORLD
    if len(names) == 1:
        return mesh.get_group(names[0])
    raise ValueError(f"no reduction group over {names} of mesh {mesh.mesh_dim_names}")


def local_block_shape(global_shape: tuple[int, int], mesh: DeviceMesh) -> tuple[int, int]:
    """Per-rank block of a block-partitioned (Ny, Nx) field."""
    shape = tuple(mesh.shape)
    py, px = shape if len(shape) == 2 else (shape[0], 1)
    ny, nx = global_shape
    if ny % py or nx % px:
        raise ValueError(f"grid {global_shape} not divisible by mesh {shape}")
    return ny // py, nx // px
