"""Halo exchange and sharded stencil operators (port of
``iterative_solvers_tpu/dist/halo.py``).

Each rank owns a block of the ``(Ny, Nx)`` grid on a :class:`DeviceMesh`;
stencil application exchanges a fixed-width halo with the mesh neighbours
(``batch_isend_irecv`` with the two ring neighbours of the axis group),
and Krylov inner products are summed over the ranks (``pdot``, the
``group`` of the solvers).  Every function here takes and returns the
rank's local block, the JAX package's ``shard_map`` view.  Decisions that
JAX takes with ``jnp.where(axis_index == ...)`` are branches on the rank's
own mesh coordinate here, so a rank skips the edge strips it does not own
(they hold no collective).

On a CUDA block the local bodies of :func:`sharded_lap_periodic` and
:func:`sharded_sh_operator` launch the periodic stencil kernels of
``ops/periodic_stencil`` on the halo-extended block and keep its core: the
kernels' periodic wrap touches only the ring that is thrown away.  On a CPU
block they compose the plain 5-point core as the JAX package does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.periodic_stencil import lap_periodic_kernel, sh_operator_kernel
from . import comm
from .mesh import mesh_group, rank_device


def _axis(mesh: DeviceMesh, axis_name: str):
    """``(n, idx, group, ranks)`` of this rank along ``axis_name``: the
    axis's size, this rank's coordinate on it, its process group and the
    group's global ranks in coordinate order."""
    dim = mesh.mesh_dim_names.index(axis_name)
    n = mesh.size(dim)
    idx = mesh.get_coordinate()[dim]
    group = mesh.get_group(axis_name)
    return n, idx, group, dist.get_process_group_ranks(group)


def halo_exchange_1d(block, width: int, mesh: DeviceMesh, axis_name: str, *,
                     axis: int = 0, periodic: bool = True):
    """Exchange ``width`` rows (axis=0) or columns (axis=1) with the two
    neighbours along mesh axis ``axis_name``.

    Returns ``(lo_halo, hi_halo)`` — the ghost strips that belong *before*
    and *after* this rank's block.  For non-periodic axes, the global edge
    ranks receive zeros (callers overwrite edge values with one-sided
    formulas anyway).
    """
    n, idx, group, ranks = _axis(mesh, axis_name)
    size = block.shape[axis]
    if n == 1:
        if periodic:
            return block.narrow(axis, size - width, width), block.narrow(axis, 0, width)
        zeros = torch.zeros_like(block.narrow(axis, 0, width))
        return zeros, zeros
    top = block.narrow(axis, size - width, width)
    bot = block.narrow(axis, 0, width)
    # my top strip becomes my +1 neighbour's lo halo; my bottom strip becomes
    # my -1 neighbour's hi halo
    lo, hi = comm.exchange(bot, top, ranks[(idx - 1) % n], ranks[(idx + 1) % n], group)
    if not periodic:
        if idx == 0:
            lo = torch.zeros_like(lo)
        if idx == n - 1:
            hi = torch.zeros_like(hi)
    return lo, hi


def with_halo(block, width: int, mesh: DeviceMesh,
              axis_names: tuple[str, str] = ("y", "x"), periodic: bool = True):
    """Extend a 2-D block with ``width`` ghost cells on all four sides
    (y first, then x over the y-extended block: the corners arrive in two
    hops)."""
    ay, ax = axis_names
    lo_y, hi_y = halo_exchange_1d(block, width, mesh, ay, axis=0, periodic=periodic)
    ext = torch.cat([lo_y, block, hi_y], dim=0)
    lo_x, hi_x = halo_exchange_1d(ext, width, mesh, ax, axis=1, periodic=periodic)
    return torch.cat([lo_x, ext, hi_x], dim=1)


def _lap_core(ext, inv_h2):
    """5-point Laplacian of the core region of a 1-cell-extended block."""
    return (
        ext[:-2, 1:-1] + ext[2:, 1:-1] + ext[1:-1, :-2] + ext[1:-1, 2:]
        - 4.0 * ext[1:-1, 1:-1]
    ) * inv_h2


def sharded_lap_periodic(u, h: float, mesh: DeviceMesh,
                         axis_names: tuple[str, str] = ("y", "x")):
    """Periodic 5-point Laplacian of the rank's block ``u`` (explicit
    width-1 halos)."""
    ext = with_halo(u, 1, mesh, axis_names, periodic=True)
    if ext.device.type == "cuda":
        return lap_periodic_kernel(ext, h)[1:-1, 1:-1]
    return _lap_core(ext, 1.0 / (h * h))


def sharded_sh_operator(u, h: float, r: float, mesh: DeviceMesh,
                        axis_names: tuple[str, str] = ("y", "x")):
    """Swift–Hohenberg L = -Lap^2 - 2 Lap + (r-1) I of the rank's block with
    ONE width-2 halo exchange feeding the fused double Laplacian (vs two
    width-1 exchanges)."""
    ext = with_halo(u, 2, mesh, axis_names, periodic=True)     # one exchange
    if ext.device.type == "cuda":
        return sh_operator_kernel(ext, h, r)[2:-2, 2:-2]
    inv_h2 = 1.0 / (h * h)
    lap1 = _lap_core(ext, inv_h2)                               # core+1 ring
    lap2 = _lap_core(lap1, inv_h2)                              # core
    return -lap2 - 2.0 * lap1[1:-1, 1:-1] + (r - 1.0) * u


def pdot(a, b, mesh: DeviceMesh, axis_names=None):
    """Inner product of two sharded fields from the ranks' blocks, summed
    over ``axis_names`` (default: the whole mesh)."""
    return comm.all_reduce(torch.sum(a * b), mesh_group(mesh, axis_names))


def sharded_y_chain(chain, depth: int, mesh: DeviceMesh, axis_name: str):
    """Lift a global-in-y operator chain onto row-sharded blocks.

    ``chain(*blocks) -> block`` must be the ordinary single-device function
    (same row count in as out) composed of y-direction stencils with
    one-sided edge handling, whose total *influence depth* — the maximum of
    (a) the stencil radius accumulated through the chain and (b) the number
    of output rows any global-edge special formula reaches — is <= ``depth``.

    The lifted function of the rank's blocks:

    1. exchanges a ``depth``-row halo once per input,
    2. evaluates the UNMODIFIED chain on the extended blocks and keeps the
       core rows — interior formulas see real neighbour data; the chain's
       own edge handling lands in the discarded halo rows,
    3. on the global edge ranks only, re-evaluates the chain on a thin
       strip at the true domain edge (where the one-sided formulas are
       *supposed* to fire) and patches the first/last ``depth`` rows.

    Block rows must be >= ``2 * depth + 8`` so the edge strips hold the
    full one-sided influence.
    """

    def lifted(*blocks):
        n, idx, _, _ = _axis(mesh, axis_name)
        if n == 1:
            return chain(*blocks)
        bm = blocks[0].shape[0]
        s = 2 * depth + 8
        if bm < s:
            raise ValueError(
                f"sharded_y_chain: {bm} block rows < {s} needed for "
                f"depth={depth} (use fewer ranks or a bigger grid)")
        exts = []
        for b in blocks:
            lo, hi = halo_exchange_1d(b, depth, mesh, axis_name, axis=0,
                                      periodic=False)
            exts.append(torch.cat([lo, b, hi], dim=0))
        core = chain(*exts)[depth:-depth]
        if idx == 0:
            lo_out = chain(*(e[depth:depth + s] for e in exts))[:depth]
            core = torch.cat([lo_out, core[depth:]], dim=0)
        if idx == n - 1:
            hi_out = chain(*(e[-(depth + s):e.shape[0] - depth] for e in exts))[-depth:]
            core = torch.cat([core[:-depth], hi_out], dim=0)
        return core

    return lifted


def sharded_xy_chain(chain, depth: int, mesh: DeviceMesh,
                     axis_names: tuple[str, str] = ("y", "x")):
    """Lift a global operator chain onto 2-D block-sharded fields.

    Generalises :func:`sharded_y_chain` to a ``(py, px)`` mesh: the same
    contract (``chain`` is the unmodified single-device function whose
    total influence depth in *either* axis is <= ``depth``), the same
    correct-by-construction structure:

    1. ONE halo exchange per input per axis (corners arrive via the two-hop
       y-then-x exchange of :func:`with_halo`, zeros at global edges),
    2. the chain runs verbatim on the extended blocks; the core
       ``[depth:-depth, depth:-depth]`` is kept,
    3. the global-edge regions are re-evaluated on thin strips anchored at
       the true domain edges: the edge strips (one-sided in one axis,
       interior in the other) and the corner blocks (one-sided in both),
       each by the ranks on that edge or corner only.

    Block-size requirement: both block dims >= ``2 * depth + 8``.
    """
    ay, ax = axis_names

    def lifted(*blocks):
        ny_sh, iy, _, _ = _axis(mesh, ay)
        nx_sh, ix, _, _ = _axis(mesh, ax)
        if ny_sh == 1 and nx_sh == 1:
            return chain(*blocks)
        if nx_sh == 1:
            return sharded_y_chain(chain, depth, mesh, ay)(*blocks)
        bm, bn = blocks[0].shape
        s = 2 * depth + 8
        if bm < s or bn < s:
            raise ValueError(
                f"sharded_xy_chain: block {bm}x{bn} < {s} needed for "
                f"depth={depth} (use fewer ranks or a bigger grid)")
        d = depth
        exts = [with_halo(b, d, mesh, axis_names, periodic=False) for b in blocks]

        core = chain(*exts)[d:-d, d:-d].clone()

        # edge strips: one-sided axis anchored at the true edge, the other
        # axis still halo-extended (its one-sided rows/cols land in the
        # discarded margin; edge-rank leftovers are fixed by the corners)
        if iy == 0:
            core[:d, :] = chain(*(e[d:d + s, :] for e in exts))[:d, d:-d]
        if iy == ny_sh - 1:
            core[-d:, :] = chain(*(e[e.shape[0] - d - s:e.shape[0] - d, :]
                                   for e in exts))[-d:, d:-d]
        if ix == 0:
            core[:, :d] = chain(*(e[:, d:d + s] for e in exts))[d:-d, :d]
        if ix == nx_sh - 1:
            core[:, -d:] = chain(*(e[:, e.shape[1] - d - s:e.shape[1] - d]
                                   for e in exts))[d:-d, -d:]

        # corner blocks: one-sided in both axes.  True-domain s x s blocks:
        # lo side = ext[d : d+s], hi side = ext[-d-s : -d]
        lo_sl, hi_sl = slice(d, d + s), slice(-d - s, -d)
        for cy, on_y in ((0, iy == 0), (1, iy == ny_sh - 1)):
            for cx, on_x in ((0, ix == 0), (1, ix == nx_sh - 1)):
                if not (on_y and on_x):
                    continue
                sub = chain(*(e[lo_sl if cy == 0 else hi_sl,
                                lo_sl if cx == 0 else hi_sl] for e in exts))
                core[slice(0, d) if cy == 0 else slice(bm - d, bm),
                     slice(0, d) if cx == 0 else slice(bn - d, bn)] = sub[
                    slice(0, d) if cy == 0 else slice(s - d, s),
                    slice(0, d) if cx == 0 else slice(s - d, s)]
        return core

    return lifted


@dataclasses.dataclass(frozen=True)
class GridSharding:
    """Where a rank's block of a 2-D field lies: the ``mesh``, the
    partition ``spec`` (one mesh axis name, or ``None`` for a replicated
    dimension, per array dimension) and, from them, the rank's global
    slice (:meth:`index`) and device."""

    mesh: DeviceMesh
    spec: tuple

    def _parts(self, dim: int):
        name = self.spec[dim] if dim < len(self.spec) else None
        if name is None:
            return 1, 0
        n, idx, _, _ = _axis(self.mesh, name)
        return n, idx

    def index(self, global_shape) -> tuple[slice, ...]:
        """The rank's block of a field of ``global_shape``."""
        out = []
        for dim, size in enumerate(global_shape):
            n, idx = self._parts(dim)
            if size % n:
                raise ValueError(f"dimension {size} not divisible by {n} ranks")
            b = size // n
            out.append(slice(idx * b, (idx + 1) * b))
        return tuple(out)

    def global_shape(self, block_shape) -> tuple[int, ...]:
        return tuple(b * self._parts(dim)[0] for dim, b in enumerate(block_shape))

    @property
    def device(self) -> torch.device:
        return rank_device(self.mesh.device_type)

    @property
    def spec_str(self) -> str:
        """The spec as the JAX package prints its ``PartitionSpec`` (what
        ``io/checkpoint.save_sharded`` stores and checks)."""
        return "PartitionSpec(" + ", ".join(repr(a) for a in self.spec) + ")"


def grid_sharding(mesh: DeviceMesh, axis_names=("y", "x")) -> GridSharding:
    return GridSharding(mesh, tuple(axis_names))


def shard_field(u, mesh: DeviceMesh, axis_names=("y", "x")):
    """The rank's block of the global ``(Ny, Nx)`` field ``u`` (a tensor or
    an array), on the rank's device."""
    sh = grid_sharding(mesh, axis_names)
    u = torch.as_tensor(u)
    return u[sh.index(u.shape)].to(sh.device).contiguous()


def gather_field(block, mesh: DeviceMesh, axis_names=("y", "x")):
    """The global field from every rank's block (one all-gather over the
    whole mesh), on this rank's device."""
    sh = grid_sharding(mesh, axis_names)
    shape = sh.global_shape(block.shape)
    blocks = comm.all_gather(block, mesh_group(mesh))
    out = torch.empty(shape, dtype=block.dtype, device=block.device)
    coords = np.argwhere(np.ones(tuple(mesh.shape), dtype=bool))
    ranks = mesh.mesh.reshape(-1).tolist()
    for rank, coord in zip(ranks, coords):
        idx = []
        for dim, size in enumerate(shape):
            name = sh.spec[dim] if dim < len(sh.spec) else None
            if name is None:
                idx.append(slice(0, size))
                continue
            n = mesh.size(mesh.mesh_dim_names.index(name))
            c = int(coord[mesh.mesh_dim_names.index(name)])
            idx.append(slice(c * size // n, (c + 1) * size // n))
        out[tuple(idx)] = blocks[rank]
    return out
