"""The distribution layer's collectives, each counted.

Every halo exchange, all-reduce and all-gather of the port goes through
these functions, which count calls and bytes on :data:`COUNTS` (the
counterpart of the collectives the JAX package reads from the compiled
program, ``utils/roofline.comm_stats_from_compiled``; here
``utils/roofline.comm_stats`` reads the counters).  Byte counts are per
rank: what this rank receives from a neighbour for a halo strip, the
reduced buffer of an all-reduce, the gathered result of an all-gather.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class CommCounts:
    permutes: int = 0           # halo strips received (two per exchange)
    permute_bytes: int = 0
    all_reduces: int = 0
    all_reduce_bytes: int = 0
    all_gathers: int = 0
    all_gather_bytes: int = 0


COUNTS = CommCounts()


def reset_counts() -> None:
    """Set every counter to 0."""
    for f in dataclasses.fields(CommCounts):
        setattr(COUNTS, f.name, 0)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t, group, op: str = "sum"):
    """``t`` reduced over ``group`` (``"sum"`` or ``"max"``), as a new
    tensor; every rank gets the same value."""
    out = t.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    COUNTS.all_reduces += 1
    COUNTS.all_reduce_bytes += out.numel() * out.element_size()
    return out


def reduce_sum(t, group):
    """``t`` summed over ``group``, or ``t`` itself for ``group=None`` (the
    single-device path, unchanged)."""
    return t if group is None else all_reduce(t, group)


def all_gather(t, group) -> list:
    """Every rank's ``t`` (same shape on all ranks), in the group's rank
    order."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, t, group=group)
    COUNTS.all_gathers += 1
    COUNTS.all_gather_bytes += len(outs) * t.numel() * t.element_size()
    return outs


def exchange(to_lo, to_hi, peer_lo: int, peer_hi: int, group):
    """Send ``to_hi`` to the rank ``peer_hi`` and ``to_lo`` to ``peer_lo``
    (global ranks); return ``(from_lo, from_hi)``: ``peer_lo``'s
    ``to_hi`` and ``peer_hi``'s ``to_lo``.  The tags keep the two
    directions apart where both neighbours are one rank (a ring of two)."""
    to_lo, to_hi = to_lo.contiguous(), to_hi.contiguous()
    from_lo, from_hi = torch.empty_like(to_hi), torch.empty_like(to_lo)
    ops = [dist.P2POp(dist.isend, to_hi, peer_hi, group, tag=0),
           dist.P2POp(dist.irecv, from_lo, peer_lo, group, tag=0),
           dist.P2POp(dist.isend, to_lo, peer_lo, group, tag=1),
           dist.P2POp(dist.irecv, from_hi, peer_hi, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COUNTS.permutes += 2
    COUNTS.permute_bytes += (from_lo.numel() + from_hi.numel()) * from_lo.element_size()
    return from_lo, from_hi
