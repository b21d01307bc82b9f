"""Byte and operation counts of the hot kernels, and the device's memory
rate and on-chip size (port of ``iterative_solvers_tpu/utils/roofline.py``).

Stencil application and SpMV are bound by device-memory traffic; these
helpers count the bytes each call must move (every input read once, every
output written once) and its operations, and turn a measured time into an
achieved rate.  :func:`roofline_denominator_gbps` is the rate a fraction is
taken of: the larger of the card's spec (:data:`HBM_GBPS`) and its measured
streaming rate (:func:`measured_stream_gbps`); :func:`working_set_exceeds_vmem`
says when a working set is too large to stay in the card's on-chip cache
across a timing chain, the precondition for quoting a fraction of device
memory's rate.  :class:`CommStats` and the halo models count the
distribution layer's traffic.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device

# Device-memory rates in GB/s, keyed by a lower-case part of
# ``torch.cuda.get_device_name`` (spec sheets: H100 SXM 3.35 TB/s, H200
# 4.8 TB/s); "cpu" is the JAX package's figure for its CPU backend.
HBM_GBPS = {"h100 80gb hbm3": 3350.0, "h200": 4800.0, "cpu": 50.0}
# The on-chip level a timing chain can stay resident in: on the JAX
# package's TPUs the VMEM, on these cards the 50 MB L2 cache (a working set
# below it is served from the L2 between back-to-back calls, so its rate
# can exceed device memory's); "cpu" is the JAX package's 16 MiB default.
VMEM_BYTES = {"h100 80gb hbm3": 50_000_000, "h200": 50_000_000, "cpu": 16 * 2**20}


@dataclasses.dataclass(frozen=True)
class KernelCost:
    bytes_moved: int
    flops: int

    def achieved_gbps(self, seconds: float) -> float:
        return self.bytes_moved / seconds / 1e9

    def roofline_fraction(self, seconds: float, hbm_gbps: float) -> float:
        return self.achieved_gbps(seconds) / hbm_gbps

    def bound_ms(self, bytes_per_s: float, flop_per_s: float) -> tuple[float, str]:
        """The least time a device with these rates could take, in ms, and
        which of the two bounds it (``"bytes"`` or ``"operations"``)."""
        bytes_ms = self.bytes_moved / bytes_per_s * 1e3
        ops_ms = self.flops / flop_per_s * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def stencil_cost(shape: tuple[int, int], dtype_bytes: int,
                 points: int = 5) -> KernelCost:
    """One stencil application: read the field once, write once, ~2*points
    flops per node."""
    n = shape[0] * shape[1]
    return KernelCost(bytes_moved=2 * n * dtype_bytes, flops=2 * points * n)


def spmv_cost(nnz: int, n_rows: int, n_cols: int, dtype_bytes: int,
              index_bytes: int = 4, fmt: str = "csr") -> KernelCost:
    """Minimal SpMV byte traffic: values + (indices for csr/coo) + x + y.
    This is the format-ideal lower bound (each value and vector element
    touched once); see :func:`spmv_kernel_cost` for what the diagonal
    kernels must move."""
    value_bytes = nnz * dtype_bytes
    index_traffic = 0 if fmt == "dia" else nnz * index_bytes
    vec_bytes = (n_cols + n_rows) * dtype_bytes
    return KernelCost(bytes_moved=value_bytes + index_traffic + vec_bytes,
                      flops=2 * nnz)


def coefficients_read(terms, ny: int, nx: int, cyclic: bool = False) -> int:
    """How many coefficients one product with a diagonal container needs.

    ``terms`` are a ``GridDIA``'s shifts ``(dy, dx)`` or a ``DIA``'s flat
    offsets (ints, on ``n = ny * nx`` unknowns).  A term whose source lies
    outside the grid (outside ``[0, n)`` for a flat offset) adds nothing,
    whatever is stored there, so only the points with a source inside are
    counted: ``(ny - |dy|)(nx - |dx|)`` per clamped shift, ``n - |off|``
    per flat offset, every point per cyclic shift."""
    n = ny * nx
    total = 0
    for t in terms:
        if isinstance(t, int):
            total += max(n - abs(t), 0)
        elif cyclic:
            total += n
        else:
            total += max(ny - abs(t[0]), 0) * max(nx - abs(t[1]), 0)
    return total


def spmv_kernel_cost(terms, ny: int, nx: int, dtype_bytes: int,
                     nrhs: int = 1, cyclic: bool = False) -> KernelCost:
    """Byte traffic of the diagonal kernels (``ops/spmv.py``) on a
    container with these ``terms`` (see :func:`coefficients_read`): each
    coefficient the product needs is read once (the values a container
    stores where a shift leaves the domain are not needed and not
    counted), each right-hand side is read once and each result written
    once.  For a cyclic container this is ``(nterms + 2 nrhs)`` fields."""
    n = ny * nx
    coeffs = coefficients_read(terms, ny, nx, cyclic)
    return KernelCost(bytes_moved=(coeffs + 2 * nrhs * n) * dtype_bytes,
                      flops=2 * coeffs * nrhs)


def _device_entry(table: dict, what: str, device) -> float:
    """``table``'s entry for ``device``: "cpu" for a CPU device, else the
    first key that is part of the card's lower-case name.  A card absent
    from the table raises (no CPU figure stands in for it)."""
    dev = resolve_device(device)
    kind = "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev).lower()
    for k, v in table.items():
        if k in kind:
            return v
    raise KeyError(f"no {what} for {kind!r}: add the card to utils/roofline.py")


def device_vmem_bytes(device="cuda") -> int:
    """Bytes of the on-chip level a timing chain can stay resident in
    (:data:`VMEM_BYTES`: the L2 cache on a GPU)."""
    return _device_entry(VMEM_BYTES, "on-chip size", device)


def working_set_exceeds_vmem(bytes_total: int, margin: float = 1.5, device="cuda") -> bool:
    """True when a timing chain over this working set must stream from
    device memory (set > margin x the on-chip size) — the precondition for
    quoting a fraction of device memory's rate."""
    return bytes_total > margin * device_vmem_bytes(device)


def device_hbm_gbps(device="cuda") -> float:
    """The card's spec device-memory rate in GB/s (:data:`HBM_GBPS`)."""
    return _device_entry(HBM_GBPS, "memory rate", device)


_HBM_MEASURED: dict = {}


def measured_stream_gbps(n: int = 8192, reps: int = 5, device="cuda") -> float:
    """Measured streaming rate of device memory in GB/s: a chained f32
    triad ``v = v + x`` over two ``(n, n)`` fields (3 n^2 x 4 B a call,
    in place), timed by the marginal-cost method: the median of ``reps``
    runs of a chain of 80 calls less that of a chain of 10, over 70.  On a
    GPU each chain is one CUDA-graph replay, so the host's launch time
    drops out; on the CPU it is a loop.  Cached per process on
    ``(n, reps, device)``.  The spec figure is not always the card's
    ceiling either way, so roofline denominators use ``max(spec,
    measured)`` (:func:`roofline_denominator_gbps`)."""
    dev = resolve_device(device)
    key = (n, reps, str(dev))
    if key in _HBM_MEASURED:
        return _HBM_MEASURED[key]
    x = torch.full((n, n), 1e-9, dtype=torch.float32, device=dev)
    v = torch.zeros((n, n), dtype=torch.float32, device=dev)

    def chain(k):
        if dev.type == "cpu":
            return lambda: [v.add_(x) for _ in range(k)]
        v.add_(x)  # warm-up before capture
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(k):
                v.add_(x)
        return graph.replay

    def run(k):
        fn = chain(k)
        fn()
        ts = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    t = (run(80) - run(10)) / 70.0
    _HBM_MEASURED[key] = 3 * n * n * 4 / t / 1e9
    return _HBM_MEASURED[key]


def roofline_denominator_gbps(device="cuda") -> float:
    """The roofline denominator: max(spec, measured stream) — a fraction of
    this can never exceed 1.0 for a kernel that streams from device
    memory."""
    return max(device_hbm_gbps(device), measured_stream_gbps(device=device))


# -- communication accounting --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommStats:
    """Collective traffic of a run, counted by the distribution layer's
    collectives (``dist/comm.py``).

    Byte counts are PER RANK: what each rank receives for its halo strips,
    and the gathered result of its all-gathers.  The JAX package reads the
    same fields from the compiled program's text
    (``comm_stats_from_compiled``), which has no counterpart here."""

    collective_permute_count: int
    all_reduce_count: int
    all_gather_count: int
    reduce_scatter_count: int
    permute_bytes: int        # sum of the halo strips received
    all_gather_bytes: int

    @property
    def total_comm_bytes(self) -> int:
        return self.permute_bytes + self.all_gather_bytes


def comm_stats(counts=None) -> CommStats:
    """A :class:`CommStats` from the counters of ``dist/comm.py`` (default:
    its module counters ``COUNTS``) since their last reset."""
    from ..dist import comm

    c = comm.COUNTS if counts is None else counts
    return CommStats(collective_permute_count=c.permutes,
                     all_reduce_count=c.all_reduces,
                     all_gather_count=c.all_gathers, reduce_scatter_count=0,
                     permute_bytes=c.permute_bytes,
                     all_gather_bytes=c.all_gather_bytes)


def halo_step_model(ny: int, nx: int, n_devices: int, halo_rows: int,
                    exchanges_per_step: int, dtype_bytes: int,
                    compute_passes: int, hbm_gbps: float,
                    link_gbps: float) -> dict:
    """Analytic comm/compute model of a row-sharded stencil step.

    Per device and step: compute touches ``compute_passes`` full passes over
    its ``(ny/n_devices, nx)`` block; communication moves ``halo_rows x nx``
    strips to each of two neighbours, ``exchanges_per_step`` times.  Returns
    bytes, the comm/compute ratio, and the projected weak-scaling
    efficiency  eff = t_compute / (t_compute + t_comm).  ``hbm_gbps`` and
    ``link_gbps`` are the memory and neighbour-link rates (GB/s) of the
    card the caller models: no table of them is kept here."""
    block_rows = ny // n_devices
    compute_bytes = compute_passes * 2 * block_rows * nx * dtype_bytes
    comm_bytes = exchanges_per_step * 2 * halo_rows * nx * dtype_bytes
    t_compute = compute_bytes / (hbm_gbps * 1e9)
    t_comm = comm_bytes / (link_gbps * 1e9)
    return {
        "block_rows": block_rows,
        "compute_bytes": compute_bytes,
        "comm_bytes": comm_bytes,
        "comm_compute_ratio": comm_bytes * hbm_gbps / (compute_bytes * link_gbps),
        "weak_scaling_efficiency": t_compute / (t_compute + t_comm),
    }


def halo_step_model_2d(ny: int, nx: int, py: int, px: int, halo: int,
                       exchanges_per_step: int, dtype_bytes: int,
                       compute_passes: int, hbm_gbps: float,
                       link_gbps: float) -> dict:
    """Analytic comm/compute model of a 2-D block-sharded stencil step
    (``dist.halo.sharded_xy_chain``): per device each exchange moves
    ``halo``-deep strips along the block perimeter (2 row strips + 2 column
    strips + 4 corners via the two-hop y-then-x scheme, so the column strips
    are halo-extended: bm + 2*halo rows).  Rates as in
    :func:`halo_step_model`."""
    bm, bn = ny // py, nx // px
    compute_bytes = compute_passes * 2 * bm * bn * dtype_bytes
    per_exchange = (2 * halo * bn + 2 * halo * (bm + 2 * halo)) * dtype_bytes
    comm_bytes = exchanges_per_step * per_exchange
    t_compute = compute_bytes / (hbm_gbps * 1e9)
    t_comm = comm_bytes / (link_gbps * 1e9)
    return {
        "block": (bm, bn),
        "compute_bytes": compute_bytes,
        "comm_bytes": comm_bytes,
        "comm_compute_ratio": comm_bytes * hbm_gbps / (compute_bytes * link_gbps),
        "weak_scaling_efficiency": t_compute / (t_compute + t_comm),
    }
