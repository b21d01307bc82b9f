"""Byte and operation counts of the hot kernels
(port of the cost models of ``iterative_solvers_tpu/utils/roofline.py``).

Stencil application and SpMV are bound by device-memory traffic; these
helpers count the bytes each call must move (every input read once, every
output written once) and its operations, and turn a measured time into an
achieved rate.  :class:`CommStats` and the halo models count the
distribution layer's traffic.  They hold no hardware table: the caller
divides by the rate of the card it measured on.
"""
from __future__ import annotations

import dataclasses


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
