"""The yardstick's fixed numbers: the card's published peak and the bytes a
kernel call needs.

The roofline denominator is the spec and never a rate measured in the same
run, so that a share compares across runs and commits."""
from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3) data sheet: 3.35 TB/s of device memory
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# droplet_jvp: v and the 8 coefficient fields of the stack read once, the
# output written once, float32 (the smoke script's JVP_FIELDS_MOVED)
JVP_FIELDS_MOVED = 10
JVP_ITEMSIZE = 4


def hbm_bytes_per_s(device_kind: str) -> float:
    """The published device-memory rate of ``device_kind``; raises for a
    card the table does not hold."""
    try:
        return HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(f"no published memory rate for {device_kind!r}") from None


def droplet_jvp_bytes(points: int) -> int:
    """Bytes one ``droplet_jvp`` call needs on a grid of ``points`` nodes."""
    return JVP_FIELDS_MOVED * JVP_ITEMSIZE * points


def grid_dia_matvec_bytes(grid, shifts, itemsize: int) -> int:
    """Bytes one ``grid_dia_matvec`` call needs on a clamped (non-cyclic)
    ``GridDIA`` over ``grid`` = ``(ny, nx)``: of each stored coefficient
    field the points whose source ``(r + dy, c + dx)`` lies in the grid
    (a coefficient whose source lies outside adds nothing), x read once
    and y written once."""
    ny, nx = grid
    needed = sum(max(ny - abs(dy), 0) * max(nx - abs(dx), 0) for dy, dx in shifts)
    return itemsize * (needed + 2 * ny * nx)
