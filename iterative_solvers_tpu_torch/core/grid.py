"""Structured-grid descriptor (port of ``iterative_solvers_tpu/core/grid.py``).

Convention: row index ``i`` runs along ``eta``/``y`` (``ny`` rows), column
index ``j`` along ``ksi``/``x`` (``nx`` columns); fields are ``(ny, nx)``.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property, lru_cache

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """A static 2-D tensor-product grid on ``[xl, xr] x [yb, yt]``."""

    nx: int
    ny: int
    xl: float = 0.0
    xr: float = 1.0
    yb: float = 0.0
    yt: float = 1.0

    @property
    def lx(self) -> float:
        return self.xr - self.xl

    @property
    def ly(self) -> float:
        return self.yt - self.yb

    @property
    def dx(self) -> float:
        return self.lx / (self.nx - 1)

    @property
    def dy(self) -> float:
        return self.ly / (self.ny - 1)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def n(self) -> int:
        return self.nx * self.ny

    @cached_property
    def x(self) -> np.ndarray:
        return np.linspace(self.xl, self.xr, self.nx)

    @cached_property
    def y(self) -> np.ndarray:
        return np.linspace(self.yb, self.yt, self.ny)

    @cached_property
    def xx(self) -> np.ndarray:
        """x coordinate at every node, shape (ny, nx), f64 numpy."""
        return np.broadcast_to(self.x[None, :], self.shape).copy()

    @cached_property
    def yy(self) -> np.ndarray:
        """y coordinate at every node, shape (ny, nx), f64 numpy."""
        return np.broadcast_to(self.y[:, None], self.shape).copy()

    def xx_op(self, dtype=torch.float64, device="cuda") -> torch.Tensor:
        """``(ny, nx)`` x-coordinate field on ``device``: a broadcast view
        of the f64 linspace row cast to ``dtype``.  Raises without a GPU
        unless the caller passes ``device="cpu"``."""
        row = _axis(self, "x", dtype, resolve_device(device))
        return row[None, :].expand(self.shape)

    def yy_op(self, dtype=torch.float64, device="cuda") -> torch.Tensor:
        """``(ny, nx)`` y-coordinate field on ``device`` (see :meth:`xx_op`)."""
        col = _axis(self, "y", dtype, resolve_device(device))
        return col[:, None].expand(self.shape)

    # -- boundary masks (static numpy bool arrays) ------------------------
    @cached_property
    def mask_left(self) -> np.ndarray:
        m = np.zeros(self.shape, dtype=bool)
        m[:, 0] = True
        return m

    @cached_property
    def mask_right(self) -> np.ndarray:
        m = np.zeros(self.shape, dtype=bool)
        m[:, -1] = True
        return m

    @cached_property
    def mask_bottom(self) -> np.ndarray:
        m = np.zeros(self.shape, dtype=bool)
        m[0, :] = True
        return m

    @cached_property
    def mask_top(self) -> np.ndarray:
        m = np.zeros(self.shape, dtype=bool)
        m[-1, :] = True
        return m

    @cached_property
    def mask_boundary(self) -> np.ndarray:
        return self.mask_left | self.mask_right | self.mask_top | self.mask_bottom

    @cached_property
    def mask_interior(self) -> np.ndarray:
        return ~self.mask_boundary


@lru_cache(maxsize=64)
def _axis(grid: Grid2D, name: str, dtype: torch.dtype, device: torch.device):
    """A grid's coordinate vector on ``device``, copied there once."""
    return torch.as_tensor(getattr(grid, name), device=device).to(dtype)


def square(n: int, lo: float = -1.0, hi: float = 1.0) -> Grid2D:
    """Square ``n x n`` grid on ``[lo, hi]^2`` (the reference's PMA
    workloads use ``[-1, 1]^2``, n = 51)."""
    return Grid2D(nx=n, ny=n, xl=lo, xr=hi, yb=lo, yt=hi)
