"""Structured-grid descriptor (port of ``iterative_solvers_tpu/core/grid.py``).

Convention: row index ``i`` runs along ``eta``/``y`` (``ny`` rows), column
index ``j`` along ``ksi``/``x`` (``nx`` columns); fields are ``(ny, nx)``.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property, lru_cache

import numpy as np
import torch


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
    def dx(self) -> float:
        return (self.xr - self.xl) / (self.nx - 1)

    @property
    def dy(self) -> float:
        return (self.yt - self.yb) / (self.ny - 1)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

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

    def xx_op(self, dtype=torch.float64, device="cpu") -> torch.Tensor:
        """``(ny, nx)`` x-coordinate field on ``device``: a broadcast view
        of the f64 linspace row cast to ``dtype``."""
        row = _axis(self, "x", dtype, torch.device(device))
        return row[None, :].expand(self.shape)

    def yy_op(self, dtype=torch.float64, device="cpu") -> torch.Tensor:
        """``(ny, nx)`` y-coordinate field on ``device``."""
        col = _axis(self, "y", dtype, torch.device(device))
        return col[:, None].expand(self.shape)


@lru_cache(maxsize=64)
def _axis(grid: Grid2D, name: str, dtype: torch.dtype, device: torch.device):
    """A grid's coordinate vector on ``device``, copied there once."""
    return torch.as_tensor(getattr(grid, name), device=device).to(dtype)
