"""Sparse-matrix containers with their SpMV and SpMM, and the host-side
assembly of the structured-grid operators
(port of ``iterative_solvers_tpu/ops/sparse.py``).

- :class:`DIA` (diagonal/banded): one row-aligned value vector per flat
  diagonal.  SpMV is a sum of shifted multiplies with no index traffic.
- :class:`CSR`, :class:`COO`: general sparsity.  SpMV gathers
  ``x[indices]`` and sums per row with ``index_add_``.
- :class:`BSR` (block CSR): dense ``(bs, bs)`` blocks, batched small
  products at full f32.
- :class:`GridDIA`: a diagonal matrix over a structured ``(ny, nx)`` grid,
  one 2-D coefficient field per stencil shift, clamped or cyclic.

Assembly runs on the host with numpy/scipy (the structure is static); the
containers hold tensors on one device and their methods are plain PyTorch.
``DIA.matvec`` and ``GridDIA._apply`` are also the plain versions that the
CUDA kernels of ``ops/spmv.py`` are held against.

Summation order.  On a CUDA device ``index_add_`` sums with atomics in no
fixed order, so CSR/COO/BSR results vary at rounding level from run to
run: compare them at 1e-12 (f64) or 1e-5 (f32) of the result's scale,
never bit for bit.  DIA and GridDIA sum their terms in a fixed order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

_NEAR = 8  # shifts up to this size read slices of one padded copy of x


def _segment_sum(prod, rows, num_segments: int):
    """Sum the rows of ``prod`` into ``num_segments`` bins by ``rows``."""
    out = torch.zeros((num_segments,) + tuple(prod.shape[1:]), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, rows, prod)


def _index(a, dev):
    """A scipy index array as an int64 tensor on ``dev``."""
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)


def _row_aligned_diagonals(md, n: int) -> np.ndarray:
    """The diagonals of a scipy DIA matrix as ``(ndiags, n)`` rows with
    ``out[k][i] = A[i, i + off_k]``.  scipy aligns ``data[k][j] = A[j - off,
    j]`` and stores only as many columns as the last occupied one."""
    cols = np.zeros((len(md.offsets), n), dtype=md.data.dtype)
    cols[:, : md.data.shape[1]] = md.data[:, :n]
    out = np.zeros_like(cols)
    for k, off in enumerate(md.offsets):
        off = int(off)
        if off >= 0:
            out[k, : n - off] = cols[k, off:]
        else:
            out[k, -off:] = cols[k, : n + off]
    return out


# -- DIA (diagonal/banded) ---------------------------------------------------

class DIA(NamedTuple):
    """Diagonal-format sparse matrix: ``data[k]`` holds the k-th diagonal
    (offset ``offsets[k]``), aligned so that ``A[i, i + off] = data[k][i]``.

    ``offsets`` is a static tuple; ``n`` the (square) dimension.
    """

    data: torch.Tensor       # (ndiags, n)
    offsets: tuple[int, ...]
    n: int

    def _terms(self, xf):
        """Per-diagonal products as full-length vectors (zero where the
        diagonal leaves ``[0, n)``), in the order of ``offsets``."""
        for k, off in enumerate(self.offsets):
            d = self.data[k]
            if off >= 0:
                yield F.pad(d[: self.n - off] * xf[..., off:], (0, off))
            else:
                yield F.pad(d[-off:] * xf[..., : self.n + off], (-off, 0))

    def matvec(self, x):
        """y[i] = sum_k data[k][i] * x[i + off_k] (zero outside [0, n))."""
        y = sum(self._terms(x.reshape(-1)), torch.zeros_like(x).reshape(-1))
        return y.reshape(x.shape)

    def matmat(self, X):
        """SpMM: ``(n, nrhs)`` dense right-hand side."""
        return sum(self._terms(X.T), torch.zeros_like(X.T)).T

    @staticmethod
    def from_scipy(m, device="cuda") -> "DIA":
        dev = resolve_device(device)
        md = m.todia()
        n = md.shape[0]
        data = _row_aligned_diagonals(md, n)
        return DIA(data=torch.as_tensor(data, device=dev),
                   offsets=tuple(int(o) for o in md.offsets), n=n)


# -- CSR ---------------------------------------------------------------------

class CSR(NamedTuple):
    data: torch.Tensor       # (nnz,)
    indices: torch.Tensor    # (nnz,) column index per entry, int64
    rows: torch.Tensor       # (nnz,) row index per entry (expanded indptr)
    shape: tuple[int, int]

    def matvec(self, x):
        xf = x.reshape(-1)
        y = _segment_sum(self.data * xf[self.indices], self.rows, self.shape[0])
        return y.reshape(x.shape if self.shape[0] == xf.numel() else (self.shape[0],))

    def matmat(self, X):
        """SpMM: gather rhs rows per nonzero, scale, sum per row."""
        return _segment_sum(self.data[:, None] * X[self.indices, :], self.rows,
                            self.shape[0])

    @staticmethod
    def from_scipy(m, device="cuda") -> "CSR":
        dev = resolve_device(device)
        mc = m.tocsr()
        rows = np.repeat(np.arange(mc.shape[0]), np.diff(mc.indptr))
        return CSR(data=torch.as_tensor(mc.data, device=dev),
                   indices=_index(mc.indices, dev), rows=_index(rows, dev),
                   shape=tuple(mc.shape))

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


class COO(NamedTuple):
    data: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    shape: tuple[int, int]

    def matvec(self, x):
        xf = x.reshape(-1)
        return _segment_sum(self.data * xf[self.col], self.row, self.shape[0])

    def to_csr(self) -> CSR:
        order = torch.argsort(self.row, stable=True)
        return CSR(data=self.data[order], indices=self.col[order],
                   rows=self.row[order], shape=self.shape)

    @staticmethod
    def from_scipy(m, device="cuda") -> "COO":
        dev = resolve_device(device)
        mc = m.tocoo()
        return COO(data=torch.as_tensor(mc.data, device=dev),
                   row=_index(mc.row, dev), col=_index(mc.col, dev),
                   shape=tuple(mc.shape))


# -- BSR (block CSR) ---------------------------------------------------------

class BSR(NamedTuple):
    data: torch.Tensor       # (nblocks, bs, bs)
    indices: torch.Tensor    # (nblocks,) block-column per block
    rows: torch.Tensor       # (nblocks,) block-row per block
    shape: tuple[int, int]
    blocksize: int

    def matvec(self, x):
        bs = self.blocksize
        gathered = x.reshape(-1, bs)[self.indices]       # (nblocks, bs)
        prod = torch.einsum("nij,nj->ni", self.data, gathered)
        y = _segment_sum(prod, self.rows, self.shape[0] // bs)
        return y.reshape(x.shape if self.shape[0] == x.numel() else (self.shape[0],))

    def matmat(self, X):
        """SpMM: per-block (bs, bs) x (bs, nrhs) batched products."""
        bs = self.blocksize
        gathered = X.reshape(-1, bs, X.shape[-1])[self.indices]  # (nblocks, bs, nrhs)
        prod = torch.einsum("nij,njk->nik", self.data, gathered)
        y = _segment_sum(prod, self.rows, self.shape[0] // bs)
        return y.reshape(self.shape[0], X.shape[-1])

    @staticmethod
    def from_scipy(m, blocksize: int, device="cuda") -> "BSR":
        dev = resolve_device(device)
        mb = m.tobsr(blocksize=(blocksize, blocksize))
        rows = np.repeat(np.arange(mb.shape[0] // blocksize), np.diff(mb.indptr))
        return BSR(data=torch.as_tensor(mb.data, device=dev),
                   indices=_index(mb.indices, dev), rows=_index(rows, dev),
                   shape=tuple(mb.shape), blocksize=blocksize)


# -- structured-grid DIA (2-D shift form) -------------------------------------

def term_order(shifts, cyclic: bool):
    """``(k, dy, dx)`` per term of a :class:`GridDIA` in the order
    ``_apply`` sums them, as two lists: the near terms (the stencil body),
    then the far ones."""
    def is_near(term):
        _, dy, dx = term
        return abs(dx) <= _NEAR and (not cyclic or abs(dy) <= _NEAR)

    terms = [(k, dy, dx) for k, (dy, dx) in enumerate(shifts)]
    return ([t for t in terms if is_near(t)],
            [t for t in terms if not is_near(t)])


class GridDIA(NamedTuple):
    """Diagonal sparse matrix over a structured ``(ny, nx)`` grid, stored as
    2-D coefficient *fields* per stencil offset: ``y[r, c] = sum_k
    data[k][r, c] * x[r + dy_k, c + dx_k]`` (zero outside the grid).

    Any flat DIA matrix maps onto it exactly: a flat offset
    ``off = dy*nx + dx`` whose column index wraps at a row boundary splits
    into two 2-D shift terms with complementary masks (see
    :meth:`from_scipy`), so periodic wrap diagonals are representable too.

    With ``cyclic=True`` the shifts are interpreted modulo the grid
    (``x[(r + dy) % ny, (c + dx) % nx]``) and :meth:`from_scipy` merges every
    entry onto its minimal-residue shift — exact for *any* matrix, and for
    periodic stencil operators it collapses the wrap-residue fields: the
    13-point SH operator stores 13 fields instead of ~21.
    """

    data: torch.Tensor                   # (nterms, ny, nx)
    shifts: tuple[tuple[int, int], ...]  # (dy, dx) per term
    grid: tuple[int, int]                # (ny, nx)
    cyclic: bool = False                 # shifts wrap modulo the grid

    def _apply(self, x2):
        """Shift-multiply sum on a ``(..., ny, nx)`` field.

        Near shifts read same-shape slices of one padded copy of ``x``
        (wrapped when cyclic, zero otherwise).  Far shifts (the flat-
        diagonal wrap residues, ``|dx| ~ nx``) touch only a narrow band:
        cyclic ones roll ``x``, clamped ones are evaluated on the band.
        """
        ny, nx = self.grid
        near, far = term_order(self.shifts, self.cyclic)
        my = max([abs(dy) for _, dy, _ in near], default=0)
        mx = max([abs(dx) for _, _, dx in near], default=0)
        if self.cyclic and (my or mx):
            # circular padding wants a 4-D tensor for the last two axes
            xp = F.pad(x2.reshape(1, -1, ny, nx), (mx, mx, my, my), mode="circular")
            xp = xp.reshape(x2.shape[:-2] + xp.shape[-2:])
        else:
            xp = F.pad(x2, (mx, mx, my, my))
        out = torch.zeros_like(x2)
        for k, dy, dx in near:
            out = out + self.data[k] * xp[..., my + dy:my + dy + ny,
                                          mx + dx:mx + dx + nx]
        for k, dy, dx in far:
            if self.cyclic:
                out = out + self.data[k] * torch.roll(x2, (-dy, -dx), dims=(-2, -1))
                continue
            # columns with 0 <= c + dx < nx form one contiguous band
            xlo, xhi = max(0, -dx), min(nx, nx - dx)
            ylo, yhi = max(0, -dy), min(ny, ny - dy)
            if ylo >= yhi or xlo >= xhi:
                continue
            band = (self.data[k][ylo:yhi, xlo:xhi]
                    * x2[..., ylo + dy:yhi + dy, xlo + dx:xhi + dx])
            out[..., ylo:yhi, xlo:xhi] += band
        return out

    def matvec(self, x):
        return self._apply(x.reshape(self.grid)).reshape(x.shape)

    def matmat(self, X):
        """SpMM on an ``(n, nrhs)`` dense block."""
        ny, nx = self.grid
        Xg = X.T.reshape(X.shape[-1], ny, nx)
        return self._apply(Xg).reshape(X.shape[-1], ny * nx).T

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.data))

    @staticmethod
    def from_scipy(m, grid: tuple[int, int], cyclic: bool = False,
                   device="cuda") -> "GridDIA":
        """Build from any scipy sparse matrix whose row/col spaces are the
        flattened ``(ny, nx)`` grid.  Each flat diagonal ``off`` becomes the
        2-D shift ``(dy, dx)`` with ``dx`` the minimal-magnitude residue of
        ``off mod nx`` — plus, where the column index would wrap past a row
        edge, the complementary shift ``(dy +- 1, dx -+ nx)``; entries land
        in whichever term keeps ``0 <= c + dx < nx``.

        With ``cyclic=True``, every entry ``(i, j)`` instead lands on the
        minimal residue of ``(row_j - row_i, col_j - col_i)`` modulo the
        grid — exact for any matrix, and the minimal-field layout for
        periodic operators (wrap diagonals merge onto the interior shift)."""
        dev = resolve_device(device)
        ny, nx = grid
        n = ny * nx
        if tuple(m.shape) != (n, n):
            raise ValueError(f"a {m.shape} matrix does not act on a {ny} x {nx} grid")
        if cyclic:
            coo = m.tocoo()
            ri, ci = np.divmod(coo.row.astype(np.int64), nx)
            rj, cj = np.divmod(coo.col.astype(np.int64), nx)
            dy = (rj - ri) % ny
            dy = np.where(dy > ny // 2, dy - ny, dy)
            dx = (cj - ci) % nx
            dx = np.where(dx > nx // 2, dx - nx, dx)
            # unique integer code per shift, ordered like sorted (dy, dx)
            k = np.int64(2 * nx + 2)
            uniq, inv = np.unique(dy * k + dx, return_inverse=True)
            # entries sharing (shift, row, col) add up, in f64 and in the
            # order the matrix lists them (bincount: one pass, where
            # np.add.at takes minutes at 2048^2)
            flat = (inv.reshape(-1) * ny + ri) * nx + ci
            data = np.bincount(flat, weights=coo.data, minlength=len(uniq) * n)
            data = data.astype(coo.data.dtype).reshape(len(uniq), ny, nx)
            shifts = tuple((int((c + nx) // k), int((c + nx) % k - nx))
                           for c in uniq)
            return GridDIA(data=torch.as_tensor(data, device=dev), shifts=shifts,
                           grid=(ny, nx), cyclic=True)
        md = m.todia()
        fields: dict[tuple[int, int], np.ndarray] = {}
        cols = np.arange(nx)
        diags = _row_aligned_diagonals(md, n)
        for k, off in enumerate(md.offsets):
            off = int(off)
            diag2 = diags[k].reshape(ny, nx)
            dy0, dx0 = divmod(off, nx)
            if dx0 > nx // 2:
                dy0, dx0 = dy0 + 1, dx0 - nx
            in_row = (cols + dx0 >= 0) & (cols + dx0 < nx)
            # column underflow wraps to the previous row, overflow to the next
            wrap = ((dy0 - 1, dx0 + nx) if dx0 < 0 else (dy0 + 1, dx0 - nx))
            for (dy, dx), mask in (((dy0, dx0), in_row), (wrap, ~in_row)):
                vals = diag2 * mask[None, :]
                if not np.any(vals):
                    continue
                f = fields.setdefault((dy, dx),
                                      np.zeros((ny, nx), dtype=md.data.dtype))
                f += vals
        shifts = tuple(sorted(fields))
        if not shifts:  # empty matrix
            return GridDIA(data=torch.zeros((0, ny, nx), device=dev,
                                            dtype=torch.as_tensor(md.data).dtype),
                           shifts=(), grid=(ny, nx))
        data = np.stack([fields[s] for s in shifts])
        return GridDIA(data=torch.as_tensor(data, device=dev), shifts=shifts,
                       grid=(ny, nx))


# -- assembly helpers --------------------------------------------------------

def laplacian_5pt_periodic(n: int, h: float):
    """scipy CSR of the periodic 5-point Laplacian on an n x n grid."""
    import scipy.sparse as sp

    e = 1.0 / (h * h)
    idx = np.arange(n * n).reshape(n, n)
    rows, cols, vals = [], [], []
    for shift in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nb = np.roll(idx, shift, axis=(0, 1))
        rows.append(idx.reshape(-1))
        cols.append(nb.reshape(-1))
        vals.append(np.full(n * n, e))
    rows.append(idx.reshape(-1))
    cols.append(idx.reshape(-1))
    vals.append(np.full(n * n, -4 * e))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n * n, n * n),
    )


def sh_operator(n: int, h: float, r: float):
    """scipy CSR of L = -Lap^2 - 2 Lap + (r-1) I (periodic)."""
    import scipy.sparse as sp

    lap = laplacian_5pt_periodic(n, h)
    return (-(lap @ lap) - 2.0 * lap + (r - 1.0) * sp.identity(n * n)).tocsr()


def biharmonic_dirichlet(n: int, h: float):
    """scipy CSR of the 13-point Dirichlet bilaplacian ``Lap_5pt @ Lap_5pt``."""
    lap = laplacian_5pt_dirichlet(n, h)
    return (lap @ lap).tocsr()


def laplacian_5pt_dirichlet(n: int, h: float):
    """scipy CSR of the interior-node homogeneous-Dirichlet Laplacian
    ((n-1)^2 unknowns for n intervals per direction)."""
    import scipy.sparse as sp

    m = n - 1
    main = np.full(m * m, -4.0)
    off = np.ones(m * m - 1)
    off[m - 1 :: m] = 0
    far = np.ones(m * (m - 1))
    return (
        sp.diags([main, off, off, far, far], [0, 1, -1, m, -m], format="csr")
        / (h * h)
    )
