"""Sparse matrix containers (mirrors :mod:`repro.sparse.formats`).

Frozen dataclasses of torch tensors.  Builders are host-side numpy code, as
in the reference — format construction is data-pipeline work — and put
their result on the device their input lives on (``device=`` for numpy
input, CPU by default).

Formats
-------
COO        (row, col, val)            — construction + index-add SpMV.
CSR        (indptr, indices, data)    — compact storage; the per-nnz row
                                        array is kept alongside.
BlockELL   rows grouped in blocks of ``block_rows``; every row padded to a
           global width — the layout of the ``ell_spmm`` kernel.
           Out-of-width overflow entries spill to a COO tail (HYB layout).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix.

    ``sorted_rows`` is a structural tag: True iff ``row`` is non-decreasing.
    Producers that emit unsorted coordinates (e.g.
    :func:`repro_torch.sparse.ops.symmetrize_coo`) construct with
    ``sorted_rows=False``, and :func:`~repro_torch.sparse.ops.sort_coo_rows`
    restores the layout.
    """

    row: torch.Tensor  # [nnz] int64
    col: torch.Tensor  # [nnz] int64
    val: torch.Tensor  # [nnz] float
    shape: Tuple[int, int]
    sorted_rows: bool = True

    @property
    def nnz(self) -> int:
        return self.row.shape[0]

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    def to(self, device) -> "COO":
        return COO(self.row.to(device), self.col.to(device),
                   self.val.to(device), self.shape, self.sorted_rows)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row, with the expanded per-nnz ``row`` kept for
    O(1) conversion back to the COO path."""

    indptr: torch.Tensor  # [n_rows+1] int64
    indices: torch.Tensor  # [nnz] int64
    data: torch.Tensor  # [nnz] float
    row: torch.Tensor  # [nnz] int64
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass(frozen=True)
class BlockELL:
    """Blocked-ELL + COO-tail hybrid.

    cols : [n_blocks, block_rows, width] int32
    vals : [n_blocks, block_rows, width] float
    tail : COO with the overflow entries (a one-entry zero dummy when empty)

    Padding slots have ``col = 0`` and ``val = 0``.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    tail: COO
    shape: Tuple[int, int]
    block_rows: int
    width: int

    @property
    def n_blocks(self) -> int:
        return self.cols.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "BlockELL":
        return BlockELL(self.cols.to(device), self.vals.to(device),
                        self.tail.to(device), self.shape, self.block_rows,
                        self.width)


# ---------------------------------------------------------------------------
# Host-side builders (numpy, as in the reference)
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def coo_from_edges(
    row,
    col,
    val,
    shape: Tuple[int, int],
    *,
    sort: bool = True,
    sum_duplicates: bool = False,
    dtype=torch.float32,
    device=None,
) -> COO:
    """Build a COO matrix from edge arrays, optionally row-major sorted.

    ``device=None`` places the result where ``val`` lives if it is a
    tensor, else on the CPU.
    """
    if device is None:
        device = val.device if isinstance(val, torch.Tensor) else "cpu"
    row = _host(row).astype(np.int32)
    col = _host(col).astype(np.int32)
    val = _host(val)
    if sort:
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
    if sum_duplicates and row.size:
        key = row.astype(np.int64) * shape[1] + col
        uniq, inv = np.unique(key, return_inverse=True)
        val = np.bincount(inv, weights=val.astype(np.float64), minlength=uniq.size)
        row = (uniq // shape[1]).astype(np.int32)
        col = (uniq % shape[1]).astype(np.int32)
    sorted_rows = bool(sort or sum_duplicates or row.size == 0 or (np.diff(row) >= 0).all())
    return COO(torch.as_tensor(row.astype(np.int64), device=device),
               torch.as_tensor(col.astype(np.int64), device=device),
               torch.as_tensor(np.asarray(val), device=device).to(dtype),
               tuple(shape), sorted_rows=sorted_rows)


def coo_to_csr(m: COO) -> CSR:
    """COO (row-sorted) → CSR."""
    row = _host(m.row)
    n_rows = m.shape[0]
    counts = np.bincount(row, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(indptr=torch.as_tensor(indptr, device=m.device), indices=m.col,
               data=m.val, row=m.row, shape=m.shape)


def csr_to_blockell(
    m: CSR,
    *,
    block_rows: int = 8,
    width: Optional[int] = None,
    width_quantile: float = 0.95,
    lane_multiple: int = 8,
) -> BlockELL:
    """CSR → BlockELL(+COO tail), the same host-side layout as the reference
    (bit for bit): ``width`` defaults to the ``width_quantile`` of row
    degrees rounded up to ``lane_multiple``; rows past it spill to the tail.
    """
    device = m.data.device
    indptr = _host(m.indptr)
    indices = _host(m.indices)
    data = _host(m.data)
    n_rows, _ = m.shape
    deg = np.diff(indptr)
    if width is None:
        q = int(np.quantile(deg, width_quantile)) if n_rows else lane_multiple
        width = max(lane_multiple, int(np.ceil(max(q, 1) / lane_multiple) * lane_multiple))
    n_blocks = (n_rows + block_rows - 1) // block_rows
    pad_rows = n_blocks * block_rows

    cols = np.zeros((pad_rows, width), np.int32)
    vals = np.zeros((pad_rows, width), data.dtype)
    nnz_row = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    slot = np.arange(indices.size, dtype=np.int64) - np.repeat(indptr[:-1].astype(np.int64), deg)
    body = slot < width
    cols[nnz_row[body], slot[body]] = indices[body]
    vals[nnz_row[body], slot[body]] = data[body]
    spill = ~body
    if spill.any():
        tr = nnz_row[spill]
        tc = indices[spill].astype(np.int64)
        tv = data[spill]
    else:  # a 1-element dummy, as in the reference
        tr = np.zeros(1, np.int64)
        tc = np.zeros(1, np.int64)
        tv = np.zeros(1, data.dtype)
    tail = COO(torch.as_tensor(tr, device=device), torch.as_tensor(tc, device=device),
               torch.as_tensor(tv, device=device), m.shape)
    return BlockELL(
        cols=torch.as_tensor(cols.reshape(n_blocks, block_rows, width), device=device),
        vals=torch.as_tensor(vals.reshape(n_blocks, block_rows, width), device=device),
        tail=tail,
        shape=m.shape,
        block_rows=block_rows,
        width=width,
    )
