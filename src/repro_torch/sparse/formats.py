"""Sparse matrix containers (mirrors :mod:`repro.sparse.formats`).

Frozen dataclasses of torch tensors.  The builders run in torch on the
device their input lives on (``device=`` for numpy input, CPU by default)
and give the reference's host-built numpy layouts bit for bit; on the card
they read back only a few scalars (the sizes that set shapes).

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
import math
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
# Builders (torch, on the input's device)
# ---------------------------------------------------------------------------

def _tensor(a, device) -> torch.Tensor:
    return a.to(device) if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a),
                                                                            device=device)


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

    ``device=None`` builds where ``val`` lives if it is a tensor, else on the
    CPU.  The entries and their order are the reference's numpy builder's: a
    stable sort on ``row·n_cols + col`` orders as its ``lexsort`` does, and
    duplicate coordinates sum in float64 before the cast to ``dtype``.
    """
    if device is None:
        device = val.device if isinstance(val, torch.Tensor) else "cpu"
    row = _tensor(row, device).long()
    col = _tensor(col, device).long()
    val = _tensor(val, device)
    if sort or sum_duplicates:
        key, order = torch.sort(row * shape[1] + col, stable=True)
        row, col, val = row[order], col[order], val[order]
    if sum_duplicates and row.numel():
        uniq, inv = torch.unique_consecutive(key, return_inverse=True)
        # a float64 sum of float32 values is exact while it fits float64's 53
        # bits (24 + the values' exponent span + log2 of their count), so the
        # order in which index_add_'s atomics add them does not change it
        val = torch.zeros(uniq.numel(), dtype=torch.float64, device=device) \
            .index_add_(0, inv, val.double())
        row, col = uniq // shape[1], uniq % shape[1]
    sorted_rows = bool(sort or sum_duplicates or row.numel() == 0
                       or (row[1:] >= row[:-1]).all())
    return COO(row, col, val.to(dtype), tuple(shape), sorted_rows=sorted_rows)


def coo_to_csr(m: COO) -> CSR:
    """COO (row-sorted) → CSR."""
    indptr = torch.zeros(m.shape[0] + 1, dtype=torch.int64, device=m.device)
    indptr[1:] = torch.bincount(m.row, minlength=m.shape[0]).cumsum(0)
    return CSR(indptr=indptr, indices=m.col, data=m.val, row=m.row, shape=m.shape)


def _quantile_int(deg: torch.Tensor, q: float) -> int:
    """``int(np.quantile(deg, q))``: numpy's linear interpolation, in its
    arithmetic, between two order statistics of a sort on the device (the
    only values read back).  ``torch.quantile`` is not used: it takes at most
    2²⁴ elements."""
    n = deg.numel()
    v = (n - 1) * q
    if v >= n - 1:  # numpy takes the largest value
        return int(deg.max())
    lo = math.floor(v)
    a, b = torch.sort(deg).values[lo:lo + 2].tolist()
    t = v - lo
    return int(b - (b - a) * (1 - t) if t >= 0.5 else a + (b - a) * t)


def ell_width(deg: torch.Tensor, *, width_quantile: float = 0.95,
              lane_multiple: int = 8) -> int:
    """The ELL width :func:`csr_to_blockell` picks for rows of degrees
    ``deg``: their ``width_quantile`` rounded up to ``lane_multiple``."""
    q = _quantile_int(deg, width_quantile) if deg.numel() else lane_multiple
    return max(lane_multiple, math.ceil(max(q, 1) / lane_multiple) * lane_multiple)


def csr_to_blockell(
    m: CSR,
    *,
    block_rows: int = 8,
    width: Optional[int] = None,
    width_quantile: float = 0.95,
    lane_multiple: int = 8,
) -> BlockELL:
    """CSR → BlockELL(+COO tail), the reference's layout bit for bit:
    ``width`` defaults to the ``width_quantile`` of row degrees rounded up to
    ``lane_multiple``; a row's first ``width`` entries fill its slots in
    order and the rest spill to the tail in nnz order (a one-entry zero
    dummy when nothing spills).
    """
    device = m.data.device
    n_rows = m.shape[0]
    deg = m.indptr[1:] - m.indptr[:-1]
    if width is None:
        width = ell_width(deg, width_quantile=width_quantile, lane_multiple=lane_multiple)
    n_blocks = (n_rows + block_rows - 1) // block_rows
    pad_rows = n_blocks * block_rows

    nnz = m.indices.numel()
    nnz_row = torch.repeat_interleave(torch.arange(n_rows, device=device), deg,
                                      output_size=nnz)
    slot = torch.arange(nnz, device=device) - m.indptr[nnz_row]
    body = slot < width
    # one scatter of every entry: spilled ones write a spare last slot, which
    # is dropped (each real slot is written by exactly one entry)
    flat = torch.where(body, nnz_row * width + slot, pad_rows * width)
    cols = torch.zeros(pad_rows * width + 1, dtype=torch.int32, device=device)
    vals = torch.zeros(pad_rows * width + 1, dtype=m.data.dtype, device=device)
    cols[flat] = m.indices.int()
    vals[flat] = m.data
    spill = ~body
    if int(spill.sum()):
        tail = COO(nnz_row[spill], m.indices[spill].long(), m.data[spill], m.shape)
    else:
        zero = torch.zeros(1, dtype=torch.int64, device=device)
        tail = COO(zero, zero.clone(), torch.zeros(1, dtype=m.data.dtype, device=device),
                   m.shape)
    return BlockELL(
        cols=cols[:-1].reshape(n_blocks, block_rows, width),
        vals=vals[:-1].reshape(n_blocks, block_rows, width),
        tail=tail,
        shape=m.shape,
        block_rows=block_rows,
        width=width,
    )
