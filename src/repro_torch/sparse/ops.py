"""Sparse linear-algebra ops on the formats in :mod:`repro_torch.sparse.formats`
(mirrors :mod:`repro.sparse.ops`).

Plain PyTorch: the reference's ``segment_sum`` becomes ``index_add_``.  The
BlockELL multi-vector product used by the eigensolver on the card is the
``ell_spmm`` kernel (:mod:`repro_torch.kernels.ell_spmm`); the functions here
are the plain paths.  Every op runs where its input tensors live.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.formats import COO, BlockELL


def spmv_coo(m: COO, x: torch.Tensor, *, sorted_rows=None) -> torch.Tensor:
    """y = W @ x via gather + index-add, accumulated in fp32.

    ``sorted_rows`` is accepted for signature parity with the reference; the
    index-add is correct for any row order.
    """
    gathered = m.val.float() * x[m.col].float()
    y = torch.zeros(m.shape[0], dtype=torch.float32, device=x.device)
    y.index_add_(0, m.row, gathered)
    return y.to(x.dtype)


def spmm_coo(m: COO, x: torch.Tensor, *, sorted_rows=None) -> torch.Tensor:
    """Y = W @ X for dense X [n, d], accumulated in fp32."""
    gathered = m.val.float()[:, None] * x[m.col].float()
    y = torch.zeros((m.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    y.index_add_(0, m.row, gathered)
    return y.to(x.dtype)


def spmv_csr(m, x: torch.Tensor) -> torch.Tensor:
    return spmv_coo(COO(m.row, m.indices, m.data, m.shape), x)


def spmv_blockell(m: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """BlockELL SpMV, plain path: dense gather over the padded layout + COO tail."""
    nb, br, w = m.cols.shape
    gathered = m.vals.float() * x[m.cols.long()].float()
    y = gathered.sum(dim=-1).reshape(nb * br)[: m.shape[0]]
    y = y + spmv_coo(m.tail, x).float()
    return y.to(x.dtype)


def spmm_blockell(m: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Y = W @ X for dense X [n, b] on the BlockELL layout, plain path: one
    gather over the padded body serves all b columns; the tail goes through
    the COO product."""
    nb, br, w = m.cols.shape
    gathered = m.vals.float()[..., None] * x[m.cols.long()].float()
    y = gathered.sum(dim=2).reshape(nb * br, -1)[: m.shape[0]]
    y = y + spmm_coo(m.tail, x).float()
    return y.to(x.dtype)


def degrees(m: COO) -> torch.Tensor:
    """D_ii = sum_j W_ij (the paper computes this as W @ 1)."""
    return spmv_coo(m, torch.ones(m.shape[1], dtype=m.val.dtype, device=m.device))


def normalize_rw(m: COO, deg=None) -> COO:
    """D^{-1} W — the paper's Alg. 2 (ScaleElements kernel).  Row-stochastic."""
    d = degrees(m) if deg is None else deg
    inv = torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
    return COO(m.row, m.col, m.val * inv[m.row], m.shape, sorted_rows=m.sorted_rows)


def normalize_sym(m: COO, deg=None) -> COO:
    """D^{-1/2} W D^{-1/2} — symmetric normalization (same spectrum as D^{-1}W)."""
    d = degrees(m) if deg is None else deg
    d32 = d.float()
    inv_sqrt = torch.where(d32 > 0, torch.rsqrt(d32), torch.zeros_like(d32)).to(m.val.dtype)
    return COO(m.row, m.col, m.val * inv_sqrt[m.row] * inv_sqrt[m.col], m.shape,
               sorted_rows=m.sorted_rows)


def symmetrize_coo(m: COO) -> COO:
    """(W + Wᵀ)/2 as a duplicate-coordinate COO (nnz doubles).  The appended
    transpose half carries column ids as rows, so the result is tagged
    ``sorted_rows=False``; :func:`sort_coo_rows` restores the layout."""
    row = torch.cat([m.row, m.col])
    col = torch.cat([m.col, m.row])
    val = torch.cat([m.val, m.val]) * 0.5
    return COO(row, col, val, m.shape, sorted_rows=False)


def sort_coo_rows(m: COO) -> COO:
    """Row-major re-sort on the device.  The sort is stable, so in-row column
    order is preserved."""
    if m.sorted_rows:
        return m
    order = torch.argsort(m.row, stable=True)
    return COO(m.row[order], m.col[order], m.val[order], m.shape, sorted_rows=True)


def coo_identity_minus(m: COO) -> COO:
    """I - M for a COO with no diagonal guarantees: appends an explicit
    diagonal and negates M.  Host-side ordering, as in the reference."""
    n = m.shape[0]
    diag = torch.arange(n, dtype=m.row.dtype, device=m.device)
    row = torch.cat([m.row, diag])
    col = torch.cat([m.col, diag])
    val = torch.cat([-m.val, torch.ones(n, dtype=m.val.dtype, device=m.device)])
    order = np.lexsort((col.cpu().numpy(), row.cpu().numpy()))
    order = torch.as_tensor(order, device=m.device)
    return COO(row[order], col[order], val[order], m.shape)
