"""Sparse linear-algebra ops on the formats in :mod:`repro_torch.sparse.formats`
(mirrors :mod:`repro.sparse.ops`).

Plain PyTorch: the reference's ``segment_sum`` becomes ``index_add_``.  The
BlockELL multi-vector product used by the eigensolver on the card is the
``ell_spmm`` kernel (:mod:`repro_torch.kernels.ell_spmm`); the functions here
are the plain paths, and ``ell_body_spmv`` / ``ell_body_spmm`` are also the
plain versions of the ``ell_spmv`` / ``ell_spmm`` kernels.  Every op runs
where its input tensors live.
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


_TILE_ELEMS = 1 << 26  # bound on the live [rows, w, b] gather tile of ell_body_spmm


def ell_body_spmv(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """y[r] = Σ_w vals[r, w] · x[cols[r, w]] over the [rows, w] slots of an
    ELL body (padding slots carry val = 0), in fp32."""
    return (vals.float() * x.float()[cols.long()]).sum(dim=1)


def ell_body_spmm(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Y[r, :] = Σ_w vals[r, w] · x[cols[r, w], :] over the [rows, w] slots of
    an ELL body, in fp32; one gather serves all b columns.  Chunked over
    rows so it runs at main-path shapes on the card."""
    n_rows, w = cols.shape
    b = x.shape[1]
    xf = x.float()
    step = max(1, _TILE_ELEMS // max(1, w * b))
    out = [(vals[s:s + step].float()[..., None] * xf[cols[s:s + step].long()]).sum(dim=1)
           for s in range(0, n_rows, step)]
    return torch.cat(out) if out else torch.zeros((0, b), device=x.device)


def spmv_blockell(m: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """BlockELL SpMV, plain path: the ELL body's gather + the COO tail."""
    nb, br, w = m.cols.shape
    y = ell_body_spmv(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w))
    y = y[: m.shape[0]] + spmv_coo(m.tail, x).float()
    return y.to(x.dtype)


def spmm_blockell(m: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Y = W @ X for dense X [n, b] on the BlockELL layout, plain path: the
    ELL body's gather + the COO tail."""
    nb, br, w = m.cols.shape
    y = ell_body_spmm(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w))
    y = y[: m.shape[0]] + spmm_coo(m.tail, x).float()
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
    # one product of the two scales, which commutes: an edge's two
    # orientations get the same value, so D^{-1/2} W D^{-1/2} is exactly
    # symmetric when W is (the reference rounds (w·s_u)·s_v, which is not)
    return COO(m.row, m.col, m.val * (inv_sqrt[m.row] * inv_sqrt[m.col]), m.shape,
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
