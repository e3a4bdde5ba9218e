"""Public wrapper for the kNN top-k kernel (mirrors
:mod:`repro.kernels.knn_topk.ops`).

Dispatch is by the device of the input: a CUDA tensor launches the kernel
in ``csrc/knn_topk.cu`` (or raises), a CPU tensor runs the plain version in
:mod:`.ref`.  There is no fallback between the two.

The ε-ball variant masks neighbours beyond ``eps`` to (+inf, −1), giving a
static-shape [n, k] ε-neighbourhood (k caps the per-row degree).

:func:`knn_topk_rerank` is the exact rerank of the approximate (LSH)
Stage 1 over bounded candidate sets; as in the reference it is plain tensor
code (a gather and a batched product), with no kernel of its own.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels._util import pad_to, round_up
from repro_torch.kernels.knn_topk.kernel import MAX_K, knn_topk_cuda
from repro_torch.kernels.knn_topk.ref import knn_topk_ref


def _float4_rows(a: torch.Tensor, dp: int) -> torch.Tensor:
    """``a`` as a contiguous fp32 [n, dp] block, zero columns past its own,
    16-byte aligned."""
    ac = pad_to(a.float(), dp, 1).contiguous()
    return ac.clone() if ac.data_ptr() % 16 else ac  # a view at an odd offset


def knn_topk(
    x: torch.Tensor,  # [n, d] candidate points
    k: int,
    *,
    queries: Optional[torch.Tensor] = None,  # [nq, d]; defaults to x (all pairs)
    query_offset: int = 0,  # global row id of queries[0]
    eps: Optional[float] = None,
):
    """dist²[i, :], idx[i, :] = the k nearest neighbours of query i (self
    excluded against ``query_offset + i``), ascending by distance, ties to
    the lowest id.  Invalid slots (k ≥ n, or beyond ``eps``) are (+inf, −1).
    ``k`` is at most 128 (the kernel's register top-k) on every device."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_topk supports 1 <= k <= {MAX_K}, got k={k}")
    q = x if queries is None else queries
    if x.device.type == "cuda":
        # zero columns up to a multiple of 4 for the kernel's float4 loads
        # (they add exactly 0); it computes only the d real ones, and keeps a
        # query's coordinates in registers when d ≤ 4, or d ≤ 16 for k ≤ 16
        d = x.shape[1]
        dp = round_up(d, 4)
        xc = _float4_rows(x, dp)
        xq = xc if queries is None else _float4_rows(q, dp)
        dist, idx = knn_topk_cuda(xq, xc, k, query_offset=query_offset, d=d)
        knn_topk.launches += 1
    elif x.device.type == "cpu":
        dist, idx = knn_topk_ref(x, k, queries=queries, query_offset=query_offset)
    else:
        raise ValueError(f"knn_topk: unsupported device {x.device}")
    if eps is not None:
        beyond = dist > float(eps) ** 2
        dist = torch.where(beyond, math.inf, dist)
        idx = torch.where(beyond, -1, idx)
    return dist, idx


knn_topk.launches = 0  # kernel launches (CUDA path only)


_NAN_KEY = 0x7F800001  # every NaN distance's sort key: just above +inf's bits
_NOT_A_CANDIDATE = 0x7FFFFFFF  # the query's own row and −1 slots


def knn_topk_rerank(
    x: torch.Tensor,  # [n, d] candidate pool
    cand: torch.Tensor,  # [nq, m] candidate ids (−1 = padding), unique per row
    k: int,
    *,
    queries: Optional[torch.Tensor] = None,  # [nq, d]; defaults to x (cand is [n, m])
    query_rows: Optional[torch.Tensor] = None,  # [nq] global ids; default arange(nq)
    eps: Optional[float] = None,
    block_q: int = 1024,
):
    """Exact top-k over per-query candidate sets: ``knn_topk``'s output
    contract (dist² ascending, int32 ids, invalid slots (+inf, −1), ties to
    the lowest position in the row — the smallest id, since candidate rows
    are ascending) with the ``m ≪ n`` ids of ``cand`` as the only candidates.
    The query's own row and −1 slots never count: they rank after every
    candidate, a NaN distance included, so a query with a NaN coordinate
    keeps its candidates at NaN distances (as ``knn_topk`` keeps them), where
    the reference ranks them after its +inf padding and returns no
    neighbours (ROADMAP R6).  Queries go in chunks of ``block_q``, so only a
    [block_q, m, d] gather is live."""
    xf = x.float()
    cn = (xf * xf).sum(1)
    q = xf if queries is None else queries.float()
    nq, m = q.shape[0], cand.shape[1]
    if cand.shape[0] != nq:
        raise ValueError(f"knn_topk_rerank: cand has {cand.shape[0]} rows for {nq} queries")
    qrow = (torch.arange(nq, device=x.device) if query_rows is None
            else query_rows.to(x.device).long())
    qn = (q * q).sum(1)
    ko = min(k, m)
    dist = torch.empty((nq, ko), dtype=torch.float32, device=x.device)
    idx = torch.empty((nq, ko), dtype=torch.int32, device=x.device)
    for s in range(0, nq, block_q):
        cb = cand[s:s + block_q].long()
        valid = (cb >= 0) & (cb != qrow[s:s + block_q, None])
        safe = torch.where(cb >= 0, cb, 0)
        d2 = qn[s:s + block_q, None] + cn[safe] \
            - 2.0 * torch.einsum("qd,qmd->qm", q[s:s + block_q], xf[safe])
        d2 = torch.clamp(d2, min=0.0)
        # sort keys: a distance's bits without the sign (monotone for d2 ≥ 0,
        # −0 as 0), every NaN one word above +inf, a slot that does not
        # count above all
        key = torch.clamp(d2.view(torch.int32) & 0x7FFFFFFF, max=_NAN_KEY)
        key = torch.where(valid, key, _NOT_A_CANDIDATE)
        kv, sel = torch.sort(key, dim=1, stable=True)  # ties → lowest position
        sel = sel[:, :ko]
        dist[s:s + block_q] = torch.where(kv[:, :ko] == _NOT_A_CANDIDATE, math.inf,
                                          d2.gather(1, sel))
        idx[s:s + block_q] = safe.gather(1, sel).to(torch.int32)
    idx = torch.where(torch.isinf(dist), -1, idx)  # canonicalize invalid slots
    if ko < k:  # fewer candidates than requested neighbours
        dist = torch.cat([dist, torch.full((nq, k - ko), math.inf, device=x.device)], 1)
        idx = torch.cat([idx, torch.full((nq, k - ko), -1, dtype=torch.int32,
                                         device=x.device)], 1)
    if eps is not None:
        beyond = dist > float(eps) ** 2
        dist = torch.where(beyond, math.inf, dist)
        idx = torch.where(beyond, -1, idx)
    return dist, idx
