"""Plain PyTorch version of the kNN top-k kernel (the CPU path of
:func:`repro_torch.kernels.knn_topk.ops.knn_topk`, and what the CUDA kernel
is held against on the card).

Same function as ``csrc/knn_topk.cu``: squared distances formed directly as
``Σ (q_j − c_j)²``, self excluded against the global query id, ascending,
ties to the lowest candidate id (a stable sort), unfilled slots (+inf, −1).
Chunked over queries so that only a ``[block_q, n, d]`` difference tile is
live, which keeps it runnable at main-path shapes on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_TILE_ELEMS = 1 << 26  # bound on the live [block_q, n, d] difference tile


def knn_topk_ref(
    x: torch.Tensor,  # [n, d] candidate points
    k: int,
    *,
    queries: Optional[torch.Tensor] = None,  # [nq, d]; defaults to x
    query_offset: int = 0,  # global row id of queries[0]
    block_q: Optional[int] = None,
):
    """(dist² [nq, k] ascending, idx [nq, k] int32)."""
    xf = x.float()
    n, d = xf.shape
    q = xf if queries is None else queries.float()
    nq = q.shape[0]
    ko = min(k, n)
    dist = torch.full((nq, k), math.inf, dtype=torch.float32, device=x.device)
    idx = torch.full((nq, k), -1, dtype=torch.int32, device=x.device)
    bq = block_q or max(1, _TILE_ELEMS // max(1, n * d))
    cand = torch.arange(n, device=x.device)
    for s in range(0, nq, bq):
        qb = q[s:s + bq]
        d2 = ((qb[:, None, :] - xf[None, :, :]) ** 2).sum(dim=2)  # [bq, n]
        rows = query_offset + s + torch.arange(qb.shape[0], device=x.device)
        d2 = torch.where(cand[None, :] == rows[:, None], math.inf, d2)
        vals, order = torch.sort(d2, dim=1, stable=True)
        vals, order = vals[:, :ko], order[:, :ko]
        dist[s:s + bq, :ko] = vals
        idx[s:s + bq, :ko] = torch.where(torch.isinf(vals), -1, order).to(torch.int32)
    return dist, idx
