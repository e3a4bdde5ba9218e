"""Public wrapper for the kNN top-k kernel (mirrors
:mod:`repro.kernels.knn_topk.ops`).

Dispatch is by the device of the input: a CUDA tensor launches the kernel
in ``csrc/knn_topk.cu`` (or raises), a CPU tensor runs the plain version in
:mod:`.ref`.  There is no fallback between the two.

The ε-ball variant masks neighbours beyond ``eps`` to (+inf, −1), giving a
static-shape [n, k] ε-neighbourhood (k caps the per-row degree).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels._util import pad_to, round_up
from repro_torch.kernels.knn_topk.kernel import MAX_K, knn_topk_cuda
from repro_torch.kernels.knn_topk.ref import knn_topk_ref


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
        # zero columns up to a multiple of 4 add exactly 0 to every distance;
        # the kernel keeps a query's coordinates in registers when d ≤ 4
        dp = round_up(x.shape[1], 4)
        xc = pad_to(x.float(), dp, 1).contiguous()
        xq = xc if queries is None else pad_to(q.float(), dp, 1).contiguous()
        dist, idx = knn_topk_cuda(xq, xc, k, query_offset=query_offset)
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
