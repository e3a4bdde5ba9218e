"""Public wrapper for the fused k-means iteration (mirrors
:mod:`repro.kernels.kmeans_iter.ops`).

One call = one Lloyd iteration's statistics ``(labels, dmin, sums,
counts)`` from one pass over ``x``.  A CUDA input launches the kernel in
``csrc/kmeans_iter.cu`` (or raises) — for any k and d, with no
shared-memory budget to fall back from; a CPU input runs the chunked plain
version in :mod:`.ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._util import KMEANS_BLOCK_Q
from repro_torch.kernels.kmeans_iter.kernel import kmeans_iter_cuda
from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref


def kmeans_iter(x: torch.Tensor, c: torch.Tensor, *,
                x_norm: Optional[torch.Tensor] = None,
                block_q: int = KMEANS_BLOCK_Q):
    """labels[i], dist²[i], per-cluster sums [k, d] and counts [k] — one
    Lloyd iteration.  Empty-cluster policy is the caller's (counts == 0 rows
    carry zero sums).  ``block_q`` is the plain version's row chunk."""
    if x.device.type == "cuda":
        d = x.shape[1]
        cf = c.float().contiguous()
        cn = (cf * cf).sum(1)
        tile_min, labels, acc = kmeans_iter_cuda(x.float().contiguous(), cf, cn)
        kmeans_iter.launches += 1
        xn = (x.float() ** 2).sum(1) if x_norm is None else x_norm.float()
        dmin = torch.clamp(tile_min + xn, min=0.0)
        return labels, dmin, acc[:, :d], acc[:, d]
    if x.device.type == "cpu":
        return kmeans_iter_ref(x, c, x_norm, block_q=block_q)
    raise ValueError(f"kmeans_iter: unsupported device {x.device}")


kmeans_iter.launches = 0  # kernel launches (CUDA path only)
