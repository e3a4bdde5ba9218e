"""Plain PyTorch version of the fused k-means iteration (the CPU path of
:func:`repro_torch.kernels.kmeans_iter.ops.kmeans_iter`, and what the CUDA
kernel is held against on the card).

The reference's online ``chunked`` formulation: row blocks of ``block_q``,
a ``[block_q, k]`` distance tile with ‖x‖² included before the argmin
(ties low), and an index-add of the block's rows into the sums.  Only the
distance tile is ever live, so it runs at main-path shapes on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._util import KMEANS_BLOCK_Q


def kmeans_iter_ref(x: torch.Tensor, c: torch.Tensor,
                    x_norm: Optional[torch.Tensor] = None, *,
                    block_q: int = KMEANS_BLOCK_Q):
    """``(labels [n] int32, dmin [n] f32, sums [k, d] f32, counts [k] f32)``."""
    n, d = x.shape
    k = c.shape[0]
    xf = x.float()
    cf = c.float()
    xn = (xf * xf).sum(1) if x_norm is None else x_norm.float()
    cn = (cf * cf).sum(1)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    dmin = torch.empty(n, dtype=torch.float32, device=x.device)
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    for s in range(0, n, block_q):
        xb = xf[s:s + block_q]
        dist = xn[s:s + block_q, None] + cn[None, :] - 2.0 * (xb @ cf.T)
        lab = torch.argmin(dist, dim=1)  # first occurrence: ties low
        labels[s:s + block_q] = lab.to(torch.int32)
        dmin[s:s + block_q] = torch.clamp(dist.gather(1, lab[:, None])[:, 0], min=0.0)
        sums.index_add_(0, lab, xb)
    counts = torch.bincount(labels.long(), minlength=k).float()
    return labels, dmin, sums, counts
