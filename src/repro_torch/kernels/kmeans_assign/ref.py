"""Plain PyTorch version of the fused k-means assignment (the CPU path of
:func:`repro_torch.kernels.kmeans_assign.ops.kmeans_assign`, and what the
CUDA kernel is held against on the card).

Row blocks of ``block_q``: a ``[block_q, k]`` distance tile with ‖x‖²
included before the argmin (ties low); only that tile is ever live, so it
runs at main-path shapes on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._util import KMEANS_BLOCK_Q


def kmeans_assign_ref(x: torch.Tensor, c: torch.Tensor,
                      x_norm: Optional[torch.Tensor] = None, *,
                      block_q: int = KMEANS_BLOCK_Q):
    """``(labels [n] int32, dist² [n] f32)``: argmin / min_j ‖x_i − c_j‖²."""
    n = x.shape[0]
    xf = x.float()
    cf = c.float()
    xn = (xf * xf).sum(1) if x_norm is None else x_norm.float()
    cn = (cf * cf).sum(1)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    dmin = torch.empty(n, dtype=torch.float32, device=x.device)
    for s in range(0, n, block_q):
        dist = xn[s:s + block_q, None] + cn[None, :] - 2.0 * (xf[s:s + block_q] @ cf.T)
        val, lab = torch.min(dist, dim=1)
        labels[s:s + block_q] = lab.to(torch.int32)
        dmin[s:s + block_q] = torch.clamp(val, min=0.0)
    return labels, dmin
