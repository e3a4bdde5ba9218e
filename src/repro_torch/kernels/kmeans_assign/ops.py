"""Public wrapper for the fused k-means assignment (mirrors
:mod:`repro.kernels.kmeans_assign.ops`).

A CUDA input launches the kernel in ``csrc/kmeans_assign.cu`` (or raises)
— for any k and d, with no padding: the kernel masks ragged tiles, which
is what the reference's +inf ‖c‖² on padded centroids achieves; a CPU
input runs the chunked plain version in :mod:`.ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._util import KMEANS_BLOCK_Q
from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref


def kmeans_assign(x: torch.Tensor, c: torch.Tensor, *,
                  x_norm: Optional[torch.Tensor] = None,
                  block_q: int = KMEANS_BLOCK_Q):
    """labels[i], dist²[i] = argmin_j / min_j ‖x_i − c_j‖² (ties to the
    lowest j).  ``block_q`` is the plain version's row chunk."""
    if x.device.type == "cuda":
        cf = c.float().contiguous()
        tile_min, labels = kmeans_assign_cuda(x.float().contiguous(), cf, (cf * cf).sum(1))
        kmeans_assign.launches += 1
        xn = (x.float() ** 2).sum(1) if x_norm is None else x_norm.float()
        return labels, torch.clamp(tile_min + xn, min=0.0)
    if x.device.type == "cpu":
        return kmeans_assign_ref(x, c, x_norm, block_q=block_q)
    raise ValueError(f"kmeans_assign: unsupported device {x.device}")


kmeans_assign.launches = 0  # kernel launches (CUDA path only)
