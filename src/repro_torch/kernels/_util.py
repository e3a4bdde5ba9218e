"""Shared shape-padding helpers + tile defaults for the kernel wrapper layer."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# The reference's k-means tile defaults, kept so that KMeansConfig JSON from
# the reference round-trips; the CUDA kernel picks its own tiles.
KMEANS_BLOCK_Q = 1024
KMEANS_BLOCK_K = 512


def pad_to(a: torch.Tensor, size: int, axis: int, value=0.0) -> torch.Tensor:
    """Zero-pad (or ``value``-pad) ``a`` up to ``size`` along ``axis``."""
    pad = size - a.shape[axis]
    if pad <= 0:
        return a
    widths = [0, 0] * a.ndim
    widths[2 * (a.ndim - 1 - axis) + 1] = pad  # F.pad lists the last dim first
    return F.pad(a, widths, value=value)


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult
