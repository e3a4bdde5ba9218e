"""DTI-like point clouds (paper §V-A): spatial points with d-dim
connectivity profiles + an ε-distance edge list — the Stage-1 input
(mirrors :mod:`repro.data.pointcloud`)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.similarity import eps_neighbors, knn_edges


def dti_like_pointcloud(
    n_points: int,
    d_profile: int = 90,
    n_regions: int = 8,
    *,
    eps: float = 1.5,
    neighbors: str = "eps",  # "eps" | "knn" | "none"
    knn_k: int = 16,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (positions [n,3] f32, profiles [n,d] f32, edges [m,2] int64,
    region labels [n] int64) on ``device`` (the card unless the caller asks
    for the CPU) — the reference's arrays, value for value.

    Points fill a cubic lattice patch; each belongs to a latent region whose
    mean connectivity profile it inherits with noise.  ``neighbors`` picks
    the host edge list: ε-ball pairs, spatial kNN pairs, or none (for
    consumers that build the graph on the device).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n_points ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = grid[:n_points].astype(np.float32)
    centers = rng.uniform(0, side, (n_regions, 3)).astype(np.float32)
    d2 = ((pos[:, None, :] - centers[None]) ** 2).sum(-1)
    region = d2.argmin(1)
    base = rng.normal(size=(n_regions, d_profile)).astype(np.float32) * 3
    profiles = base[region] + rng.normal(size=(n_points, d_profile)).astype(np.float32)
    if neighbors == "none":
        edges = np.zeros((0, 2), np.int64)
    elif neighbors == "knn":
        edges = knn_edges(pos, knn_k)
    elif neighbors == "eps":
        edges = eps_neighbors(pos, eps)
    else:
        raise ValueError(f"neighbors must be 'eps', 'knn', or 'none', got {neighbors!r}")
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (pos, profiles, edges.astype(np.int64), region.astype(np.int64)))
