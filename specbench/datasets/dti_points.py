"""The DTI-like point cloud of the paper's §V-A, frozen: positions on a
cubic lattice patch, each point in the latent region of its nearest of
``n_regions`` random centres, and a ``d``-dim connectivity profile (the
region's mean profile, scaled by 3, plus unit noise).

A NumPy copy of ``repro_torch.data.pointcloud.dti_like_pointcloud`` with
``neighbors="none"``: the same seed gives the same arrays, value for value
(``tests/test_specbench_data.py`` holds it to the port's), and a later
change to the port's loader does not change what the benchmark feeds it.

A configuration names this file as its data's ``maker``; :func:`make`
reads the configuration's ``n_points``, ``d_profile`` and ``n_regions``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def dti_points(n_points: int, d_profile: int, n_regions: int,
               seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions [n, 3] f32, profiles [n, d] f32, region [n] int64)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n_points ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = grid[:n_points].astype(np.float32)
    centers = rng.uniform(0, side, (n_regions, 3)).astype(np.float32)
    # the nearest centre, a block of rows at a time, the squared distance
    # summed over the coordinates in their order as the loader's .sum(-1)
    # does (its [n, regions, 3] difference tile is 0.4 GB at the DTI size)
    region = np.empty(n_points, np.int64)
    for s in range(0, n_points, 8192):
        p = pos[s:s + 8192]
        d2 = np.square(p[:, 0:1] - centers[:, 0])
        d2 += np.square(p[:, 1:2] - centers[:, 1])
        d2 += np.square(p[:, 2:3] - centers[:, 2])
        region[s:s + 8192] = d2.argmin(1)
    base = rng.normal(size=(n_regions, d_profile)).astype(np.float32) * 3
    profiles = base[region] + rng.normal(size=(n_points, d_profile)).astype(np.float32)
    return pos, profiles, region


def make(params: dict, seed: int) -> Dict[str, torch.Tensor]:
    """One dataset drawn from ``seed``, on the host: ``points`` [n, 3] and
    ``features`` [n, d] (float32)."""
    pos, prof, _ = dti_points(params["n_points"], params["d_profile"], params["n_regions"],
                              seed)
    return {"points": torch.from_numpy(pos), "features": torch.from_numpy(prof)}
