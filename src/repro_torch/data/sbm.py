"""Stochastic block model graphs (paper §V-A, Syn200; mirrors
:mod:`repro.data.sbm`)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.sparse.formats import COO, coo_from_edges


def sbm_graph(
    n_per_cluster: int,
    n_clusters: int,
    p_in: float = 0.3,
    p_out: float = 0.01,
    *,
    seed: int = 0,
    weighted: bool = False,
    device: DeviceLike = None,
) -> Tuple[COO, torch.Tensor]:
    """Symmetric SBM graph as row-sorted COO + ground-truth labels, on
    ``device`` (the card unless the caller asks for the CPU).  The same
    draws, in the same order, as the reference."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = n_per_cluster * n_clusters
    rows, cols = [], []
    for i in range(n_clusters):
        for j in range(i, n_clusters):
            prob = p_in if i == j else p_out
            if i == j:
                n_pairs = n_per_cluster * (n_per_cluster - 1) // 2
            else:
                n_pairs = n_per_cluster * n_per_cluster
            m = rng.binomial(n_pairs, prob)
            if m == 0:
                continue
            idx = rng.choice(n_pairs, size=m, replace=False)
            if i == j:
                a = (np.floor((1 + np.sqrt(1 + 8 * idx)) / 2)).astype(np.int64)
                b = idx - a * (a - 1) // 2
                rr, cc = b + i * n_per_cluster, a + i * n_per_cluster
            else:
                rr = idx // n_per_cluster + i * n_per_cluster
                cc = idx % n_per_cluster + j * n_per_cluster
            rows.append(rr)
            cols.append(cc)
    r = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    c = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    v = rng.random(r.size).astype(np.float32) * 0.5 + 0.5 if weighted else np.ones(r.size, np.float32)
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    vv = np.concatenate([v, v])
    labels = np.repeat(np.arange(n_clusters), n_per_cluster)
    coo = coo_from_edges(rr, cc, vv, (n, n), sort=True, sum_duplicates=True, device=dev)
    return coo, torch.as_tensor(labels, device=dev)
