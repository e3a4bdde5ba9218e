"""Helpers shared by the port's parity tests (numpy and torch only)."""
from __future__ import annotations

import numpy as np


def to_np(a) -> np.ndarray:
    """A torch tensor (any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def subspace_alignment(u, v) -> float:
    """Smallest singular value of ``Q_uᵀ Q_v`` for the column spans of two
    [n, k] bases (1.0 = the same subspace)."""
    qu, _ = np.linalg.qr(to_np(u).astype(np.float64))
    qv, _ = np.linalg.qr(to_np(v).astype(np.float64))
    return float(np.linalg.svd(qu.T @ qv, compute_uv=False).min())
