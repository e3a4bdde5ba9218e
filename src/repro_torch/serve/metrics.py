"""Label-agreement metrics for the serving parity gates (a numpy copy of
:mod:`repro.serve.metrics`).

The OOS acceptance contract is *parity with full re-clustering*: labels for
a fresh batch served through the out-of-sample extension must agree
with the labels a full pipeline run over pool+batch would assign — up to
cluster-id permutation, which is why the gate is **adjusted Rand index**
(pair-counting, permutation-invariant, chance-corrected) rather than
accuracy.  Pure numpy — runs in CI without sklearn.
"""
from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def adjusted_rand_index(a, b) -> float:
    """ARI between two label vectors (any integer coding).  1.0 = identical
    partitions, ~0.0 = chance agreement, negative = worse than chance."""
    a = _host(a).ravel()
    b = _host(b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"label shapes differ: {a.shape} vs {b.shape}")
    n = a.size
    if n < 2:
        return 1.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = ai.max() + 1, bi.max() + 1
    # contingency table via bincount over the joint coding
    ct = np.bincount(ai * kb + bi, minlength=ka * kb).reshape(ka, kb)

    def comb2(x):
        x = x.astype(np.float64)
        return (x * (x - 1.0)) / 2.0

    sum_ij = comb2(ct).sum()
    sum_a = comb2(ct.sum(axis=1)).sum()
    sum_b = comb2(ct.sum(axis=0)).sum()
    total = comb2(np.asarray([n]))[0]
    expected = sum_a * sum_b / total
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:  # both partitions trivial (all-one-cluster)
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))
