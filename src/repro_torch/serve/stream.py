"""Streaming refresh — mini-batch k-means over the one-pass accumulator
(mirrors :mod:`repro.serve.stream`).

Every labelled batch also updates the centroids it was assigned to, with a
per-centroid learning rate 1/count (Sculley, WWW 2010), from the statistics
of one fused Lloyd iteration over the batch
(:func:`repro_torch.core.kmeans.lloyd_iter`: the ``kmeans_iter`` kernel on
the card).

Padded batches fold in exactly: a pad row is the zero row, which adds the
zero vector to its cluster's sum and 1 to the count of the one cluster
nearest the origin; :func:`stream_update` subtracts ``n_pad`` there.

Drift detection, ``max_j ‖c_j − baseline_j‖`` in embedding units, tells
the caller when to re-embed and publish through
:class:`~repro_torch.serve.registry.EmbeddingRegistry`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

import repro_torch.core.kmeans as km


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Drift/refresh policy.  ``drift_threshold`` is in embedding units (rows
    are unit-norm, so 0.1 ≈ a 10 % centroid move); ``min_count`` floors the
    learning-rate denominator of a fresh centroid."""

    drift_threshold: float = 0.1
    min_count: float = 1.0

    def __post_init__(self):
        if self.drift_threshold <= 0:
            raise ValueError(
                f"StreamConfig.drift_threshold must be > 0, got {self.drift_threshold}")
        if self.min_count < 0:
            raise ValueError(f"StreamConfig.min_count must be >= 0, got {self.min_count}")


class StreamState(NamedTuple):
    """The streaming accumulator, on the centroids' device."""

    centroids: torch.Tensor  # [k, ke] current (refined) centroids
    counts: torch.Tensor  # [k] f32 cumulative points folded into each centroid
    baseline: torch.Tensor  # [k, ke] centroids at the last full refresh
    updates: int  # mini-batches folded in since the refresh


def stream_init(centroids, counts: Optional[torch.Tensor] = None,
                cfg: StreamConfig = StreamConfig()) -> StreamState:
    """A fresh stream state anchored at ``centroids`` (= the baseline), on
    their device.  ``counts`` seeds the learning-rate denominators (pass the
    training cluster sizes, :func:`stream_from_index`); default
    ``min_count``."""
    c = torch.as_tensor(centroids).float()
    if counts is None:
        counts = torch.full((c.shape[0],), cfg.min_count, dtype=torch.float32, device=c.device)
    counts = torch.clamp(counts.float(), min=cfg.min_count)
    return StreamState(centroids=c, counts=counts, baseline=c, updates=0)


def stream_from_index(index, cfg: StreamConfig = StreamConfig()) -> StreamState:
    """Stream state for a :class:`~repro_torch.serve.oos.ServingIndex`:
    centroids from the index, counts from the training label histogram."""
    counts = torch.bincount(index.labels.long(), minlength=index.n_clusters).float()
    return stream_init(index.centroids, counts, cfg)


def stream_update(state: StreamState, h: torch.Tensor, n_pad: int = 0):
    """Fold one (possibly padded) batch of embedding rows ``h`` [B, ke] into
    the stream; pad rows are zero rows at the end of the batch.  Returns
    ``(new_state, labels [B])``; pad-row labels are meaningless and the
    update is exact without them."""
    k = state.centroids.shape[0]
    h = h.to(state.centroids.device, torch.float32)
    labels, _, sums, counts_b = km.lloyd_iter(h, state.centroids, None, km.KMeansConfig(k=k))
    # zero-pad correction: pad rows add 0 to sums but 1 each to the count of
    # the single cluster nearest the origin — subtract them there
    zlab, _ = km.assign_ref(torch.zeros((1, h.shape[1]), device=h.device), state.centroids)
    pad_onehot = (torch.arange(k, device=h.device) == zlab[0]).float()
    counts_b = torch.clamp(counts_b - float(n_pad) * pad_onehot, min=0.0)
    new_counts = state.counts + counts_b
    # c ← (c·count + Σ_batch x) / new_count: learning rate counts_b / new_counts
    new_c = (state.centroids * state.counts[:, None] + sums) \
        / torch.clamp(new_counts, min=1.0)[:, None]
    new_c = torch.where(counts_b[:, None] > 0, new_c, state.centroids)
    return StreamState(centroids=new_c, counts=new_counts, baseline=state.baseline,
                       updates=state.updates + 1), labels


def drift(state: StreamState) -> torch.Tensor:
    """max_j ‖c_j − baseline_j‖ — the refresh trigger metric (0-d tensor)."""
    return torch.linalg.norm(state.centroids - state.baseline, dim=1).max()


def needs_refresh(state: StreamState, cfg: StreamConfig = StreamConfig()) -> torch.Tensor:
    """0-d bool tensor: has the stream drifted past the re-embed trigger?"""
    return drift(state) > cfg.drift_threshold


def rebase(state: StreamState) -> StreamState:
    """Mark a completed refresh: the current centroids become the baseline
    and the update counter resets (counts are kept)."""
    return StreamState(centroids=state.centroids, counts=state.counts,
                       baseline=state.centroids, updates=0)
