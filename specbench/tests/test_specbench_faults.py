"""A run with the timed path broken underneath comes out not correct: the
harness's look for a CUDA device skipped, the rest of a run driven on the CPU at a
tiny size, once for each fault a cell can have (one card, so no exchange
between chips to leave out), and once for an eigensolver that returns
sound pairs that are not the top ones, or one pair too few."""
from __future__ import annotations

import dataclasses

import pytest
import torch

import repro_torch.core.kmeans as km
import repro_torch.core.lanczos as lz
import repro_torch.core.similarity as sim
from repro_torch.core.spectral import SpectralPipeline
from specbench import runner
from specbench_tiny import TINY_CELL, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def _unchanged_state(monkeypatch):
    """A Lloyd step that returns its centroids unchanged."""
    monkeypatch.setattr(km, "centroids_from_sums", lambda sums, counts, prev: prev)


def _half_the_batch(monkeypatch):
    """Each Lloyd step's means taken over the first half of the points."""
    orig = km.lloyd_iter

    def half(x, c, x_norm, cfg):
        labels, dmin, sums, counts = orig(x, c, x_norm, cfg)
        h = x.shape[0] // 2
        lab = labels[:h].long()
        sums = torch.zeros_like(sums).index_add_(0, lab, x[:h].float())
        counts = torch.bincount(lab, minlength=c.shape[0]).float()
        return labels, dmin, sums, counts

    orig_update = km.update_centroids

    def half_update(x, labels, k, prev, **kw):  # the two-pass iteration's update
        h = x.shape[0] // 2
        return orig_update(x[:h], labels[:h], k, prev, **kw)

    monkeypatch.setattr(km, "lloyd_iter", half)
    monkeypatch.setattr(km, "update_centroids", half_update)


def _label_altered(monkeypatch):
    """One point's label moved to the next cluster where Stage 3 returns it."""
    orig = SpectralPipeline.cluster

    def altered(self, state, generator=None, **kw):
        res = orig(self, state, generator, **kw)
        k = kw.get("n_clusters") or self.n_clusters
        labels = res.labels.clone()
        labels[7] = (labels[7] + 1) % k
        return res._replace(labels=labels)

    monkeypatch.setattr(SpectralPipeline, "cluster", altered)


def _weight_altered(monkeypatch):
    """One edge's similarity changed where Stage 1 computes it."""
    orig = sim.edge_similarities

    def altered(*a, **kw):
        out = orig(*a, **kw).clone()
        out[100] = out[100] * 0.9
        return out

    monkeypatch.setattr(sim, "edge_similarities", altered)


def _pair_dropped(monkeypatch):
    """The solver asked for one pair more, the middle one of the wanted
    pairs dropped: orthonormal eigenpairs with true residuals, not the top
    ones."""
    orig = lz.eigsh

    def dropped(op, cfg, **kw):
        more = dataclasses.replace(cfg, k=cfg.k + 1, m=max(cfg.m, cfg.k + 2 * cfg.block_size))
        res = orig(op, more, **kw)
        keep = torch.arange(cfg.k + 1) != cfg.k // 2
        return res._replace(eigenvalues=res.eigenvalues[keep],
                            eigenvectors=res.eigenvectors[:, keep],
                            residuals=res.residuals[keep])

    monkeypatch.setattr(lz, "eigsh", dropped)


def _pair_missing(monkeypatch):
    """The solver returns one pair too few (its last)."""
    orig = lz.eigsh

    def missing(op, cfg, **kw):
        res = orig(op, cfg, **kw)
        return res._replace(eigenvalues=res.eigenvalues[:-1],
                            eigenvectors=res.eigenvectors[:, :-1],
                            residuals=res.residuals[:-1])

    monkeypatch.setattr(lz, "eigsh", missing)


FAULTS = {"unchanged_state": _unchanged_state, "half_the_batch": _half_the_batch,
          "label_altered": _label_altered, "weight_altered": _weight_altered,
          "pair_dropped": _pair_dropped, "pair_missing": _pair_missing}
# the number that each fault must fail at the least (others may fail too)
CAUGHT_BY = {"pair_dropped": "eig_spectrum", "pair_missing": "eig_count"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = runner.run_cell(root, TINY_CELL, 2**31 + 1, 0.05, False, device="cpu")
    assert not out["correct"], out["check"]
    if fault in CAUGHT_BY:
        value, limit = out["check"][CAUGHT_BY[fault]]
        assert not value <= limit, out["check"]


def test_the_same_runs_unbroken_are_correct(root):
    out = runner.run_cell(root, TINY_CELL, 2**31 + 1, 0.05, False, device="cpu")
    assert out["correct"], out["check"]
