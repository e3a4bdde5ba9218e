"""Stage 3 — k-means with k-means++ seeding (paper Alg. 4-5; mirrors
:mod:`repro.core.kmeans`).

Two engines, as in the reference:

* **fused** (the default): one Lloyd iteration = assignment and centroid
  accumulation from one pass over the points
  (:mod:`repro_torch.kernels.kmeans_iter`, the CUDA kernel on the card);
* **two-pass** (``iter="two_pass"``, the paper's Alg. 4 split): the
  assignment (:mod:`repro_torch.kernels.kmeans_assign`, the CUDA kernel on
  the card, or with ``assign="ref"`` the materialized distance matrix), then
  a separate centroid update — a one-hot product (``update="matmul"``) or
  an index-add (``"segment"``).  There is no fallback: ``assign="auto"``
  and ``"fused"`` launch the kernel on the card and raise if it cannot.

The reference's ``while_loop`` is a Python loop that reads the
changed-label count once per iteration; under ``fixed_iters`` it reads it
once at the end, and on ``meta`` tensors (the dry-run) not at all.  The
seedings draw on the device from a counter-based stream
(:mod:`repro_torch._random`) keyed by one draw from the caller's CPU
generator, so one seed gives the same seeding on the CPU and on the card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import _random, spans
from repro_torch._device import cpu_generator
from repro_torch.core import health
from repro_torch.kernels._util import KMEANS_BLOCK_K, KMEANS_BLOCK_Q


class KMeansResult(NamedTuple):
    labels: torch.Tensor  # [n] int32
    centroids: torch.Tensor  # [k, d]
    inertia: torch.Tensor  # [] sum of squared distances to assigned centroid
    iterations: int
    shifted: int  # labels changed in the last iteration (0 => converged)


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    # ``k=None`` only as a pipeline-stage config (filled from n_clusters).
    k: Optional[int] = None
    max_iters: int = 100
    tol_changes: int = 0  # stop when <= this many labels change
    init: str = "kmeans++"  # "kmeans++" | "random"
    iter: str = "fused"  # "fused" (one-pass kmeans_iter) | "two_pass"
    update: str = "matmul"  # two-pass update: "matmul" (one-hot) | "segment" (index-add)
    assign: str = "auto"  # two-pass assignment: "auto" | "fused" (kernel) | "ref"
    empty: str = "keep"  # dead centroids: "keep" (paper) | "reseed_farthest"
    fixed_iters: Optional[int] = None  # exact iteration count (benchmarks)
    block_q: int = KMEANS_BLOCK_Q  # plain version's row chunk
    block_k: int = KMEANS_BLOCK_K  # kept for config parity
    interpret: Optional[bool] = None  # kept for config parity (no meaning here)

    def __post_init__(self):
        if self.iter not in ("fused", "two_pass"):
            raise ValueError(f"KMeansConfig.iter must be 'fused' or "
                             f"'two_pass', got {self.iter!r}")
        if self.init not in ("kmeans++", "random"):
            raise ValueError(f"KMeansConfig.init must be 'kmeans++' or "
                             f"'random', got {self.init!r}")
        if self.update not in ("matmul", "segment"):
            raise ValueError(f"KMeansConfig.update must be 'matmul' or "
                             f"'segment', got {self.update!r}")
        if self.assign not in ("auto", "ref", "fused"):
            raise ValueError(f"KMeansConfig.assign must be one of 'auto', "
                             f"'ref', 'fused', got {self.assign!r}")
        if self.empty not in ("keep", "reseed_farthest"):
            raise ValueError(f"KMeansConfig.empty must be 'keep' or "
                             f"'reseed_farthest', got {self.empty!r}")
        if self.k is not None and self.k < 1:
            raise ValueError(f"KMeansConfig.k must be >= 1, got {self.k}")

    def resolved(self, k: int) -> "KMeansConfig":
        """This config with ``k`` filled in (pipeline-stage dispatch)."""
        return self if self.k == k else dataclasses.replace(self, k=k)


# ---------------------------------------------------------------------------
# assignment step (two-pass mode)
# ---------------------------------------------------------------------------

def assign_ref(x: torch.Tensor, c: torch.Tensor, x_norm: Optional[torch.Tensor] = None):
    """labels, min-dist² via the materialized distance matrix (paper Alg. 4)."""
    xf = x.float()
    cf = c.float()
    xn = (xf * xf).sum(1) if x_norm is None else x_norm.float()
    cn = (cf * cf).sum(1)
    s = xn[:, None] + cn[None, :] - 2.0 * (xf @ cf.T)  # Eq. 12/15/16
    val, labels = torch.min(s, dim=1)  # first occurrence: ties low
    return labels.to(torch.int32), torch.clamp(val, min=0.0)


def _assign(x, c, x_norm, cfg: KMeansConfig):
    """The configured assignment: ``"auto"``/``"fused"`` is the
    ``kmeans_assign`` wrapper (its kernel on the card, which raises rather
    than fall back; its plain version on the CPU), ``"ref"`` the
    materialized distance matrix."""
    if cfg.assign == "ref":
        return assign_ref(x, c, x_norm)
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign

    return kmeans_assign(x, c, x_norm=x_norm, block_q=cfg.block_q)


# ---------------------------------------------------------------------------
# fused iteration
# ---------------------------------------------------------------------------

def lloyd_iter(x: torch.Tensor, c: torch.Tensor, x_norm: Optional[torch.Tensor],
               cfg: KMeansConfig):
    """One Lloyd iteration's statistics ``(labels, dmin, sums, counts)``
    from a single pass over ``x``."""
    from repro_torch.kernels.kmeans_iter.ops import kmeans_iter

    return kmeans_iter(x, c, x_norm=x_norm, block_q=cfg.block_q)


def centroids_from_sums(sums: torch.Tensor, counts: torch.Tensor,
                        prev: torch.Tensor) -> torch.Tensor:
    """Means from (sums, counts); empty clusters keep their previous centroid."""
    c = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, c, prev.float()).to(prev.dtype)


def reseed_empty_farthest(c: torch.Tensor, counts: torch.Tensor, x: torch.Tensor,
                          dmin: torch.Tensor) -> torch.Tensor:
    """Revive dead centroids from the points farthest from their assigned
    centroid: the i-th empty cluster takes the i-th farthest point (ties to
    the lower row, as ``lax.top_k``)."""
    k = c.shape[0]
    empty = counts <= 0
    donor_idx = torch.sort(dmin, descending=True, stable=True)[1][:k]
    donors = x.float()[donor_idx]  # [k, d]
    rank = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0, k - 1)
    return torch.where(empty[:, None], donors[rank], c.float()).to(c.dtype)


# ---------------------------------------------------------------------------
# update step (two-pass mode)
# ---------------------------------------------------------------------------

def cluster_sums(x: torch.Tensor, labels: torch.Tensor, k: int, *,
                 how: str = "matmul"):
    """Per-cluster ``(sums [k, d], counts [k])`` of ``x``'s rows, fp32, by a
    second pass over ``x``: ``how="matmul"`` materializes the n×k one-hot
    and multiplies (fp32, no TF32 on the card), ``how="segment"``
    index-adds the rows.  The sharded loop all-reduces a rank's partials."""
    xf = x.float()
    lab = labels.long()
    if how == "matmul":
        h = torch.nn.functional.one_hot(lab, k).float()  # [n, k]
        return h.T @ xf, h.sum(0)
    sums = torch.zeros((k, xf.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, lab, xf)
    return sums, torch.bincount(lab, minlength=k).float()


def update_centroids(x: torch.Tensor, labels: torch.Tensor, k: int, prev: torch.Tensor, *,
                     how: str = "matmul") -> torch.Tensor:
    """New centroids = per-cluster means (:func:`cluster_sums`)."""
    sums, counts = cluster_sums(x, labels, k, how=how)
    return centroids_from_sums(sums, counts, prev)


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------

def row_at(x: torch.Tensor, idx) -> torch.Tensor:
    """x[idx] for a row-sharded x, without gathering x: a one-hot
    contraction over the sharded axis (on a mesh: a local product and a sum
    of d floats over the ranks)."""
    onehot = (torch.arange(x.shape[0], device=x.device) == idx).float()
    return onehot @ x.float()


GUMBEL_CHUNK = 64  # k-means++ Gumbel rows drawn in one pass (36 MB at n = 142,541)


def kmeanspp_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding on the device of ``x``: the categorical draw
    ``P_j ∝ Dist_j²`` is a Gumbel-max over ``log Dist²``.  O(nkd).

    The first centroid is draw 0 of the stream keyed from ``generator``;
    centroid i ≥ 1 takes row i − 1 of draw 1, a ``[k − 1, n]`` Gumbel block
    made ``GUMBEL_CHUNK`` rows a pass (a row's values do not depend on the
    chunking)."""
    n, d = x.shape
    xf = x.float()
    xn = (xf * xf).sum(1)
    rng = _random.Stream.from_generator(generator)
    i0 = rng.index(n, x.device)
    gumbels = rng.take()
    c0 = xf.index_select(0, i0)[0]

    def d2_to(c):
        return torch.clamp(xn - 2.0 * (xf @ c) + (c * c).sum(), min=0.0)

    dist2 = d2_to(c0)
    C = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    C[0] = c0
    chunk = GUMBEL_CHUNK
    for i in range(1, k):
        row = (i - 1) % chunk
        if row == 0:
            block = _random.gumbel(rng.key, gumbels, (min(chunk, k - i), n), x.device,
                                   row0=i - 1)
        g = block[row]
        idx = torch.argmax(torch.log(torch.clamp(dist2, min=1e-30)) + g)
        c = xf.index_select(0, idx.view(1))[0]  # no host sync for the row
        C[i] = c
        dist2 = torch.minimum(dist2, d2_to(c))
    return C.to(x.dtype)


def random_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k distinct random rows: those of the k smallest of n device uniforms
    (32-bit words of the stream keyed from ``generator``), ties to the lower
    row."""
    w = _random.Stream.from_generator(generator).words(1, x.shape[0], x.device)[0]
    idx = torch.sort(w, stable=True)[1][:k]
    return x[idx]


def seed_centroids(x: torch.Tensor, cfg: KMeansConfig,
                   generator: torch.Generator) -> torch.Tensor:
    """Dispatch the configured seeding."""
    with spans.span("kmeans.seed"):
        if cfg.init == "kmeans++":
            return kmeanspp_init(x, cfg.k, generator)
        return random_init(x, cfg.k, generator)


# ---------------------------------------------------------------------------
# driver (Alg. 4)
# ---------------------------------------------------------------------------

def kmeans(x: torch.Tensor, cfg: KMeansConfig,
           generator: Optional[torch.Generator] = None, *,
           init_centroids: Optional[torch.Tensor] = None) -> KMeansResult:
    """Lloyd's algorithm on the device of ``x``, from ``init_centroids`` or
    the configured seeding (drawn there from a stream keyed by the CPU
    ``generator``, seed 0 by default)."""
    if cfg.k is None:
        raise ValueError("KMeansConfig.k is unset — standalone kmeans() needs "
                         "an explicit k (use cfg.resolved(k))")
    n, _ = x.shape
    k = cfg.k
    xf32 = x.float()
    x_norm = (xf32 * xf32).sum(1)
    if init_centroids is not None:
        c = init_centroids.to(x.device)
    else:
        c = seed_centroids(x, cfg, cpu_generator(0) if generator is None else generator)

    labels = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    dmin = torch.zeros(n, dtype=torch.float32, device=x.device)
    changed, iters = n, 0

    def one_iter(c, labels):
        if cfg.iter == "fused":
            new_labels, dmin, sums, counts = lloyd_iter(x, c, x_norm, cfg)
            new_c = centroids_from_sums(sums, counts, c)
        else:  # two_pass: re-stream x for the update
            new_labels, dmin = _assign(x, c, x_norm, cfg)
            new_c = update_centroids(x, new_labels, k, c, how=cfg.update)
            if cfg.empty == "reseed_farthest":
                counts = torch.bincount(new_labels.long(), minlength=k).float()
        if cfg.empty == "reseed_farthest":
            new_c = reseed_empty_farthest(new_c, counts, x, dmin)
        return new_c, new_labels, dmin, (new_labels != labels).sum()

    if cfg.fixed_iters is not None:
        changed_t = torch.tensor(n)
        for _ in range(cfg.fixed_iters):
            c, labels, dmin, changed_t = one_iter(c, labels)
        # nothing read back on values that are not concrete (meta)
        changed = int(changed_t) if health.is_concrete(changed_t) else changed_t
        iters = cfg.fixed_iters
    else:
        while changed > cfg.tol_changes and iters < cfg.max_iters:
            c, labels, dmin, changed_t = one_iter(c, labels)
            with spans.span("host.sync"):
                changed = int(changed_t)  # the one host read per iteration
            iters += 1
    return KMeansResult(labels=labels, centroids=c.to(x.dtype), inertia=dmin.sum(),
                        iterations=iters, shifted=changed)
