"""Stage 3 — k-means with k-means++ seeding (paper Alg. 4-5; mirrors
:mod:`repro.core.kmeans`).

The fused iteration is the default and the only engine ported so far: one
Lloyd iteration = assignment and centroid accumulation from one pass over
the points (:mod:`repro_torch.kernels.kmeans_iter`, the CUDA kernel on the
card).  ``iter="two_pass"`` waits for the ``kmeans_assign`` kernel
(ROADMAP B6).  The reference's ``while_loop`` is a Python loop that reads
the changed-label count once per iteration.  k-means++ draws its Gumbels
from the caller's CPU generator, so one seed gives the same seeding on the
CPU and on the card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch._device import cpu_generator
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
    iter: str = "fused"  # "fused" | "two_pass" (not ported: ROADMAP B6)
    update: str = "matmul"  # two-pass update (kept for config parity)
    assign: str = "auto"  # two-pass assignment (kept for config parity)
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
# seeding
# ---------------------------------------------------------------------------

def _gumbel(n: int, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def kmeanspp_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding on the device of ``x``: the categorical draw
    ``P_j ∝ Dist_j²`` is a Gumbel-max over ``log Dist²``.  O(nkd)."""
    n, d = x.shape
    xf = x.float()
    xn = (xf * xf).sum(1)
    i0 = torch.randint(n, (1,), generator=generator).to(x.device)
    c0 = xf.index_select(0, i0)[0]

    def d2_to(c):
        return torch.clamp(xn - 2.0 * (xf @ c) + (c * c).sum(), min=0.0)

    dist2 = d2_to(c0)
    C = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    C[0] = c0
    for i in range(1, k):
        g = _gumbel(n, generator, x.device)
        idx = torch.argmax(torch.log(torch.clamp(dist2, min=1e-30)) + g)
        c = xf.index_select(0, idx.view(1))[0]  # no host sync for the row
        C[i] = c
        dist2 = torch.minimum(dist2, d2_to(c))
    return C.to(x.dtype)


def random_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k distinct random rows."""
    idx = torch.randperm(x.shape[0], generator=generator)[:k].to(x.device)
    return x[idx]


def seed_centroids(x: torch.Tensor, cfg: KMeansConfig,
                   generator: torch.Generator) -> torch.Tensor:
    """Dispatch the configured seeding."""
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
    the configured seeding (draws from the CPU ``generator``, seed 0 by
    default)."""
    if cfg.k is None:
        raise ValueError("KMeansConfig.k is unset — standalone kmeans() needs "
                         "an explicit k (use cfg.resolved(k))")
    if cfg.iter != "fused":
        raise NotImplementedError(
            "KMeansConfig(iter='two_pass') is not ported yet — its "
            "assign='auto' path needs the kmeans_assign kernel (ROADMAP B6)")
    n, _ = x.shape
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
        new_labels, dmin, sums, counts = lloyd_iter(x, c, x_norm, cfg)
        new_c = centroids_from_sums(sums, counts, c)
        if cfg.empty == "reseed_farthest":
            new_c = reseed_empty_farthest(new_c, counts, x, dmin)
        return new_c, new_labels, dmin, (new_labels != labels).sum()

    if cfg.fixed_iters is not None:
        changed_t = torch.tensor(n)
        for _ in range(cfg.fixed_iters):
            c, labels, dmin, changed_t = one_iter(c, labels)
        changed, iters = int(changed_t), cfg.fixed_iters
    else:
        while changed > cfg.tol_changes and iters < cfg.max_iters:
            c, labels, dmin, changed_t = one_iter(c, labels)
            changed = int(changed_t)  # the one host read per iteration
            iters += 1
    return KMeansResult(labels=labels, centroids=c.to(x.dtype), inertia=dmin.sum(),
                        iterations=iters, shifted=changed)
