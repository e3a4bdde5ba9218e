"""Out-of-sample extension — label unseen points without touching Stage 2
(mirrors :mod:`repro.serve.oos`).

An unseen point's embedding row is the kernel-weighted average of its
neighbours' cached rows (the Nyström view),

    h(q) ≈ normalize( Σ_j w(q, x_j) · H[j]  /  Σ_j w(q, x_j) ),

with w the Stage-1 similarity exp(−‖q − x‖² / 2σ²) and the NJW row
normalization; the label is the nearest cached centroid — O(knn_k·d + k·d)
a query, no eigensolver.

Neighbour search reuses the Stage-1 kernels against the cached pool:

* ``method="exact"`` — :func:`repro_torch.kernels.knn_topk.ops.knn_topk`
  with ``queries=`` and ``query_offset=n`` (query ids sit past the pool, so
  the kernel's self-exclusion never fires on a pool point);
* ``method="lsh"`` — persisted tables: :func:`build_index` hashes the pool
  once (:func:`~repro_torch.kernels.lsh_candidates.ops.sorted_tables`);
  a serve call hashes only its query rows, ranks them into the tables
  (:func:`~repro_torch.kernels.lsh_candidates.ops.routed_candidates`) and
  reranks the windows exactly.  An index without tables (an old snapshot)
  takes the hash-[pool; queries]-together path, :func:`_lsh_neighbors_rehash`.

Every output row depends only on its query row and the index, so a padded
batch returns the same real rows whatever the pad rows hold (the batcher's
contract).  Outputs stay on the index's device.  PyTorch runs eagerly:
:func:`serve_fn` is :func:`oos_labels` itself (the reference jits it).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

import repro_torch.core.kmeans as km
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import health
from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_rerank
from repro_torch.kernels.lsh_candidates import ops as lsh
from repro_torch.kernels.lsh_candidates.ops import (
    DEFAULT_N_BITS,
    DEFAULT_N_TABLES,
    MAX_N_BITS,
    LshTables,
)

_METHODS = ("exact", "lsh")


@dataclasses.dataclass(frozen=True)
class OOSConfig:
    """Out-of-sample query knobs.  ``knn_k``/``sigma`` mirror the Stage-1
    graph config — the interpolation weights should come from the kernel the
    graph was built with (:meth:`from_graph_config`).  ``impl``,
    ``block_q`` and ``interpret`` select Pallas paths in the reference and
    are kept so its JSON loads both ways; here the index's device picks the
    kernel or its plain version, and they are ignored."""

    knn_k: int = 10
    sigma: float = 1.0
    method: str = "exact"  # neighbour search: "exact" | "lsh"
    n_tables: int = DEFAULT_N_TABLES
    n_bits: int = DEFAULT_N_BITS
    candidates: Optional[int] = None  # LSH budget m; None → default_candidates
    lsh_seed: int = 0
    impl: str = "auto"
    block_q: Optional[int] = None
    interpret: Optional[bool] = None

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(
                f"OOSConfig.method must be one of {_METHODS}, got {self.method!r}")
        if self.knn_k < 1:
            raise ValueError(f"OOSConfig.knn_k must be >= 1, got {self.knn_k}")
        if self.sigma <= 0:
            raise ValueError(f"OOSConfig.sigma must be > 0, got {self.sigma}")
        if not 1 <= self.n_bits <= MAX_N_BITS:
            raise ValueError(
                f"OOSConfig.n_bits must be in [1, {MAX_N_BITS}], got {self.n_bits}")

    @classmethod
    def from_graph_config(cls, g, **overrides) -> "OOSConfig":
        """The OOS config matching a pipeline ``GraphConfig`` — same kernel
        bandwidth, neighbour count, search method and LSH knobs."""
        base = dict(
            knn_k=g.knn_k, sigma=g.sigma, method=g.method,
            n_tables=g.n_tables, n_bits=g.n_bits, candidates=g.candidates,
            lsh_seed=g.lsh_seed, impl=g.impl, interpret=g.interpret)
        base.update(overrides)
        return cls(**base)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ServingIndex:
    """Everything a query needs, on one device: the cached training points,
    their embedding rows, the k-means centroids (in embedding space), the
    training labels, and for ``method="lsh"`` the pool's persisted tables
    (``None`` ⇒ the rehash path)."""

    points: torch.Tensor  # [n, d] training points (neighbour-search pool)
    embedding: torch.Tensor  # [n, ke] NJW-normalized spectral embedding rows
    centroids: torch.Tensor  # [kc, ke] k-means centroids in embedding space
    labels: torch.Tensor  # [n] int32 training cluster assignment
    config: OOSConfig = OOSConfig()
    lsh_tables: Optional[LshTables] = None

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device


class OOSResult(NamedTuple):
    """Per-query serving output (all leading dims = n_queries)."""

    labels: torch.Tensor  # [q] int32 nearest-centroid assignment
    dist2: torch.Tensor  # [q] squared distance to the winning centroid
    embedding: torch.Tensor  # [q, ke] interpolated + normalized embedding rows
    weight_sum: torch.Tensor  # [q] Σ_j w(q, x_j) — 0 ⇒ query far from all neighbours
    neighbors: torch.Tensor  # [q, knn_k] int32 pool ids used (−1 = invalid slot)


def build_index(points, result, *, n_clusters: Optional[int] = None,
                config: OOSConfig = OOSConfig(), device: DeviceLike = None) -> ServingIndex:
    """A :class:`ServingIndex` on ``device`` (the card unless the caller asks
    for the CPU) from a pipeline run: cache the points, the embedding, and
    the per-label means of the embedding as centroids (the converged k-means
    centroids up to the final Lloyd update, and defined for a re-cluster at
    another k).  ``n_clusters`` defaults to ``max(labels) + 1``."""
    dev = resolve_device(device)
    labels = torch.as_tensor(result.labels).to(dev, torch.int32)
    h = torch.as_tensor(result.embedding).to(dev, torch.float32)
    pts = torch.as_tensor(points).to(dev, torch.float32)
    if pts.shape[0] != h.shape[0]:
        raise ValueError(
            f"points rows ({pts.shape[0]}) must match embedding rows "
            f"({h.shape[0]}) — one cached point per embedded row")
    if n_clusters is None:
        n_clusters = int(labels.max()) + 1
    lab = labels.long()
    sums = torch.zeros((n_clusters, h.shape[1]), dtype=torch.float32, device=dev)
    sums.index_add_(0, lab, h)
    counts = torch.bincount(lab, minlength=n_clusters).float()
    centroids = km.centroids_from_sums(sums, counts, torch.zeros_like(sums))
    tables = None
    if config.method == "lsh":
        # hash the pool once; every serve call hashes only its query rows
        planes = lsh.make_planes(pts.shape[1], config.n_tables, config.n_bits,
                                 config.lsh_seed)
        tables = lsh.sorted_tables(*lsh.hash_codes(pts, planes))
    return ServingIndex(points=pts, embedding=h, centroids=centroids, labels=labels,
                        config=config, lsh_tables=tables)


def _budget(cfg: OOSConfig) -> int:
    return cfg.candidates or lsh.default_candidates(cfg.knn_k, cfg.n_tables)


def _lsh_neighbors_rehash(index: ServingIndex, queries: torch.Tensor):
    """The path for an index without tables: hash [pool; queries] together
    per call so the per-table sort positions the queries among the pool,
    take the window ids, drop other queries' ids, rerank exactly."""
    cfg = index.config
    n = index.n_points
    q = queries.shape[0]
    both = torch.cat([index.points, queries.to(index.points.dtype)], 0)
    qrows = n + torch.arange(q, device=index.device)
    cand = lsh.lsh_candidates(both, m=_budget(cfg), n_tables=cfg.n_tables, n_bits=cfg.n_bits,
                              seed=cfg.lsh_seed, query_rows=qrows)
    cand = torch.where(cand >= n, -1, cand)  # other queries are not the pool
    return knn_topk_rerank(index.points, cand, cfg.knn_k, queries=queries, query_rows=qrows)


def _lsh_neighbors(index: ServingIndex, queries: torch.Tensor):
    """LSH candidate windows for out-of-pool queries against the persisted
    tables: hash only the query rows, rank them into the tables, window,
    rerank exactly.  The same candidate sets as the rehash path (same
    tables, same window m // n_tables) with less work a call."""
    cfg = index.config
    if index.lsh_tables is None:  # old snapshot without tables
        return _lsh_neighbors_rehash(index, queries)
    n = index.n_points
    win = min(max(_budget(cfg) // cfg.n_tables, 1), n)
    planes = lsh.make_planes(queries.shape[1], cfg.n_tables, cfg.n_bits, cfg.lsh_seed)
    qcodes, qties = lsh.hash_codes(queries, planes)
    cand = lsh.routed_candidates(index.lsh_tables, qcodes, qties, win=win)
    qrows = n + torch.arange(queries.shape[0], device=index.device)  # never a pool id
    return knn_topk_rerank(index.points, cand, cfg.knn_k, queries=queries, query_rows=qrows)


def oos_embed(index: ServingIndex, queries) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Interpolated embedding rows for unseen points: ``(h [q, ke],
    weight_sum [q], neighbors [q, knn_k])``.  A query with ``weight_sum ==
    0`` (every weight underflowed — it is far from the pool) gets the zero
    row; a query with a non-finite coordinate has NaN distances, so NaN
    weights, a NaN row and a NaN ``weight_sum``, which the post-hoc serving
    gate turns into a failed request."""
    cfg = index.config
    qf = torch.as_tensor(queries).to(index.device, torch.float32)
    if cfg.method == "lsh":
        dist2, idx = _lsh_neighbors(index, qf)
    else:
        dist2, idx = knn_topk(index.points, cfg.knn_k, queries=qf,
                              query_offset=index.n_points)
    valid = idx >= 0
    w = torch.where(valid, torch.exp(-torch.where(valid, dist2, 0.0) / (2.0 * cfg.sigma ** 2)),
                    0.0)  # [q, k]
    rows = index.embedding[torch.clamp(idx, min=0).long()]  # [q, k, ke]
    num = (w[:, :, None] * rows).sum(1)
    wsum = w.sum(1)
    # zero-coverage guard via where with exact divisors, not ε clamps (the
    # reference's rule: fused ε·ε divisors underflow to 0/0 = NaN); the
    # divisor is exactly 1 for an uncovered row, so h stays the zero row
    h = num / torch.where(wsum > 0, wsum, 1.0)[:, None]
    norm2 = (h * h).sum(1, keepdim=True)
    h = h / torch.sqrt(torch.where(norm2 > 0, norm2, 1.0))
    return h, wsum, idx


def oos_labels(index: ServingIndex, queries) -> OOSResult:
    """Labels for unseen points — THE serving function.  Row-independent by
    construction: each output row is a function of that query row and the
    index alone."""
    h, wsum, idx = oos_embed(index, queries)
    labels, dmin = km.assign_ref(h, index.centroids)
    return OOSResult(labels=labels, dist2=dmin, embedding=h, weight_sum=wsum, neighbors=idx)


# the serving entry point the batcher flushes into (the reference's jit of
# oos_labels; PyTorch runs eagerly)
serve_fn = oos_labels


def index_problems(index: ServingIndex) -> Tuple[str, ...]:
    """Structural problems that make an index unservable — the registry's
    default health gate; an empty tuple means healthy.  Non-finite values
    are counted on the index's device."""
    problems = []
    n = index.points.shape[0]
    if n == 0:
        problems.append("index_empty[n=0]")
    if index.embedding.shape[0] != n or index.labels.shape[0] != n:
        problems.append(
            f"index_shape_mismatch[points={n},embedding="
            f"{index.embedding.shape[0]},labels={index.labels.shape[0]}]")
    if index.centroids.shape[1] != index.embedding.shape[1]:
        problems.append(
            f"centroid_width_mismatch[centroids={index.centroids.shape[1]},"
            f"embedding={index.embedding.shape[1]}]")
    for name, arr in (("points", index.points), ("embedding", index.embedding),
                      ("centroids", index.centroids)):
        bad = health.nonfinite_count(arr)
        if bad:
            problems.append(f"nonfinite_{name}[{bad}]")
    return tuple(problems)
