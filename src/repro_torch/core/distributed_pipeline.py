"""The sharded plan's building blocks and its deprecated ``_sharded`` shims
(mirrors :mod:`repro.core.distributed_pipeline`), over ``torch.distributed``.

* :func:`make_knn_rowblock` — the row-block Stage-1 neighbour search;
* :func:`kmeans_sharded` — Stage 3 with one packed all-reduce a Lloyd
  iteration;
* :func:`spectral_cluster_sharded` / :func:`spectral_cluster_from_points_sharded`
  — thin shims over ``SpectralPipeline`` with ``Plan(device="sharded")``.

How the reference's mesh maps onto torch: every rank of the mesh runs the
same program on the same inputs (the whole points, or the whole
:class:`~repro_torch.sparse.distributed.ShardedCOO`), takes its own row
block or bucket, and meets the other ranks only in the counted collectives
of :mod:`repro_torch.sparse.distributed`.

Stage 2 keeps the solver's dense state whole on every rank.  Under GSPMD
the reference row-shards the Lanczos and Chebyshev basis; here
``ShardedCooOperator`` computes a rank's row block of ``A·x`` and
all-gathers the product — still one collective an application — and every
rank repeats the arithmetic of ``core/lanczos.py`` and ``core/chebyshev.py``,
unchanged.  The basis is therefore not split across ranks: a
row-distributed basis needs all-reduces in Gram–Schmidt and a distributed
tall-skinny QR (ROADMAP).  Replicated work that rounds differently from
run to run on the card (an index-add) can leave the ranks' copies apart —
an eigenvector's sign may differ — so the pipeline makes the Stage-2
output one: under a mesh ``SpectralPipeline.embed`` (and ``refine``)
broadcast coordinate 0's embedding and eigenvalues, and a ShardedCOO's
degrees come from the gathered product.  Stage 3 then starts from one
embedding on every rank, whichever k-means runs it.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional

import torch

import repro_torch.core.health as health
import repro_torch.core.kmeans as km
from repro_torch._device import cpu_generator
from repro_torch.core.pipeline import SpectralClusteringConfig
from repro_torch.core.spectral import GraphConfig, Plan, SpectralResult
from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_rerank
from repro_torch.kernels.lsh_candidates.ops import (DEFAULT_N_BITS, DEFAULT_N_TABLES,
                                                    default_candidates, hash_codes,
                                                    lsh_candidates, make_planes,
                                                    routed_candidates, sorted_tables)
from repro_torch.sparse.distributed import (  # noqa: F401  (normalize_sharded re-export)
    ShardedCOO,
    all_gather,
    all_reduce,
    mesh_axis,
    normalize_sharded,
    ring_shift,
)

_EXCHANGES = ("gather", "ring")
_NAN_KEY = 0x7F800001  # every NaN distance's key: one word above +inf's bits


def merge_topk(best_d: torch.Tensor, best_i: torch.Tensor, new_d: torch.Tensor,
               new_i: torch.Tensor, k: int):
    """The ``min(k, width)`` smallest (dist², global id) pairs of the running
    best and a new block's results, per row.

    Selection is lexicographic on (dist, id): ties go to the smallest global
    id, as a full-pool ``knn_topk`` resolves them, so the streamed merge is
    bitwise the gathered computation.  A NaN distance ranks after +inf and
    keeps its id, as in ``knn_topk``; +inf entries come back as (+inf, −1).
    Every entry passed in counts: callers leave padding slots out (the best
    starts with width 0)."""
    cd = torch.cat([best_d, new_d.float()], 1)
    ci = torch.cat([best_i, new_i], 1)
    key = torch.clamp(cd.view(torch.int32) & 0x7FFFFFFF, max=_NAN_KEY).long()
    order = torch.argsort((key << 32) | (ci.long() + 1), dim=1)[:, :k]
    cd, ci = cd.gather(1, order), ci.gather(1, order)
    return cd, torch.where(torch.isinf(cd), -1, ci).to(torch.int32)


def _pad_to_k(d: torch.Tensor, i: torch.Tensor, k: int):
    short = k - d.shape[1]
    if short <= 0:
        return d, i
    return (torch.cat([d, torch.full((d.shape[0], short), math.inf, device=d.device)], 1),
            torch.cat([i, torch.full((i.shape[0], short), -1, dtype=torch.int32,
                                     device=i.device)], 1))


def make_knn_rowblock(mesh, k: int, *, axis="data", block_q: int = 1024,
                      method: str = "exact", n_tables: int = DEFAULT_N_TABLES,
                      n_bits: int = DEFAULT_N_BITS, candidates: Optional[int] = None,
                      lsh_seed: int = 0, exchange: str = "gather"):
    """Row-block-sharded Stage-1 neighbour search.  Returns ``knn(x_blk) ->
    (dist² [n/S, k], idx [n/S, k])`` for this rank's row block ``x_blk``
    (rows ``rank·n/S …``), ids global; the device of the points picks the
    kernel.

    ``exchange="gather"`` — one all-gather of the points, then this rank's
    rows against the whole pool: ``knn_topk`` with ``query_offset =
    rank·n/S`` (self excluded), or for ``method="lsh"`` the full pool hashed
    on every rank and this rank's rows windowed and reranked.

    ``exchange="ring"`` — no rank holds the whole pool.  Exact: the blocks go
    round the ring (S−1 shifts); at each step ``knn_topk`` runs block
    against block with ``query_offset = (rank − src)·n/S``, so the self
    mask fires only at home, and :func:`merge_topk` keeps the running top-k
    by (dist, global id): bitwise the gathered result.  LSH: ``hash_codes``
    on the local block once, its ``sorted_tables`` travel with it, and at
    each step this rank's queries are routed into the visiting tables
    (windows of ⌈m/(T·S)⌉) and reranked against the visiting block.
    """
    if method not in ("exact", "lsh"):
        raise ValueError(f"make_knn_rowblock method must be 'exact'|'lsh', got {method!r}")
    if exchange not in _EXCHANGES:
        raise ValueError(
            f"make_knn_rowblock exchange must be one of {_EXCHANGES}, got {exchange!r}")
    m = default_candidates(k, n_tables) if candidates is None else candidates
    ax = mesh_axis(mesh, axis)

    def knn(x_blk: torch.Tensor):
        nl = x_blk.shape[0]
        if exchange == "ring":
            return _knn_ring(x_blk, nl)
        x_full = all_gather(x_blk, ax)
        offset = ax.rank * nl
        if method == "lsh":
            qrows = offset + torch.arange(nl, device=x_blk.device)
            cand = lsh_candidates(x_full, m=m, n_tables=n_tables, n_bits=n_bits,
                                  seed=lsh_seed, query_rows=qrows)
            return knn_topk_rerank(x_full, cand, k, queries=x_blk, query_rows=qrows,
                                   block_q=block_q)
        return knn_topk(x_full, k, queries=x_blk, query_offset=offset)

    def _knn_ring(x_blk, nl):
        S, my, dev = ax.size, ax.rank, x_blk.device
        best_d = torch.zeros((nl, 0), device=dev)
        best_i = torch.zeros((nl, 0), dtype=torch.int32, device=dev)
        arange_l = torch.arange(nl, device=dev)
        if method == "lsh":
            # hash once, at home; the sorted tables travel with the block
            planes = make_planes(x_blk.shape[1], n_tables, n_bits, lsh_seed)
            qcodes, qties = hash_codes(x_blk, planes)
            win_full = min(max(m // n_tables, 1), S * nl)
            win_step = max(-(-win_full // S), 1)
            payload = (x_blk, sorted_tables(qcodes, qties))
        else:
            payload = x_blk
        for t in range(S):
            src = (my - t) % S  # owner of the block visiting at step t
            # query ids in the visiting block's coordinates: in [0, nl) only
            # at home, so self-exclusion fires exactly there
            if method == "lsh":
                blk, tbl = payload
                qrows_vis = (my - src) * nl + arange_l
                cand = routed_candidates(tbl, qcodes, qties, win=win_step,
                                         query_rows=qrows_vis)
                d_t, i_t = knn_topk_rerank(blk, cand, k, queries=x_blk,
                                           query_rows=qrows_vis, block_q=block_q)
                keep = min(k, cand.shape[1])
            else:
                d_t, i_t = knn_topk(payload, k, queries=x_blk, query_offset=(my - src) * nl)
                keep = min(k, nl)  # slots past the block's rows are padding
            i_g = torch.where(i_t >= 0, i_t + src * nl, -1)
            best_d, best_i = merge_topk(best_d, best_i, d_t[:, :keep], i_g[:, :keep], k)
            if t < S - 1:
                payload = ring_shift(payload, ax)
        return _pad_to_k(best_d, best_i, k)

    return knn


def spectral_cluster_from_points_sharded(x, cfg: SpectralClusteringConfig,
                                         generator: Optional[torch.Generator] = None, *,
                                         mesh, knn_k: int = 10, axis="data",
                                         measure: str = "exp_decay", sigma: float = 1.0,
                                         knn_eps=None, points=None,
                                         device=None) -> SpectralResult:
    """Deprecated: ``cfg.to_pipeline(graph=GraphConfig(...),
    plan=Plan(device="sharded", mesh=mesh, axis=axis)).run(x, generator)``.
    ``x.shape[0]`` must divide by the mesh axis' size."""
    warnings.warn(
        "spectral_cluster_from_points_sharded is deprecated; use SpectralPipeline "
        "with Plan(device='sharded', mesh=...) (repro_torch.core.spectral)",
        DeprecationWarning, stacklevel=2)
    pipe = cfg.to_pipeline(
        graph=GraphConfig(knn_k=knn_k, measure=measure, sigma=sigma, eps=knn_eps),
        plan=Plan(device="sharded", mesh=mesh, axis=axis))
    return pipe.run(x, generator, points=points, device=device)


def kmeans_sharded(x: torch.Tensor, cfg: km.KMeansConfig,
                   generator: Optional[torch.Generator] = None, *, mesh, axis="data",
                   init_centroids: Optional[torch.Tensor] = None) -> km.KMeansResult:
    """Row-sharded Lloyd iterations with one all-reduce an iteration.

    ``x`` is the same whole [n, d] embedding on every rank (the pipeline's
    embed stage makes it one).  Every rank seeds alike, runs the fused iteration
    (:func:`repro_torch.core.kmeans.lloyd_iter`, the ``kmeans_iter`` kernel
    on the card) on its rows, packs its partial statistics into one
    ``[k, d+2]`` block ``[Σx | counts | label changes]`` and all-reduces it;
    every rank then forms the same centroids and the same convergence test.
    The inertia is reduced once, after the loop, and the labels all-gathered
    once.

    ``KMeansConfig(empty="reseed_farthest")`` adds a second all-reduce an
    iteration: each rank writes its k locally farthest ``[row | dmin]``
    candidates into its own slice of a zero ``[S·k, d+1]`` buffer, and the
    donors are the k farthest of the sum — exact, since a globally farthest
    point is farthest on its own shard.  It needs ``n // S >= k``.
    """
    if cfg.iter != "fused":
        raise ValueError(
            "kmeans_sharded runs the fused one-pass engine only (the two-pass "
            f"modes stay on km.kmeans); got KMeansConfig.iter={cfg.iter!r}")
    if cfg.k is None:
        raise ValueError("KMeansConfig.k is unset — standalone kmeans_sharded needs an "
                         "explicit k (use cfg.resolved(k))")
    ax = mesh_axis(mesh, axis)
    n, d = x.shape
    k, S = cfg.k, ax.size
    if n % S:
        raise ValueError(f"kmeans_sharded needs n divisible by the axis size: n={n}, S={S}")
    nl = n // S
    if cfg.empty == "reseed_farthest" and nl < k:
        raise ValueError(
            f"KMeansConfig(empty='reseed_farthest') under kmeans_sharded needs at "
            f"least k rows per shard (each shard contributes k farthest-point "
            f"candidates): n//S = {nl} < k = {k}")
    if init_centroids is not None:
        c = init_centroids.to(x.device)
    else:
        c = km.seed_centroids(x, cfg, cpu_generator(0) if generator is None else generator)
    xb = x[ax.rank * nl:(ax.rank + 1) * nl]
    xf = xb.float()
    x_norm = (xf * xf).sum(1)
    labels = torch.full((nl,), -1, dtype=torch.int32, device=x.device)
    dmin = torch.zeros(nl, dtype=torch.float32, device=x.device)

    def global_farthest(dmin):
        vals, idx = torch.sort(dmin, descending=True, stable=True)
        cand = torch.cat([xf[idx[:k]], vals[:k, None]], 1)
        buf = torch.zeros((S * k, d + 1), dtype=torch.float32, device=x.device)
        buf[ax.rank * k:(ax.rank + 1) * k] = cand
        all_reduce(buf, ax)  # the reseed's second collective
        sel = torch.sort(buf[:, d], descending=True, stable=True)[1][:k]
        return buf[sel, :d]  # [k, d] donors, farthest first

    def one_iter(c, labels):
        new_labels, dmin, sums, counts = km.lloyd_iter(xb, c, x_norm, cfg)
        changed_pc = torch.zeros(k, dtype=torch.float32, device=x.device).index_add_(
            0, new_labels.long(), (new_labels != labels).float())
        packed = torch.cat([sums.float(), counts.float()[:, None], changed_pc[:, None]], 1)
        all_reduce(packed, ax)  # the iteration's one collective
        new_c = km.centroids_from_sums(packed[:, :d], packed[:, d], c)
        if cfg.empty == "reseed_farthest":
            empty = packed[:, d] <= 0
            donors = global_farthest(dmin)
            rank = torch.clamp(torch.cumsum(empty.long(), 0) - 1, 0, k - 1)
            new_c = torch.where(empty[:, None], donors[rank], new_c.float()).to(new_c.dtype)
        return new_c, new_labels, dmin, packed[:, d + 1].sum()

    changed, iters = n, 0
    if cfg.fixed_iters is not None:
        changed_t = torch.tensor(float(n))
        for _ in range(cfg.fixed_iters):
            c, labels, dmin, changed_t = one_iter(c, labels)
        # nothing read back on values that are not concrete (meta)
        changed = int(changed_t) if health.is_concrete(changed_t) else changed_t
        iters = cfg.fixed_iters
    else:
        while changed > cfg.tol_changes and iters < cfg.max_iters:
            c, labels, dmin, changed_t = one_iter(c, labels)
            changed = int(changed_t)  # the one host read an iteration
            iters += 1
    inertia = all_reduce(dmin.sum().reshape(1), ax)[0]  # once, after the loop
    return km.KMeansResult(labels=all_gather(labels, ax), centroids=c.to(x.dtype),
                           inertia=inertia, iterations=iters, shifted=changed)


def spectral_cluster_sharded(sm: ShardedCOO, cfg: SpectralClusteringConfig,
                             generator: Optional[torch.Generator] = None, *,
                             variant: str = "gspmd", mesh=None, axis="data",
                             gather_dtype=None, device=None) -> SpectralResult:
    """Deprecated: ``cfg.to_pipeline(plan=Plan(device="sharded", mesh=mesh,
    variant=variant, ...)).run(sm, generator)``.  Stage 2 runs over the
    row-partitioned edges (:class:`~repro_torch.core.operator.ShardedCooOperator`);
    the shard_map plan also gets the one-all-reduce Stage 3."""
    warnings.warn(
        "spectral_cluster_sharded is deprecated; use SpectralPipeline with "
        "Plan(device='sharded', variant=..., mesh=...) (repro_torch.core.spectral)",
        DeprecationWarning, stacklevel=2)
    plan = Plan(device="sharded", mesh=mesh, axis=axis, variant=variant,
                gather_dtype=gather_dtype)
    return cfg.to_pipeline(plan=plan).run(sm, generator, device=device)
