"""Port parity: Stage 1 — the kNN top-k wrapper and the kNN graph builders of
``repro_torch`` against the JAX reference (its Pallas kernel in interpret
mode on tiny shapes, and its jnp path), on the same numpy inputs.

Tolerances: neighbour ids must be equal — on tie-free random data (the
fixtures check their own gaps) and on an integer lattice, where every
distance is exact in fp32 and the lowest-id tie rule decides.  Distances
compare at rtol 1e-5: the reference forms ‖x‖² + ‖c‖² − 2x·c, the port
Σ (x − c)², and both round in fp32.  Graph values compare at rtol 1e-5 for
the same reason (exp_decay reuses the search distances).
"""
from pathlib import Path
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import similarity as js
from repro.kernels.knn_topk.ops import knn_topk as j_knn
from repro_torch.core import similarity as ts
from repro_torch.kernels.knn_topk.kernel import (MAX_TILE, SMEM_FLOATS, THREADS, choose_splits,
                                                 tile_rows)
from repro_torch.kernels.knn_topk.ops import knn_topk as t_knn
from repro_torch.kernels.knn_topk.ref import knn_topk_ref
from tests._parity import to_np

DIST = dict(rtol=1e-5, atol=1e-6)


def _tie_free(n, d, k, seed):
    """Random points whose k+1 nearest distances per row are separated by a
    relative gap of at least 1e-4 (checked in float64), so ids are defined:
    the first such draw from seeds ``seed, seed+1, ...``."""
    for s in range(seed, seed + 1000):
        x = np.random.default_rng(s).normal(size=(n, d)).astype(np.float32)
        x64 = x.astype(np.float64)
        d2 = ((x64[:, None] - x64[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        srt = np.sort(d2, axis=1)[:, : k + 1]
        if (np.diff(srt, axis=1) / srt[:, 1:] > 1e-4).all():
            return x
    raise AssertionError("no tie-free fixture found")


def _lattice(side):
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    return g.reshape(-1, 3).astype(np.float32)


def _compare(want, got):
    wd, wi = (np.asarray(a) for a in want)
    gd, gi = (to_np(a) for a in got)
    np.testing.assert_array_equal(wi, gi)
    np.testing.assert_allclose(wd, gd, **DIST)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_knn_topk_tie_free(impl):
    x = _tie_free(70, 5, 6, seed=0)
    kw = dict(interpret=True, block_q=32, block_k=32) if impl == "pallas" else {}
    _compare(j_knn(jnp.asarray(x), 6, impl=impl, **kw), t_knn(torch.as_tensor(x), 6))


def test_knn_topk_lattice_ties_lowest_id():
    """On a 5³ lattice most neighbour shells tie; ids and distances must be
    equal exactly (integer coordinates: every distance is exact)."""
    x = _lattice(5)
    jd, ji = j_knn(jnp.asarray(x), 16, impl="ref")
    td, ti = t_knn(torch.as_tensor(x), 16)
    np.testing.assert_array_equal(np.asarray(ji), to_np(ti))
    np.testing.assert_array_equal(np.asarray(jd), to_np(td))


def test_knn_topk_queries_offset_eps_and_exhaustion():
    x = _tie_free(40, 3, 8, seed=1)
    q = x[10:25]
    _compare(j_knn(jnp.asarray(x), 5, queries=jnp.asarray(q), query_offset=10, impl="ref"),
             t_knn(torch.as_tensor(x), 5, queries=torch.as_tensor(q), query_offset=10))
    _compare(j_knn(jnp.asarray(x), 8, eps=0.9, impl="ref"),
             t_knn(torch.as_tensor(x), 8, eps=0.9))
    small = x[:5]  # k ≥ n: unfilled slots are (+inf, -1)
    _compare(j_knn(jnp.asarray(small), 7, impl="ref"), t_knn(torch.as_tensor(small), 7))


def test_knn_topk_duplicates_and_k_limit():
    x = np.repeat(_lattice(2), 2, axis=0)  # every point twice
    _compare(j_knn(jnp.asarray(x), 4, impl="ref"), t_knn(torch.as_tensor(x), 4))
    with pytest.raises(ValueError, match="k <= 128"):
        t_knn(torch.as_tensor(x), 129)
    # the plain version itself has no k cap
    assert knn_topk_ref(torch.as_tensor(x), 3)[1].shape == (16, 3)


@pytest.mark.parametrize("measure", ["exp_decay", "cosine", "cross_correlation"])
@pytest.mark.parametrize("with_points", [False, True])
def test_build_knn_graph_matches(measure, with_points):
    pos = _tie_free(80, 3, 5, seed=2)
    feats = np.random.default_rng(3).normal(size=(80, 6)).astype(np.float32)
    x = feats if with_points else pos
    kw = dict(points=pos) if with_points else {}
    want = js.build_knn_graph(jnp.asarray(x), 5, measure=measure, sigma=0.7, impl="ref",
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ts.build_knn_graph(torch.as_tensor(x), 5, measure=measure, sigma=0.7,
                             **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert want.shape == got.shape and bool(want.sorted_rows) == got.sorted_rows
    np.testing.assert_array_equal(np.asarray(want.row), to_np(got.row))
    np.testing.assert_array_equal(np.asarray(want.col), to_np(got.col))
    np.testing.assert_allclose(np.asarray(want.val), to_np(got.val), **DIST)


def test_graph_from_knn_eps_and_invalid_slots():
    pos = _tie_free(50, 3, 4, seed=4)
    jd, ji = j_knn(jnp.asarray(pos), 4, impl="ref")
    ji = ji.at[0, 1].set(-1)  # an invalid slot becomes a zero-valued self edge
    want = js.graph_from_knn(jnp.asarray(pos), jd, ji, measure="exp_decay", eps=0.8)
    got = ts.graph_from_knn(torch.as_tensor(pos), torch.as_tensor(np.array(jd)),
                            torch.as_tensor(np.array(ji)), measure="exp_decay", eps=0.8)
    np.testing.assert_array_equal(np.asarray(want.col), to_np(got.col))
    np.testing.assert_allclose(np.asarray(want.val), to_np(got.val), **DIST)


@pytest.mark.parametrize("measure", ["exp_decay", "cosine", "cross_correlation"])
def test_edge_similarities_and_host_builders(measure):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 7)).astype(np.float32)
    pos = _lattice(3) * 1.0
    edges = js.eps_neighbors(pos, 1.5)
    np.testing.assert_array_equal(edges, ts.eps_neighbors(pos, 1.5))
    np.testing.assert_array_equal(js.knn_edges(pos, 4), ts.knn_edges(pos, 4))
    xe = x[:27]
    want = js.edge_similarities(jnp.asarray(xe), jnp.asarray(edges), measure=measure, chunk=16)
    got = ts.edge_similarities(torch.as_tensor(xe), torch.as_tensor(edges), measure=measure,
                               chunk=16)
    np.testing.assert_allclose(np.asarray(want), to_np(got), **DIST)
    wg = js.build_similarity_graph(xe, edges, measure=measure)
    tg = ts.build_similarity_graph(torch.as_tensor(xe), edges, measure=measure)
    np.testing.assert_array_equal(np.asarray(wg.row), to_np(tg.row))
    np.testing.assert_array_equal(np.asarray(wg.col), to_np(tg.col))
    np.testing.assert_allclose(np.asarray(wg.val), to_np(tg.val), **DIST)


def test_lsh_method_with_a_full_budget_equals_exact():
    """``method="lsh"`` now builds the graph (it raised before ROADMAP A7):
    with a candidate budget that covers every point, the exact rerank finds
    the exact neighbours, so the graph equals the exact method's."""
    x = _tie_free(60, 3, 5, seed=4)
    exact = ts.build_knn_graph(torch.as_tensor(x), 5)
    lsh = ts.build_knn_graph(torch.as_tensor(x), 5, method="lsh", n_tables=2, candidates=120)
    np.testing.assert_array_equal(to_np(exact.row), to_np(lsh.row))
    np.testing.assert_array_equal(to_np(exact.col), to_np(lsh.col))
    np.testing.assert_allclose(to_np(exact.val), to_np(lsh.val), **DIST)
    with pytest.raises(ValueError, match="unknown method"):
        ts.build_knn_graph(torch.as_tensor(x), 5, method="ann")


def _kernel_width(k):
    """The register top-k the CUDA kernel keeps for k: 8, 12, 16, 32, 64 or
    128."""
    return next(kp for kp in (8, 12, 16, 32, 64, 128) if k <= kp)


def _tile_order(t0, lo, hi, near_first):
    """Tiles ``lo`` ≤ t < ``hi`` in the kernel's visit order: from ``t0``
    (clamped into the range) outward (−1, +1, −2, +2, …) when
    ``near_first``, else ascending."""
    if not near_first:
        return list(range(lo, hi))
    t0 = min(max(t0, lo), hi - 1)
    order, j = [], 0
    while len(order) < hi - lo:
        t = t0 - (j + 1) // 2 if j % 2 else t0 + j // 2
        if lo <= t < hi:
            order.append(t)
        j += 1
    return order


def _sweep_topk(x, k, tile, block, queries=None, query_offset=0, near_first=True, splits=1):
    """A numpy model of the sweep of ``csrc/knn_topk.cu``.  Queries go in
    blocks of ``block``; the candidate tiles of ``tile`` rows are cut into
    ``splits`` slices of whole tiles (slice s: tiles ⌊s·nt/S⌋ to
    ⌊(s+1)·nt/S⌋, empty when S exceeds the tiles).  A block sweeps each
    slice on its own: it starts at the tile that holds its first query's
    global id, clamped into the slice, and visits the slice's others
    outward.  Each query keeps the kernel's sorted list of kp ≥ k
    (distance, id) pairs per slice; a candidate other than the query itself
    enters when its pair comes before the last one's, and the shift keeps
    the (distance, id) order.  The slices' first k pairs are then merged in
    (distance, id) order, empty slots last, as the merge kernel does (with
    one slice the sweep's list is the result).  Distances are float32 sums
    of squares (exact on the integer and half-integer lattices used here).
    Returns (dist, idx, insertions per query)."""
    q = x if queries is None else queries
    n, nq, kp = x.shape[0], q.shape[0], _kernel_width(k)
    nt = -(-n // tile)
    parts_d = np.full((splits, nq, k), np.inf, np.float32)
    parts_i = np.full((splits, nq, k), -1, np.int64)
    inserts = np.zeros(nq, np.int64)
    ar = np.arange(kp)
    for s in range(splits):
        lo, hi = s * nt // splits, (s + 1) * nt // splits
        for b0 in range(0, nq, block):
            rows = np.arange(b0, min(nq, b0 + block))
            self_ids = query_offset + rows
            bd = np.full((rows.size, kp), np.inf, np.float32)
            bi = np.full((rows.size, kp), -1, np.int64)
            for t in _tile_order((query_offset + b0) // tile, lo, hi, near_first):
                for c in range(t * tile, min(n, (t + 1) * tile)):
                    d = ((q[rows] - x[c]) ** 2).sum(1, dtype=np.float32)
                    enter = ((d < bd[:, -1]) | ((d == bd[:, -1]) & (c < bi[:, -1]))) \
                        & (self_ids != c)
                    if not enter.any():
                        continue
                    inserts[rows[enter]] += 1
                    e = np.nonzero(enter)[0]
                    de, be, ie = d[e, None], bd[e], bi[e]
                    p = ((be < de) | ((be == de) & (ie < c))).sum(1, keepdims=True)
                    sd = np.concatenate([be[:, :1], be[:, :-1]], 1)
                    si = np.concatenate([ie[:, :1], ie[:, :-1]], 1)
                    bd[e] = np.where(ar < p, be, np.where(ar == p, de, sd))
                    bi[e] = np.where(ar < p, ie, np.where(ar == p, c, si))
            parts_d[s, rows], parts_i[s, rows] = bd[:, :k], bi[:, :k]
    # merge: every slice's k pairs of a query, in (distance, id) order with
    # an empty slot (id −1) after every candidate
    md = parts_d.transpose(1, 0, 2).reshape(nq, -1)
    mi = parts_i.transpose(1, 0, 2).reshape(nq, -1)
    order = np.lexsort((np.where(mi < 0, n, mi), md), axis=1)[:, :k]
    dist = np.take_along_axis(md, order, 1)
    idx = np.where(np.isinf(dist), -1, np.take_along_axis(mi, order, 1))
    return dist, idx.astype(np.int32), inserts


@pytest.mark.parametrize("side,k,tile,block", [
    (5, 16, 7, 4), (6, 1, 50, 16), (7, 33, 64, 32), (8, 16, 37, 8), (9, 63, 100, 64),
    (9, 16, 128, 256), (6, 63, 216, 8), (7, 1, 13, 128)])
def test_near_first_sweep_model_matches_ref_on_lattices(side, k, tile, block):
    """The kernel's sweep, modelled on the CPU (the kernel itself runs only on
    the card): tiles that leave a ragged last one, a start tile in the
    middle of the candidates, and k below, at and above the kernel's 16.
    On a lattice most neighbour shells tie, so the (distance, id) insertion
    rule alone decides the ids, and they must equal the plain version's
    (a stable sort) and the JAX reference's exactly."""
    x = _lattice(side)
    gd, gi, _ = _sweep_topk(x, k, tile, block)
    wd, wi = knn_topk_ref(torch.as_tensor(x), k)
    np.testing.assert_array_equal(gi, to_np(wi))
    np.testing.assert_array_equal(gd, to_np(wd))
    jd, ji = j_knn(jnp.asarray(x), k, impl="ref")
    np.testing.assert_array_equal(gi, np.asarray(ji))


@pytest.mark.parametrize("side,k,tile,block,lo,hi,offset", [
    (7, 16, 30, 16, 100, 200, 100),      # a query set inside the candidates
    (8, 33, 50, 32, 400, 512, 400),      # the last queries: the start tile is the last
    (6, 16, 20, 8, 0, 216, 216),         # ids past every candidate: start clamped
    (9, 63, 90, 64, 0, 300, 729)])
def test_near_first_sweep_model_with_query_offset(side, k, tile, block, lo, hi, offset):
    """``queries=`` with ``query_offset``: the start tile follows the global
    query ids and is clamped to the last tile when they lie past the
    candidates (out-of-sample queries, here the lattice shifted by half a
    step, so that ties stay exact and no candidate is the query itself)."""
    x = _lattice(side)
    q = x[lo:hi] if offset == lo else x[lo:hi] + np.float32(0.5)
    gd, gi, _ = _sweep_topk(x, k, tile, block, queries=q, query_offset=offset)
    wd, wi = knn_topk_ref(torch.as_tensor(x), k, queries=torch.as_tensor(q),
                          query_offset=offset)
    np.testing.assert_array_equal(gi, to_np(wi))
    np.testing.assert_array_equal(gd, to_np(wd))


def test_near_first_sweep_inserts_less_on_a_raster_lattice():
    """The diagnosis behind the near-first order, in the model: on a lattice
    in raster order an ascending sweep keeps finding nearer slices and
    rebuilds the top-k; starting at the query's own tile it is final early.
    Both orders give the same neighbours."""
    x = _lattice(9)
    nd, ni, near = _sweep_topk(x, 16, 81, 16)
    ad, ai, asc = _sweep_topk(x, 16, 81, 16, near_first=False)
    np.testing.assert_array_equal(ni, ai)
    np.testing.assert_array_equal(nd, ad)
    assert near.mean() < asc.mean()


@pytest.mark.parametrize("side,k,tile,block,splits", [
    (6, 16, 7, 16, 5),     # 31 tiles in 5 slices: S does not divide the tiles
    (5, 16, 50, 32, 4),    # 3 tiles, S = 4: an empty slice
    (7, 33, 64, 64, 2),
    (5, 16, 7, 8, 18),     # slices of one tile: 7 candidates, fewer than k
    (8, 1, 37, 128, 7),
    (6, 63, 20, 16, 11)])  # slices of 20 candidates against k = 63
def test_split_sweep_model_matches_ref_on_lattices(side, k, tile, block, splits):
    """The candidate split, modelled on the CPU: each slice swept into its
    own list and the lists merged in (distance, id) order give the plain
    version's and the JAX reference's ids and distances exactly, however
    the slices fall on the tiles (ragged, empty, shorter than k), on a
    lattice where most neighbour shells tie."""
    x = _lattice(side)
    gd, gi, _ = _sweep_topk(x, k, tile, block, splits=splits)
    wd, wi = knn_topk_ref(torch.as_tensor(x), k)
    np.testing.assert_array_equal(gi, to_np(wi))
    np.testing.assert_array_equal(gd, to_np(wd))
    jd, ji = j_knn(jnp.asarray(x), k, impl="ref")
    np.testing.assert_array_equal(gi, np.asarray(ji))
    np.testing.assert_array_equal(gd, np.asarray(jd))


@pytest.mark.parametrize("side,k,tile,block,splits,lo,hi,offset", [
    (7, 16, 30, 16, 3, 100, 200, 100),    # a query set inside the candidates
    (8, 33, 50, 32, 4, 400, 512, 400),    # the last queries: their tile in the last slice
    (6, 16, 20, 8, 13, 0, 216, 216),      # ids past every candidate; 13 slices of 11 tiles
    (9, 63, 90, 64, 5, 0, 300, 729)])
def test_split_sweep_model_with_query_offset(side, k, tile, block, splits, lo, hi, offset):
    """``queries=`` with ``query_offset`` under the split: the start tile is
    clamped into each slice, and queries past the candidates (the lattice
    shifted by half a step: ties stay exact, no candidate is the query
    itself) start every slice at its last tile.  Equal to the plain
    version and the JAX reference, ids and distances."""
    x = _lattice(side)
    q = x[lo:hi] if offset == lo else x[lo:hi] + np.float32(0.5)
    gd, gi, _ = _sweep_topk(x, k, tile, block, queries=q, query_offset=offset, splits=splits)
    wd, wi = knn_topk_ref(torch.as_tensor(x), k, queries=torch.as_tensor(q),
                          query_offset=offset)
    np.testing.assert_array_equal(gi, to_np(wi))
    np.testing.assert_array_equal(gd, to_np(wd))
    jd, ji = j_knn(jnp.asarray(x), k, queries=jnp.asarray(q), query_offset=offset, impl="ref")
    np.testing.assert_array_equal(gi, np.asarray(ji))
    np.testing.assert_array_equal(gd, np.asarray(jd))


def test_choose_splits_at_the_paths_shapes():
    """On an H100's 132 SMs: the lattice's all-pairs search (1,114 query
    blocks) and the serving pool's (1,250) keep one slice; a serving batch
    of 256 queries (2 blocks) is split, into no more slices than the
    pool's tiles."""
    assert choose_splits(142541, 142541, 4, 132) == 1
    assert choose_splits(160000, 160000, 16, 132) == 1
    s = choose_splits(256, 160000, 16, 132)
    assert 1 < s <= -(-160000 // tile_rows(16))


@pytest.mark.parametrize("nq,nc,dp", [
    (256, 160000, 16), (35635, 142540, 4), (1, 5, 4), (1, 1024, 4), (1, 1025, 4),
    (256, 100, 16), (37, 1_000_000, 4), (129, 3000, 92), (0, 10, 4), (5, 0, 4)])
@pytest.mark.parametrize("sms", [1, 132])
def test_choose_splits_never_more_slices_than_tiles(nq, nc, dp, sms):
    tiles = -(-nc // tile_rows(dp))
    s = choose_splits(nq, nc, dp, sms)
    assert 1 <= s <= max(1, tiles)
    q_blocks = -(-nq // THREADS)
    if q_blocks * s < 4 * sms:  # short of the aim only where the tiles run out
        assert s == max(1, tiles)


def test_binding_constants_match_the_kernel_source():
    """The chooser's tile arithmetic is the kernel's: the constants of
    ``csrc/knn_topk.cu`` that fix a tile and a block."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "knn_topk.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kThreads"), const("kSmemFloats"), const("kTile")) == (
        THREADS, SMEM_FLOATS, MAX_TILE)
    assert [tile_rows(dp) for dp in (4, 8, 12, 16, 92)] == [1024, 1024, 1024, 768, 133]
