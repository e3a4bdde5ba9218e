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
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import similarity as js
from repro.kernels.knn_topk.ops import knn_topk as j_knn
from repro_torch.core import similarity as ts
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


def test_lsh_method_is_not_ported_yet():
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
    """The register top-k the CUDA kernel keeps for k: 8, 16, 32, 64 or 128."""
    return next(kp for kp in (8, 16, 32, 64, 128) if k <= kp)


def _tile_order(t0, nt, near_first):
    """Tiles in the kernel's visit order: from ``t0`` outward (−1, +1, −2,
    +2, …) when ``near_first``, else ascending."""
    if not near_first:
        return list(range(nt))
    order, j = [], 0
    while len(order) < nt:
        t = t0 - (j + 1) // 2 if j % 2 else t0 + j // 2
        if 0 <= t < nt:
            order.append(t)
        j += 1
    return order


def _sweep_topk(x, k, tile, block, queries=None, query_offset=0, near_first=True):
    """A numpy model of the sweep of ``csrc/knn_topk.cu``.  Queries go in
    blocks of ``block``; a block starts at the tile of ``tile`` candidates
    that holds its first query's global id (clamped to the last tile) and
    visits the others outward.  Each query keeps the kernel's sorted list
    of kp ≥ k (distance, id) pairs; a candidate other than the query itself
    enters when its pair comes before the last one's, and the shift keeps
    the (distance, id) order.  Distances are float32 sums of squares (exact
    on the integer and half-integer lattices used here).  Returns (dist,
    idx, insertions per query)."""
    q = x if queries is None else queries
    n, nq, kp = x.shape[0], q.shape[0], _kernel_width(k)
    nt = -(-n // tile)
    dist = np.full((nq, kp), np.inf, np.float32)
    idx = np.full((nq, kp), -1, np.int64)
    inserts = np.zeros(nq, np.int64)
    ar = np.arange(kp)
    for b0 in range(0, nq, block):
        rows = np.arange(b0, min(nq, b0 + block))
        self_ids = query_offset + rows
        t0 = min((query_offset + b0) // tile, nt - 1)
        bd, bi = dist[rows], idx[rows]
        for t in _tile_order(t0, nt, near_first):
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
        dist[rows], idx[rows] = bd, bi
    return dist[:, :k], idx[:, :k].astype(np.int32), inserts


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
