"""Port parity: the approximate Stage 1 — LSH hashing (kernel B7's plain
version), the candidate windows, the exact rerank and the LSH kNN graph of
``repro_torch`` against the JAX reference, with the reference's hyperplanes
substituted for the port's (``jax.random`` planes cannot be drawn in torch).

Tolerances: codes equal on fixtures whose every projection is at least 1e-4
from 0 (checked in float64: nearer, fp32 sums in another order may take the
other sign), tie-break projections at rtol 1e-5; candidate sets equal;
rerank ids equal on tie-free fixtures (relative gaps ≥ 1e-4), dist² at
rtol 1e-5; recall@10 ≥ 0.95 with the port's own planes (the reference's
gate on its 4k clustered-Gaussian fixture).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import similarity as js
from repro.kernels.knn_topk.ops import knn_topk_rerank as j_rerank
from repro.kernels.lsh_candidates import ops as jl
from repro_torch.core import similarity as ts
from repro_torch.kernels.knn_topk.ops import knn_topk_rerank as t_rerank
from repro_torch.kernels.knn_topk.ref import knn_topk_ref
from repro_torch.kernels.lsh_candidates import ops as tl
from tests._parity import to_np

DIST = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def reference_planes(monkeypatch):
    """The port's ``make_planes`` returns the reference's planes."""
    monkeypatch.setattr(tl, "make_planes", lambda d, t, b, s: torch.as_tensor(
        np.array(jl.make_planes(d, t, b, s))))


def _clear_of_zero(n, d, t, b, seed, eps=1e-4):
    """Random points none of whose projections onto the reference's planes
    (seed ``seed``) is within ``eps`` of 0, in float64."""
    planes = np.asarray(jl.make_planes(d, t, b, seed), np.float64)
    x = np.random.default_rng(seed).normal(size=(4 * n, d)).astype(np.float32)
    proj = np.einsum("nd,tdb->tnb", x.astype(np.float64), planes)[..., :-1]
    keep = (np.abs(proj) >= eps).all(axis=(0, 2))
    assert keep.sum() >= n
    return x[keep][:n], np.asarray(jl.make_planes(d, t, b, seed))


def _clustered_gaussians(n, d, n_clusters, *, scale=4.0, seed=0):
    """The reference's recall-gate fixture: tight clusters far from the
    origin, the adversarial case for origin-hyperplane LSH."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * scale
    x = centers[rng.integers(0, n_clusters, n)]
    return (x + rng.normal(size=(n, d)).astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("n,d,t,b", [(256, 8, 4, 12), (100, 3, 2, 16), (300, 3, 16, 16),
                                     (64, 20, 3, 24)])
def test_hash_codes_match_reference(n, d, t, b):
    x, planes = _clear_of_zero(n, d, t, b, seed=n + b)
    jc, jt = jl.hash_codes(jnp.asarray(x), jnp.asarray(planes), impl="pallas",
                           interpret=True)
    tc, tt = tl.hash_codes(torch.as_tensor(x), torch.as_tensor(planes))
    assert tc.dtype == torch.int32 and tc.shape == (t, n)
    np.testing.assert_array_equal(np.asarray(jc), to_np(tc))
    np.testing.assert_allclose(np.asarray(jt), to_np(tt), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m,t,b,query", [(400, 64, 4, 8, False), (400, 64, 4, 8, True),
                                           (333, 100, 16, 12, False),
                                           (50, 200, 4, 4, True)])
def test_lsh_candidates_match_reference(reference_planes, n, m, t, b, query):
    x = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    rows = np.random.default_rng(1).choice(n, n // 3, replace=False).astype(np.int32)
    kw = dict(m=m, n_tables=t, n_bits=b, seed=3)
    want = jl.lsh_candidates(jnp.asarray(x), query_rows=jnp.asarray(rows) if query else None,
                             **kw)
    got = tl.lsh_candidates(torch.as_tensor(x),
                            query_rows=torch.as_tensor(rows) if query else None, **kw)
    assert got.dtype == torch.int32 and got.shape == (rows.size if query else n, m)
    np.testing.assert_array_equal(np.asarray(want), to_np(got))
    g = to_np(got)
    qid = rows if query else np.arange(n)
    assert not (g == qid[:, None]).any()  # the query itself never appears
    for row in g:
        v = row[row >= 0]
        assert (np.diff(v) > 0).all()  # unique, ascending


def test_lsh_candidates_guard():
    with pytest.raises(ValueError, match="m >= n_tables"):
        tl.lsh_candidates(torch.zeros(10, 3), m=4, n_tables=8)
    assert tl.default_candidates(16) == jl.default_candidates(16) == 1536
    assert tl.default_candidates(3, 4) == jl.default_candidates(3, 4)
    assert (tl.MAX_N_BITS, tl.DEFAULT_N_TABLES, tl.DEFAULT_N_BITS) == \
        (jl.MAX_N_BITS, jl.DEFAULT_N_TABLES, jl.DEFAULT_N_BITS)
    p = tl.make_planes(3, 16, 16, seed=0)
    assert p.shape == (16, 3, 17) and torch.equal(p, tl.make_planes(3, 16, 16, seed=0))


def _tie_free_candidates(n, d, m, seed):
    """Points and random unique candidate rows (−1 padded) whose candidate
    distances per row are separated by a relative gap ≥ 1e-4 (float64)."""
    for s in range(seed, seed + 1000):
        rng = np.random.default_rng(s)
        x = rng.normal(size=(n, d)).astype(np.float32)
        cand = np.stack([np.sort(rng.choice(n, m, replace=False)) for _ in range(n)])
        cand[:, -3:] = -1  # padding
        x64 = x.astype(np.float64)
        safe = np.where(cand >= 0, cand, 0)
        d2 = ((x64[:, None] - x64[safe]) ** 2).sum(-1)
        d2[(cand < 0) | (cand == np.arange(n)[:, None])] = np.inf
        srt = np.sort(d2, axis=1)
        srt = srt[:, : np.isfinite(srt).sum(1).min()]
        if (np.diff(srt, axis=1) / srt[:, 1:] > 1e-4).all():
            return x, cand.astype(np.int32)
    raise AssertionError("no tie-free fixture found")


@pytest.mark.parametrize("k,block_q,eps", [(5, 1024, None), (8, 16, None), (40, 7, None),
                                           (6, 64, 1.5)])
def test_knn_topk_rerank_matches_reference(k, block_q, eps):
    x, cand = _tie_free_candidates(120, 4, 30, seed=k)
    want = j_rerank(jnp.asarray(x), jnp.asarray(cand), k, eps=eps, block_q=block_q)
    got = t_rerank(torch.as_tensor(x), torch.as_tensor(cand), k, eps=eps, block_q=block_q)
    np.testing.assert_array_equal(np.asarray(want[1]), to_np(got[1]))
    np.testing.assert_allclose(np.asarray(want[0]), to_np(got[0]), **DIST)
    assert got[1].dtype == torch.int32 and got[0].shape == (120, k)
    # separate queries with global row ids: the first 50 rows as a shard
    q, rows = x[:50] + 0.0, np.arange(50, dtype=np.int32)
    wq = j_rerank(jnp.asarray(x), jnp.asarray(cand[:50]), k, queries=jnp.asarray(q),
                  query_rows=jnp.asarray(rows))
    gq = t_rerank(torch.as_tensor(x), torch.as_tensor(cand[:50]), k,
                  queries=torch.as_tensor(q), query_rows=torch.as_tensor(rows))
    np.testing.assert_array_equal(np.asarray(wq[1]), to_np(gq[1]))


def test_recall_at_k_seeded_clustered_gaussians():
    """The reference's own acceptance gate, with the port's planes: recall@10
    ≥ 0.95 at n = 4000 with the default knobs, and the reported neighbours
    carry their true distances."""
    n, d, k = 4000, 16, 10
    x = torch.as_tensor(_clustered_gaussians(n, d, 10, seed=0))
    cand = tl.lsh_candidates(x, m=tl.default_candidates(k))
    dist, idx = t_rerank(x, cand, k)
    _, want = knn_topk_ref(x, k)
    got, want = to_np(idx), to_np(want)
    hits = sum(len(set(got[i].tolist()) & set(want[i].tolist())) for i in range(n))
    assert hits / (n * k) >= 0.95, hits / (n * k)
    xn = to_np(x).astype(np.float64)
    sel = np.where(got >= 0, got, 0)
    true_d = ((xn[:, None, :] - xn[sel]) ** 2).sum(-1)
    dd = to_np(dist)
    fin = np.isfinite(dd)
    np.testing.assert_allclose(dd[fin], true_d[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("measure,separate", [("exp_decay", False),
                                              ("cross_correlation", True)])
def test_lsh_knn_graph_matches_reference(reference_planes, measure, separate):
    """``build_knn_graph(method="lsh")`` end to end: the same symmetric COO
    as the reference for the same planes (positions searched separately from
    the similarity features in the DTI form)."""
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(300, 3)).astype(np.float32)
    feats = rng.normal(size=(300, 12)).astype(np.float32) if separate else pos
    kw = dict(measure=measure, method="lsh", n_tables=8, n_bits=10, candidates=96,
              lsh_seed=2)
    want = js.build_knn_graph(jnp.asarray(feats), 6,
                              points=jnp.asarray(pos) if separate else None, **kw)
    got = ts.build_knn_graph(torch.as_tensor(feats), 6,
                             points=torch.as_tensor(pos) if separate else None, **kw)
    np.testing.assert_array_equal(np.asarray(want.row), to_np(got.row))
    np.testing.assert_array_equal(np.asarray(want.col), to_np(got.col))
    np.testing.assert_allclose(np.asarray(want.val), to_np(got.val), **DIST)
