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
    with pytest.raises(NotImplementedError, match="A7"):
        ts.build_knn_graph(torch.zeros(10, 3), 3, method="lsh")
