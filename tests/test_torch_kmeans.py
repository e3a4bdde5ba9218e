"""Port parity: Stage 3 — the fused k-means iteration and the Lloyd driver of
``repro_torch`` against the JAX reference (its Pallas kernel in interpret
mode on a tiny shape, its chunked path otherwise), with the initial
centroids injected.

Tolerances: labels and iteration counts must be equal (the port's plain
version forms the distance tile exactly as the reference's chunked path:
‖x‖² + ‖c‖² − 2x·c, argmin ties low); counts must be equal (sums of ones);
sums and centroids within 1e-5 (fp32 sums of the same terms in another
order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import kmeans as jkm
from repro.kernels.kmeans_iter.ops import kmeans_iter as j_iter
from repro_torch import convert
from repro_torch.core import kmeans as tkm
from repro_torch.kernels.kmeans_iter.ops import kmeans_iter as t_iter
from tests._parity import to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _blobs(n=300, k=5, d=6, seed=0, spread=0.4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 3
    lab = rng.integers(0, k, n)
    x = (centers[lab] + spread * rng.normal(size=(n, d))).astype(np.float32)
    return x, lab


@pytest.mark.parametrize("impl,n,k,d", [("chunked", 300, 7, 6), ("chunked", 513, 40, 33),
                                        ("pallas", 40, 5, 3)])
def test_kmeans_iter_matches_reference(impl, n, k, d):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    kw = dict(interpret=True, block_q=8, block_k=128) if impl == "pallas" else dict(block_q=128)
    jl, jd, js, jn = (np.asarray(a) for a in j_iter(jnp.asarray(x), jnp.asarray(c),
                                                     impl=impl, **kw))
    tl, td, ts, tn = (to_np(a) for a in t_iter(torch.as_tensor(x), torch.as_tensor(c),
                                               block_q=128))
    np.testing.assert_array_equal(jl, tl)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_allclose(jd, td, **TOL)
    np.testing.assert_allclose(js, ts, **TOL)


@pytest.mark.parametrize("empty", ["keep", "reseed_farthest"])
def test_kmeans_with_injected_init_matches(empty):
    x, _ = _blobs()
    # a deliberately poor start (two centroids near one blob, one far away)
    init = np.concatenate([x[:3], x[:1] + 0.01, np.full((1, 6), 40.0, np.float32)])
    jcfg = jkm.KMeansConfig(k=5, empty=empty)
    tcfg = tkm.KMeansConfig(k=5, empty=empty)
    want = jkm.kmeans(jnp.asarray(x), jcfg, jax.random.PRNGKey(0),
                      init_centroids=jnp.asarray(init))
    got = tkm.kmeans(torch.as_tensor(x), tcfg,
                     init_centroids=convert.centroids(jnp.asarray(init), device="cpu"))
    np.testing.assert_array_equal(np.asarray(want.labels), to_np(got.labels))
    assert int(want.iterations) == got.iterations
    assert int(want.shifted) == got.shifted
    np.testing.assert_allclose(np.asarray(want.centroids), to_np(got.centroids), **TOL)
    np.testing.assert_allclose(float(want.inertia), float(got.inertia), rtol=1e-5)


def test_fixed_iters_and_tol_changes():
    x, _ = _blobs(seed=1)
    init = x[:5]
    for kw in (dict(fixed_iters=3), dict(tol_changes=5, max_iters=50), dict(max_iters=2)):
        want = jkm.kmeans(jnp.asarray(x), jkm.KMeansConfig(k=5, **kw), jax.random.PRNGKey(0),
                          init_centroids=jnp.asarray(init))
        got = tkm.kmeans(torch.as_tensor(x), tkm.KMeansConfig(k=5, **kw),
                         init_centroids=torch.as_tensor(init))
        np.testing.assert_array_equal(np.asarray(want.labels), to_np(got.labels))
        assert int(want.iterations) == got.iterations


def test_centroid_helpers_match():
    rng = np.random.default_rng(2)
    sums = rng.normal(size=(6, 4)).astype(np.float32)
    counts = np.array([3, 0, 1, 0, 5, 2], np.float32)
    prev = rng.normal(size=(6, 4)).astype(np.float32)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    dmin = np.round(rng.random(50), 2).astype(np.float32)  # ties between donors
    np.testing.assert_allclose(
        np.asarray(jkm.centroids_from_sums(jnp.asarray(sums), jnp.asarray(counts),
                                           jnp.asarray(prev))),
        to_np(tkm.centroids_from_sums(torch.as_tensor(sums), torch.as_tensor(counts),
                                      torch.as_tensor(prev))), **TOL)
    np.testing.assert_array_equal(
        np.asarray(jkm.reseed_empty_farthest(jnp.asarray(prev), jnp.asarray(counts),
                                             jnp.asarray(x), jnp.asarray(dmin))),
        to_np(tkm.reseed_empty_farthest(torch.as_tensor(prev), torch.as_tensor(counts),
                                        torch.as_tensor(x), torch.as_tensor(dmin))))


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_seeding_is_deterministic_and_recovers_blobs(init):
    x, lab = _blobs(n=400, k=4, seed=3, spread=0.2)
    cfg = tkm.KMeansConfig(k=4, init=init)
    a = tkm.seed_centroids(torch.as_tensor(x), cfg, torch.Generator().manual_seed(4))
    b = tkm.seed_centroids(torch.as_tensor(x), cfg, torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(to_np(a), to_np(b))
    rows = {tuple(r) for r in x}
    assert all(tuple(r) in rows for r in to_np(a))  # seeds are data rows
    assert len({tuple(r) for r in to_np(a)}) == 4
    if init == "kmeans++":  # well-separated blobs: one seed per blob, clean recovery
        out = tkm.kmeans(torch.as_tensor(x), cfg, torch.Generator().manual_seed(4))
        assert len(np.unique(to_np(out.labels))) == 4
        table = np.zeros((4, 4), int)
        np.add.at(table, (to_np(out.labels), lab), 1)
        assert ((table > 0).sum(1) == 1).all()


def test_two_pass_and_unset_k_raise():
    """Two-pass k-means runs (it raised before kernel B6 was ported) and
    reaches the fused engine's partition from the same seeds; an unset k
    still raises."""
    x, _ = _blobs(n=300, k=4, seed=9, spread=0.3)
    init = torch.as_tensor(x[:4] + 0.0)
    two = tkm.kmeans(torch.as_tensor(x), tkm.KMeansConfig(k=4, iter="two_pass"),
                     init_centroids=init)
    fused = tkm.kmeans(torch.as_tensor(x), tkm.KMeansConfig(k=4), init_centroids=init)
    np.testing.assert_array_equal(to_np(two.labels), to_np(fused.labels))
    np.testing.assert_allclose(to_np(two.centroids), to_np(fused.centroids), **TOL)
    assert two.iterations == fused.iterations
    x = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="unset"):
        tkm.kmeans(x, tkm.KMeansConfig())
    with pytest.raises(ValueError, match="iter"):
        tkm.KMeansConfig(iter="fast")


def test_kmeans_iter_on_meta_gives_the_plain_versions_shapes_and_dtypes():
    """On ``meta`` (the dry-run) the ``repro_torch::kmeans_iter`` operator
    runs its fake: the CPU plain version's output shapes and dtypes, no
    values, and no kernel launch counted."""
    from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref

    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(97, 6)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(5, 6)).astype(np.float32))
    launches = t_iter.launches
    got = t_iter(x.to("meta"), c.to("meta"), x_norm=(x * x).sum(1).to("meta"))
    want = kmeans_iter_ref(x, c)
    assert [(g.device.type, g.shape, g.dtype) for g in got] == \
        [("meta", w.shape, w.dtype) for w in want]
    assert t_iter.launches == launches
    # the CPU path through the operator is the plain version, bitwise
    for g, w in zip(t_iter(x, c), want):
        assert torch.equal(g, w)
