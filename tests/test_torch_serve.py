"""Port parity: online serving — ``repro_torch.serve`` (out-of-sample labels,
persisted LSH tables, the micro-batcher, the stream refresh, the registry)
against :mod:`repro.serve` on the same seeded inputs, and the serving
contracts the reference's ``tests/test_serving.py`` pins, on the port.

Tolerances: OOS neighbours and labels equal on an index carried across with
``convert.serving_index`` (blobs near the origin, see ``_blobs``), embedding
rows, weight sums and centroid distances within 1e-5 (fp32 sums in another
order); the persisted
LSH tables and the routed candidates bitwise the reference's on the same
hash output, including duplicate keys, a query key equal to a pool key and
a NaN query; stream centroids within 1e-5, counts equal; the registry's
snapshots bitwise across the two packages in both directions; the
acceptance gates as the reference's (ARI ≥ 0.95 against a full
re-clustering, mini-batch inertia within 10 % of Lloyd's, real rows
bitwise invariant to pad rows).
"""
import dataclasses
import functools
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.serve as js
from repro.core import health as jhealth
from repro.core.spectral import SpectralPipeline as JPipeline
from repro.kernels.lsh_candidates import ops as jl
from repro.serve import oos as joos
from repro_torch import convert
from repro_torch.core import health
from repro_torch.core import kmeans as tkm
from repro_torch.core.spectral import SpectralPipeline
from repro_torch.kernels.lsh_candidates import ops as tl
from repro_torch.serve import (
    BatchConfig,
    EmbeddingRegistry,
    MicroBatcher,
    OOSConfig,
    RegistryGateError,
    ServingIndex,
    adjusted_rand_index,
    build_index,
    drift,
    index_problems,
    needs_refresh,
    oos,
    rebase,
    serve_fn,
    stream_from_index,
    stream_init,
    stream_update,
)
from repro_torch.testing import faults
from tests._parity import to_np

CPU = "cpu"
K, D = 3, 6
CLOSE = dict(rtol=1e-5, atol=1e-5)
OOSResultFields = oos.OOSResult._fields


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _blobs(n_per, k=K, d=D, seed=0):
    """Blobs near the origin (‖x‖² ≲ 12): there the reference's distances,
    ‖q‖² + ‖c‖² − 2q·c, round within ~1e-6 of the port's Σ (q − c)²
    (the cancellation error grows with the norms)."""
    rng = np.random.default_rng(seed)
    centers = (np.eye(k, d) * 3.0).astype(np.float32)
    return np.concatenate([centers[i] + 0.3 * rng.normal(size=(n_per, d))
                           for i in range(k)]).astype(np.float32)


@pytest.fixture(scope="module")
def trained():
    """One reference run and one port run on the same pool; the reference's
    index carried across, and the port's own."""
    pool = _blobs(n_per=80)
    jres = JPipeline(n_clusters=K).run(jnp.asarray(pool), jax.random.PRNGKey(0))
    cfg = dict(knn_k=10, sigma=1.0)
    jidx = js.build_index(jnp.asarray(pool), jres, config=js.OOSConfig(**cfg))
    pipe = SpectralPipeline(n_clusters=K)
    tres = pipe.run(pool, _gen(), device=CPU)
    return {"pool": pool, "jres": jres, "jidx": jidx, "pipe": pipe, "tres": tres,
            "carried": convert.serving_index(jidx, device=CPU),
            "index": build_index(pool, tres, config=OOSConfig(**cfg), device=CPU)}


@pytest.fixture
def reference_planes(monkeypatch):
    """The port's ``make_planes`` returns the reference's planes."""
    monkeypatch.setattr(tl, "make_planes", lambda d, t, b, s: torch.as_tensor(
        np.array(jl.make_planes(d, t, b, s))))


def _clear_of_zero(x, t, b, seed, eps=1e-4):
    """The rows of ``x`` none of whose projections onto the reference's planes
    is within ``eps`` of 0 in float64 (nearer, fp32 sums in another order
    may take the other sign)."""
    planes = np.asarray(jl.make_planes(x.shape[1], t, b, seed), np.float64)
    proj = np.einsum("nd,tdb->tnb", x.astype(np.float64), planes)[..., :-1]
    return x[(np.abs(proj) >= eps).all(axis=(0, 2))]


# ---------------------------------------------------------------------------
# Out-of-sample extension against the reference
# ---------------------------------------------------------------------------

def _host_result(res):
    """A reference result's labels and embedding as numpy."""
    return types.SimpleNamespace(labels=np.array(res.labels), embedding=np.array(res.embedding))


def _assert_same_rows(want, got):
    np.testing.assert_array_equal(np.asarray(want.neighbors), to_np(got.neighbors))
    np.testing.assert_array_equal(np.asarray(want.labels), to_np(got.labels))
    for f in ("embedding", "weight_sum", "dist2"):
        np.testing.assert_allclose(np.asarray(getattr(want, f)), to_np(getattr(got, f)),
                                   **CLOSE, err_msg=f)


def test_build_index_matches_reference(trained):
    jidx = trained["jidx"]
    tidx = build_index(trained["pool"], _host_result(trained["jres"]), config=OOSConfig(knn_k=10),
                       device=CPU)
    np.testing.assert_array_equal(np.asarray(jidx.labels), to_np(tidx.labels))
    assert tidx.labels.dtype == torch.int32 and tidx.lsh_tables is None
    np.testing.assert_allclose(np.asarray(jidx.centroids), to_np(tidx.centroids), **CLOSE)
    np.testing.assert_array_equal(np.asarray(jidx.points), to_np(tidx.points))


@pytest.mark.parametrize("seed", [7, 11])
def test_oos_exact_matches_reference(trained, seed):
    q = _blobs(n_per=40, seed=seed)
    want = js.serve_fn(trained["jidx"], jnp.asarray(q))
    got = serve_fn(trained["carried"], q)
    _assert_same_rows(want, got)
    assert got.labels.dtype == torch.int32 and got.neighbors.dtype == torch.int32


def test_oos_far_queries_have_zero_weight(trained):
    far = np.full((4, D), 1e4, np.float32)
    want = js.serve_fn(trained["jidx"], jnp.asarray(far))
    got = serve_fn(trained["carried"], far)
    assert float(got.weight_sum.max()) == 0.0  # every weight underflows
    assert bool(torch.isfinite(got.embedding).all())  # still servable
    _assert_same_rows(want, got)


def test_oos_nan_query_fails_the_gate_and_leaves_its_neighbours(trained):
    q = _blobs(n_per=2, seed=3)
    bad = q.copy()
    bad[1, 0] = np.nan
    want = js.serve_fn(trained["jidx"], jnp.asarray(bad))
    got = serve_fn(trained["carried"], bad)
    for out in (want, got):
        emb = np.asarray(to_np(out.embedding))
        assert np.isnan(emb[1]).all() and np.isfinite(np.delete(emb, 1, 0)).all()
        assert health.numeric_problems({"embedding": out.embedding}) != ()
    keep = [i for i in range(q.shape[0]) if i != 1]
    clean = serve_fn(trained["carried"], q)
    for f in OOSResultFields:
        np.testing.assert_array_equal(to_np(getattr(got, f))[keep],
                                      to_np(getattr(clean, f))[keep])


def test_lsh_nan_query_fails_the_gate(trained, reference_planes):
    """On the LSH path a NaN query keeps its routed candidates at NaN
    distances, so its row is NaN and the serving gate fails it, as on the
    exact path.  The reference's rerank ranks those candidates after its
    +inf padding and serves the query an uncovered zero row (ROADMAP R6):
    the one row where the two packages differ."""
    q = _blobs(n_per=2, seed=3)
    bad = q.copy()
    bad[1, 0] = np.nan
    jidx = js.build_index(jnp.asarray(trained["pool"]), trained["jres"],
                          config=js.OOSConfig(knn_k=10, sigma=1.0, method="lsh"))
    carried = convert.serving_index(jidx, device=CPU)
    got, want = serve_fn(carried, bad), js.serve_fn(jidx, jnp.asarray(bad))
    assert np.isnan(to_np(got.embedding)[1]).all() and np.isnan(to_np(got.weight_sum)[1])
    assert (to_np(got.neighbors)[1] >= 0).all()
    assert health.numeric_problems({"embedding": got.embedding}) != ()
    assert float(want.weight_sum[1]) == 0.0 and (np.asarray(want.neighbors)[1] == -1).all()
    keep = [i for i in range(q.shape[0]) if i != 1]
    for f in OOSResultFields:
        np.testing.assert_array_equal(to_np(getattr(got, f))[keep],
                                      to_np(getattr(serve_fn(carried, q), f))[keep])


def _lsh_fixture():
    """Pool and queries clear of 0 on the reference's planes (seed 0, 16
    tables of 16 bits): six duplicated pool rows, a query equal to a pool
    row, a duplicated query, and a NaN query appended last."""
    pool = _clear_of_zero(_blobs(n_per=120, seed=21), 16, 16, 0)
    pool = np.concatenate([pool, pool[:6]])
    q = _clear_of_zero(_blobs(n_per=12, seed=22), 16, 16, 0)
    q = np.concatenate([q, pool[3:4], q[:1], np.full((1, D), np.nan, np.float32)])
    return pool, q


def test_sorted_and_routed_tables_match_reference():
    pool, q = _lsh_fixture()
    planes = jl.make_planes(D, 16, 16, 0)
    jc, jt = jl.hash_codes(jnp.asarray(pool), planes)
    qc, qt = jl.hash_codes(jnp.asarray(q), planes)
    assert np.isnan(np.asarray(qt)[:, -1]).all()
    jtab = jl.sorted_tables(jc, jt)
    ttab = tl.sorted_tables(torch.as_tensor(np.array(jc)), torch.as_tensor(np.array(jt)))
    for name in ("order", "codes", "ties"):
        np.testing.assert_array_equal(np.asarray(getattr(jtab, name)),
                                      to_np(getattr(ttab, name)), err_msg=name)
    assert ttab.order.dtype == torch.int32
    for win, rows in ((60, None), (7, np.arange(q.shape[0], dtype=np.int32)), (1000, None)):
        want = jl.routed_candidates(jtab, qc, qt, win=win,
                                    query_rows=None if rows is None else jnp.asarray(rows))
        got = tl.routed_candidates(ttab, torch.as_tensor(np.array(qc)),
                                   torch.as_tensor(np.array(qt)), win=win,
                                   query_rows=None if rows is None else torch.as_tensor(rows))
        np.testing.assert_array_equal(np.asarray(want), to_np(got))
        assert got.dtype == torch.int32


def test_oos_lsh_matches_reference(reference_planes):
    """With the reference's planes, the port hashes the pool and the queries
    to the reference's codes, builds its tables and serves the reference's
    neighbours, persisted or rehashed."""
    pool, q = _lsh_fixture()
    q = q[:-1]  # the NaN query has no neighbours to compare
    jres = JPipeline(n_clusters=K).run(jnp.asarray(pool), jax.random.PRNGKey(0))
    cfg = dict(knn_k=10, sigma=1.0, method="lsh")
    jidx = js.build_index(jnp.asarray(pool), jres, config=js.OOSConfig(**cfg))
    tidx = build_index(pool, _host_result(jres), config=OOSConfig(**cfg), device=CPU)
    for name in ("order", "codes"):
        np.testing.assert_array_equal(np.asarray(getattr(jidx.lsh_tables, name)),
                                      to_np(getattr(tidx.lsh_tables, name)))
    np.testing.assert_allclose(np.asarray(jidx.lsh_tables.ties), to_np(tidx.lsh_tables.ties),
                               **CLOSE)
    _assert_same_rows(js.serve_fn(jidx, jnp.asarray(q)), serve_fn(tidx, q))
    jold = dataclasses.replace(jidx, lsh_tables=None)
    _assert_same_rows(js.serve_fn(jold, jnp.asarray(q)),
                      serve_fn(dataclasses.replace(tidx, lsh_tables=None), q))


@pytest.mark.parametrize("method", ["exact", "lsh"])
def test_padded_batch_bitwise_invariance(trained, method):
    index = build_index(trained["pool"], trained["tres"],
                        config=OOSConfig(knn_k=10, method=method), device=CPU)
    B = 32
    q = _blobs(n_per=4, seed=3)  # 12 real rows
    other = _blobs(n_per=3, seed=5)  # 9 different co-batched rows
    b1 = np.zeros((B, D), np.float32)
    b1[:12] = q
    b2 = b1.copy()
    b2[12:21] = other
    o1, o2 = serve_fn(index, b1), serve_fn(index, b2)
    for f in OOSResultFields:
        np.testing.assert_array_equal(to_np(getattr(o1, f))[:12], to_np(getattr(o2, f))[:12],
                                      err_msg=f"OOSResult.{f} not pad-invariant")


@pytest.mark.parametrize("method", ["exact", "lsh"])
def test_oos_parity_with_full_reclustering(trained, method):
    """The acceptance gate: served labels of held-out points against a full
    pipeline run over pool + queries, ARI ≥ 0.95."""
    index = build_index(trained["pool"], trained["tres"],
                        config=OOSConfig(knn_k=10, method=method), device=CPU)
    queries = _blobs(n_per=40, seed=7)
    served = serve_fn(index, queries)
    full = trained["pipe"].run(np.concatenate([trained["pool"], queries]), _gen(1), device=CPU)
    ari = adjusted_rand_index(served.labels, full.labels[trained["pool"].shape[0]:])
    assert ari >= 0.95, f"OOS/full-reclustering ARI {ari:.3f} < 0.95"


def test_persistent_lsh_tables_match_rehash(trained):
    lsh_index = build_index(trained["pool"], trained["tres"],
                            config=OOSConfig(knn_k=10, method="lsh"), device=CPU)
    assert lsh_index.lsh_tables.order.shape == (16, trained["pool"].shape[0])
    queries = _blobs(n_per=40, seed=13)
    new = serve_fn(lsh_index, queries)
    old = serve_fn(dataclasses.replace(lsh_index, lsh_tables=None), queries)
    agree = float((new.labels == old.labels).float().mean())
    assert agree >= 0.99, f"persistent/rehash label agreement {agree:.3f}"
    ari = adjusted_rand_index(new.labels, serve_fn(trained["index"], queries).labels)
    assert ari >= 0.95, f"persistent-LSH/exact ARI {ari:.3f} < 0.95"


# ---------------------------------------------------------------------------
# The micro-batcher
# ---------------------------------------------------------------------------

def _padded(r, B):
    b = np.zeros((B, D), np.float32)
    b[:r.shape[0]] = r
    return b


def test_microbatcher_matches_direct_call(trained):
    B = 16
    index = trained["index"]
    reqs = [_blobs(n_per=2, seed=s) for s in range(5)]
    with MicroBatcher(functools.partial(serve_fn, index), D,
                      BatchConfig(batch_size=B, max_wait_s=0.003), device=CPU) as mb:
        outs = [f.result(timeout=30.0) for f in [mb.submit(r) for r in reqs]]
    for r, out in zip(reqs, outs):
        direct = serve_fn(index, _padded(r, B))
        assert isinstance(out, oos.OOSResult) and isinstance(out.labels, np.ndarray)
        for f in OOSResultFields:
            np.testing.assert_array_equal(getattr(out, f), to_np(getattr(direct, f))[:r.shape[0]])


def test_microbatcher_flush_isolation(trained):
    """A serving-fn exception fails the futures of that flush only; the
    thread survives and later submits succeed."""
    good = functools.partial(serve_fn, trained["index"])

    def bad(batch):
        raise RuntimeError("injected flush fault")

    with MicroBatcher(good, D, BatchConfig(batch_size=8, max_wait_s=0.003), device=CPU) as mb:
        mb.set_fn(bad)
        f1 = mb.submit(np.zeros((2, D), np.float32))
        with pytest.raises(RuntimeError, match="injected flush fault"):
            f1.result(timeout=30.0)
        mb.set_fn(good)
        out = mb.label(trained["pool"][:3], timeout=30.0)
        assert out.labels.shape == (3,)
        assert mb.stats.failed_batches == 1
    assert mb.stats.batches >= 1


def test_fault_injected_burst_isolates_poisoned_requests(trained):
    """NaN-poisoned requests fail the post-hoc gate while the clean requests
    in the same batch return their rows bitwise."""
    index = trained["index"]
    B = 32
    clean = [_blobs(n_per=1, seed=s) for s in range(4)]  # 3 rows each
    poisoned = [faults.poison_points(c, n_bad=2, seed=s) for s, c in enumerate(clean[:2])]
    with MicroBatcher(functools.partial(serve_fn, index), D,
                      BatchConfig(batch_size=B, max_wait_s=0.05), device=CPU) as mb:
        futs = [mb.submit(r) for r in clean + poisoned]
        outs = [f.result(timeout=30.0) for f in futs]
    assert mb.stats.batches == 1  # everything rode one padded batch
    for r, out in zip(clean, outs):
        assert health.numeric_problems({"embedding": out.embedding, "dist2": out.dist2}) == ()
        np.testing.assert_array_equal(
            out.labels, to_np(serve_fn(index, _padded(r, B)).labels)[:r.shape[0]])
    for out in outs[len(clean):]:
        assert health.numeric_problems({"embedding": out.embedding, "dist2": out.dist2})


def test_batcher_splits_oversized_request():
    d = 4

    def fn(batch):
        return {"double": batch * 2.0, "sum": batch.sum(dim=1)}

    with MicroBatcher(fn, d, BatchConfig(batch_size=8, max_wait_s=0.005), device=CPU) as mb:
        big = np.arange(150 * d, dtype=np.float32).reshape(150, d)
        out = mb.submit(big).result(timeout=60)
        np.testing.assert_array_equal(out["double"], big * 2.0)
        np.testing.assert_array_equal(out["sum"], big.sum(axis=1))
        assert mb.stats.split_requests == 1 and mb.stats.rows == 150


def test_batcher_split_failure_isolation():
    d = 4

    def picky_fn(batch):
        if torch.isnan(batch).any():
            raise ValueError("poisoned batch")
        return batch * 2.0

    with MicroBatcher(picky_fn, d, BatchConfig(batch_size=8, max_wait_s=0.005),
                      device=CPU) as mb:
        poisoned = np.ones((20, d), np.float32)
        poisoned[13, 2] = np.nan
        f_bad = mb.submit(poisoned)
        good = np.ones((3, d), np.float32)
        f_good = mb.submit(good)
        np.testing.assert_array_equal(f_good.result(timeout=60), good * 2.0)
        assert isinstance(f_bad.exception(timeout=60), ValueError)
        assert mb.stats.failed_batches >= 1


def test_batcher_rejects_bad_shapes_and_configs():
    with pytest.raises(ValueError, match="batch_size"):
        BatchConfig(batch_size=0)
    with pytest.raises(ValueError, match="max_wait_s"):
        BatchConfig(max_wait_s=0.0)
    with MicroBatcher(lambda b: b, 4, device=CPU) as mb:
        with pytest.raises(ValueError, match="feature_dim"):
            mb.submit(np.zeros((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.zeros((1, 4), np.float32))


# ---------------------------------------------------------------------------
# Mini-batch streaming k-means
# ---------------------------------------------------------------------------

def _unit_rows(n_per, k=K, ke=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.eye(k, ke).astype(np.float32)
    x = np.concatenate([centers[i] + 0.05 * rng.normal(size=(n_per, ke))
                        for i in range(k)]).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return rng.permutation(x)


def test_stream_matches_reference():
    h = _unit_rows(n_per=60, seed=4)
    js_state = js.stream_init(jnp.asarray(h[:K] + 0.1))
    ts_state = stream_init(torch.as_tensor(h[:K] + 0.1))
    for i in range(0, h.shape[0], 32):
        batch = _padded_rows(h[i:i + 32], 40)
        js_state, jlab = js.stream_update(js_state, jnp.asarray(batch), n_pad=40 - len(h[i:i + 32]))
        ts_state, tlab = stream_update(ts_state, torch.as_tensor(batch),
                                       n_pad=40 - len(h[i:i + 32]))
        np.testing.assert_array_equal(np.asarray(jlab), to_np(tlab))
    np.testing.assert_array_equal(np.asarray(js_state.counts), to_np(ts_state.counts))
    np.testing.assert_allclose(np.asarray(js_state.centroids), to_np(ts_state.centroids), **CLOSE)
    assert int(js_state.updates) == ts_state.updates
    np.testing.assert_allclose(float(js.drift(js_state)), float(drift(ts_state)), **CLOSE)


def _padded_rows(rows, B):
    out = np.zeros((B, rows.shape[1]), np.float32)
    out[:rows.shape[0]] = rows
    return out


def test_stream_minibatch_converges_to_lloyd_inertia():
    h = torch.as_tensor(_unit_rows(n_per=200))
    full = tkm.kmeans(h, tkm.KMeansConfig(k=K, max_iters=50), _gen())
    state = stream_init(h[:K] + 0.1)
    for i in range(0, h.shape[0], 32):
        state, _ = stream_update(state, h[i:i + 32])
    _, dmin = tkm.assign_ref(h, state.centroids)
    assert float(dmin.sum()) <= 1.10 * float(full.inertia) + 1e-6


def test_stream_update_pad_correction_is_exact():
    h = torch.as_tensor(_unit_rows(n_per=40, seed=2))
    padded = torch.zeros((32, h.shape[1]))
    padded[:24] = h[:24]
    s0 = stream_init(h[:K])
    s_plain, _ = stream_update(s0, h[:24])
    s_padded, _ = stream_update(s0, padded, n_pad=8)
    assert torch.equal(s_plain.counts, s_padded.counts)
    assert torch.equal(s_plain.centroids, s_padded.centroids)


def test_stream_drift_detection_and_rebase(trained):
    state = stream_from_index(trained["index"])
    assert float(drift(state)) == 0.0
    np.testing.assert_array_equal(
        to_np(state.counts), np.bincount(to_np(trained["index"].labels), minlength=K))
    rng = np.random.default_rng(5)
    shifted = rng.normal(size=(512, trained["index"].embedding.shape[1])).astype(np.float32) + 3.0
    shifted = torch.as_tensor(shifted / np.linalg.norm(shifted, axis=1, keepdims=True))
    for i in range(0, 512, 64):
        state, _ = stream_update(state, shifted[i:i + 64])
    assert bool(needs_refresh(state))
    state = rebase(state)
    assert float(drift(state)) == 0.0 and state.updates == 0


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def _toy(tag: float, lsh: bool = False):
    """(reference index, port index) with the same arrays."""
    n, d, ke = 12, 4, 3
    rng = np.random.default_rng(int(tag))
    h = rng.normal(size=(n, ke)).astype(np.float32)
    arrays = dict(points=rng.normal(size=(n, d)).astype(np.float32), embedding=h,
                  centroids=h[:K] + np.float32(tag),
                  labels=rng.integers(0, K, size=n).astype(np.int32))
    jtab = ttab = None
    if lsh:
        codes = rng.integers(0, 8, size=(2, n)).astype(np.int32)
        ties = rng.normal(size=(2, n)).astype(np.float32)
        jtab = jl.sorted_tables(jnp.asarray(codes), jnp.asarray(ties))
        ttab = tl.sorted_tables(torch.as_tensor(codes), torch.as_tensor(ties))
    jidx = js.ServingIndex(**{k: jnp.asarray(v) for k, v in arrays.items()},
                           config=js.OOSConfig(knn_k=3), lsh_tables=jtab)
    tidx = ServingIndex(**{k: torch.as_tensor(v) for k, v in arrays.items()},
                        config=OOSConfig(knn_k=3), lsh_tables=ttab)
    return jidx, tidx


def _assert_same_index(a, b):
    for f in ("points", "embedding", "centroids", "labels"):
        x, y = to_np(getattr(a, f)) if hasattr(getattr(a, f), "detach") \
            else np.asarray(getattr(a, f)), to_np(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.config.to_dict() == b.config.to_dict()
    assert (a.lsh_tables is None) == (b.lsh_tables is None)
    if a.lsh_tables is not None:
        for x, y in zip(a.lsh_tables, b.lsh_tables):
            np.testing.assert_array_equal(np.asarray(to_np(x)), to_np(y))
            assert np.asarray(to_np(x)).dtype == to_np(y).dtype


def test_registry_publish_load_rollback(tmp_path):
    reg = EmbeddingRegistry(str(tmp_path))
    assert (reg.publish(_toy(1.0)[1]), reg.publish(_toy(2.0)[1])) == (1, 2)
    assert reg.active_version() == 2
    ver, idx = reg.load(device=CPU)
    assert ver == 2
    _assert_same_index(_toy(2.0)[1], idx)
    assert idx.config == OOSConfig(knn_k=3)
    assert reg.rollback() == 1
    ver, idx = reg.load(device=CPU)
    assert ver == 1
    _assert_same_index(_toy(1.0)[1], idx)


def test_registry_gate_rejection_is_rollback(tmp_path):
    reg = EmbeddingRegistry(str(tmp_path))
    reg.publish(_toy(1.0)[1])
    bad = _toy(2.0)[1]
    c = bad.centroids.clone()
    c[0, 0] = float("nan")
    with pytest.raises(RegistryGateError, match="nonfinite_centroids"):
        reg.publish(dataclasses.replace(bad, centroids=c))
    assert reg.active_version() == 1 and reg.versions() == [1]
    _, idx = reg.load(device=CPU)
    assert bool(torch.isfinite(idx.centroids).all())


def test_registry_active_swap_is_atomic(tmp_path):
    reg = EmbeddingRegistry(str(tmp_path))
    reg.publish(_toy(1.0)[1])
    reg.publish(_toy(2.0)[1])
    assert not os.path.exists(os.path.join(str(tmp_path), "ACTIVE.json.tmp"))
    with open(os.path.join(str(tmp_path), "ACTIVE.json"), "w") as f:
        f.write("{corrupt")
    assert reg.active_version() == 2
    assert reg.load(device=CPU)[0] == 2


def test_registry_roundtrip_persists_lsh_tables(tmp_path, trained):
    lsh_index = build_index(trained["pool"], trained["tres"],
                            config=OOSConfig(knn_k=10, method="lsh"), device=CPU)
    reg = EmbeddingRegistry(str(tmp_path))
    reg.publish(lsh_index)
    _, loaded = reg.load(device=CPU)
    _assert_same_index(lsh_index, loaded)
    queries = _blobs(n_per=20, seed=17)
    assert torch.equal(serve_fn(loaded, queries).labels, serve_fn(lsh_index, queries).labels)


@pytest.mark.parametrize("lsh", [False, True])
def test_registry_disk_format_cross_loads(tmp_path, lsh):
    """A snapshot published by either package loads in the other, bitwise,
    with the config (every key of the reference's ``to_dict``) intact."""
    jidx, tidx = _toy(3.0, lsh=lsh)
    EmbeddingRegistry(str(tmp_path / "port")).publish(tidx)
    _, from_port = js.EmbeddingRegistry(str(tmp_path / "port")).load()
    _assert_same_index(tidx, from_port)
    assert from_port.config == js.OOSConfig(knn_k=3)
    js.EmbeddingRegistry(str(tmp_path / "ref")).publish(jidx)
    _, from_ref = EmbeddingRegistry(str(tmp_path / "ref")).load(device=CPU)
    _assert_same_index(tidx, from_ref)
    assert set(from_ref.config.to_dict()) == set(jidx.config.to_dict())


def test_carried_index_config_round_trips(trained):
    jcfg = js.OOSConfig(knn_k=7, method="lsh", impl="ref", block_q=128, interpret=True)
    tcfg = OOSConfig(**jcfg.to_dict())
    assert tcfg.to_dict() == jcfg.to_dict()
    assert js.OOSConfig(**tcfg.to_dict()) == jcfg
    g = trained["pipe"].graph
    assert OOSConfig.from_graph_config(g, method="lsh").to_dict() == \
        js.OOSConfig.from_graph_config(JPipeline(n_clusters=K).graph, method="lsh").to_dict()


# ---------------------------------------------------------------------------
# Health gates
# ---------------------------------------------------------------------------

def test_index_problems_match_reference():
    jidx, tidx = _toy(1.0)
    assert index_problems(tidx) == () == joos.index_problems(jidx)
    pts = tidx.points.clone()
    pts[0, 0] = float("nan")
    cases = [
        (dataclasses.replace(tidx, points=pts),
         dataclasses.replace(jidx, points=jidx.points.at[0, 0].set(jnp.nan))),
        (dataclasses.replace(tidx, labels=tidx.labels[:-1]),
         dataclasses.replace(jidx, labels=jidx.labels[:-1])),
        (dataclasses.replace(tidx, centroids=tidx.centroids[:, :2]),
         dataclasses.replace(jidx, centroids=jidx.centroids[:, :2])),
    ]
    for t, j in cases:
        assert index_problems(t) == joos.index_problems(j) != ()


def test_numeric_problems_match_reference_on_nested_trees():
    trees = [
        {"a": 1.0, "b": [2.0, 3.0]},
        {"m": {"x": np.float32("nan")}, "ok": "a string", "n": None},
        {"v": np.array([1.0, np.inf, np.nan]), "i": np.array([1, 2])},
        ({"deep": [(np.float64("inf"), 1)]}, [np.zeros(3), np.array([np.nan])]),
    ]
    for tree in trees:
        assert health.numeric_problems(tree, context="cell") == \
            jhealth.numeric_problems(tree, context="cell")
    # tensors count on their own device; integer tensors are not numbers to scan
    t = {"e": torch.tensor([[1.0, float("nan")], [2.0, 3.0]]), "l": torch.tensor([1, 2]),
         "s": torch.tensor(float("inf"))}
    assert health.numeric_problems(t) == jhealth.numeric_problems(
        {k: v.numpy() for k, v in t.items()})
    assert health.numeric_problems(t) == ("non-finite value at 'e' (1 entries)",
                                          "non-finite value at 's'")


def test_reports_to_dict_matches_reference():
    jout = JPipeline(n_clusters=K).run(jnp.asarray(_blobs(n_per=30)), jax.random.PRNGKey(0))
    tout = SpectralPipeline(n_clusters=K).run(_blobs(n_per=30), _gen(), device=CPU)
    jd, td = jhealth.reports_to_dict(jout.reports), health.reports_to_dict(tout.reports)
    assert [r["stage"] for r in td] == [r["stage"] for r in jd]
    assert [set(r) for r in td] == [set(r) for r in jd]


def test_blob_pool_needs_a_lanczos_block_of_k():
    """ROADMAP R3 on the serving launcher's pool (16 blobs × 8.0 in d = 16,
    n = 3,200): its kNN graph has 16 components, and single-vector Lanczos
    (the launcher's default) resolves fewer than 16 of the repeated zero
    eigenvalues — the reference and the port alike; a block of 16 (the
    serving cell's training, as the reference's ``BENCH_serving.json`` run)
    resolves all of them and recovers the blobs in both."""
    from repro.core.spectral import EigConfig as JEig
    from repro_torch.core.spectral import EigConfig

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 16)) * 8.0
    pool = np.concatenate([c + rng.normal(size=(200, 16)) for c in centers]).astype(np.float32)
    truth = np.repeat(np.arange(16), 200)
    for b in (1, 16):
        want = JPipeline(n_clusters=16, eig=JEig(block_size=b)).run(
            jnp.asarray(pool), jax.random.PRNGKey(0))
        got = SpectralPipeline(n_clusters=16, eig=EigConfig(block_size=b)).run(
            pool, _gen(), device=CPU)
        zeros = [int((np.asarray(to_np(r.eigenvalues)) < 1e-4).sum()) for r in (want, got)]
        aris = [adjusted_rand_index(to_np(r.labels), truth) for r in (want, got)]
        if b == 1:
            assert max(zeros) < 16 and max(aris) < 0.95, (zeros, aris)
        else:
            assert zeros == [16, 16] and min(aris) == 1.0, (zeros, aris)
