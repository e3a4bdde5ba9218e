"""Port parity: the whole pipeline — ``repro_torch``'s ``SpectralPipeline``
against the reference's on the same inputs, its JSON config, and reference
state carried across with :mod:`repro_torch.convert`.

Tolerances: labels reach ARI ≥ 0.99 against the reference's (the two
packages draw their random start blocks and k-means++ seeds from different
generators, so labels are compared as partitions, not ids); Laplacian
eigenvalues within 1e-4 (both solve to the pipeline's tol in fp32).
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import spectral as jsp
from repro.core.health import HealthConfig as JHealth
from repro.core.reduce import SparsifyConfig as JSparsify
from repro.data.pointcloud import dti_like_pointcloud
from repro.data.sbm import sbm_graph
from repro_torch import convert
from repro_torch.core import spectral as tsp
from repro_torch.core.health import PipelineError
from repro.serve.metrics import adjusted_rand_index
from repro_torch.serve.metrics import adjusted_rand_index as t_ari
from tests._parity import to_np

CPU = "cpu"


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _both(jpipe, data, points=None, seed=0):
    tpipe = convert.pipeline(json.dumps(jpipe.to_dict()))
    kw = {} if points is None else dict(points=jnp.asarray(points))
    want = jpipe.run(data if not isinstance(data, np.ndarray) else jnp.asarray(data),
                     jax.random.PRNGKey(seed), **kw)
    tdata = data if isinstance(data, np.ndarray) else convert.coo(data, device=CPU)
    got = tpipe.run(tdata, _gen(seed), device=CPU,
                    **({} if points is None else dict(points=points)))
    return want, got


@pytest.mark.parametrize("block_size,representation", [(1, "coo"), (4, "blockell")])
def test_sbm_pipeline_matches_reference(block_size, representation):
    w, truth = sbm_graph(60, 4, 0.3, 0.02, seed=4)
    jpipe = jsp.SpectralPipeline(
        n_clusters=4, eig=jsp.EigConfig(block_size=block_size, representation=representation))
    want, got = _both(jpipe, w)
    assert adjusted_rand_index(np.asarray(want.labels), got.labels) >= 0.99
    assert adjusted_rand_index(truth, got.labels) >= 0.99
    np.testing.assert_allclose(np.asarray(want.eigenvalues), to_np(got.eigenvalues), atol=1e-4)
    assert [r.stage for r in got.reports] == ["prepare", "embed", "cluster"]


def test_dti_pointcloud_pipeline_matches_reference():
    """The DTI workflow at a small size: spatial kNN on lattice positions,
    cross-correlation weights from profiles, block Lanczos on BlockELL."""
    pos, prof, _, region = dti_like_pointcloud(512, 16, 4, neighbors="none", seed=1)
    jpipe = jsp.SpectralPipeline(
        n_clusters=4, graph=jsp.GraphConfig(knn_k=8, measure="cross_correlation"),
        eig=jsp.EigConfig(tol=1e-4, block_size=4, representation="blockell"))
    want, got = _both(jpipe, prof, points=pos)
    assert adjusted_rand_index(np.asarray(want.labels), got.labels) >= 0.99
    np.testing.assert_allclose(np.asarray(want.eigenvalues), to_np(got.eigenvalues), atol=1e-4)


def test_quickstart_blobs_from_points():
    """Gaussian blobs → exp_decay kNN graph → embed → k-means."""
    rng = np.random.default_rng(6)
    centers = np.array([[0, 0], [6, 0], [0, 6]], np.float32)
    x = (centers[np.repeat(np.arange(3), 100)]
         + rng.normal(size=(300, 2)).astype(np.float32) * 0.6)
    jpipe = jsp.SpectralPipeline(n_clusters=3, graph=jsp.GraphConfig(knn_k=10, sigma=1.0))
    want, got = _both(jpipe, x)
    assert adjusted_rand_index(np.asarray(want.labels), got.labels) >= 0.99
    assert adjusted_rand_index(np.repeat(np.arange(3), 100), got.labels) >= 0.99


def test_from_dict_accepts_reference_json():
    cfgs = [
        jsp.SpectralPipeline(n_clusters=5),
        jsp.SpectralPipeline(
            n_clusters=7, graph=jsp.GraphConfig(knn_k=12, measure="cosine", eps=2.5),
            eig=jsp.EigConfig(block_size=4, representation="blockell", drop_first=True),
            kmeans=jsp.KMeansConfig(max_iters=30, empty="reseed_farthest"),
            plan=jsp.Plan(device="sharded", variant="shard_map", gather_dtype="bfloat16"),
            stages=("prepare", "sparsify", "embed", "cluster"),
            sparsify=JSparsify(target_nnz_ratio=0.5), health=JHealth(max_attempts=2)),
    ]
    for jp in cfgs:
        text = json.dumps(jp.to_dict())
        tp = convert.pipeline(text)
        assert tp.to_dict() == json.loads(text)
        assert tsp.SpectralPipeline.from_dict(tp.to_dict()) == tp


def test_reference_state_carried_across():
    """The reference's Stage-1 state into the port's embed, and the
    reference's embedding into the port's cluster."""
    w, truth = sbm_graph(50, 3, 0.35, 0.02, seed=8)
    jpipe = jsp.SpectralPipeline(n_clusters=3)
    jg = jpipe.prepare(w)
    jemb = jpipe.embed(jg, jax.random.PRNGKey(1))
    tpipe = convert.pipeline(jpipe.to_dict())
    temb = tpipe.embed(convert.graph_state(jg, device=CPU), _gen(1), device=CPU)
    np.testing.assert_allclose(np.asarray(jemb.eigenvalues), to_np(temb.eigenvalues), atol=1e-4)
    jres = jpipe.cluster(jemb, jax.random.PRNGKey(2))
    tres = tpipe.cluster(convert.embed_state(jemb, device=CPU), _gen(2), device=CPU)
    assert adjusted_rand_index(np.asarray(jres.labels), tres.labels) >= 0.99
    assert adjusted_rand_index(truth, tres.labels) >= 0.99


def test_escalation_ladders_and_guards():
    w, _ = sbm_graph(40, 3, 0.3, 0.05, seed=9)
    pipe = tsp.SpectralPipeline(
        n_clusters=3, eig=tsp.EigConfig(tol=1e-12, max_restarts=1, basis_m=8))
    out = pipe.run(convert.coo(w, device=CPU), _gen(), device=CPU)
    embed = out.reports[1]
    assert embed.attempts == 3 and embed.escalations[0].startswith("lanczos_widen")
    strict = tsp.SpectralPipeline(
        n_clusters=3, eig=tsp.EigConfig(tol=1e-12, max_restarts=1, basis_m=8, strict=True))
    with pytest.raises(PipelineError, match="unconverged"):
        strict.run(convert.coo(w, device=CPU), _gen(), device=CPU)
    bad = np.ones((20, 3), np.float32)
    bad[0, 0] = np.nan
    with pytest.raises(PipelineError, match="non-finite"):
        tsp.SpectralPipeline(n_clusters=2).run(bad, _gen(), device=CPU)
    with pytest.raises(PipelineError, match="distinct"):
        tsp.SpectralPipeline(n_clusters=3).run(np.zeros((20, 3), np.float32), _gen(),
                                               device=CPU)


@pytest.mark.parametrize("kw,item,done", [
    (dict(plan=tsp.Plan(device="sharded")), "A12", ()),
])
def test_unported_features_raise(kw, item, done):
    """Each feature that raised naming its ROADMAP item until it was ported
    now runs: the sharded plan (A12) on a row-partitioned graph, the layout
    path in one process, beside the reference's on its own layout (ARI ≥
    0.99, eigenvalues within 1e-4).  ``done`` marks stages as already run,
    to reach a later stage."""
    from repro.sparse.distributed import partition_coo_by_rows as j_partition
    from repro_torch.sparse.distributed import ShardedCOO, partition_coo_by_rows

    coo, truth = sbm_graph(60, 4, 0.3, 0.02, seed=2)
    pipe = tsp.SpectralPipeline(n_clusters=4, **kw)
    jpipe = jsp.SpectralPipeline.from_dict(pipe.to_dict())
    sm = partition_coo_by_rows(convert.coo(coo, device=CPU), 4)
    st = pipe.run_stages(tsp.PipelineState(input_graph=sm, provenance=done,
                                           gen_embed=_gen(1), gen_cluster=_gen(2),
                                           device=torch.device(CPU)))
    assert isinstance(st.graph.adj, ShardedCOO), item
    want = jpipe.run(j_partition(coo, 4), jax.random.PRNGKey(0))
    assert adjusted_rand_index(np.asarray(want.labels), to_np(st.result.labels)) >= 0.99
    assert adjusted_rand_index(truth, to_np(st.result.labels)) >= 0.99
    np.testing.assert_allclose(to_np(st.result.eigenvalues), np.asarray(want.eigenvalues),
                               atol=1e-4)


def _dup_rows():
    x = np.repeat(np.arange(4, dtype=np.float32)[:, None], 3, 1)
    return np.concatenate([x, x, x])  # 12 rows, 4 distinct


def _signed_zeros():
    x = np.array([[0.0, 1.0], [-0.0, 1.0], [2.0, 3.0], [2.0, -0.0], [2.0, 0.0]], np.float32)
    return x  # 5 rows, 3 distinct: np.unique(axis=0) counts -0.0 as 0.0


@pytest.mark.parametrize("x,k", [
    (np.array([[1.0, np.nan], [np.inf, 2.0], [3.0, 4.0]], np.float32), 2),
    (np.ones((3, 2), np.float32), 5),
    (_dup_rows(), 5),
    (_dup_rows(), 4),
    (_signed_zeros(), 4),
    (_signed_zeros(), 3),
])
def test_check_points_matches_reference(x, k):
    """The Stage-1 guard counts on the points' device: the reference's
    verdict and message, word for word, on NaN/Inf, too few rows, duplicate
    rows and signed zeros."""
    from repro.core import health as jh
    from repro.core.health import PipelineError as JPipelineError
    from repro_torch.core import health as th

    try:
        jh.check_points(jnp.asarray(x), k)
        want = None
    except JPipelineError as e:
        want = str(e)
    try:
        th.check_points(torch.as_tensor(x), k)
        got = None
    except PipelineError as e:
        got = str(e)
    assert got == want


def test_label_metric_matches_reference():
    rng = np.random.default_rng(11)
    for n, ka, kb in ((1, 1, 1), (50, 3, 4), (400, 12, 12)):
        a, b = rng.integers(0, ka, n), rng.integers(0, kb, n)
        b[: n // 2] = a[: n // 2]
        assert t_ari(torch.as_tensor(a), b) == adjusted_rand_index(a, b)


def test_health_signals_match_reference():
    from repro.core import health as jh
    from repro_torch.core import health as th

    val = np.array([0.5, np.nan, -1.0, 2.0, np.inf], np.float32)
    deg = np.array([1.0, 0.0, 3.0], np.float32)
    want = {k: int(v) for k, v in jh.graph_signals(jnp.asarray(val), jnp.asarray(deg)).items()}
    assert th.graph_signals(torch.as_tensor(val), torch.as_tensor(deg)) == want
    h = np.ones((4, 2), np.float32)
    h[1, 1] = np.nan
    res = np.array([1e-3, 2e-2], np.float32)
    jsig = jh.embedding_signals(jnp.asarray(h), jnp.asarray(res))
    tsig = th.embedding_signals(torch.as_tensor(h), torch.as_tensor(res))
    assert tsig["nonfinite_embedding"] == int(jsig["nonfinite_embedding"])
    assert tsig["residual_max"] == pytest.approx(float(jsig["residual_max"]))
    w, _ = sbm_graph(30, 2, 0.4, 0.05, seed=1)
    out = tsp.SpectralPipeline(n_clusters=2).run(convert.coo(w, device=CPU), _gen(), device=CPU)
    assert th.result_problems(out) == ()
    bad = out._replace(embedding=out.embedding * float("nan"))
    assert th.result_problems(bad)[0].startswith("non-finite embedding")
