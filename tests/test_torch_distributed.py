"""Port parity: the sharded plan (``repro_torch.sparse.distributed``,
``repro_torch.core.distributed_pipeline``, ``ShardedCooOperator`` and
``Plan(device="sharded")``) against the reference.

The reference's mesh tests fail on this jax (ROADMAP R1), so the port's mesh
path — gloo ranks spawned by ``repro_torch.testing.dist``, S = 2 on a
``(2, 2)`` ``("data", "model")`` mesh over ``"data"`` and S = 4 on a 1-D
mesh — is held against the single-device reference and the single-device
port; the reference's sharded functions are called directly where they
still run here (the layout, the gspmd operator, the layout path).

Tolerances: kNN ids and distances bitwise across ring, gather and the
single-device port, ids equal and distances rtol 1e-5 against the
reference's BLAS-form distances; k-means labels and iterations equal,
centroids rtol 1e-5; labels as partitions (ARI ≥ 0.99) against the
reference's, whose random draws differ.
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import spectral as jsp
from repro.core.operator import ShardedCooOperator as JShardedOp
from repro.data.sbm import sbm_graph
from repro.kernels.knn_topk.ops import knn_topk as j_knn_topk
from repro.kernels.knn_topk.ops import knn_topk_rerank as j_rerank
from repro.kernels.lsh_candidates import ops as j_lsh
from repro.serve.metrics import adjusted_rand_index
from repro.sparse import distributed as jd
from repro_torch import convert
from repro_torch._device import cpu_generator
from repro_torch.core import spectral as tsp
from repro_torch.core.distributed_pipeline import merge_topk
from repro_torch.core.kmeans import KMeansConfig, kmeans
from repro_torch.core.operator import ShardedCooOperator
from repro_torch.kernels.knn_topk.ops import knn_topk
from repro_torch.kernels.lsh_candidates.ops import DEFAULT_N_TABLES
from repro_torch.sparse import distributed as tdist
from repro_torch.sparse.ops import spmm_coo
from repro_torch.testing import dist as td
from tests._parity import to_np

CPU = "cpu"
N, D, K, KC = 1024, 16, 10, 8  # the reference's ring tests' sizes


def _clustered(n=N, d=D, kc=KC, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(kc, d)) * 6
    return (centers[rng.integers(kc, size=n)] + rng.normal(size=(n, d))).astype(np.float32)


def _blobs(k=KC, n_per=128, d=D, seed=0):
    """Well-separated blobs: one graph component a blob, so the k zero
    eigenvalues fix the partition (found with a Lanczos block of k, R3)."""
    rng = np.random.default_rng(seed)
    centers = (rng.permutation(np.eye(k, d)) * 20.0).astype(np.float32)
    return np.concatenate([c + rng.normal(size=(n_per, d)) for c in centers]).astype(np.float32)


def _ties_and_nan():
    """A 4×4×4 lattice (every distance a small integer: ties everywhere)
    with one NaN coordinate (row 5)."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = g.astype(np.float32)
    x[5, 1] = np.nan
    return x


def _blobs5():
    rng = np.random.default_rng(0)
    centers = np.eye(4, 6).astype(np.float32) * 20.0
    x = np.concatenate([c + rng.normal(size=(64, 6)) for c in centers]).astype(np.float32)
    init = np.concatenate([centers, np.full((1, 6), 1e3, np.float32)])
    return x, init


# ---------------------------------------------------------------------------
# The layout, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 3, 4])
def test_partition_coo_by_rows_matches_reference(shards):
    coo, _ = sbm_graph(100, 4, 0.2, 0.01, seed=3)
    want = jd.partition_coo_by_rows(coo, shards)
    got = tdist.partition_coo_by_rows(convert.coo(coo, device=CPU), shards)
    assert got.shape == want.shape and got.rows_per_shard == want.rows_per_shard
    assert got.edges_per_shard == want.edges_per_shard and got.num_shards == shards
    for f in ("row_local", "col", "val"):
        np.testing.assert_array_equal(to_np(getattr(got, f)), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(to_np(tdist.global_rows(got)),
                                  np.asarray(jd.global_rows(want)))
    back = convert.sharded_coo(want, device=CPU)
    assert torch.equal(back.val, got.val) and torch.equal(back.row_local, got.row_local)


def test_sharded_operator_gspmd_matches_reference():
    coo, _ = sbm_graph(60, 4, 0.3, 0.02, seed=1)
    jsm = jd.partition_coo_by_rows(coo, 4)
    tsm = convert.sharded_coo(jsm, device=CPU)
    x = np.random.default_rng(0).normal(size=(jsm.shape[0], 3)).astype(np.float32)
    jop, top = JShardedOp(jsm), ShardedCooOperator(tsm)
    np.testing.assert_allclose(to_np(top.mv(torch.as_tensor(x[:, 0]))),
                               np.asarray(jop.mv(jnp.asarray(x[:, 0]))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(top.mm(torch.as_tensor(x))),
                               np.asarray(jop.mm(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert top.nnz == jop.nnz and top.shape == jop.shape
    with pytest.raises(ValueError, match="needs a mesh"):
        ShardedCooOperator(tsm, variant="shard_map")
    with pytest.raises(ValueError, match="variant"):
        ShardedCooOperator(tsm, variant="pjit")


@pytest.mark.parametrize("shards", [4, 3])
def test_layout_path_matches_single_device(shards):
    """A ShardedCOO input on one process: bitwise the port's COO run when no
    padding row is added (the buckets keep each row's edge order; the null
    edges add +0); with padding rows (3 blocks of 134 for 400 nodes) the
    solver's space grows by two isolated nodes, and the labels stay equal,
    the eigenvalues within 1e-5, and ARI ≥ 0.99 against the reference's
    run on its own layout."""
    coo, truth = sbm_graph(100, 4, 0.2, 0.01, seed=3)
    tw = convert.coo(coo, device=CPU)
    pipe = tsp.SpectralPipeline(n_clusters=4)
    single = pipe.run(tw, cpu_generator(0), device=CPU)
    sharded = pipe.run(tdist.partition_coo_by_rows(tw, shards), cpu_generator(0), device=CPU)
    n_pad = tdist.padded_rows(400, shards)
    assert sharded.labels.shape == (n_pad,)
    assert torch.equal(sharded.labels[:400], single.labels)
    if n_pad == 400:
        assert torch.equal(sharded.eigenvalues, single.eigenvalues)
    else:  # the reference's own layout path, run once (its compile is slow)
        want = jsp.SpectralPipeline(n_clusters=4).run(jd.partition_coo_by_rows(coo, shards),
                                                      jax.random.PRNGKey(0))
        assert adjusted_rand_index(np.asarray(want.labels)[:400],
                                   to_np(sharded.labels[:400])) >= 0.99
    np.testing.assert_allclose(to_np(sharded.eigenvalues), to_np(single.eigenvalues), atol=1e-5)
    assert adjusted_rand_index(truth, to_np(sharded.labels[:400])) >= 0.99


def test_merge_topk_is_lexicographic():
    """Ties go to the smaller id, NaN after +inf keeping its id, +inf comes
    back with id −1; the result is the same whatever the merge order."""
    d = torch.tensor([[1.0, 2.0, 2.0, math.inf, math.nan, 0.5]])
    i = torch.tensor([[7, 9, 3, -1, 4, 8]], dtype=torch.int32)
    want_d = [0.5, 1.0, 2.0, 2.0, math.inf, math.nan]
    want_i = [8, 7, 3, 9, -1, 4]
    empty_d, empty_i = torch.zeros((1, 0)), torch.zeros((1, 0), dtype=torch.int32)
    for perm in ([0, 1, 2, 3, 4, 5], [5, 4, 3, 2, 1, 0], [2, 4, 0, 5, 1, 3]):
        bd, bi = merge_topk(empty_d, empty_i, d[:, perm[:3]], i[:, perm[:3]], 6)
        bd, bi = merge_topk(bd, bi, d[:, perm[3:]], i[:, perm[3:]], 6)
        np.testing.assert_array_equal(to_np(bd)[0], want_d)
        assert to_np(bi)[0].tolist() == want_i
    bd, bi = merge_topk(empty_d, empty_i, d, i, 3)
    assert to_np(bi)[0].tolist() == [8, 7, 3]


# ---------------------------------------------------------------------------
# The mesh path on gloo ranks
# ---------------------------------------------------------------------------

MESHES = {"S2-mesh2x2": (4, ((2, 2), ("data", "model"))), "S4": (4, ((4,), ("data",)))}


def _knn(x, **kw):
    return ("knn_rank", dict(x=x, knn=dict(k=kw.pop("k", K), **kw)))


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    """One spawn of the mesh's ranks running every task below; the results
    of the ranks at model coordinate 0, in data-coordinate order."""
    world, mesh = MESHES[request.param]
    x, lattice = _clustered(), _ties_and_nan()
    xk, init = _blobs5()
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(256, 6)).astype(np.float32)
    planes = np.asarray(j_lsh.make_planes(D, DEFAULT_N_TABLES, j_lsh.DEFAULT_N_BITS, 0))
    coo, _ = sbm_graph(64, 4, 0.3, 0.02, seed=3)
    graph = dict(row=np.asarray(coo.row), col=np.asarray(coo.col), val=np.asarray(coo.val),
                 n=coo.shape[0])
    cheb = tsp.SpectralPipeline(n_clusters=4, eig=tsp.EigConfig(solver="chebyshev"),
                                plan=tsp.Plan(device="sharded", variant="shard_map"))
    lanczos = tsp.SpectralPipeline(n_clusters=4, plan=tsp.Plan(device="sharded"))

    def pipe(graph=None, eig=None, **kw):
        return tsp.SpectralPipeline(n_clusters=KC, graph=tsp.GraphConfig(**(graph or {})),
                                    eig=tsp.EigConfig(**(eig or {})),
                                    plan=tsp.Plan(device="sharded", variant="shard_map",
                                                  **kw)).to_dict()

    blobs = _blobs()
    e2e = dict(graph=dict(sigma=2.0), eig=dict(block_size=KC))

    tasks = {
        "gather": _knn(x), "ring": _knn(x, exchange="ring"),
        "ring_lsh": _knn(x, exchange="ring", method="lsh"),
        "ties_gather": _knn(lattice, k=12), "ties_ring": _knn(lattice, k=12, exchange="ring"),
        "kmeans": ("kmeans_rank", dict(x=emb, cfg=dict(k=5, max_iters=30))),
        "reseed": ("kmeans_rank", dict(x=xk, init=init,
                                       cfg=dict(k=5, max_iters=30, empty="reseed_farthest"))),
        "operator": ("operator_rank", dict(graph=graph, x=emb[:, :3])),
        "e2e_gather": ("pipeline_rank", dict(x=blobs, pipeline=pipe(**e2e))),
        "e2e_flipped": ("pipeline_rank", dict(x=blobs, pipeline=pipe(**e2e),
                                              flip_off_home=True)),
        "e2e_ring": ("pipeline_rank", dict(x=blobs, pipeline=pipe(stage1_exchange="ring", **e2e))),
        "e2e_lsh_gather": ("pipeline_rank", dict(x=x, pipeline=pipe(graph=dict(method="lsh")))),
        "e2e_lsh_ring": ("pipeline_rank", dict(x=x, pipeline=pipe(graph=dict(method="lsh"),
                                                                  stage1_exchange="ring"))),
        "cheb": ("pipeline_rank", dict(graph=graph, pipeline=cheb.to_dict())),
        "graph_whole": ("pipeline_rank", dict(graph=graph, pipeline=lanczos.to_dict())),
        "graph_bucket": ("pipeline_rank", dict(graph=graph, pipeline=lanczos.to_dict(),
                                               own_bucket=True)),
        "gather_lsh_planes": ("knn_rank", dict(x=x, planes=planes,
                                               knn=dict(k=K, method="lsh"))),
    }
    for _, spec in tasks.values():
        spec["mesh"] = mesh
    outs = td.run_ranks(td.tasks_rank, world, list(tasks.values()),
                        tmpdir=str(tmp_path_factory.mktemp("ranks")), timeout=60.0,
                        join_timeout=180.0)
    shards = mesh[0][0]
    lead = outs[:: world // shards]  # model coordinate 0 of each data coordinate
    res = {name: [o[j] for o in lead] for j, name in enumerate(tasks)}
    res["_all"] = {name: [o[j] for o in outs] for j, name in enumerate(tasks)}
    res["_S"], res["_inputs"] = shards, dict(x=x, lattice=lattice, emb=emb, xk=xk, init=init,
                                             planes=planes, coo=coo, blobs=blobs)
    return res


def _rows(blocks, key):
    assert [b["coord"] for b in blocks] == list(range(len(blocks)))
    return np.concatenate([b[key] for b in blocks])


def test_ring_exact_bitwise_gather_and_single_device(ranks):
    x = ranks["_inputs"]["x"]
    sd, si = knn_topk(torch.as_tensor(x), K)
    for mode in ("gather", "ring"):
        d, i = _rows(ranks[mode], "dist"), _rows(ranks[mode], "idx")
        np.testing.assert_array_equal(i, to_np(si))
        assert (d.view(np.uint32) == to_np(sd).view(np.uint32)).all(), mode
    # against the reference's BLAS-form distances: ids equal up to near-ties
    # (a differing id is as near, float64 rtol 1e-5, as the reference's)
    # (its ‖q‖² + ‖c‖² − 2q·c cancels: fp32 error ~ u·(‖q‖² + ‖c‖²))
    jdist, jidx = (np.asarray(a) for a in j_knn_topk(jnp.asarray(x), K))
    scale = 2 * float((x.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(to_np(sd), jdist, rtol=0, atol=1e-6 * scale)
    rows, slots = np.nonzero(to_np(si) != jidx)
    assert rows.size <= 8
    x64 = x.astype(np.float64)
    d_got = ((x64[rows] - x64[to_np(si)[rows, slots]]) ** 2).sum(1)
    d_want = ((x64[rows] - x64[jidx[rows, slots]]) ** 2).sum(1)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-5)


def test_ring_merge_on_ties_and_a_nan_row(ranks):
    """The lattice's tied distances and a NaN point: ring = gather = the
    single-device port, bitwise, the NaN query's row included (+inf for
    itself first, then NaN distances at the lowest ids)."""
    lat = ranks["_inputs"]["lattice"]
    sd, si = knn_topk(torch.as_tensor(lat), 12)
    for mode in ("ties_gather", "ties_ring"):
        d, i = _rows(ranks[mode], "dist"), _rows(ranks[mode], "idx")
        np.testing.assert_array_equal(i, to_np(si))
        assert (d.view(np.uint32) == to_np(sd).view(np.uint32)).all(), mode
    assert np.isinf(to_np(sd)[5, 0]) and np.isnan(to_np(sd)[5, 1:]).all()
    assert to_np(si)[5, 1:].tolist() == [0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11]


def test_ring_lsh_recall_and_e2e_ari(ranks):
    """The reference's gates: ring-LSH recall@k ≥ 0.95 against exact
    neighbours, and ring-LSH labels at least 0.99× gather-LSH's ARI
    against the exact single-device labels."""
    x = ranks["_inputs"]["x"]
    _, i_ref = knn_topk(torch.as_tensor(x), K)
    i_r = _rows(ranks["ring_lsh"], "idx")
    hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
               for a, b in zip(i_r, to_np(i_ref)))
    assert hits / (to_np(i_ref) >= 0).sum() >= 0.95
    single = tsp.SpectralPipeline(n_clusters=KC).run(x, cpu_generator(0), device=CPU)
    aris = {m: adjusted_rand_index(ranks[f"e2e_lsh_{m}"][0]["labels"], to_np(single.labels))
            for m in ("gather", "ring")}
    assert aris["ring"] >= 0.99 * aris["gather"], aris


def test_gather_lsh_matches_reference_with_its_planes(ranks):
    x = ranks["_inputs"]["x"]
    xj = jnp.asarray(x)
    cand = j_lsh.lsh_candidates(xj, m=j_lsh.default_candidates(K))
    jdist, jidx = j_rerank(xj, cand, K)
    blocks = ranks["gather_lsh_planes"]
    np.testing.assert_array_equal(_rows(blocks, "idx"), np.asarray(jidx))
    scale = 2 * float((x.astype(np.float64) ** 2).sum(1).max())  # ‖q‖² + ‖c‖² − 2q·c
    np.testing.assert_allclose(_rows(blocks, "dist"), np.asarray(jdist), rtol=0,
                               atol=1e-6 * scale)


def test_collective_bytes_follow_the_reference_model(ranks):
    S = ranks["_S"]
    nl = N // S
    payload = (S - 1) * nl * D * 4
    assert ranks["gather"][0]["bytes"] == {"all_gather": payload, "total": payload}
    assert ranks["ring"][0]["bytes"] == {"ppermute": payload, "total": payload}
    tables = (S - 1) * 3 * DEFAULT_N_TABLES * nl * 4
    assert ranks["ring_lsh"][0]["bytes"]["ppermute"] == payload + tables
    assert ranks["ring_lsh"][0]["calls"]["all_gather"] == 0
    assert tdist.ring_perm(S) == jd.ring_perm(S)


def test_kmeans_sharded_one_allreduce_per_iteration(ranks):
    """Labels, iterations and centroids of the single-device run (rtol 1e-5),
    one all-reduce an iteration plus one for the inertia; the reseed config
    revives the far centroid with one more all-reduce an iteration."""
    emb = torch.as_tensor(ranks["_inputs"]["emb"])
    want = kmeans(emb, KMeansConfig(k=5, max_iters=30), cpu_generator(0))
    for got in ranks["_all"]["kmeans"]:
        np.testing.assert_array_equal(got["labels"], to_np(want.labels))
        assert got["iterations"] == want.iterations
        np.testing.assert_allclose(got["centroids"], to_np(want.centroids), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["inertia"], float(want.inertia), rtol=1e-5)
        assert got["calls"]["psum"] == want.iterations + 1
        assert got["calls"]["broadcast"] == 0
    xk, init = (torch.as_tensor(a) for a in (ranks["_inputs"]["xk"], ranks["_inputs"]["init"]))
    want = kmeans(xk, KMeansConfig(k=5, max_iters=30, empty="reseed_farthest"),
                  init_centroids=init)
    got = ranks["reseed"][0]
    np.testing.assert_array_equal(got["labels"], to_np(want.labels))
    np.testing.assert_allclose(got["centroids"], to_np(want.centroids), rtol=1e-5, atol=1e-6)
    assert np.unique(got["labels"]).size == 5
    assert got["calls"]["psum"] == 2 * got["iterations"] + 1


def test_sharded_operator_on_the_mesh(ranks):
    coo = ranks["_inputs"]["coo"]
    x = torch.as_tensor(ranks["_inputs"]["emb"][:, :3])
    want = spmm_coo(convert.coo(coo, device=CPU), x)
    for got in ranks["_all"]["operator"]:
        np.testing.assert_allclose(got["mm"], to_np(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["mm_bucket"], got["mm"])
        np.testing.assert_allclose(got["mv"], to_np(want[:, 0]), rtol=1e-6, atol=1e-6)
        assert got["calls"]["all_gather"] == 2  # one a product


@pytest.fixture(scope="module")
def single_blobs():
    """The single-device port's and the reference's runs on the blobs, once."""
    x = _blobs()
    single = tsp.SpectralPipeline(n_clusters=KC, graph=tsp.GraphConfig(sigma=2.0),
                                  eig=tsp.EigConfig(block_size=KC)).run(
        x, cpu_generator(0), device=CPU)
    want = jsp.SpectralPipeline(n_clusters=KC, graph=jsp.GraphConfig(sigma=2.0),
                                eig=jsp.EigConfig(block_size=KC)).run(
        jnp.asarray(x), jax.random.PRNGKey(0))
    return single, want


def test_sharded_points_pipeline_matches_single_device(ranks, single_blobs):
    """The raw-points sharded plan, gather and ring: labels bitwise the
    single-device port's on every rank (eigenvalues within 1e-6), ARI ≥ 0.99
    against the reference's single-device labels."""
    single, want = single_blobs
    for mode in ("e2e_gather", "e2e_ring"):
        for got in ranks["_all"][mode]:
            np.testing.assert_array_equal(got["labels"], to_np(single.labels))
            # the ranks run one thread each, so their GEMMs round differently
            np.testing.assert_allclose(got["eigenvalues"], to_np(single.eigenvalues), atol=1e-6)
        assert adjusted_rand_index(got["labels"], np.asarray(want.labels)) >= 0.99


def test_ranks_leave_stage2_with_one_embedding(ranks, single_blobs):
    """Every rank but coordinate 0 has its eigensolver return the last
    eigenvector negated (the card's rounding can flip a sign on one rank
    only): after Stage 2 every rank holds coordinate 0's embedding and
    eigenvalues, bitwise, through two broadcasts, and the labels are the
    single-device port's."""
    single, _ = single_blobs
    for mode in ("e2e_gather", "e2e_flipped"):
        runs = ranks["_all"][mode]
        for got in runs:
            np.testing.assert_array_equal(got["embedding"], runs[0]["embedding"])
            assert (got["eigenvalues"].view(np.uint32)
                    == runs[0]["eigenvalues"].view(np.uint32)).all(), mode
            np.testing.assert_array_equal(got["labels"], to_np(single.labels))
            assert got["calls"]["broadcast"] == 2


def test_sharded_chebyshev_matches_single(ranks):
    """The reference's ``test_sharded_chebyshev_matches_single`` on the mesh
    (shard_map): labels equal, eigenvalues within 1e-5."""
    coo = ranks["_inputs"]["coo"]
    single = tsp.SpectralPipeline(n_clusters=4, eig=tsp.EigConfig(solver="chebyshev")).run(
        convert.coo(coo, device=CPU), cpu_generator(0), device=CPU)
    got = ranks["cheb"][0]
    np.testing.assert_array_equal(got["labels"], to_np(single.labels))
    np.testing.assert_allclose(got["eigenvalues"], to_np(single.eigenvalues), atol=1e-5)
    assert got["calls"]["all_gather"] > 0 and got["calls"]["psum"] > 0  # shard_map Stage 3


def test_a_rank_handed_only_its_own_bucket_runs_the_whole_layouts_pipeline(ranks):
    """Each rank handed only its own [E] bucket of the graph (as the dry-run
    cells hand it its local shard): labels, embedding and eigenvalues
    bitwise the run on the whole [S·E] layout, on every rank."""
    for got, want in zip(ranks["_all"]["graph_bucket"], ranks["_all"]["graph_whole"]):
        for key in ("labels", "embedding", "eigenvalues"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["calls"] == want["calls"]


def test_normalize_sharded_on_each_ranks_bucket_is_its_slice():
    """``global_rows`` and ``normalize_sharded`` on one rank's [E] bucket,
    the shard taken from the axis: bitwise that rank's slice of the
    whole-layout result; without the axis a bucket is refused."""
    coo, _ = sbm_graph(50, 4, 0.3, 0.02, seed=5)
    shards = 4
    sm = tdist.partition_coo_by_rows(convert.coo(coo, device=CPU), shards)
    deg = tdist.spmv_gspmd(sm, torch.ones(sm.shape[0]))
    whole_rows, whole = tdist.global_rows(sm), tdist.normalize_sharded(sm, deg)
    E = sm.edges_per_shard
    for r in range(shards):
        rl, c, v = sm.bucket(r)
        one = dataclasses.replace(sm, row_local=rl, col=c, val=v)
        ax = tdist.Axis(group=None, size=shards, rank=r)
        assert torch.equal(tdist.global_rows(one, ax), whole_rows[r * E:(r + 1) * E])
        got = tdist.normalize_sharded(one, deg, ax)
        assert torch.equal(got.val, whole.val[r * E:(r + 1) * E])
        assert got.row_local is rl and got.col is c
    with pytest.raises(ValueError, match="pass the mesh axis"):
        tdist.global_rows(one)


def test_plan_needs_a_mesh_and_divisible_rows():
    pipe = tsp.SpectralPipeline(n_clusters=2, plan=tsp.Plan(device="sharded"))
    x = _clustered(n=40, d=3, kc=2)
    with pytest.raises(ValueError, match="needs a mesh"):
        pipe.run(x, cpu_generator(0), device=CPU)
    with pytest.raises(ValueError, match="match feature rows"):
        pipe.run(x, cpu_generator(0), points=x[:10], device=CPU)
    plan = tsp.Plan(device="sharded", variant="shard_map", axis=("data",),
                    stage1_exchange="ring", gather_dtype=torch.bfloat16)
    assert tsp.Plan.from_dict(plan.to_dict()) == plan
    assert plan.to_dict() == jsp.Plan(device="sharded", variant="shard_map", axis=("data",),
                                      stage1_exchange="ring",
                                      gather_dtype="bfloat16").to_dict()
