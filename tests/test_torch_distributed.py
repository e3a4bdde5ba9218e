"""Port parity: the sharded plan (``repro_torch.sparse.distributed``,
``repro_torch.core.distributed_pipeline``, ``ShardedCooOperator`` and
``Plan(device="sharded")``) against the reference.

The reference's mesh tests fail on this jax (ROADMAP R1), so the port's mesh
path — gloo ranks spawned by ``repro_torch.testing.dist``, S = 2 on a
``(2, 2)`` ``("data", "model")`` mesh over ``"data"`` and S = 4 on a 1-D
mesh — is held against the single-device reference and the single-device
port; the reference's sharded functions are called directly where they
still run here (the layout, the gspmd operator, the layout path).

The mesh path keeps Stage 2's and Stage 3's dense state as each rank's row
block: every rank's operator inputs (the Krylov basis rows, the Chebyshev
block) and its embedding hold n/S rows, and the eigenvalues are bitwise
the same on every rank with no broadcast.  The operator follows the
reference's routes: a ShardedCOO keeps ``ShardedCooOperator`` whatever
``representation`` says, and a COO graph under ``"blockell"`` gets
``RowBlockEllOperator``, which ignores ``gather_dtype``.  A COO graph whose
n (4001) does not divide by the ranks is padded for Stage 2 and held
against the reference's single-device run, which is its sharded plan's
route for such a graph (``CooOperator``, then ``kmeans``).

Tolerances: kNN ids and distances bitwise across ring, gather and the
single-device port, ids equal and distances rtol 1e-5 against the
reference's BLAS-form distances; k-means labels and iterations equal,
centroids rtol 1e-5; eigenvalues within 1e-4 of the single-device port
and of the reference (both converge to tol 1e-5 in fp32); labels as
partitions (ARI ≥ 0.99) against the reference's, whose random draws
differ; the gathered embedding of a gapped SBM within 1e-4 of the
single-device port's up to column signs (the Lanczos tolerance over a
gap of 0.01).
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
from repro.sparse import formats as jf
from repro_torch import convert
from repro_torch._device import cpu_generator
from repro_torch.core import spectral as tsp
from repro_torch.core.distributed_pipeline import merge_topk
from repro_torch.core.kmeans import KMeansConfig, kmeans
from repro_torch.core import lanczos as tlz
from repro_torch.core.operator import CooOperator, ShardedCooOperator
from repro_torch.kernels.knn_topk.ops import knn_topk
from repro_torch.kernels.lsh_candidates.ops import DEFAULT_N_TABLES
from repro_torch.sparse import distributed as tdist
from repro_torch.sparse.formats import COO
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


def _cliques(n_per=16, blobs=4):
    """Disconnected cliques: the top eigenvalue of A_sym has multiplicity 4
    (found by a Krylov block of 4; at b = 1 both packages diverge, R3)."""
    rows, cols = [], []
    for b in range(blobs):
        idx = np.arange(b * n_per, (b + 1) * n_per)
        r, c = np.meshgrid(idx, idx, indexing="ij")
        keep = r != c
        rows.append(r[keep])
        cols.append(c[keep])
    r, c = np.concatenate(rows), np.concatenate(cols)
    return dict(row=r, col=c, val=np.ones(r.size, np.float32), n=n_per * blobs)


def _sbm():
    """A gapped SBM (top eigenvalues of A_sym 1, 0.8145, 0.8043, 0.7879,
    then 0.34): no near-ties among the four the pipeline keeps."""
    coo, _ = sbm_graph(64, 4, 0.3, 0.02, seed=3)
    return coo, dict(row=np.asarray(coo.row), col=np.asarray(coo.col), val=np.asarray(coo.val),
                     n=coo.shape[0])


def _isolated(n=32):
    """32 isolated nodes: the zero operator, whose every Krylov step breaks
    down exactly (w = 0), so each new basis direction is the careful path's
    random refill."""
    idx = np.arange(n)
    return dict(row=idx, col=idx, val=np.zeros(n, np.float32), n=n)


REFILL = dict(k=2, m=8, tol=1e-6, max_restarts=3)  # the reference's refill test's config
ISOLATED_PADDED = 31  # padded to 32 rows on S = 2 and on S = 4
QR_ROWS = (8, 64)  # [n, 4] blocks: 8 rows leave a rank fewer than 4 at S = 4


def _cheb_draws(n: int, k: int = 4, n_probes: int = 8):
    """The reference's three Chebyshev draws in ``run(w, PRNGKey(0))``: its
    embed key, split three ways (bounds start, probes, sketch of k + 8)."""
    kb, km_, ks = jax.random.split(jax.random.split(jax.random.PRNGKey(0), 3)[1], 3)
    return (np.array(jax.random.normal(kb, (n,), jnp.float32)),
            np.array(jax.random.rademacher(km_, (n, n_probes), jnp.float32)),
            np.array(jax.random.rademacher(ks, (n, k + 8), jnp.float32)))

# the row-distributed Stage 2: (graph, EigConfig, Plan.variant) of each task; the
# ell_* tasks hand the graph over as a COO (a ShardedCOO keeps its own operator)
STAGE2 = {"graph_whole": ("sbm", {}, "gspmd"),
          "graph_b4": ("sbm", {"block_size": 4}, "shard_map"),
          "cliques_b4": ("cliques", {"block_size": 4}, "shard_map"),
          "cheb": ("sbm", {"solver": "chebyshev"}, "shard_map"),
          "ell_b1": ("sbm", {"representation": "blockell"}, "shard_map"),
          "ell_b4": ("sbm", {"block_size": 4, "representation": "blockell"}, "gspmd")}
# the Chebyshev runs with the reference's draws put in
CHEB_REF = {"cheb_ref_draws": STAGE2["cheb"],
            "ell_cheb_ref_draws": ("sbm", {"solver": "chebyshev", "representation": "blockell"},
                                   "shard_map")}
ELL_BF16 = ("ell_b1", "ell_b4")  # rerun under gather_dtype="bfloat16"


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
def mesh_name(request) -> str:
    """The mesh of ``ranks`` and ``repairs``, which a test taking both sees
    alike."""
    return request.param


@pytest.fixture(scope="module")
def ranks(mesh_name, tmp_path_factory):
    """One spawn of the mesh's ranks running every task below; the results
    of the ranks at model coordinate 0, in data-coordinate order."""
    world, mesh = MESHES[mesh_name]
    x, lattice = _clustered(), _ties_and_nan()
    xk, init = _blobs5()
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(256, 6)).astype(np.float32)
    planes = np.asarray(j_lsh.make_planes(D, DEFAULT_N_TABLES, j_lsh.DEFAULT_N_BITS, 0))
    coo, graph = _sbm()
    graphs = {"sbm": graph, "cliques": _cliques()}
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
        "kmeans_random": ("kmeans_rank", dict(x=emb, cfg=dict(k=5, max_iters=30, init="random"))),
        "reseed": ("kmeans_rank", dict(x=xk, init=init,
                                       cfg=dict(k=5, max_iters=30, empty="reseed_farthest"))),
        "operator": ("operator_rank", dict(graph=graph, x=emb[:, :3])),
        "e2e_gather": ("pipeline_rank", dict(x=blobs, pipeline=pipe(**e2e))),
        "e2e_ring": ("pipeline_rank", dict(x=blobs, pipeline=pipe(stage1_exchange="ring", **e2e))),
        "e2e_lsh_gather": ("pipeline_rank", dict(x=x, pipeline=pipe(graph=dict(method="lsh")))),
        "e2e_lsh_ring": ("pipeline_rank", dict(x=x, pipeline=pipe(graph=dict(method="lsh"),
                                                                  stage1_exchange="ring"))),
        **{name: ("pipeline_rank", dict(graph=graphs[g], pipeline=_stage2_pipe(eig, variant),
                                        as_coo=name.startswith("ell")))
           for name, (g, eig, variant) in STAGE2.items()},
        **{name: ("pipeline_rank", dict(graph=graph, draws=_cheb_draws(graph["n"]),
                                        pipeline=_stage2_pipe(*cfg[1:]),
                                        as_coo=name.startswith("ell")))
           for name, cfg in CHEB_REF.items()},
        "ell_operator": ("ell_operator_rank", dict(graph=graph, x=emb[:, :4], prev=emb[:, 2:])),
        "e2e_ell": ("pipeline_rank", dict(x=blobs, pipeline=pipe(
            graph=dict(sigma=2.0), eig=dict(block_size=KC, representation="blockell")))),
        "e2e_coarsen": ("pipeline_rank", dict(x=blobs, pipeline=_coarsen_pipe(tsp).to_dict())),
        "graph_bucket": ("pipeline_rank", dict(graph=graph, pipeline=lanczos.to_dict(),
                                               own_bucket=True)),
        "checkpoint": ("checkpoint_rank", dict(graph=graph, pipeline=lanczos.to_dict(),
                                               dir=str(tmp_path_factory.mktemp("ckpt")))),
        "gather_lsh_planes": ("knn_rank", dict(x=x, planes=planes,
                                               knn=dict(k=K, method="lsh"))),
        **{f"refill_b{b}": ("eigsh_rank", dict(graph=_isolated(), cfg=dict(REFILL, block_size=b)))
           for b in (1, 2)},
        **{f"qr_{n}": ("qr_rank", dict(w=np.random.default_rng(n).normal(size=(n, 4))
                                       .astype(np.float32))) for n in QR_ROWS},
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


@pytest.fixture(scope="module")
def repairs(mesh_name, tmp_path_factory):
    """One spawn of the mesh's ranks (its own, beside ``ranks``) running the
    operator-route (P14), two-pass Stage 3 (A15) and padded-refill tasks;
    the results of the ranks at model coordinate 0, by task."""
    world, mesh = MESHES[mesh_name]
    _, graph = _sbm()
    emb = np.random.default_rng(3).normal(size=(256, 6)).astype(np.float32)
    tasks = {
        # P14: plans of the ranks fixture under gather_dtype="bfloat16"; the
        # ShardedCOO's bf16 products cannot reach tol 1e-5, so 1e-2 there
        **{f"{name}_bf16": ("pipeline_rank", dict(graph=graph, as_coo=True, pipeline=_stage2_pipe(
            STAGE2[name][1], STAGE2[name][2], gather_dtype="bfloat16"))) for name in ELL_BF16},
        **{f"sharded_{rep}_bf16": ("pipeline_rank", dict(graph=graph, pipeline=_stage2_pipe(
            {"representation": rep, "tol": 1e-2}, "shard_map", gather_dtype="bfloat16")))
           for rep in ("coo", "blockell")},
        "ell_operator_bf16": ("ell_operator_rank", dict(graph=graph, x=emb[:, :4],
                                                        prev=emb[:, 2:],
                                                        gather_dtype="bfloat16")),
        # A15: two-pass Stage 3 on the ranks' rows, beside the gathered route
        "two_pass": ("pipeline_rank", dict(graph=graph, gathered=True, pipeline=_stage2_pipe(
            {}, "gspmd", kmeans=dict(iter="two_pass")))),
        **{f"refill_b{b}_padded": ("eigsh_rank", dict(graph=_isolated(ISOLATED_PADDED),
                                                      cfg=dict(REFILL, block_size=b)))
           for b in (1, 2)},
    }
    for _, spec in tasks.values():
        spec["mesh"] = mesh
    outs = td.run_ranks(td.tasks_rank, world, list(tasks.values()),
                        tmpdir=str(tmp_path_factory.mktemp("repairs")), timeout=120.0,
                        join_timeout=600.0)
    shards = mesh[0][0]
    lead = outs[:: world // shards]  # model coordinate 0 of each data coordinate
    return {"_S": shards, **{name: [o[j] for o in lead] for j, name in enumerate(tasks)}}


def _stage2_pipe(eig: dict, variant: str, package=tsp, kmeans=None,
                 **plan) -> "dict | object":
    """The four-cluster pipeline of a STAGE2 task: the port's as the dict a
    rank loads, or the reference's (``package=jsp``) for one device."""
    pipe = package.SpectralPipeline(n_clusters=4, eig=package.EigConfig(**eig),
                                    kmeans=package.KMeansConfig(**(kmeans or {})),
                                    plan=package.Plan(device="sharded", variant=variant,
                                                      **plan))
    return pipe.to_dict() if package is tsp else dataclasses.replace(pipe,
                                                                     plan=package.Plan())


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
    """Each rank handed its own rows: labels, iterations and centroids of the
    single-device run (rtol 1e-5; the k-means++ seeds are the whole array's
    rows, picked without gathering it), one all-reduce an iteration plus one
    for the inertia, beside the seeding's k row fetches (one all-reduce of
    [d] each) and k − 1 all-gathers of the ranks' best (score, id) pairs,
    and random-row seeding's one fetch of [k, d]; the reseed config revives
    the far centroid with one more all-reduce an iteration."""
    emb = torch.as_tensor(ranks["_inputs"]["emb"])
    want = kmeans(emb, KMeansConfig(k=5, max_iters=30), cpu_generator(0))
    for got in ranks["_all"]["kmeans"]:
        np.testing.assert_array_equal(got["labels"], to_np(want.labels))
        assert got["iterations"] == want.iterations
        np.testing.assert_allclose(got["centroids"], to_np(want.centroids), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["inertia"], float(want.inertia), rtol=1e-5)
        assert got["calls"]["psum"] == want.iterations + 1 + 5
        assert got["calls"]["all_gather"] == 5 - 1 + 1  # the draws' best pairs, the labels
        assert got["calls"]["broadcast"] == 0
    # random rows: the k picks fetched in one all-reduce of [k, d]
    want = kmeans(emb, KMeansConfig(k=5, max_iters=30, init="random"), cpu_generator(0))
    for got in ranks["_all"]["kmeans_random"]:
        np.testing.assert_array_equal(got["labels"], to_np(want.labels))
        np.testing.assert_allclose(got["centroids"], to_np(want.centroids), rtol=1e-5, atol=1e-6)
        assert got["calls"]["psum"] == want.iterations + 1 + 1
    xk, init = (torch.as_tensor(a) for a in (ranks["_inputs"]["xk"], ranks["_inputs"]["init"]))
    want = kmeans(xk, KMeansConfig(k=5, max_iters=30, empty="reseed_farthest"),
                  init_centroids=init)
    got = ranks["reseed"][0]
    np.testing.assert_array_equal(got["labels"], to_np(want.labels))
    np.testing.assert_allclose(got["centroids"], to_np(want.centroids), rtol=1e-5, atol=1e-6)
    assert np.unique(got["labels"]).size == 5
    assert got["calls"]["psum"] == 2 * got["iterations"] + 1


def test_sharded_operator_on_the_mesh(ranks):
    """Row block in, row block out: each rank's products are its n/S rows
    of the whole products, one all-gather (of the input) a product; a
    column-major input block, gathered by columns, gives the same product."""
    coo = ranks["_inputs"]["coo"]
    x = torch.as_tensor(ranks["_inputs"]["emb"][:, :3])
    want = spmm_coo(convert.coo(coo, device=CPU), x)
    rps = coo.shape[0] // ranks["_S"]
    for got in ranks["_all"]["operator"]:
        assert (got["mv_rows"], got["mm_rows"], got["mm_bucket_rows"]) == \
            ((rps,), (rps, 3), (rps, 3))
        np.testing.assert_allclose(got["mm"], to_np(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["mm_bucket"], got["mm"])
        np.testing.assert_array_equal(got["mm_colmajor"], got["mm"])  # gathered by columns
        np.testing.assert_allclose(got["mv"], to_np(want[:, 0]), rtol=1e-6, atol=1e-6)
        assert got["calls"]["all_gather"] == 2  # one a product
        assert got["bytes"]["all_gather"] == (ranks["_S"] - 1) * rps * 4 * (1 + 3)


def test_blockell_on_the_mesh_maps_each_ranks_rows_through_the_ell_kernels(ranks, repairs,
                                                                           single_blobs):
    """``representation="blockell"`` on a mesh of S ranks: over a COO graph
    the operator is the rank's rows of BlockELL, whose ``mv``, ``mm`` (a
    column-major block too) and fused ``cheb_step`` map its n/S rows to its
    rows with one all-gather (of the input) a product, and the gathered
    products are the single-device BlockELL operator's bit for bit (each
    row laid out at the whole graph's width), under ``gather_dtype=
    "bfloat16"`` too (the operator ignores it, as the reference's
    ``BlockEllOperator`` does).  The same plan gives the graph partitioned
    into a ShardedCOO its ``ShardedCooOperator``, as the reference does
    (products within 1e-6).  The raw-points pipeline (a COO graph) runs it
    too: ARI ≥ 0.99 against the reference's labels, every rank the same
    labels and eigenvalues."""
    from repro_torch.core.operator import BlockEllOperator
    from repro_torch.sparse.formats import coo_to_csr, csr_to_blockell

    coo = ranks["_inputs"]["coo"]
    emb = torch.as_tensor(ranks["_inputs"]["emb"])
    x, prev = emb[:, :4], emb[:, 2:]
    whole = BlockEllOperator(csr_to_blockell(coo_to_csr(convert.coo(coo, device=CPU))))
    want = {"mv": whole.mv(x[:, 0]), "mm": whole.mm(x), "mm_colmajor": whole.mm(x),
            "cheb": whole.cheb_step(x, prev, 0.5, -0.25)}
    rps = coo.shape[0] // ranks["_S"]
    for task, runs in (("ell_operator", ranks["_all"]["ell_operator"]),
                       ("ell_operator_bf16", repairs["ell_operator_bf16"])):
        for got in runs:
            assert got["operator"] == "RowBlockEllOperator"
            assert got["operator_sharded"] == "ShardedCooOperator"
            for name, y in want.items():
                y = to_np(y)
                np.testing.assert_array_equal(got[name], y)
                assert got[f"{name}_rows"] == (rps,) + y.shape[1:]
                if name in ("mv", "mm"):
                    assert got[f"{name}_sharded_rows"] == (rps,) + y.shape[1:]
                    if task == "ell_operator":  # the bf16 plan's ShardedCOO casts its input
                        np.testing.assert_allclose(got[f"{name}_sharded"], y, rtol=1e-6,
                                                   atol=1e-6)
            assert got["calls"]["all_gather"] == 2  # one a product
            assert got["bytes"]["all_gather"] == (ranks["_S"] - 1) * rps * 4 * (1 + 4)
    _, ref = single_blobs
    runs = ranks["_all"]["e2e_ell"]
    for run in runs:
        assert run["operators"] == ["RowBlockEllOperator"]
        assert (run["eigenvalues"].view(np.uint32)
                == runs[0]["eigenvalues"].view(np.uint32)).all()
        np.testing.assert_array_equal(run["labels"], runs[0]["labels"])
    assert adjusted_rand_index(runs[0]["labels"], np.asarray(ref.labels)) >= 0.99


def test_a_sharded_coo_keeps_its_operator_whatever_the_representation(repairs):
    """P14: a ShardedCOO under ``representation="blockell"`` runs
    ``ShardedCooOperator`` on every rank, as the reference routes it at any
    world size, so under ``gather_dtype="bfloat16"`` its eigenvalues,
    embedding rows and labels are bitwise those of ``representation="coo"``."""
    for got, want in zip(repairs["sharded_blockell_bf16"], repairs["sharded_coo_bf16"]):
        assert got["operators"] == want["operators"] == ["ShardedCooOperator"]
        for key in ("eigenvalues", "embedding", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["calls"] == want["calls"]


@pytest.mark.parametrize("task", ELL_BF16)
def test_row_block_ell_ignores_gather_dtype(ranks, repairs, task):
    """P14: a COO graph under ``representation="blockell"`` runs
    ``RowBlockEllOperator``, which gathers its input at its own dtype, as
    the reference's ``BlockEllOperator`` ignores ``gather_dtype``: the
    eigenvalues and labels under ``gather_dtype="bfloat16"`` are bitwise
    those without it (which
    ``test_row_distributed_stage2_matches_one_device_and_the_reference``
    holds to the reference's single-device BlockELL run), and so are the
    bytes gathered."""
    for got, want in zip(repairs[f"{task}_bf16"], ranks[task]):  # both in coordinate order
        assert got["operators"] == want["operators"] == ["RowBlockEllOperator"]
        for key in ("eigenvalues", "embedding", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["bytes"] == want["bytes"]


def test_two_pass_stage3_runs_on_each_ranks_rows(repairs):
    """A15: ``KMeansConfig(iter="two_pass")`` on S ranks clusters each
    rank's rows: every rank the same labels, those of ``kmeans`` run on the
    embedding gathered whole from the same generator (the route that
    gathered it); Stage 3 all-reduces once an iteration, once for the
    inertia and k times for the k-means++ seeds, and all-gathers only the
    seeding's (score, id) pairs and the [n] int32 labels — never [n, k]."""
    S, k = repairs["_S"], 4
    runs = repairs["two_pass"]
    for got in runs:
        n = got["labels"].shape[0]
        np.testing.assert_array_equal(got["labels"], runs[0]["labels"])
        np.testing.assert_array_equal(got["labels"], got["gathered_labels"])
        stage3 = got["stage3"]
        assert stage3["calls"]["psum"] == got["kmeans_iterations"] + 1 + k
        assert stage3["calls"]["all_gather"] == k - 1 + 1
        assert stage3["bytes"]["all_gather"] == (S - 1) * ((k - 1) * 16 + (n // S) * 4)
        assert got["embedding"].shape == (n // S, k)


@pytest.mark.parametrize("block_size", [1, 2])
def test_careful_path_refills_are_zero_on_padding_rows(repairs, block_size):
    """A graph of 31 isolated nodes padded to 32 rows on S ranks: every
    random direction the careful path draws is zero on the padding row, so
    the eigenvectors are too, and their real rows are the single-device
    port's on the 31 nodes (1e-5, up to column signs): the padded draw's
    real rows carry the unpadded draw's bits."""
    w = _isolated(ISOLATED_PADDED)
    op = CooOperator(COO(torch.as_tensor(w["row"]).long(), torch.as_tensor(w["col"]).long(),
                         torch.as_tensor(w["val"]), (w["n"], w["n"])))
    want = to_np(tlz.eigsh(op, tlz.LanczosConfig(**REFILL, block_size=block_size),
                           generator=cpu_generator(0)).eigenvectors)
    blocks = repairs[f"refill_b{block_size}_padded"]
    u = np.concatenate([b["eigenvectors"] for b in blocks])
    assert u.shape[0] == 32 and all(b["refills"] > 0 for b in blocks)
    np.testing.assert_array_equal(u[ISOLATED_PADDED:], 0.0)
    u = u[:ISOLATED_PADDED]
    np.testing.assert_allclose(u.T @ u, np.eye(2), atol=1e-5)
    np.testing.assert_allclose(u * np.sign((u * want).sum(0)), want, atol=1e-5)


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


COARSEN_STAGES = ("prepare", "coarsen", "embed", "refine", "cluster")


def _coarsen_pipe(package):
    """The blobs' pipeline through coarsen and refine (one level: the
    1024-node graph coarsens to 757 nodes, which divide by neither 2 nor 4
    ranks); the reference's on one device."""
    plan = package.Plan(device="sharded", variant="shard_map") if package is tsp else \
        package.Plan()
    return package.SpectralPipeline(n_clusters=KC, graph=package.GraphConfig(sigma=2.0),
                                    eig=package.EigConfig(block_size=KC),
                                    stages=COARSEN_STAGES, plan=plan)


@pytest.fixture(scope="module")
def coarsen_reference():
    """The reference's single-device run of the blobs through coarsen and
    refine."""
    return _coarsen_pipe(jsp).run_state(jnp.asarray(_blobs()), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def stage2_single():
    """Each STAGE2 task on one device: the port's run and the reference's
    (Chebyshev: the port's run with the reference's draws put in, as the
    ``cheb_ref_draws`` ranks run)."""
    from repro_torch.core import chebyshev as tch

    coo, graph = _sbm()
    graphs = {"sbm": graph, "cliques": _cliques()}
    out = {}
    for name, (g, eig, variant) in {**STAGE2, **CHEB_REF}.items():
        w = graphs[g]
        tw = COO(*(torch.tensor(np.asarray(w[f])) for f in ("row", "col", "val")),
                 (w["n"], w["n"]))
        tw = dataclasses.replace(tw, row=tw.row.long(), col=tw.col.long())
        port = tsp.SpectralPipeline.from_dict(_stage2_pipe(eig, variant))
        port = dataclasses.replace(port, plan=tsp.Plan())
        jw = jf.coo_from_edges(w["row"], w["col"], w["val"], (w["n"], w["n"]))
        ref = _stage2_pipe(eig, variant, package=jsp).run(jw, jax.random.PRNGKey(0))
        if name not in CHEB_REF:
            out[name] = (port.run(tw, cpu_generator(0), device=CPU), ref)
            continue
        draws = _cheb_draws(w["n"])
        saved, tch.draw_signals = tch.draw_signals, lambda *a, **kw: tuple(
            torch.as_tensor(d) for d in draws)
        try:
            out[name] = (port.run(tw, cpu_generator(0), device=CPU), ref)
        finally:
            tch.draw_signals = saved
    return out


@pytest.mark.parametrize("task", [t for t in STAGE2 if t != "cheb"] + list(CHEB_REF))
def test_row_distributed_stage2_matches_one_device_and_the_reference(ranks, stage2_single,
                                                                     task):
    """Lanczos at b = 1 and b = 4 on a gapped SBM, block Lanczos on
    disconnected cliques, and Chebyshev with the reference's draws put in,
    over the COO operator and (``ell_*``) over BlockELL, on S ranks: every
    rank's operator (the row-distributed one the representation names)
    takes and gives its n/S rows, and its embedding holds them; the
    eigenvalues are bitwise the same on every rank, with no broadcast, and
    within 1e-4 of the single-device port's and of the reference's; the
    labels ARI ≥ 0.99 against the reference's."""
    port, ref = stage2_single[task]
    n = port.labels.shape[0]
    rps = n // ranks["_S"]
    runs = ranks["_all"][task]
    kind = "RowBlockEllOperator" if task.startswith("ell") else "ShardedCooOperator"
    for got in runs:
        assert got["operators"] == [kind], got["operators"]
        assert got["basis_rows"] == [rps], got["basis_rows"]
        assert got["embedding"].shape == (rps, 4)
        assert (got["eigenvalues"].view(np.uint32)
                == runs[0]["eigenvalues"].view(np.uint32)).all()
        assert got["calls"]["broadcast"] == 0
        np.testing.assert_array_equal(got["labels"], runs[0]["labels"])
    vals = runs[0]["eigenvalues"]
    np.testing.assert_allclose(vals, to_np(port.eigenvalues), atol=1e-4)
    np.testing.assert_allclose(vals, np.asarray(ref.eigenvalues), atol=1e-4)
    assert adjusted_rand_index(runs[0]["labels"], np.asarray(ref.labels)) >= 0.99
    if task.startswith("cliques"):  # the 4-fold Laplacian eigenvalue 0
        np.testing.assert_allclose(vals, 0.0, atol=1e-4)


@pytest.mark.parametrize("block_size", [1, 2])
def test_careful_path_refills_each_ranks_rows_of_one_draw(ranks, block_size):
    """The reference's refill test on S ranks: the zero operator breaks down
    at every step, so every basis direction after the first is a random
    draw — made whole from the one stream and sliced, orthogonalized with
    all-reduced dot products and a tall-skinny QR.  The spectrum is {0};
    the ranks' rows, gathered, are orthonormal and the single-device port's
    eigenvectors (1e-5) up to column signs (a tall-skinny QR's R may differ
    from the one-device R in the signs of its rows)."""
    w = _isolated()
    op = CooOperator(COO(torch.as_tensor(w["row"]).long(), torch.as_tensor(w["col"]).long(),
                         torch.as_tensor(w["val"]), (w["n"], w["n"])))
    want = tlz.eigsh(op, tlz.LanczosConfig(**REFILL, block_size=block_size),
                     generator=cpu_generator(0))
    blocks = ranks[f"refill_b{block_size}"]
    u = np.concatenate([b["eigenvectors"] for b in blocks])
    assert {b["eigenvectors"].shape[0] for b in blocks} == {w["n"] // ranks["_S"]}
    assert all(b["refills"] > 0 for b in blocks)
    for b in blocks:
        np.testing.assert_allclose(b["eigenvalues"], 0.0, atol=1e-6)
        assert (b["eigenvalues"].view(np.uint32) == blocks[0]["eigenvalues"].view(np.uint32)).all()
    np.testing.assert_allclose(u.T @ u, np.eye(2), atol=1e-5)
    want = to_np(want.eigenvectors)
    np.testing.assert_allclose(u * np.sign((u * want).sum(0)), want, atol=1e-5)


@pytest.mark.parametrize("n", QR_ROWS)
def test_tall_skinny_qr_of_each_ranks_rows(ranks, n):
    """``RowBlock.qr`` on S ranks (at n = 8 and S = 4 a rank has 2 rows of a
    4-column block, so its factor is padded with zero rows): the ranks' Q
    rows, gathered, are orthonormal, Q·R is the block (1e-5), and R is
    bitwise the same on every rank and upper triangular."""
    blocks = ranks[f"qr_{n}"]
    w = np.random.default_rng(n).normal(size=(n, 4)).astype(np.float32)
    q = np.concatenate([b["q"] for b in blocks])
    r = blocks[0]["r"]
    assert {b["q"].shape for b in blocks} == {(n // ranks["_S"], 4)}
    for b in ranks["_all"][f"qr_{n}"]:
        assert (b["r"].view(np.uint32) == r.view(np.uint32)).all()
    np.testing.assert_allclose(q.T @ q, np.eye(4), atol=1e-5)
    np.testing.assert_allclose(q @ r, w, atol=1e-5)
    np.testing.assert_array_equal(np.tril(r, -1), 0.0)


def test_world_size_one_mesh_is_the_layout_path_bitwise(tmp_path):
    """On a one-rank mesh every row-distribution hook is the identity: the
    mesh run (block Lanczos, b = 4) computes the layout path's embedding,
    eigenvalues and labels bit for bit, with one all-gather an operator
    product (plus the degree pass's and the labels') and no all-reduce in
    Stage 2 (gspmd: Stage 3 is ``kmeans``)."""
    coo, graph = _sbm()
    pipe = _stage2_pipe({"block_size": 4}, "gspmd")
    got = td.run_ranks(td.pipeline_rank, 1, dict(graph=graph, pipeline=pipe,
                                                 mesh=((1,), ("data",))),
                       tmpdir=str(tmp_path), timeout=60.0, join_timeout=120.0)[0]
    sm = tdist.partition_coo_by_rows(convert.coo(coo, device=CPU), 1)
    want = tsp.SpectralPipeline.from_dict(pipe).run(sm, cpu_generator(0), device=CPU)
    for key in ("embedding", "eigenvalues", "labels"):
        np.testing.assert_array_equal(got[key], to_np(getattr(want, key)))
    assert got["basis_rows"] == [coo.shape[0]]
    assert got["calls"]["psum"] == 0 and got["calls"]["broadcast"] == 0
    assert got["calls"]["all_gather"] > 2


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


def test_coarsen_refine_on_the_mesh_pads_the_coarse_graph(ranks, coarsen_reference):
    """The raw points' COO graph coarsened on S ranks: the coarse graph, a
    COO whose n divides by neither 2 nor 4, takes the operator's route for
    such a graph (padded rows, marked as padding, so no draw or start
    vector reaches them, as the reference keeps a coarse COO a COO), and
    refine lifts the coarse embedding's real rows onto each rank's fine
    rows.  Every rank the same labels and eigenvalues, the eigenvalues
    within 1e-4 of the reference's single-device run and the labels ARI ≥
    0.99 against it."""
    S = ranks["_S"]
    runs = ranks["_all"]["e2e_coarsen"]
    ref = coarsen_reference
    n = ranks["_inputs"]["blobs"].shape[0]
    nc = ref.reductions[0].n_after
    assert nc % 2 and nc % S
    for got in runs:
        assert got["provenance"] == tuple(ref.provenance)
        assert got["operators"] == ["ShardedCooOperator"]
        assert got["live_rows"] == [nc]  # the coarse graph's padding marked
        assert got["basis_rows"] == sorted({-(-nc // S), n // S})
        assert got["embedding"].shape == (n // S, KC)
        np.testing.assert_array_equal(got["labels"], runs[0]["labels"])
        assert (got["eigenvalues"].view(np.uint32)
                == runs[0]["eigenvalues"].view(np.uint32)).all()
    np.testing.assert_allclose(runs[0]["eigenvalues"], np.asarray(ref.result.eigenvalues),
                               atol=1e-4)
    assert adjusted_rand_index(runs[0]["labels"], np.asarray(ref.result.labels)) >= 0.99


def test_ranks_leave_stage2_with_one_embedding(ranks, stage2_single):
    """Each rank leaves Stage 2 with its own n/S rows of one embedding, and
    nothing is broadcast: on the gapped SBM the ranks' rows, gathered in
    coordinate order, are the single-device port's embedding up to column
    signs (1e-4), and on the blobs every rank holds the same eigenvalues
    and labels, the labels the single-device port's."""
    rows = [b["embedding"] for b in ranks["graph_whole"]]
    got = np.concatenate(rows)
    want = to_np(stage2_single["graph_whole"][0].embedding)
    assert {r.shape for r in rows} == {(want.shape[0] // ranks["_S"], want.shape[1])}
    signs = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * signs, want, atol=1e-4)
    runs = ranks["_all"]["e2e_gather"]
    for run in runs:
        assert (run["eigenvalues"].view(np.uint32)
                == runs[0]["eigenvalues"].view(np.uint32)).all()
        np.testing.assert_array_equal(run["labels"], runs[0]["labels"])
        assert run["calls"]["broadcast"] == 0


def test_sharded_chebyshev_matches_single(ranks):
    """The reference's ``test_sharded_chebyshev_matches_single`` on the mesh
    (shard_map), the Chebyshev block distributed by rows: labels equal,
    eigenvalues within 1e-5."""
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


def test_a_checkpoint_holds_the_embedding_whole_and_each_rank_loads_its_rows(ranks):
    """``save_state`` under the mesh gathers the row-distributed embeddings
    once, so the checkpoint holds them whole, as the reference's does (and
    cross-loads with it: the layout is the reference's); ``load_state``
    with the pipeline gives each rank back its own rows."""
    outs = ranks["checkpoint"]
    whole = np.concatenate([o["rows"] for o in outs])
    for o in outs:
        assert o["saved"] == {"embedding.embedding": whole.shape,
                              "result.embedding": whole.shape}
        np.testing.assert_array_equal(o["whole"], whole)
        assert o["loaded_equal"]


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


def test_world_size_one_mesh_two_pass_is_the_layout_path_bitwise(tmp_path):
    """On a one-rank mesh two-pass Stage 3 stays ``kmeans`` on the whole
    embedding, as in the reference: the mesh run's embedding, eigenvalues
    and labels are the layout path's bit for bit, and Stage 3 makes no
    collective but the labels' — none, on one rank, at all."""
    coo, graph = _sbm()
    pipe = _stage2_pipe({"block_size": 4}, "gspmd", kmeans=dict(iter="two_pass"))
    got = td.run_ranks(td.pipeline_rank, 1, dict(graph=graph, pipeline=pipe,
                                                 mesh=((1,), ("data",))),
                       tmpdir=str(tmp_path), timeout=60.0, join_timeout=300.0)[0]
    sm = tdist.partition_coo_by_rows(convert.coo(coo, device=CPU), 1)
    want = tsp.SpectralPipeline.from_dict(pipe).run(sm, cpu_generator(0), device=CPU)
    for key in ("embedding", "eigenvalues", "labels"):
        np.testing.assert_array_equal(got[key], to_np(getattr(want, key)))
    assert got["stage3"]["calls"] == dict.fromkeys(tdist.COLLECTIVES.NAMES, 0)


# ---------------------------------------------------------------------------
# P15: a COO graph whose n does not divide by the ranks
# ---------------------------------------------------------------------------

N_UNEVEN = 4001
# (EigConfig, Chebyshev draws put in) of each case
UNEVEN = {"lanczos": ({}, False), "blockell": ({"representation": "blockell"}, False),
          "cheb_ref_draws": ({"solver": "chebyshev"}, True)}


def _uneven_graph():
    """A four-block SBM of 4004 nodes cut to its first 4001: its n leaves 1
    padding row on S = 2 and 3 on S = 4."""
    coo, truth = sbm_graph(1001, 4, 0.02, 0.001, seed=7)
    r, c, v = (np.asarray(a) for a in (coo.row, coo.col, coo.val))
    keep = (r < N_UNEVEN) & (c < N_UNEVEN)
    return dict(row=r[keep], col=c[keep], val=v[keep].astype(np.float32), n=N_UNEVEN)


@pytest.fixture(scope="module")
def uneven_reference():
    """The reference's single-device runs of each case on the 4001-node COO —
    its sharded plan's route for such a graph (``CooOperator`` or
    ``BlockEllOperator``, then ``kmeans``) — and the reference's Chebyshev
    draws of that run."""
    g = _uneven_graph()
    jw = jf.coo_from_edges(g["row"], g["col"], g["val"], (g["n"], g["n"]))
    out = {name: jsp.SpectralPipeline(n_clusters=4, eig=jsp.EigConfig(**eig)).run(
        jw, jax.random.PRNGKey(0)) for name, (eig, _) in UNEVEN.items()}
    return g, _cheb_draws(g["n"]), out


@pytest.fixture(scope="module", params=[2, 4])
def uneven(request, uneven_reference, tmp_path_factory):
    """One spawn of S ranks (a 1-D mesh) running each case on the 4001-node
    graph handed over as a COO, and once as the ShardedCOO a caller
    partitions itself; every rank's results."""
    S = request.param
    g, draws, _ = uneven_reference
    tasks = {name: dict(graph=g, as_coo=True, pipeline=_stage2_pipe(eig, "shard_map"),
                        **({"draws": draws} if inject else {}))
             for name, (eig, inject) in UNEVEN.items()}
    tasks["sharded_coo"] = dict(graph=g, pipeline=_stage2_pipe({}, "shard_map"))
    for spec in tasks.values():
        spec["mesh"] = ((S,), ("data",))
    outs = td.run_ranks(td.tasks_rank, S, [("pipeline_rank", t) for t in tasks.values()],
                        tmpdir=str(tmp_path_factory.mktemp("uneven")), timeout=120.0,
                        join_timeout=600.0)
    return S, {name: [o[j] for o in outs] for j, name in enumerate(tasks)}


@pytest.mark.parametrize("case", list(UNEVEN))
def test_a_coo_graph_whose_n_does_not_divide_by_the_ranks(uneven, uneven_reference, case):
    """P15: the 4001-node COO on S ranks is padded for Stage 2 — each rank's
    operator takes and gives its ⌈n/S⌉ rows — and its padding never enters
    the result: the ranks' embedding rows add up to n (the last rank holds
    fewer), the labels have n rows and are the same on every rank, the
    eigenvalues are bitwise the same on every rank and within 1e-4 of the
    reference's single-device run, and the labels reach ARI ≥ 0.99 against
    it.  Stage 3 takes the reference's route for n that does not tile the
    axis: the n real rows of the embedding gathered once, then ``kmeans``."""
    S, runs = uneven
    _, _, ref = uneven_reference
    ref = ref[case]
    n, k = N_UNEVEN, 4
    rps = -(-n // S)
    kind = "RowBlockEllOperator" if case == "blockell" else "ShardedCooOperator"
    for r, got in enumerate(runs[case]):
        assert got["operators"] == [kind]
        assert got["basis_rows"] == [rps]
        assert got["embedding"].shape == (min(rps, n - r * rps), k)
        assert got["labels"].shape == (n,)
        np.testing.assert_array_equal(got["labels"], runs[case][0]["labels"])
        assert (got["eigenvalues"].view(np.uint32)
                == runs[case][0]["eigenvalues"].view(np.uint32)).all()
        assert got["calls"]["broadcast"] == 0
        assert got["stage3"]["calls"]["all_gather"] == 1
        assert got["stage3"]["bytes"]["all_gather"] == (S - 1) * rps * k * 4
        assert got["stage3"]["calls"]["psum"] == 0
    np.testing.assert_allclose(runs[case][0]["eigenvalues"], np.asarray(ref.eigenvalues),
                               atol=1e-4)
    assert adjusted_rand_index(runs[case][0]["labels"], np.asarray(ref.labels)) >= 0.99


def test_a_sharded_coo_a_caller_hands_in_keeps_its_padding(uneven):
    """A ShardedCOO of the 4001-node graph that the caller partitioned keeps
    its own n, padding included, as in the reference: n_pad labels, each
    rank n_pad/S embedding rows, Stage 3 on the ranks' rows (no gather of
    the embedding), and the real rows' labels a partition of the COO run's
    (ARI ≥ 0.99)."""
    S, runs = uneven
    n_pad = tdist.padded_rows(N_UNEVEN, S)
    for got in runs["sharded_coo"]:
        assert got["operators"] == ["ShardedCooOperator"]
        assert got["labels"].shape == (n_pad,)
        assert got["embedding"].shape == (n_pad // S, 4)
        assert got["stage3"]["bytes"]["all_gather"] == (S - 1) * (3 * 16 + n_pad // S * 4)
    assert adjusted_rand_index(runs["sharded_coo"][0]["labels"][:N_UNEVEN],
                               runs["lanczos"][0]["labels"]) >= 0.99
