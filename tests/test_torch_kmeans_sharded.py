"""Port parity: ``kmeans_sharded`` against the reference's own
``kmeans_sharded``, which still runs on this jax — in a subprocess with 8
virtual CPU devices and a ``(4, 2)`` ``("data", "model")`` mesh, as the
reference's ``tests/test_distributed.py`` runs it — beside the port's on 4
gloo ranks (``repro_torch.testing.dist``), each handed its own rows as the
reference's ``P(axes, None)`` hands them: from the reference's own k-means++
seeds, and with each package seeding itself (the port's k-means++ over the
ranks' rows, never gathering the points).  The two-pass iteration on S = 2
and S = 4 ranks is held against the reference's one-device
``kmeans(iter="two_pass")`` from its seeds (its sharded two-pass runs
through GSPMD, which fails on this jax: ROADMAP R1), and against the port's
one-device two-pass ``kmeans`` when each package seeds itself.

Tolerances: labels and iterations equal, centroids rtol 1e-5 / atol 1e-6
(per-shard sums in another order), inertia rtol 1e-5; from each package's
own seeds (their random streams differ) labels ARI ≥ 0.99.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.testing import dist as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> dict:
    """The reference's runs, once for the module."""
    out = str(tmp_path_factory.mktemp("reference") / "ref.npz")
    script = f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.core import kmeans as km
        from repro.core.distributed_pipeline import kmeans_sharded
        mesh = jax.make_mesh((4, 2), ("data", "model"))
        rng = np.random.default_rng(0)
        x = rng.normal(size=(256, 6)).astype(np.float32)
        centers = np.eye(4, 6).astype(np.float32) * 20.0
        xk = np.concatenate([c + rng.normal(size=(64, 6)) for c in centers]).astype(np.float32)
        init = np.concatenate([centers, np.full((1, 6), 1e3, np.float32)])
        key = jax.random.PRNGKey(0)
        cfg = km.KMeansConfig(k=5, max_iters=30)
        c0 = km.seed_centroids(jnp.asarray(x), cfg, key)
        r = kmeans_sharded(jnp.asarray(x), cfg, key, mesh=mesh, axis="data", init_centroids=c0)
        two_pass = {{}}
        for update in ("matmul", "segment"):
            for empty in ("keep", "reseed_farthest"):
                tcfg = km.KMeansConfig(k=5, max_iters=30, iter="two_pass", update=update,
                                       empty=empty)
                for data, (xd, cd) in (("seeds", (x, c0)), ("far", (xk, init))):
                    t = km.kmeans(jnp.asarray(xd), tcfg, key, init_centroids=jnp.asarray(cd))
                    tag = f"tp_{{update}}_{{empty}}_{{data}}"
                    two_pass.update({{f"{{tag}}_labels": np.asarray(t.labels),
                                     f"{{tag}}_centroids": np.asarray(t.centroids),
                                     f"{{tag}}_iterations": np.asarray(t.iterations)}})
        rcfg = km.KMeansConfig(k=5, max_iters=30, empty="reseed_farthest")
        rr = kmeans_sharded(jnp.asarray(xk), rcfg, key, mesh=mesh, axis="data",
                            init_centroids=jnp.asarray(init))
        np.savez({out!r}, x=x, xk=xk, init=init, c0=np.asarray(c0),
                 labels=np.asarray(r.labels), centroids=np.asarray(r.centroids),
                 inertia=np.asarray(r.inertia), iterations=np.asarray(r.iterations),
                 r_labels=np.asarray(rr.labels), r_centroids=np.asarray(rr.centroids),
                 r_iterations=np.asarray(rr.iterations),
                 pp_labels=np.asarray(kmeans_sharded(jnp.asarray(xk), km.KMeansConfig(k=4),
                                                     key, mesh=mesh, axis="data").labels),
                 **two_pass)
    """
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def test_kmeans_sharded_matches_reference_kmeans_sharded(reference, tmp_path):
    ref = reference
    mesh = ((4,), ("data",))
    tasks = [("kmeans_rank", dict(x=ref["x"], init=ref["c0"], mesh=mesh,
                                  cfg=dict(k=5, max_iters=30))),
             ("kmeans_rank", dict(x=ref["xk"], init=ref["init"], mesh=mesh,
                                  cfg=dict(k=5, max_iters=30, empty="reseed_farthest")))]
    outs = td.run_ranks(td.tasks_rank, 4, tasks, tmpdir=str(tmp_path / "ranks"))
    for plain, reseed in outs:
        np.testing.assert_array_equal(plain["labels"], ref["labels"])
        assert plain["iterations"] == int(ref["iterations"])
        np.testing.assert_allclose(plain["centroids"], ref["centroids"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(plain["inertia"], float(ref["inertia"]), rtol=1e-5)
        assert plain["calls"]["psum"] == plain["iterations"] + 1
        np.testing.assert_array_equal(reseed["labels"], ref["r_labels"])
        assert reseed["iterations"] == int(ref["r_iterations"])
        np.testing.assert_allclose(reseed["centroids"], ref["r_centroids"], rtol=1e-5,
                                   atol=1e-6)
        assert reseed["calls"]["psum"] == 2 * reseed["iterations"] + 1


def test_kmeans_sharded_seeds_itself_over_the_ranks_rows(reference, tmp_path):
    """k-means++ over 4 ranks' rows of four blobs, each package seeding
    itself: the port's labels, iterations and centroids are its one-device
    ``kmeans``' (the seeds are the whole array's, picked with one all-reduce
    of [d] a centroid and an all-gather of the ranks' best pairs a draw), and
    ARI ≥ 0.99 against the reference's ``kmeans_sharded``."""
    import torch

    from repro.serve.metrics import adjusted_rand_index
    from repro_torch._device import cpu_generator
    from repro_torch.core.kmeans import KMeansConfig, kmeans

    ref = reference
    outs = td.run_ranks(td.kmeans_rank, 4, dict(x=ref["xk"], cfg=dict(k=4), seed=0,
                                                mesh=((4,), ("data",))),
                        tmpdir=str(tmp_path / "ranks"))
    want = kmeans(torch.as_tensor(ref["xk"]), KMeansConfig(k=4), cpu_generator(0))
    for got in outs:
        np.testing.assert_array_equal(got["labels"], want.labels.numpy())
        assert got["iterations"] == want.iterations
        np.testing.assert_allclose(got["centroids"], want.centroids.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert got["calls"]["psum"] == got["iterations"] + 1 + 4
        assert got["calls"]["all_gather"] == 3 + 1
        assert adjusted_rand_index(ref["pp_labels"], got["labels"]) >= 0.99


def test_kmeans_sharded_reseed_needs_k_rows_per_shard(tmp_path):
    """The reference's error, on a one-rank mesh."""
    with pytest.raises(RuntimeError, match="rows per shard"):
        td.run_ranks(td.kmeans_rank, 1, dict(x=np.zeros((8, 2), np.float32),
                                             cfg=dict(k=16, empty="reseed_farthest")),
                     tmpdir=str(tmp_path))


# ---------------------------------------------------------------------------
# Two-pass Stage 3 on each rank's rows
# ---------------------------------------------------------------------------

TWO_PASS = [(u, e) for u in ("matmul", "segment") for e in ("keep", "reseed_farthest")]
DATA = ("seeds", "far")  # the reference's k-means++ seeds; a far centroid left empty
INITS = ("kmeans++", "random")


@pytest.fixture(scope="module", params=[2, 4])
def two_pass_ranks(request, reference, tmp_path_factory) -> dict:
    """One spawn of S ranks running the two-pass ``kmeans_sharded``: from the
    reference's starts under each (update, empty, data), and seeding itself
    under each init; results by task, every rank's."""
    S, ref = request.param, reference
    starts = {"seeds": (ref["x"], ref["c0"]), "far": (ref["xk"], ref["init"])}
    tasks = {(u, e, data): dict(x=starts[data][0], init=starts[data][1],
                                cfg=dict(k=5, max_iters=30, iter="two_pass", update=u, empty=e))
             for u, e in TWO_PASS for data in DATA}
    tasks.update({init: dict(x=ref["xk"], seed=0, cfg=dict(k=4, iter="two_pass", init=init))
                  for init in INITS})
    for spec in tasks.values():
        spec["mesh"] = ((S,), ("data",))
    outs = td.run_ranks(td.tasks_rank, S, [("kmeans_rank", spec) for spec in tasks.values()],
                        tmpdir=str(tmp_path_factory.mktemp("two_pass")), timeout=60.0,
                        join_timeout=300.0)
    return {"S": S, "xk": ref["xk"],
            **{name: [o[j] for o in outs] for j, name in enumerate(tasks)}}


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("update,empty", TWO_PASS)
def test_two_pass_kmeans_sharded_matches_reference_kmeans(two_pass_ranks, reference, update,
                                                          empty, data):
    """The two-pass iteration on each rank's rows, from the reference's
    starts: labels and iterations of the reference's one-device two-pass
    ``kmeans``, centroids within rtol 1e-5 / atol 1e-6; one packed
    all-reduce an iteration and one for the inertia (two an iteration with
    the reseed), and the only all-gather the labels'."""
    tag = f"tp_{update}_{empty}_{data}"
    S = two_pass_ranks["S"]
    for got in two_pass_ranks[(update, empty, data)]:
        np.testing.assert_array_equal(got["labels"], reference[f"{tag}_labels"])
        assert got["iterations"] == int(reference[f"{tag}_iterations"])
        np.testing.assert_allclose(got["centroids"], reference[f"{tag}_centroids"], rtol=1e-5,
                                   atol=1e-6)
        per_iter = 2 if empty == "reseed_farthest" else 1
        assert got["calls"]["psum"] == per_iter * got["iterations"] + 1
        n = got["labels"].shape[0]
        assert got["calls"]["all_gather"] == 1
        assert got["bytes"]["all_gather"] == (S - 1) * (n // S) * 4  # the [n] int32 labels
    if data == "far":  # the far centroid's cluster is empty: the reseed revives it
        assert (np.unique(got["labels"]).size == 5) == (empty == "reseed_farthest")


@pytest.mark.parametrize("init", INITS)
def test_two_pass_kmeans_sharded_seeds_itself_as_one_device(two_pass_ranks, init):
    """Two-pass on S ranks seeding itself over the ranks' rows: labels,
    iterations and centroids of the port's one-device two-pass ``kmeans``
    from the same seed.  All-reduces: one an iteration and the inertia's,
    plus the seeding's (k row fetches, or one [k, d] fetch of random rows);
    all-gathers: the k-means++ draws' (score, id) pairs and the [n] int32
    labels — none moves [n, d]."""
    import torch

    from repro_torch._device import cpu_generator
    from repro_torch.core.kmeans import KMeansConfig, kmeans

    S, k = two_pass_ranks["S"], 4
    outs = two_pass_ranks[init]
    n = outs[0]["labels"].shape[0]
    want = kmeans(torch.as_tensor(two_pass_ranks["xk"]),
                  KMeansConfig(k=k, iter="two_pass", init=init), cpu_generator(0))
    pairs = k - 1 if init == "kmeans++" else 0
    for got in outs:
        np.testing.assert_array_equal(got["labels"], want.labels.numpy())
        assert got["iterations"] == want.iterations
        np.testing.assert_allclose(got["centroids"], want.centroids.numpy(), rtol=1e-5,
                                   atol=1e-6)
        seeding = k if init == "kmeans++" else 1
        assert got["calls"]["psum"] == got["iterations"] + 1 + seeding
        assert got["calls"]["all_gather"] == pairs + 1
        assert got["bytes"]["all_gather"] == (S - 1) * (pairs * 2 * 8 + (n // S) * 4)
        assert got["launches"] == {"kmeans_assign": 0, "kmeans_iter": 0}  # the CPU
