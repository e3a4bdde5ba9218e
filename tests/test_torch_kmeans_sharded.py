"""Port parity: ``kmeans_sharded`` against the reference's own
``kmeans_sharded``, which still runs on this jax — in a subprocess with 8
virtual CPU devices and a ``(4, 2)`` ``("data", "model")`` mesh, as the
reference's ``tests/test_distributed.py`` runs it — beside the port's on 4
gloo ranks (``repro_torch.testing.dist``), each handed its own rows as the
reference's ``P(axes, None)`` hands them: from the reference's own k-means++
seeds, and with each package seeding itself (the port's k-means++ over the
ranks' rows, never gathering the points).

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
        rcfg = km.KMeansConfig(k=5, max_iters=30, empty="reseed_farthest")
        rr = kmeans_sharded(jnp.asarray(xk), rcfg, key, mesh=mesh, axis="data",
                            init_centroids=jnp.asarray(init))
        np.savez({out!r}, x=x, xk=xk, init=init, c0=np.asarray(c0),
                 labels=np.asarray(r.labels), centroids=np.asarray(r.centroids),
                 inertia=np.asarray(r.inertia), iterations=np.asarray(r.iterations),
                 r_labels=np.asarray(rr.labels), r_centroids=np.asarray(rr.centroids),
                 r_iterations=np.asarray(rr.iterations),
                 pp_labels=np.asarray(kmeans_sharded(jnp.asarray(xk), km.KMeansConfig(k=4),
                                                     key, mesh=mesh, axis="data").labels))
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
