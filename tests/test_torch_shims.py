"""Port parity: the deprecated flat entry points of ``repro_torch.core.pipeline``
— bitwise the facade (``SpectralPipeline.run``) on the same inputs and
generator, each with its ``DeprecationWarning``, as the reference's
``tests/test_spectral_api.py`` holds its shims; and beside the reference's
shims, labels as partitions (ARI ≥ 0.99; the two packages draw from
different generators).  The sharded shims of
``repro_torch.core.distributed_pipeline`` are bitwise the facade too.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import pipeline as jpl
from repro.data.sbm import sbm_graph
from repro.serve.metrics import adjusted_rand_index
from repro_torch import convert
from repro_torch.core.pipeline import (
    GraphConfig,
    Plan,
    SpectralClusteringConfig,
    spectral_cluster,
    spectral_cluster_from_points,
)
from tests._parity import to_np

CPU = "cpu"


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _blobs(k, n_per, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = (rng.permutation(np.eye(k, d)) * 20.0).astype(np.float32)
    x = np.concatenate([c + rng.normal(size=(n_per, d)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(k), n_per)


def _bitwise(old, new):
    for f in ("labels", "eigenvalues", "embedding", "kmeans_inertia"):
        assert torch.equal(getattr(old, f), getattr(new, f)), f


@pytest.mark.parametrize("fields", [dict(), dict(lanczos_block_size=2, drop_first=True),
                                    dict(kmeans_iter="two_pass", kmeans_assign="ref")])
def test_shim_spectral_cluster_bitwise_identical(fields):
    w, truth = sbm_graph(80, 4, 0.3, 0.01, seed=13)
    cfg = SpectralClusteringConfig(n_clusters=4, **fields)
    tw = convert.coo(w, device=CPU)
    with pytest.warns(DeprecationWarning, match="spectral_cluster"):
        old = spectral_cluster(tw, cfg, _gen(), device=CPU)
    _bitwise(old, cfg.to_pipeline().run(tw, _gen(), device=CPU))
    jcfg = jpl.SpectralClusteringConfig(n_clusters=4, **fields)
    with pytest.warns(DeprecationWarning):
        want = jpl.spectral_cluster(w, jcfg, jax.random.PRNGKey(0))
    assert adjusted_rand_index(np.asarray(want.labels), to_np(old.labels)) >= 0.99
    assert cfg.to_pipeline().to_dict() == jcfg.to_pipeline().to_dict()


def test_shim_spectral_cluster_matvec_override_bitwise():
    """``matvec=`` goes through a ``CallableOperator`` into ``run(operator=)``."""
    w, _ = sbm_graph(60, 3, 0.3, 0.02, seed=3)
    cfg = SpectralClusteringConfig(n_clusters=3)
    tw = convert.coo(w, device=CPU)
    pipe = cfg.to_pipeline()
    op = pipe.operator(pipe.prepare(tw, device=CPU))
    with pytest.warns(DeprecationWarning):
        old = spectral_cluster(tw, cfg, _gen(), matvec=op.mv, matmat=op.mm, deg=None,
                               device=CPU)
    _bitwise(old, pipe.run(tw, _gen(), operator=op, device=CPU))


def test_shim_spectral_cluster_from_points_bitwise_identical():
    x, truth = _blobs(3, 50, 6, seed=7)
    cfg = SpectralClusteringConfig(n_clusters=3, lanczos_block_size=3)
    with pytest.warns(DeprecationWarning, match="from_points"):
        old = spectral_cluster_from_points(x, cfg, _gen(), knn_k=8, sigma=2.0, device=CPU)
    pipe = cfg.to_pipeline(graph=GraphConfig(knn_k=8, sigma=2.0))
    _bitwise(old, pipe.run(x, _gen(), device=CPU))
    with pytest.warns(DeprecationWarning):
        want = jpl.spectral_cluster_from_points(
            jnp.asarray(x), jpl.SpectralClusteringConfig(n_clusters=3, lanczos_block_size=3),
            jax.random.PRNGKey(0), knn_k=8, sigma=2.0)
    assert adjusted_rand_index(np.asarray(want.labels), to_np(old.labels)) >= 0.99
    assert adjusted_rand_index(truth, to_np(old.labels)) >= 0.99


def test_sharded_shim_plan_raises_naming_a12():
    """The sharded plan that raised naming ROADMAP A12 before it was ported:
    ``spectral_cluster_sharded`` on a row-partitioned graph (the layout
    path, no mesh) is bitwise ``cfg.to_pipeline(plan=Plan(device="sharded"))
    .run``, with its warning, and ARI ≥ 0.99 against the reference's shim."""
    from repro.core import distributed_pipeline as jdp
    from repro.sparse.distributed import partition_coo_by_rows as j_partition
    from repro_torch.core.distributed_pipeline import spectral_cluster_sharded
    from repro_torch.sparse.distributed import partition_coo_by_rows

    w, truth = sbm_graph(50, 4, 0.35, 0.02, seed=5)
    sm = partition_coo_by_rows(convert.coo(w, device=CPU), 4)
    cfg = SpectralClusteringConfig(n_clusters=4)
    with pytest.warns(DeprecationWarning, match="spectral_cluster_sharded"):
        old = spectral_cluster_sharded(sm, cfg, _gen(), device=CPU)
    _bitwise(old, cfg.to_pipeline(plan=Plan(device="sharded")).run(sm, _gen(), device=CPU))
    with pytest.warns(DeprecationWarning):
        want = jdp.spectral_cluster_sharded(
            j_partition(w, 4), jpl.SpectralClusteringConfig(n_clusters=4),
            jax.random.PRNGKey(0))
    assert adjusted_rand_index(np.asarray(want.labels), to_np(old.labels)) >= 0.99
    assert adjusted_rand_index(truth, to_np(old.labels)) >= 0.99
