"""Port parity: two-pass k-means (paper Alg. 4) — the fused assignment
(kernel B6's plain version), the centroid update and the two-pass Lloyd
driver of ``repro_torch`` against the JAX reference (its Pallas assignment
kernel in interpret mode), with the initial centroids injected.

Tolerances: labels equal on tie-free blobs (every point's nearest centroid
is clear by far more than fp32 rounding); min distances at atol 1e-5 of
‖x‖² + ‖c‖² (the terms they cancel); centroids within 1e-5 (fp32 means of
the same rows, summed in another order); iteration counts equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import kmeans as jkm
from repro.kernels.kmeans_assign.ops import kmeans_assign as j_assign
from repro_torch.core import kmeans as tkm
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign as t_assign
from tests._parity import to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _blobs(n, k, d, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)).astype(np.float32)
    x = (c[rng.integers(0, k, n)] + noise * rng.normal(size=(n, d))).astype(np.float32)
    return x, c


@pytest.mark.parametrize("n,k,d,impl", [(40, 5, 3, "pallas"), (300, 7, 6, "ref"),
                                        (513, 130, 33, "ref"), (1, 1, 1, "ref")])
def test_kmeans_assign_matches_reference(n, k, d, impl):
    x, c = _blobs(n, k, d, seed=n)
    want = j_assign(jnp.asarray(x), jnp.asarray(c), impl=impl,
                    interpret=True if impl == "pallas" else None)
    got = t_assign(torch.as_tensor(x), torch.as_tensor(c), block_q=64)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want[0]), to_np(got[0]))
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    np.testing.assert_allclose(np.asarray(want[1]), to_np(got[1]), rtol=0, atol=1e-5 * scale)
    xn = (torch.as_tensor(x) ** 2).sum(1)
    for lab, dist in (t_assign(torch.as_tensor(x), torch.as_tensor(c), x_norm=xn),
                      tkm.assign_ref(torch.as_tensor(x), torch.as_tensor(c), xn)):
        np.testing.assert_array_equal(to_np(got[0]), to_np(lab))
        np.testing.assert_allclose(to_np(got[1]), to_np(dist), rtol=0, atol=1e-5 * scale)


def test_kmeans_assign_ties_go_low():
    x = np.zeros((4, 2), np.float32)
    c = np.array([[1, 0], [0, 1], [-1, 0]], np.float32)  # all at distance 1
    lab, dist = t_assign(torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_array_equal(to_np(lab), 0)
    np.testing.assert_array_equal(to_np(lab), np.asarray(j_assign(jnp.asarray(x),
                                                                  jnp.asarray(c))[0]))
    np.testing.assert_allclose(to_np(dist), 1.0)


@pytest.mark.parametrize("how", ["matmul", "segment"])
def test_update_centroids_matches_reference(how):
    x, c = _blobs(200, 6, 5, seed=2)
    labels = np.random.default_rng(3).integers(0, 5, 200).astype(np.int32)  # cluster 5 empty
    want = jkm.update_centroids(jnp.asarray(x), jnp.asarray(labels), 6, jnp.asarray(c),
                                how=how)
    got = tkm.update_centroids(torch.as_tensor(x), torch.as_tensor(labels), 6,
                               torch.as_tensor(c), how=how)
    np.testing.assert_allclose(np.asarray(want), to_np(got), **TOL)
    np.testing.assert_array_equal(to_np(got)[5], c[5])  # an empty cluster keeps its centroid


@pytest.mark.parametrize("update,assign,empty", [("matmul", "auto", "keep"),
                                                 ("segment", "auto", "keep"),
                                                 ("matmul", "ref", "keep"),
                                                 ("segment", "fused", "reseed_farthest")])
def test_two_pass_kmeans_matches_reference(update, assign, empty):
    x, c = _blobs(400, 6, 8, seed=5, noise=0.3)
    init = x[:6] + 0.0  # data rows as seeds: some start in one blob
    kw = dict(k=6, iter="two_pass", update=update, assign=assign, empty=empty)
    want = jkm.kmeans(jnp.asarray(x), jkm.KMeansConfig(**kw), jax.random.PRNGKey(0),
                      init_centroids=jnp.asarray(init))
    got = tkm.kmeans(torch.as_tensor(x), tkm.KMeansConfig(**kw),
                     init_centroids=torch.as_tensor(init))
    np.testing.assert_array_equal(np.asarray(want.labels), to_np(got.labels))
    np.testing.assert_allclose(np.asarray(want.centroids), to_np(got.centroids), **TOL)
    assert int(want.iterations) == got.iterations and got.shifted == 0
    np.testing.assert_allclose(float(want.inertia), float(got.inertia), rtol=1e-5)
    # the fused engine reaches the same partition from the same seeds
    fused = tkm.kmeans(torch.as_tensor(x), tkm.KMeansConfig(k=6, empty=empty),
                       init_centroids=torch.as_tensor(init))
    np.testing.assert_array_equal(to_np(fused.labels), to_np(got.labels))
