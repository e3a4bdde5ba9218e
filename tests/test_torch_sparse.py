"""Port parity: sparse formats, sparse ops, the Laplacian helpers and the data
generators of ``repro_torch`` against the JAX reference on the same numpy
inputs.

Tolerances: structure (indices, shapes, the BlockELL layout, generator
output) must be equal bit for bit — it is the same host numpy code.  Float
ops compare at rtol 1e-6 / atol 1e-6: XLA's segment sum and torch's
``index_add_`` add the same fp32 terms in different orders.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import laplacian as jlap
from repro.data.pointcloud import dti_like_pointcloud as j_dti
from repro.data.sbm import sbm_graph as j_sbm
from repro.kernels.ell_spmm.ops import ell_spmm as j_ell_spmm
from repro.sparse import formats as jf
from repro.sparse import ops as jo
from repro_torch import convert
from repro_torch.core import laplacian as tlap
from repro_torch.data.pointcloud import dti_like_pointcloud as t_dti
from repro_torch.data.sbm import sbm_graph as t_sbm
from repro_torch.kernels.ell_spmm.ops import ell_spmm as t_ell_spmm
from repro_torch.sparse import formats as tf
from repro_torch.sparse import ops as to
from tests._parity import to_np

CPU = "cpu"
FLOAT = dict(rtol=1e-6, atol=1e-6)


def _edges(seed=0, n=60, nnz=400):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, nnz)
    col = rng.integers(0, n, nnz)
    val = rng.random(nnz).astype(np.float32) + 0.1
    return row, col, val, (n, n)


def _pair(sort=True, sum_duplicates=True, seed=0):
    r, c, v, shape = _edges(seed)
    j = jf.coo_from_edges(r, c, v, shape, sort=sort, sum_duplicates=sum_duplicates)
    t = tf.coo_from_edges(r, c, v, shape, sort=sort, sum_duplicates=sum_duplicates,
                          device=CPU)
    return j, t


def _assert_coo_equal(j, t, float_tol=None):
    assert tuple(j.shape) == tuple(t.shape)
    assert bool(j.sorted_rows) == bool(t.sorted_rows)
    np.testing.assert_array_equal(np.asarray(j.row), to_np(t.row))
    np.testing.assert_array_equal(np.asarray(j.col), to_np(t.col))
    if float_tol is None:
        np.testing.assert_array_equal(np.asarray(j.val), to_np(t.val))
    else:
        np.testing.assert_allclose(np.asarray(j.val), to_np(t.val), **float_tol)


@pytest.mark.parametrize("sort,sum_duplicates", [(True, True), (True, False), (False, False)])
def test_coo_from_edges_equal(sort, sum_duplicates):
    j, t = _pair(sort, sum_duplicates)
    _assert_coo_equal(j, t)


def test_coo_to_csr_and_blockell_bitwise():
    j, t = _pair()
    jc, tc = jf.coo_to_csr(j), tf.coo_to_csr(t)
    np.testing.assert_array_equal(np.asarray(jc.indptr), to_np(tc.indptr))
    for kw in (dict(), dict(block_rows=4, width=8), dict(width_quantile=0.5)):
        je, te = jf.csr_to_blockell(jc, **kw), tf.csr_to_blockell(tc, **kw)
        assert (je.block_rows, je.width, je.shape) == (te.block_rows, te.width, te.shape)
        np.testing.assert_array_equal(np.asarray(je.cols), to_np(te.cols))
        np.testing.assert_array_equal(np.asarray(je.vals), to_np(te.vals))
        _assert_coo_equal(je.tail, te.tail)


def test_products_match():
    j, t = _pair(seed=1)
    rng = np.random.default_rng(1)
    x = rng.normal(size=60).astype(np.float32)
    X = rng.normal(size=(60, 4)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jo.spmv_coo(j, jnp.asarray(x))),
                               to_np(to.spmv_coo(t, torch.as_tensor(x))), **FLOAT)
    np.testing.assert_allclose(np.asarray(jo.spmm_coo(j, jnp.asarray(X))),
                               to_np(to.spmm_coo(t, torch.as_tensor(X))), **FLOAT)
    je = jf.csr_to_blockell(jf.coo_to_csr(j), width=8)
    te = tf.csr_to_blockell(tf.coo_to_csr(t), width=8)
    assert te.tail.nnz > 1  # the tail is exercised
    np.testing.assert_allclose(np.asarray(jo.spmv_blockell(je, jnp.asarray(x))),
                               to_np(to.spmv_blockell(te, torch.as_tensor(x))), **FLOAT)
    np.testing.assert_allclose(np.asarray(jo.spmm_blockell(je, jnp.asarray(X))),
                               to_np(to.spmm_blockell(te, torch.as_tensor(X))), **FLOAT)
    np.testing.assert_allclose(np.asarray(jo.degrees(j)), to_np(to.degrees(t)), **FLOAT)
    np.testing.assert_allclose(np.asarray(jo.spmv_csr(jf.coo_to_csr(j), jnp.asarray(x))),
                               to_np(to.spmv_csr(tf.coo_to_csr(t), torch.as_tensor(x))), **FLOAT)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_ell_spmm_wrapper_matches_reference(impl):
    """The port's ``ell_spmm`` (plain version on CPU) against the reference
    wrapper's jnp path and its Pallas kernel in interpret mode."""
    j, t = _pair(seed=2)
    je = jf.csr_to_blockell(jf.coo_to_csr(j), block_rows=8, width=8)
    te = tf.csr_to_blockell(tf.coo_to_csr(t), block_rows=8, width=8)
    X = np.random.default_rng(2).normal(size=(60, 4)).astype(np.float32)
    kw = dict(interpret=True, block_rows=8) if impl == "pallas" else {}
    want = np.asarray(j_ell_spmm(je, jnp.asarray(X), impl=impl, **kw))
    np.testing.assert_allclose(want, to_np(t_ell_spmm(te, torch.as_tensor(X))), **FLOAT)


def test_normalizations_and_reorders():
    j, t = _pair(seed=3)
    _assert_coo_equal(jo.normalize_sym(j), to.normalize_sym(t), FLOAT)
    _assert_coo_equal(jo.normalize_rw(j), to.normalize_rw(t), FLOAT)
    js, ts = jo.symmetrize_coo(j), to.symmetrize_coo(t)
    _assert_coo_equal(js, ts)
    _assert_coo_equal(jo.sort_coo_rows(js), to.sort_coo_rows(ts))  # stable: bitwise
    _assert_coo_equal(jo.coo_identity_minus(j), to.coo_identity_minus(t))


def test_laplacian_helpers():
    j, t = _pair(seed=4)
    jg, tg = jlap.normalized_graph(j), tlap.normalized_graph(t)
    _assert_coo_equal(jg.adj_sym, tg.adj_sym, FLOAT)
    np.testing.assert_allclose(np.asarray(jg.deg), to_np(tg.deg), **FLOAT)
    np.testing.assert_allclose(np.asarray(jg.inv_sqrt_deg), to_np(tg.inv_sqrt_deg), **FLOAT)
    v = np.random.default_rng(4).normal(size=(60, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jlap.embed_rows(jnp.asarray(v), jg.inv_sqrt_deg)),
        to_np(tlap.embed_rows(torch.as_tensor(v), tg.inv_sqrt_deg)), **FLOAT)
    _assert_coo_equal(jlap.random_walk_matrix(j), tlap.random_walk_matrix(t), FLOAT)


@pytest.mark.parametrize("weighted", [False, True])
def test_sbm_graph_identical(weighted):
    jc, jl = j_sbm(30, 3, 0.3, 0.05, seed=7, weighted=weighted)
    tc, tl = t_sbm(30, 3, 0.3, 0.05, seed=7, weighted=weighted, device=CPU)
    _assert_coo_equal(jc, tc)
    np.testing.assert_array_equal(np.asarray(jl), to_np(tl))


@pytest.mark.parametrize("neighbors", ["eps", "knn", "none"])
def test_pointcloud_identical(neighbors):
    want = j_dti(300, 12, 5, eps=1.8, neighbors=neighbors, knn_k=6, seed=3)
    got = t_dti(300, 12, 5, eps=1.8, neighbors=neighbors, knn_k=6, seed=3, device=CPU)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), to_np(g))


def test_convert_round_trips_reference_formats():
    j, _ = _pair(seed=5)
    _assert_coo_equal(j, convert.coo(j, device=CPU))
    jc = jf.coo_to_csr(j)
    tc = convert.csr(jc, device=CPU)
    np.testing.assert_array_equal(np.asarray(jc.indptr), to_np(tc.indptr))
    je = jf.csr_to_blockell(jc, width=8)
    te = convert.blockell(je, device=CPU)
    np.testing.assert_array_equal(np.asarray(je.cols), to_np(te.cols))
    _assert_coo_equal(je.tail, te.tail)
    X = np.random.default_rng(5).normal(size=(60, 4)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jo.spmm_blockell(je, jnp.asarray(X))),
                               to_np(to.spmm_blockell(te, torch.as_tensor(X))), **FLOAT)
