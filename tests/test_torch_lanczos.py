"""Port parity: Stage 2 — thick-restart Lanczos (single and block) of
``repro_torch`` against the JAX reference, over COO and BlockELL operators
built from the same SBM graph, with the same start vector injected.

Tolerances: eigenvalues within 1e-4 (both solve to tol 1e-6 in fp32; the
block start's random columns differ between the two packages, so the
iterates differ and only converged quantities are comparable); the
eigenvector spans agree when the smallest singular value of
``V_jaxᵀ V_torch`` is ≥ 0.999 on this gapped spectrum.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import lanczos as jlz
from repro.core import laplacian as jlap
from repro.core.operator import BlockEllOperator as JEll, CooOperator as JCoo
from repro.data.sbm import sbm_graph as j_sbm
from repro.sparse import formats as jf
from repro_torch import convert
from repro_torch.core import lanczos as tlz
from repro_torch.core.operator import (BlockEllOperator as TEll, CallableOperator,
                                       CooOperator as TCoo)
from repro_torch.sparse import formats as tf
from tests._parity import subspace_alignment, to_np

K = 4


@pytest.fixture(scope="module")
def graph():
    w, _ = j_sbm(60, K, 0.35, 0.02, seed=3, weighted=True)
    a = jlap.normalized_graph(w).adj_sym
    deg = np.asarray(jlap.normalized_graph(w).deg)
    v0 = np.sqrt(deg) + 1e-3
    return a, convert.coo(a, device="cpu"), v0.astype(np.float32)


def _ops(graph, representation):
    ja, ta, _ = graph
    if representation == "coo":
        return JCoo(ja), TCoo(ta)
    je = jf.csr_to_blockell(jf.coo_to_csr(ja))
    return JEll(je, impl="ref"), TEll(tf.csr_to_blockell(tf.coo_to_csr(ta)))


@pytest.mark.parametrize("block_size", [1, 4])
@pytest.mark.parametrize("representation", ["coo", "blockell"])
def test_eigsh_matches_reference(graph, block_size, representation):
    jop, top = _ops(graph, representation)
    v0 = graph[2]
    cfg = dict(k=K, m=24, tol=1e-6, max_restarts=200, block_size=block_size)
    want = jlz.eigsh(jop, jlz.LanczosConfig(**cfg), v0=jnp.asarray(v0),
                     key=jax.random.PRNGKey(0))
    got = tlz.eigsh(top, tlz.LanczosConfig(**cfg), v0=torch.as_tensor(v0),
                    generator=torch.Generator().manual_seed(0))
    assert bool(want.converged) and got.converged
    np.testing.assert_allclose(np.asarray(want.eigenvalues), to_np(got.eigenvalues),
                               atol=1e-4)
    assert subspace_alignment(np.asarray(want.eigenvectors), got.eigenvectors) >= 0.999
    assert (to_np(got.residuals) <= 1e-4).all()


def test_disconnected_blobs_block_mode():
    """Three disconnected cliques: the top eigenvalue 1 has multiplicity 3,
    which block mode with b = 3 resolves (the reference's documented
    remedy); both packages must find the triple eigenvalue."""
    n_per, blobs = 8, 3
    rows, cols = [], []
    for b in range(blobs):
        idx = np.arange(b * n_per, (b + 1) * n_per)
        r, c = np.meshgrid(idx, idx, indexing="ij")
        keep = r != c
        rows.append(r[keep])
        cols.append(c[keep])
    r, c = np.concatenate(rows), np.concatenate(cols)
    v = np.ones(r.size, np.float32)
    n = n_per * blobs
    ja = jlap.normalized_graph(jf.coo_from_edges(r, c, v, (n, n))).adj_sym
    ta = convert.coo(ja, device="cpu")
    cfg = dict(k=3, m=12, tol=1e-6, max_restarts=50, block_size=3)
    want = jlz.eigsh(JCoo(ja), jlz.LanczosConfig(**cfg), key=jax.random.PRNGKey(1))
    got = tlz.eigsh(TCoo(ta), tlz.LanczosConfig(**cfg),
                    generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(np.asarray(want.eigenvalues), to_np(got.eigenvalues),
                               atol=1e-4)
    np.testing.assert_allclose(to_np(got.eigenvalues), 1.0, atol=1e-4)


@pytest.mark.parametrize("block_size", [1, 2])
def test_breakdown_refill_path(block_size):
    """An all-zero operator breaks down at every step (w is exactly 0), so
    every new basis direction is a random refill.  The spectrum is {0}, the
    refilled basis stays orthonormal, and two runs from one seed agree."""
    n = 30
    z = jf.coo_from_edges(np.arange(n), np.arange(n), np.zeros(n, np.float32), (n, n))
    cfg = dict(k=2, m=8, tol=1e-6, max_restarts=3, block_size=block_size)
    want = jlz.eigsh(JCoo(z), jlz.LanczosConfig(**cfg), key=jax.random.PRNGKey(0))
    runs = [tlz.eigsh(TCoo(convert.coo(z, device="cpu")), tlz.LanczosConfig(**cfg),
                      generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    np.testing.assert_allclose(np.asarray(want.eigenvalues), 0.0, atol=1e-6)
    np.testing.assert_allclose(to_np(runs[0].eigenvalues), 0.0, atol=1e-6)
    u = to_np(runs[0].eigenvectors)
    np.testing.assert_allclose(u.T @ u, np.eye(2), atol=1e-5)
    np.testing.assert_array_equal(u, to_np(runs[1].eigenvectors))


def test_smallest_algebraic_and_fixed_restarts(graph):
    _, top = _ops(graph, "coo")
    jop, _ = _ops(graph, "coo")
    cfg = dict(k=3, m=20, tol=1e-6, max_restarts=300, which="SA")
    want = jlz.eigsh(jop, jlz.LanczosConfig(**cfg), key=jax.random.PRNGKey(2))
    got = tlz.eigsh(top, tlz.LanczosConfig(**cfg), generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(np.asarray(want.eigenvalues), to_np(got.eigenvalues),
                               atol=1e-4)
    fixed = tlz.eigsh(top, tlz.LanczosConfig(k=3, m=20, fixed_restarts=2))
    assert fixed.restarts == 3


def test_lanczos_topk_closure_surface(graph):
    top, v0 = TCoo(graph[1]), graph[2]
    cfg = tlz.LanczosConfig(k=K, m=24, tol=1e-6, max_restarts=200, block_size=2)
    a = tlz.lanczos_topk(top.mv, top.shape[0], cfg, v0=torch.as_tensor(v0))
    b = tlz.eigsh(CallableOperator(n=top.shape[0], matvec=top.mv), cfg,
                  v0=torch.as_tensor(v0))
    np.testing.assert_allclose(to_np(a.eigenvalues), to_np(b.eigenvalues), atol=1e-6)


@pytest.mark.parametrize("b", [1, 2, 4])
def test_accounting_helpers_match(b):
    for k, m, n in ((4, 24, 240), (10, 37, 500)):
        jc = jlz.LanczosConfig(k=k, m=m, block_size=b)
        tc = tlz.LanczosConfig(k=k, m=m, block_size=b)
        assert jlz.effective_basis_size(jc) == tlz.effective_basis_size(tc)
        assert jlz.restart_keep_size(jc) == tlz.restart_keep_size(tc)
        for r in (1, 2, 7):
            assert jlz.operator_passes(jc, r) == tlz.operator_passes(tc, r)
            assert jlz.solver_streams(jc, r) == tlz.solver_streams(tc, r)
        assert jlz.default_config(k, n).m == tlz.default_config(k, n).m
        je, te = jlz.escalate_basis(jc, n), tlz.escalate_basis(tc, n)
        assert (je.m, je.max_restarts) == (te.m, te.max_restarts)
    with pytest.raises(ValueError, match="must exceed"):
        tlz.validate_basis(tlz.LanczosConfig(k=5, m=5), 100)
    with pytest.raises(ValueError, match="operator dimension"):
        tlz.validate_basis(tlz.LanczosConfig(k=5, m=20, block_size=b), 20)


def test_streamed_nnz_and_chebyshev_not_ported(graph):
    _, top = _ops(graph, "blockell")
    cfg = tlz.LanczosConfig(k=K, m=24, block_size=4)
    assert tlz.streamed_nnz(top, cfg, 2) == tlz.operator_passes(cfg, 2) * top.nnz
    from repro.core.chebyshev import ChebConfig

    with pytest.raises(NotImplementedError, match="A6"):
        tlz.eigsh(top, ChebConfig(k=K))
