"""Port parity: the Chebyshev polynomial-filter solver and its operator
kernels — ``repro_torch`` against the JAX reference on the same numpy
inputs, the reference's random draws injected (its Pallas kernels in
interpret mode).

Tolerances: the BlockELL SpMV and the fused Chebyshev step at atol 1e-5
(fp32 sums of the same products in another order); the filter's scalar
machinery (damping, coefficients, response) at atol 1e-6; the spectral
interval at 1e-5; moments at rtol 1e-4 of their scale n (each is a sum over
n·probes terms after up to 64 recurrence steps); the cut at 1e-4; filtered
signals at 1e-4 of their largest entry; Ritz values within 1e-4 and the
embedding's span aligned ≥ 0.999 (both solve the same R×R problem from the
same fp32 sketch); pipeline labels ARI ≥ 0.99.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import chebyshev as jch
from repro.core import spectral as jsp
from repro.core.operator import BlockEllOperator as JEll
from repro.data.pointcloud import dti_like_pointcloud
from repro.data.sbm import sbm_graph
from repro.kernels.ell_spmm.ops import ell_spmm_cheb_step as j_cheb_step
from repro.kernels.ell_spmv.ops import ell_spmv as j_spmv
from repro.serve.metrics import adjusted_rand_index
from repro.sparse import formats as jf
from repro.testing import faults
from repro_torch import convert
from repro_torch.core import chebyshev as tch
from repro_torch.core import lanczos as tlz
from repro_torch.core import spectral as tsp
from repro_torch.core.operator import BlockEllOperator as TEll
from repro_torch.kernels.ell_spmm.ops import ell_spmm_cheb_step as t_cheb_step
from repro_torch.kernels.ell_spmv.ops import ell_spmv as t_spmv
from tests._parity import subspace_alignment, to_np

CPU = "cpu"


def _graph(n=240, k=4, seed=0):
    """A normalized SBM adjacency as reference and port BlockELL operators."""
    w, _ = sbm_graph(n // k, k, 0.3, 0.02, seed=seed)
    g = jsp.SpectralPipeline(n_clusters=k).prepare(w)
    jm = jf.csr_to_blockell(jf.coo_to_csr(g.adj))
    return JEll(jm), TEll(convert.blockell(jm, device=CPU)), g


def _tailed_blockell(n=97, seed=0):
    """A random COO whose widest rows spill past width 8 into the COO tail."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, n, 6 * n), np.full(40, 3)])
    c = rng.integers(0, n, r.size)
    v = rng.random(r.size).astype(np.float32)
    jm = jf.csr_to_blockell(
        jf.coo_to_csr(jf.coo_from_edges(r, c, v, (n, n), sum_duplicates=True)),
        block_rows=8, width=8)
    assert int(jm.tail.nnz) > 1  # a real tail, not the one-entry dummy
    return jm, convert.blockell(jm, device=CPU)


def _draws(key, n, n_probes, r):
    """The reference's three draws of ``chebyshev_eigsh`` from ``key``."""
    kb, km, ks = jax.random.split(key, 3)
    return (np.array(jax.random.normal(kb, (n,), jnp.float32)),
            np.array(jax.random.rademacher(km, (n, n_probes), jnp.float32)),
            np.array(jax.random.rademacher(ks, (n, r), jnp.float32)))


def _inject(monkeypatch, key):
    """Make the port's :func:`draw_signals` return the reference's draws from
    ``key`` (and, on retries, from ``fold_in(key, attempt)``)."""
    keys = {}

    def fake(gen, n, n_probes, r, device):
        k = keys.setdefault(gen.initial_seed(), key if not keys else
                            jax.random.fold_in(key, len(keys)))
        return tuple(torch.as_tensor(a, device=device) for a in _draws(k, n, n_probes, r))

    monkeypatch.setattr(tch, "draw_signals", fake)


# ---------------------------------------------------------------------------
# kernels B4 and B5 (plain versions here; the CUDA kernels in test_torch_cuda)
# ---------------------------------------------------------------------------

def test_ell_spmv_matches_reference_with_tail():
    jm, tm = _tailed_blockell()
    x = np.random.default_rng(1).normal(size=jm.shape[0]).astype(np.float32)
    want = j_spmv(jm, jnp.asarray(x), impl="pallas", interpret=True, block_rows=8)
    got = t_spmv(tm, torch.as_tensor(x))
    np.testing.assert_allclose(np.asarray(want), to_np(got), atol=1e-5)
    np.testing.assert_allclose(to_np(TEll(tm).mv(torch.as_tensor(x))), to_np(got), atol=0)


@pytest.mark.parametrize("b", [1, 5, 8])
def test_ell_spmm_cheb_step_matches_reference_with_tail(b):
    jm, tm = _tailed_blockell(seed=b)
    rng = np.random.default_rng(b)
    x, prev = (rng.normal(size=(jm.shape[0], b)).astype(np.float32) for _ in range(2))
    ca, cb = np.float32(1.7), np.float32(-0.3)
    want = j_cheb_step(jm, jnp.asarray(x), jnp.asarray(prev), ca, cb, impl="pallas",
                       interpret=True, block_rows=8)
    got = t_cheb_step(tm, torch.as_tensor(x), torch.as_tensor(prev), torch.tensor(ca),
                      torch.tensor(cb))
    np.testing.assert_allclose(np.asarray(want), to_np(got), atol=1e-5)
    unfused = ca * TEll(tm).mm(torch.as_tensor(x)) + cb * torch.as_tensor(x) \
        - torch.as_tensor(prev)
    np.testing.assert_allclose(to_np(TEll(tm).cheb_step(torch.as_tensor(x),
                                                        torch.as_tensor(prev), ca, cb)),
                               to_np(unfused), atol=1e-5)


# ---------------------------------------------------------------------------
# the filter's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 16, 64])
def test_filter_machinery_matches_reference(degree):
    np.testing.assert_allclose(np.asarray(jch.jackson_damping(degree)),
                               to_np(tch.jackson_damping(degree)), atol=1e-6)
    lam = np.linspace(-1.2, 1.3, 41).astype(np.float32)
    for a in (-0.9, 0.0, 0.37, 0.95):
        np.testing.assert_allclose(np.asarray(jch.step_coefficients(jnp.float32(a), degree)),
                                   to_np(tch.step_coefficients(torch.tensor(a), degree)),
                                   atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(jch.filter_response(jnp.asarray(lam), a, -1.1, 1.2, degree)),
            to_np(tch.filter_response(torch.as_tensor(lam), a, -1.1, 1.2, degree)), atol=1e-6)


def test_spectral_bounds_moments_and_cut_match_reference():
    jop, top, g = _graph()
    n = jop.shape[0]
    key = jax.random.PRNGKey(3)
    v, z, _ = _draws(key, n, 8, 1)
    kb = jax.random.split(key, 3)[0]
    jlo, jhi = jch.estimate_spectral_bounds(jop, kb)
    tlo, thi = tch.estimate_spectral_bounds(top, torch.as_tensor(v))
    np.testing.assert_allclose([float(jlo), float(jhi)], [float(tlo), float(thi)], atol=1e-5)
    dense = np.zeros((n, n))
    np.add.at(dense, (np.asarray(g.adj.row), np.asarray(g.adj.col)), np.asarray(g.adj.val))
    spec = np.linalg.eigvalsh(dense)
    assert float(tlo) <= spec[0] and float(thi) >= spec[-1]  # the interval contains spec(A)

    km = jax.random.split(key, 3)[1]
    jmom = jch.chebyshev_moments(jop, jlo, jhi, 24, km, n_probes=8)
    tmom = tch.chebyshev_moments(top, tlo, thi, 24, torch.as_tensor(z))
    np.testing.assert_allclose(np.asarray(jmom), to_np(tmom), rtol=0, atol=1e-4 * n)
    for k in (4, 10, 30):
        ja = jch.find_cut_from_moments(jmom, k)
        ta = tch.find_cut_from_moments(tmom, k)
        np.testing.assert_allclose(float(ja), float(ta), atol=1e-4)
        np.testing.assert_allclose(float(jch.eigencount_from_moments(jmom, ja)),
                                   float(tch.eigencount_from_moments(tmom, ta)),
                                   rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_chebyshev_filter_matches_reference(sign):
    jop, top, _ = _graph()
    x = np.random.default_rng(4).normal(size=(jop.shape[0], 6)).astype(np.float32)
    want = jch.chebyshev_filter(jop, jnp.asarray(x), jnp.float32(-1.05), jnp.float32(1.05),
                                jnp.float32(0.4), 32, sign=sign)
    got = tch.chebyshev_filter(top, torch.as_tensor(x), torch.tensor(-1.05),
                               torch.tensor(1.05), torch.tensor(0.4), 32, sign=sign)
    want = np.asarray(want)
    np.testing.assert_allclose(want, to_np(got), atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which,lambda_cut", [("LA", None), ("LA", 0.5), ("SA", None),
                                              ("SA", -0.2)])
def test_chebyshev_eigsh_matches_reference(monkeypatch, which, lambda_cut):
    jop, top, g = _graph()
    key = jax.random.PRNGKey(7)
    _inject(monkeypatch, key)
    v0 = np.sqrt(np.maximum(np.asarray(g.deg), 0)) + 1e-3
    jcfg = jch.ChebConfig(k=4, which=which, lambda_cut=lambda_cut)
    tcfg = tch.ChebConfig(k=4, which=which, lambda_cut=lambda_cut)
    want = jch.chebyshev_eigsh(jop, jcfg, v0=jnp.asarray(v0), key=key)
    got = tlz.eigsh(top, tcfg, v0=torch.as_tensor(v0, dtype=torch.float32))
    np.testing.assert_allclose(np.asarray(want.eigenvalues), to_np(got.eigenvalues), atol=1e-4)
    assert subspace_alignment(want.eigenvectors, got.eigenvectors) >= 0.999
    np.testing.assert_allclose(np.asarray(want.residuals), to_np(got.residuals), atol=1e-4)
    assert got.restarts == 0 and got.converged
    assert tlz.solver_streams(tcfg) == tch.operator_streams(tcfg) \
        == jch.operator_streams(jcfg)


def test_chebyshev_config_and_guards_match_reference():
    for kw in (dict(k=0), dict(k=3, degree=0), dict(k=3, n_signals=0), dict(k=3, n_probes=0),
               dict(k=3, bounds_iters=1), dict(k=3, which="BE")):
        with pytest.raises(ValueError):
            jch.ChebConfig(**kw)
        with pytest.raises(ValueError):
            tch.ChebConfig(**kw)
    for kw in (dict(k=5), dict(k=5, n_signals=3), dict(k=5, lambda_cut=0.2, degree=9)):
        assert tch.resolved_signals(tch.ChebConfig(**kw)) == \
            jch.resolved_signals(jch.ChebConfig(**kw))
        assert tch.operator_streams(tch.ChebConfig(**kw)) == \
            jch.operator_streams(jch.ChebConfig(**kw))
    _, top, _ = _graph()
    with pytest.raises(ValueError, match="n_signals <= n"):
        tch.chebyshev_eigsh(top, tch.ChebConfig(k=4, n_signals=10_000))
    for vals in ([0.0, 0.1, 0.5], [0.0, 2.0], [np.nan, 0.1], [0.0, 3.0], [-1.0]):
        assert tch.diverged(torch.tensor(vals)) == jch.diverged(np.asarray(vals))


# ---------------------------------------------------------------------------
# the pipeline: lsh + chebyshev + two_pass, and the escalation ladder
# ---------------------------------------------------------------------------

def _scalable(n_clusters, **graph):
    return jsp.SpectralPipeline(
        n_clusters=n_clusters, graph=jsp.GraphConfig(**graph),
        eig=jsp.EigConfig(tol=1e-4, solver="chebyshev", representation="blockell"),
        kmeans=jsp.KMeansConfig(iter="two_pass"))


def _reference_planes(monkeypatch):
    from repro.kernels.lsh_candidates.ops import make_planes as j_planes
    from repro_torch.kernels.lsh_candidates import ops as lsh_ops

    monkeypatch.setattr(lsh_ops, "make_planes",
                        lambda d, t, b, s: torch.as_tensor(np.array(j_planes(d, t, b, s))))


def test_scalable_pipeline_on_sbm_matches_reference(monkeypatch):
    w, truth = sbm_graph(60, 4, 0.3, 0.02, seed=4)
    jpipe = _scalable(4)
    key = jax.random.PRNGKey(0)
    _inject(monkeypatch, jax.random.split(key, 3)[1])
    want = jpipe.run(w, key)
    got = convert.pipeline(jpipe.to_dict()).run(convert.coo(w, device=CPU),
                                                torch.Generator().manual_seed(0), device=CPU)
    assert adjusted_rand_index(np.asarray(want.labels), to_np(got.labels)) >= 0.99
    assert adjusted_rand_index(truth, to_np(got.labels)) >= 0.99
    np.testing.assert_allclose(np.asarray(want.eigenvalues), to_np(got.eigenvalues), atol=1e-4)


def test_scalable_dti_pipeline_matches_reference(monkeypatch):
    """The DTI workflow at 512 voxels on the scalable path: LSH kNN on lattice
    positions (the reference's planes injected), cross-correlation weights,
    the Chebyshev embedding (its draws injected), two-pass k-means."""
    pos, prof, _, _ = dti_like_pointcloud(512, 16, 4, neighbors="none", seed=1)
    jpipe = _scalable(4, knn_k=8, measure="cross_correlation", method="lsh")
    key = jax.random.PRNGKey(0)
    _inject(monkeypatch, jax.random.split(key, 3)[1])
    _reference_planes(monkeypatch)
    want = jpipe.run(jnp.asarray(prof), key, points=jnp.asarray(pos))
    got = convert.pipeline(jpipe.to_dict()).run(prof, torch.Generator().manual_seed(0),
                                                points=pos, device=CPU)
    assert adjusted_rand_index(np.asarray(want.labels), to_np(got.labels)) >= 0.99
    np.testing.assert_allclose(np.asarray(want.eigenvalues), to_np(got.eigenvalues), atol=1e-4)
    assert [r.escalations for r in got.reports] == [(), (), ()]


class _BoundsLiar:
    """``mv`` tells the truth, ``mm`` returns 4·A (the reference's
    ``testing.faults.BoundsLiarOperator``): the bounds estimator sees a tame
    interval while the filter streams an operator far outside it."""

    def __init__(self, op, scale: float = 4.0):
        self._op, self._scale, self.shape = op, scale, op.shape

    def mv(self, x):
        return self._op.mv(x)

    def mm(self, x):
        return self._op.mm(x) * self._scale


def test_escalation_ladder_widens_margin_then_falls_back_to_lanczos():
    rng = np.random.default_rng(0)
    centers = np.array([[0, 0], [5, 0], [0, 5]], np.float32)
    x = centers[np.repeat(np.arange(3), 40)] + rng.normal(size=(120, 2)).astype(np.float32) * .5
    jpipe = jsp.SpectralPipeline(n_clusters=3, eig=jsp.EigConfig(solver="chebyshev"))
    want = jpipe.run(jnp.asarray(x), jax.random.PRNGKey(0),
                     operator=faults.BoundsLiarOperator(
                         jpipe.operator(jpipe.build_graph(jnp.asarray(x)))))
    tpipe = convert.pipeline(jpipe.to_dict())
    top = _BoundsLiar(tpipe.operator(tpipe.build_graph(x, device=CPU)))
    got = tpipe.run(x, torch.Generator().manual_seed(0), operator=top, device=CPU)
    jrep = next(r for r in want.reports if r.stage == "embed")
    trep = next(r for r in got.reports if r.stage == "embed")
    assert trep.escalations == tuple(jrep.escalations) == ("cheb_margin_widen[0.1]",
                                                           "fallback_lanczos")
    assert trep.attempts == 3 and trep.converged
    assert torch.isfinite(got.embedding).all()
    assert adjusted_rand_index(np.repeat(np.arange(3), 40), to_np(got.labels)) >= 0.99
