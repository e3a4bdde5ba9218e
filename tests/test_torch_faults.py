"""Port parity: fault injection — ``repro_torch.testing.faults`` driving the
fail-soft layer of ``repro_torch``'s ``SpectralPipeline`` through every
single-device case of the reference's ``tests/test_faults.py``, each run
beside the reference's own faults on the same inputs.

Every fault class must recover by a named ladder rung or raise a structured
``PipelineError``, as in the reference: the same stage, the same rungs (by
name and count), the same detail.  Tolerances: the poisoners poison the same
entries as the reference's (bitwise: the same ``RandomState`` draws); a
healthy run with health on is bitwise the run with health off.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.health import PipelineError as JPipelineError
from repro.core.spectral import EigConfig as JEig
from repro.core.spectral import SpectralPipeline as JPipeline
from repro.data.sbm import sbm_graph as j_sbm
from repro.sparse.formats import COO as JCOO
from repro.testing import faults as jfaults
from repro_torch import convert
from repro_torch.core import health
from repro_torch.core.health import HealthConfig, PipelineError
from repro_torch.core.similarity import build_knn_graph
from repro_torch.core.spectral import EigConfig, SpectralPipeline
from repro_torch.sparse.formats import COO
from repro_torch.testing import faults
from tests._parity import to_np

CPU = "cpu"
KEY = jax.random.PRNGKey(0)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _blobs(k=3, n_per=30, d=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = (rng.permutation(np.eye(k, d)) * 20.0).astype(np.float32)
    return np.concatenate([c + rng.normal(size=(n_per, d)) for c in centers]).astype(np.float32)


def _raises_both(jrun, trun):
    """Both runs raise ``PipelineError``; returns (reference, port) errors."""
    with pytest.raises(JPipelineError) as je:
        jrun()
    with pytest.raises(PipelineError) as te:
        trun()
    return je.value, te.value


def test_health_enabled_is_bitwise_identical_to_disabled():
    x = _blobs()
    on = SpectralPipeline(n_clusters=3).run(x, _gen(), device=CPU)
    off = SpectralPipeline(n_clusters=3, health=HealthConfig(enabled=False)).run(
        x, _gen(), device=CPU)
    for f in ("labels", "embedding", "kmeans_inertia"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_healthy_run_reports_one_attempt_per_stage():
    out = SpectralPipeline(n_clusters=3).run(_blobs(), _gen(), device=CPU)
    assert [r.stage for r in out.reports] == ["prepare", "embed", "cluster"]
    for r in out.reports:
        assert int(r.attempts) == 1 and r.escalations == () and bool(r.converged)
        assert float(r.wall_s) >= 0.0
    assert health.result_problems(out) == ()
    json.dumps(health.reports_to_dict(out.reports))


def test_nan_operator_raises_structured_pipeline_error():
    x = _blobs()
    jpipe, tpipe = JPipeline(n_clusters=3), SpectralPipeline(n_clusters=3)
    jop = jfaults.NaNOperator(jpipe.operator(jpipe.build_graph(jnp.asarray(x))))
    top = faults.NaNOperator(tpipe.operator(tpipe.build_graph(x, device=CPU)))
    je, te = _raises_both(lambda: jpipe.run(jnp.asarray(x), KEY, operator=jop),
                          lambda: tpipe.run(x, _gen(), operator=top, device=CPU))
    assert te.stage == je.stage == "embed"
    assert te.ladder == je.ladder and len(te.ladder) == 2
    assert all("lanczos_widen" in r for r in te.ladder)
    assert te.detail == je.detail and te.remedy == je.remedy
    assert "[embed]" in str(te) and "ladder exhausted" in str(te)


def test_counting_operator_counts_every_retry():
    x = _blobs()
    pipe = SpectralPipeline(n_clusters=3)
    op = faults.CountingOperator(faults.NaNOperator(pipe.operator(pipe.build_graph(x, device=CPU))))
    with pytest.raises(PipelineError):
        pipe.run(x, _gen(), operator=op, device=CPU)
    single = faults.CountingOperator(pipe.operator(pipe.build_graph(x, device=CPU)))
    pipe.run(x, _gen(), operator=single, device=CPU)
    # three attempts, each on a basis at least as wide as the healthy run's
    assert op.mv_calls >= 3 * single.mv_calls > 0 and op.mm_calls == 0


@pytest.mark.parametrize("recover_after,attempts", [(1, 2), (None, 3)])
def test_forced_nonconvergence_ladder(recover_after, attempts):
    """Recovering mid-ladder (the second attempt tells the truth) and
    exhausted (every attempt poisoned: degraded, reported, labels finite)."""
    x = _blobs()
    with jfaults.forced_nonconvergence(recover_after=recover_after) as jcalls:
        want = JPipeline(n_clusters=3).run(jnp.asarray(x), KEY)
    with faults.forced_nonconvergence(recover_after=recover_after) as calls:
        got = SpectralPipeline(n_clusters=3).run(x, _gen(), device=CPU)
    assert calls[0] == jcalls[0] == attempts
    rep = next(r for r in got.reports if r.stage == "embed")
    jrep = next(r for r in want.reports if r.stage == "embed")
    assert int(rep.attempts) == int(jrep.attempts) == attempts
    assert len(rep.escalations) == len(jrep.escalations) == attempts - 1
    assert all("lanczos_widen" in r for r in rep.escalations)
    assert bool(rep.converged) == bool(np.asarray(jrep.converged)) == (recover_after is not None)
    assert bool(torch.isfinite(got.embedding).all())
    problems = health.result_problems(got)
    if recover_after is None:
        assert any("converged=False" in p for p in problems)
    else:
        assert problems == ()


def test_strict_mode_raises_on_unconverged_embed():
    x = _blobs()
    with jfaults.forced_nonconvergence(), faults.forced_nonconvergence():
        je, te = _raises_both(
            lambda: JPipeline(n_clusters=3, eig=JEig(strict=True)).run(jnp.asarray(x), KEY),
            lambda: SpectralPipeline(n_clusters=3, eig=EigConfig(strict=True)).run(
                x, _gen(), device=CPU))
    assert te.stage == je.stage == "embed"
    assert "strict" in str(te) and te.ladder == je.ladder


def test_chebyshev_bound_violation_falls_back_to_lanczos():
    x = _blobs()
    jpipe = JPipeline(n_clusters=3, eig=JEig(solver="chebyshev"))
    tpipe = SpectralPipeline(n_clusters=3, eig=EigConfig(solver="chebyshev"))
    jop = jfaults.BoundsLiarOperator(jpipe.operator(jpipe.build_graph(jnp.asarray(x))))
    top = faults.BoundsLiarOperator(tpipe.operator(tpipe.build_graph(x, device=CPU)))
    want = jpipe.run(jnp.asarray(x), KEY, operator=jop)
    got = tpipe.run(x, _gen(), operator=top, device=CPU)
    rep = next(r for r in got.reports if r.stage == "embed")
    jrep = next(r for r in want.reports if r.stage == "embed")
    assert rep.escalations == jrep.escalations
    assert any("cheb_margin_widen" in r for r in rep.escalations)
    assert rep.escalations[-1] == "fallback_lanczos" and bool(rep.converged)
    assert bool(torch.isfinite(got.embedding).all())


def test_poisoners_poison_the_reference_entries():
    x = _blobs()
    for kw in (dict(), dict(n_bad=5, value=-1.0, seed=3)):
        got = faults.poison_points(torch.as_tensor(x), **kw)
        np.testing.assert_array_equal(got, jfaults.poison_points(x, **kw))
    w = j_sbm(20, 3, 0.3, 0.05, seed=2)[0]
    for kw in (dict(), dict(n_bad=4, value=-0.5, seed=1)):
        got = faults.poison_graph(convert.coo(w, device=CPU), **kw)
        want = jfaults.poison_graph(w, **kw)
        np.testing.assert_array_equal(to_np(got.val), np.asarray(want.val))
        assert torch.equal(got.row, torch.as_tensor(np.array(w.row)).long())


@pytest.mark.parametrize("case", ["nan_points", "duplicate_only", "k_exceeds_n"])
def test_degenerate_points_raise_at_prepare(case):
    x = {"nan_points": faults.poison_points(_blobs()),
         "duplicate_only": np.ones((20, 4), np.float32),
         "k_exceeds_n": _blobs(k=2, n_per=2)}[case]
    k = 8 if case == "k_exceeds_n" else 3
    je, te = _raises_both(lambda: JPipeline(n_clusters=k).run(jnp.asarray(x), KEY),
                          lambda: SpectralPipeline(n_clusters=k).run(x, _gen(), device=CPU))
    assert te.stage == je.stage == "prepare" and te.detail == je.detail


@pytest.mark.parametrize("value,word", [(np.nan, "non-finite"), (-0.5, "negative")])
def test_poisoned_graph_weights_raise_at_prepare(value, word):
    from repro.core.similarity import build_knn_graph as j_build

    x = _blobs()
    jw = jfaults.poison_graph(j_build(jnp.asarray(x), 10), value=value)
    tw = faults.poison_graph(build_knn_graph(torch.as_tensor(x), 10), value=value)
    je, te = _raises_both(lambda: JPipeline(n_clusters=3).run(jw, KEY),
                          lambda: SpectralPipeline(n_clusters=3).run(tw, _gen(), device=CPU))
    assert word in te.detail and te.detail == je.detail


def test_isolated_vertices_noted_and_survived():
    # two 10-cliques and one vertex with no edges at all
    rows, cols = [], []
    for base in (0, 10):
        for i in range(10):
            for j in range(10):
                if i != j:
                    rows.append(base + i)
                    cols.append(base + j)
    r, c = np.array(rows), np.array(cols)
    jw = JCOO(row=jnp.asarray(r), col=jnp.asarray(c), val=jnp.ones((r.size,), jnp.float32),
              shape=(21, 21), sorted_rows=False)
    tw = COO(torch.as_tensor(r), torch.as_tensor(c), torch.ones(r.size), (21, 21),
             sorted_rows=False)
    want = JPipeline(n_clusters=2).run(jw, KEY)
    out = SpectralPipeline(n_clusters=2).run(tw, _gen(), device=CPU)
    assert out.reports[0].escalations == want.reports[0].escalations == ("isolated_vertices[1]",)
    assert bool(torch.isfinite(out.embedding).all())
    assert out.labels.shape == (21,)


def test_poisoned_cached_embedding_caught_by_cluster_guard():
    x = _blobs()
    jpipe = jfaults.wrap_stage(JPipeline(n_clusters=3), "embed", jfaults.poison_embedding)
    tpipe = faults.wrap_stage(SpectralPipeline(n_clusters=3), "embed", faults.poison_embedding)
    assert isinstance(tpipe, SpectralPipeline) and type(tpipe).__name__.startswith("Faulty_")
    je, te = _raises_both(lambda: jpipe.run(jnp.asarray(x), KEY),
                          lambda: tpipe.run(x, _gen(), device=CPU))
    assert te.stage == je.stage == "cluster" and te.detail == je.detail
    assert "non-finite" in te.detail


def test_wrap_stage_keeps_the_pipeline_config():
    pipe = SpectralPipeline(n_clusters=4, eig=EigConfig(block_size=2))
    wrapped = faults.wrap_stage(pipe, "prepare", lambda st: st)
    assert wrapped.to_dict() == pipe.to_dict()
    x = _blobs(k=4, n_per=20)
    assert torch.equal(wrapped.run(x, _gen(), device=CPU).labels,
                       pipe.run(x, _gen(), device=CPU).labels)
