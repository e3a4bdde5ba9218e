"""The plain reference against the port at a tiny size, and the control:
the reference in float32 in the program's place passes the check, in TF32
(the nearest precision below the configurations' float32) it fails, and
with a pair dropped or a k-means step broken it fails too."""
from __future__ import annotations

import pytest
import torch

from repro_torch.core.similarity import build_knn_graph
from repro_torch.kernels.knn_topk.ref import knn_topk_ref
from specbench.datasets.dti_points import dti_points
from specbench.reference import eigen, graph, judge, pipeline
from specbench_tiny import TINY_DATA, tiny_config


def _points(seed=3, n=TINY_DATA["n_points"], d=TINY_DATA["d_profile"]):
    pos, prof, _ = dti_points(n, d, TINY_DATA["n_regions"], seed)
    return torch.from_numpy(pos), torch.from_numpy(prof)


@pytest.mark.parametrize("lattice", [True, False])
def test_exact_knn_is_the_ports_plain_search(lattice):
    pos, _ = _points()
    if not lattice:  # integer points off the lattice: ties of other shapes
        pos = torch.randint(0, 9, pos.shape, generator=torch.Generator().manual_seed(0)).float()
    _, want = knn_topk_ref(pos, 16)
    assert torch.equal(graph.exact_knn(pos, 16), want.long())


def test_reference_graph_is_the_ports():
    pos, prof = _points()
    w = build_knn_graph(prof, 16, points=pos, measure="cross_correlation")
    ids = graph.exact_knn(pos, 16)
    row, col, edge = graph.layout(ids)
    assert torch.equal(row, w.row.long()) and torch.equal(col, w.col.long())
    raw = 0.5 * graph.edge_weights(prof, ids, "fp64")[edge]  # (W + Wᵀ)/2
    torch.testing.assert_close(w.val.double(), raw, rtol=1e-5, atol=1e-6)


def test_eigenpairs_match_a_dense_solve():
    pos, prof = _points(n=300)
    g = graph.build(pos, prof, 16, "fp64")
    a = graph.operator(g)
    got = eigen.top_eigenpairs(a, 6, "fp64", tol=1e-9)
    want = torch.linalg.eigvalsh(a.to_dense()).flip(0)[:6]
    torch.testing.assert_close(got.values, want, rtol=0, atol=1e-8)
    assert float(got.residuals.max()) <= 1e-9


def test_the_judges_top_eigenvalues_match_a_dense_solve():
    """At the judge's own tolerance the reference's top eigenvalues are
    those of a dense solve to 1e-12, far below any limit."""
    pos, prof = _points(n=400)
    a = graph.operator(graph.build(pos, prof, 49, "fp64"))
    got = eigen.top_eigenpairs(a, 40, "fp64", tol=judge.SPECTRUM_TOL)
    want = torch.linalg.eigvalsh(a.to_dense()).flip(0)[:40]
    torch.testing.assert_close(got.values, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("precision,fault,correct", [
    ("fp32", None, True), ("tf32", None, False),
    ("fp32", "drop_pair", False), ("fp32", "unchanged", False), ("fp32", "half", False),
    ("fp32", "label", False)])
def test_the_control_fails_and_the_reference_passes(precision, fault, correct):
    cfg = tiny_config(clusters=8)
    pos, prof = _points(seed=5)
    out = pipeline.run(pos, prof, cfg, precision, seed=5, fault=fault)
    nums = judge.judge(out, pos, prof, cfg["pipeline"])
    ok, shown = judge.verdict(nums, cfg["check"]["limits"])
    assert ok is correct, shown
    if fault == "drop_pair":  # only the spectrum tells these pairs from the top ones
        failed = {name for name, (v, lim) in shown.items() if not v <= lim}
        assert failed == {"eig_spectrum"}, shown
