"""The metrics that read the port's spans (``repro_torch.spans``): a traced
run of the tiny cell on the CPU reports each of them, an untraced run none;
a program without spans leaves them silent; the stage idle seconds by hand
on a planted trace."""
from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import pytest

from specbench import harness, runner
from specbench.trace import Trace
from specbench_tiny import REPO, TINY_CELL, make_root

SPAN_METRICS = ("lanczos_orth_s", "lanczos_orth_useful", "lanczos_qr_s", "lanczos_restart_s",
                "seeding_s", "host_syncs", "embed_idle_s", "cluster_idle_s")


def _reader(name):
    return harness.load_module(harness.part_path(REPO, "metrics", name))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def test_the_span_metrics_are_the_cells_per_layer_metrics():
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    names = {m["name"] for m in harness.metrics_for(man, "dti-exact.serial", True)}
    assert set(SPAN_METRICS) <= names


def test_a_traced_tiny_run_reports_every_span_metric(root):
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import spans

    spans.reset()  # spans of another traced run in this process
    out = runner.run_cell(root, TINY_CELL, 2**31 + 11, 0.2, True, device="cpu")
    assert out["correct"], out["check"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS) <= set(got)
    assert all(got[k] > 0 for k in SPAN_METRICS), got
    assert got["lanczos_orth_useful"] < 100  # the first step multiplies zero rows
    # on the CPU the span's device seconds are its host seconds, all inside the stage
    assert got["lanczos_orth_s"] + got["lanczos_qr_s"] + got["lanczos_restart_s"] \
        < got["embed_s"]
    assert got["seeding_s"] < got["cluster_s"]
    # no device operation on the CPU: the stage's whole range reads idle
    assert got["cluster_idle_s"] == pytest.approx(got["cluster_s"], rel=0.2)
    assert got["host_syncs"] >= got["kmeans_iters"]


def test_an_untraced_run_reports_none_of_them(root):
    out = runner.run_cell(root, TINY_CELL, 2**31 + 12, 0.05, False, device="cpu")
    assert out["correct"], out["check"]
    assert not set(SPAN_METRICS) & set(out["metrics"])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_spans_leaves_the_metric_silent(name, monkeypatch):
    sys.path.insert(0, str(REPO / "src"))
    import repro_torch

    # the import fails, as on a program from before the spans
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    trace = Trace(device=[("k", 0.0, 1.0)], host=[("aten::mm", 0.0, 1.0)], busy_s=1.0)
    assert _reader(name).read(SimpleNamespace(trace=trace, jobs=[{}])) is None


def test_stage_idle_by_hand():
    # two stage ranges, [1, 5] and [10, 12]; an operation from before the
    # first covers [1, 2], two overlap on [2.5, 4], one ends past the range;
    # the second range holds one operation of 0.5 s
    dev = [("a", 0.0, 2.0), ("b", 2.5, 3.5), ("c", 3.0, 4.0), ("d", 4.5, 6.0),
           ("e", 10.5, 11.0)]
    host = [("spectral.embed", 1.0, 5.0), ("aten::mm", 2.5, 3.0),
            ("spectral.embed", 10.0, 12.0)]
    run = SimpleNamespace(trace=Trace(dev, host, busy_s=0.0), jobs=[{}, {}])
    idle = (4.0 - (1.0 + 1.5 + 0.5)) + (2.0 - 0.5)
    assert _reader("embed_idle_s").read(run) == pytest.approx(idle / 2)
    assert _reader("cluster_idle_s").read(run) is None  # no such range
