"""The port's spans (:mod:`repro_torch.spans`) on the CPU: nothing is kept
without a profiler; under one, each span is a host range of the profiler's
own timeline (not a user annotation), nested as the layers are; the span
counts of a small job are the program's own numbers; tracing changes no
bit of the result; a stage's ``wall_s`` is its span's host seconds."""
from __future__ import annotations

import sys
import threading
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.lanczos as lz
from repro_torch import spans
from repro_torch._device import cpu_generator
from repro_torch.core.pipeline import SpectralClusteringConfig
from repro_torch.core.spectral import EigConfig, Plan, SpectralPipeline
from repro_torch.sparse.distributed import ShardedCOO

STAGES = ("spectral.prepare", "spectral.embed", "spectral.cluster")
PARENTS = {"lanczos.orth": {"spectral.embed"}, "lanczos.qr": {"spectral.embed"},
           "lanczos.restart": {"spectral.embed"}, "kmeans.seed": {"spectral.cluster"},
           "host.sync": set(STAGES) | {"lanczos.restart"}}


def _blobs(n_per=100, k=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.cat([torch.randn(n_per, 3, generator=g) + 6.0 * i for i in range(k)])


def _pipe(block_size=4):
    return SpectralPipeline(n_clusters=4, eig=EigConfig(block_size=block_size, tol=1e-6,
                                                        representation="blockell"))


def _run(pipe, x, traced):
    spans.reset()
    if not traced:
        return pipe.run_state(x, cpu_generator(7), device="cpu"), spans.records(), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = pipe.run_state(x, cpu_generator(7), device="cpu")
    return st, spans.records(), prof


def test_without_a_profiler_nothing_is_kept():
    st, recs, _ = _run(_pipe(), _blobs(), traced=False)
    assert recs == [] and st.result.lanczos_restarts >= 2
    assert spans.span("lanczos.orth", filled=1, rows=2) is spans.span("host.sync")


def test_spans_are_host_ranges_of_the_profiler_nested_as_the_layers():
    _, recs, prof = _run(_pipe(), _blobs(), traced=True)
    names = {r.name for r in recs}
    assert names == set(PARENTS) | set(STAGES)
    for r in recs:
        parent = None if r.parent is None else recs[r.parent]
        if r.name in STAGES:
            assert parent is None
        else:
            assert parent.name in PARENTS[r.name], (r.name, parent.name)
            assert parent.start_s <= r.start_s <= r.end_s <= parent.end_s
        assert r.device_s == r.end_s - r.start_s  # on the CPU: host seconds
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in names]
    assert Counter(e.name() for e in events) == Counter(r.name for r in recs)
    assert not any(e.is_user_annotation() for e in events)
    assert all(e.device_type() == torch.autograd.DeviceType.CPU for e in events)
    embed = next(e for e in events if e.name() == "spectral.embed")
    for e in events:
        if e.name().startswith("lanczos."):
            assert embed.start_ns() <= e.start_ns() and e.end_ns() <= embed.end_ns()


@pytest.mark.parametrize("block_size", [1, 4])
def test_span_counts_are_the_programs_own_numbers(block_size):
    x = _blobs()
    pipe = _pipe(block_size)
    st, recs, _ = _run(pipe, x, traced=True)
    res = st.result
    products = lz.operator_passes(pipe._lanczos_config(x.shape[0]), res.lanczos_restarts)
    count = Counter(r.name for r in recs)
    # block: the two Gram–Schmidt passes and the cleanup pass, two QRs a step
    assert count["lanczos.orth"] == (2 if block_size > 1 else 1) * products
    assert count["lanczos.qr"] == (2 * products if block_size > 1 else 0)
    assert count["lanczos.restart"] == res.lanczos_restarts
    assert count["kmeans.seed"] == 1
    under = Counter(recs[r.parent].name for r in recs if r.name == "host.sync")
    # Lloyd's changed-label read an iteration; the stage's health reads
    # (non-finite embedding rows, live labels, non-finite inertia) and its
    # report's (clusters with points, inertia); its closing synchronisation
    assert under["spectral.cluster"] == res.kmeans_iterations + 3 + 2 + 1
    assert under["lanczos.restart"] == res.lanczos_restarts  # the cycle's flag read
    # the BlockELL layout's width and spill reads; non-finite embedding rows
    # and eigenvalues; the residual read; the closing synchronisation
    assert under["spectral.embed"] == 2 + 2 + 1 + 1
    # the input guard's non-finite and distinct-row reads; isolated vertices; closing
    assert under["spectral.prepare"] == 2 + 1 + 1


def test_orth_useful_share_by_hand():
    x = _blobs()
    pipe = _pipe(4)
    st, recs, _ = _run(pipe, x, traced=True)
    cfg = pipe._lanczos_config(x.shape[0])
    m, b, keep = lz.effective_basis_size(cfg), cfg.block_size, lz.restart_keep_size(cfg)
    restarts = st.result.lanczos_restarts
    # step j of a cycle multiplies the m + b rows of V, of which j + b hold a vector
    first = [j + b for j in range(0, m, b)]
    steady = [j + b for j in range(keep, m, b)] * (restarts - 1)
    orth = [r for r in recs if r.name == "lanczos.orth"]
    assert sum(r.attrs["filled"] for r in orth) == 2 * (sum(first) + sum(steady))
    assert sum(r.attrs["rows"] for r in orth) == 2 * (len(first) + len(steady)) * (m + b)


@pytest.mark.parametrize("block_size", [1, 4])
def test_tracing_changes_no_bit(block_size):
    x = _blobs(seed=3)
    off, _, _ = _run(_pipe(block_size), x, traced=False)
    on, recs, _ = _run(_pipe(block_size), x, traced=True)
    assert recs
    for f in ("labels", "eigenvalues", "embedding", "kmeans_inertia"):
        assert torch.equal(getattr(off.result, f), getattr(on.result, f)), f


def test_card_events_come_from_a_pool_and_are_read_without_a_wait(monkeypatch):
    """The card's path with a stream the test moves by hand: each span's
    two events are recorded on the stream of the outermost span; the card
    is asked once a ``host.sync`` whether the spans closed before it have
    passed, and those are read and their events reused; ``records()`` waits
    once, for the rest; device seconds are the time between a span's
    events."""
    stream = SimpleNamespace(ticks=0, passed=0, waits=0, queries=0)
    made = []

    class Event:  # a tick of the stream is a millisecond
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self, on):
            assert on is stream
            stream.ticks += 1
            self.at = stream.ticks

        def query(self):
            stream.queries += 1
            return self.at <= stream.passed

        def elapsed_time(self, end):
            assert self.at <= stream.passed and end.at <= stream.passed
            return float(end.at - self.at)

    def synchronize():
        stream.waits += 1
        stream.passed = stream.ticks

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch._C, "_CudaEventBase", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    monkeypatch.setattr(spans, "_threads", [])
    monkeypatch.setattr(spans, "_local", threading.local())
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.clock("spectral.embed"):
            for i in range(50):
                with spans.span("lanczos.orth", filled=i + 1, rows=50):
                    stream.passed = stream.ticks - 4  # the device two spans behind
                if i % 10 == 9:
                    with spans.span("host.sync"):
                        stream.passed = stream.ticks  # the host reads a value
    # new events for the stage, the first ten spans and the first two
    # host.syncs; the pool serves every later span
    assert stream.waits == 0 and stream.queries == 5 and len(made) == 2 + 20 + 2 * 2
    recs = spans.records()
    assert stream.waits == 1
    assert [r.name for r in recs].count("host.sync") == 5
    assert recs[0].device_s == (2 * 55 + 1) * 1e-3  # 55 spans inside
    assert all(r.device_s == 1e-3 for r in recs[1:])
    assert [r.attrs["filled"] for r in recs if r.name == "lanczos.orth"] == list(range(1, 51))
    spans.reset()


def test_each_thread_nests_its_own_spans():
    """Threads tracing at once: a span's parent is the enclosing span of its
    own thread, and no span is lost."""
    def work(tag):
        for i in range(200):
            with spans.span(f"outer.{tag}"):
                with spans.span(f"inner.{tag}", i=i):
                    pass

    spans.reset()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(t,)) for t in "abcd"]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    recs = spans.records()
    assert Counter(r.name for r in recs) == {f"{k}.{t}": 200 for k in ("outer", "inner")
                                             for t in "abcd"}
    for r in recs:
        if r.name.startswith("inner."):
            assert recs[r.parent].name == "outer." + r.name[-1]
        else:
            assert r.parent is None
    spans.reset()


def test_wall_s_is_the_stage_spans_host_seconds():
    st, recs, _ = _run(_pipe(), _blobs(), traced=True)
    walls = {f"spectral.{r.stage}": r.wall_s for r in st.reports}
    assert all(w > 0 for w in walls.values())
    for r in recs:
        if r.name in STAGES:
            assert walls[r.name] == r.end_s - r.start_s
    st, recs, _ = _run(_pipe(), _blobs(), traced=False)
    assert all(r.wall_s > 0 for r in st.reports) and recs == []


def test_wall_s_on_meta_is_minus_one():
    S, E, rps, k = 2, 40, 16, 4
    sm = ShardedCOO(row_local=torch.empty(S * E, dtype=torch.int32, device="meta"),
                    col=torch.empty(S * E, dtype=torch.int32, device="meta"),
                    val=torch.empty(S * E, device="meta"), shape=(S * rps, S * rps),
                    rows_per_shard=rps, num_shards=S, edges_per_shard=E)
    cfg = SpectralClusteringConfig(n_clusters=k, lanczos_m=2 * k, fixed_restarts=1,
                                   fixed_kmeans_iters=2)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        st = cfg.to_pipeline(plan=Plan(device="sharded")).run_state(sm, cpu_generator(0),
                                                                    device="meta")
    assert [r.wall_s for r in st.reports] == [-1.0, -1.0, -1.0]
    # nothing is read back on meta: no host.sync
    assert {r.name for r in spans.records()} >= set(STAGES)
    assert "host.sync" not in {r.name for r in spans.records()}
