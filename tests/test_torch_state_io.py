"""Port parity: checkpoints and resume — ``repro_torch.ckpt`` and
``repro_torch.core.state_io`` against :mod:`repro.ckpt.manager` and
:mod:`repro.core.state_io`, and ``run(checkpoint_dir=, resume_from=)``.

Tolerances: none — the on-disk format is the reference's (the same
manifest and the same ``.npy`` leaves), so every restored array is bitwise
equal to the one saved, across the two packages in both directions, and a
resumed run on the CPU lands bitwise on the uninterrupted run's labels.
"""
import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as JManager
from repro.core import spectral as jsp
from repro.core import state_io as jio
from repro.core.reduce import CoarsenConfig as JCoarsen
from repro.data.sbm import sbm_graph
from repro_torch import convert
from repro_torch.ckpt import CheckpointManager
from repro_torch.core import spectral as tsp
from repro_torch.core import state_io as tio
from repro_torch.core.health import PipelineError
from tests._parity import to_np

CPU = "cpu"
_COARSEN = ("prepare", "coarsen", "embed", "refine", "cluster")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _blobs(n_per=40, k=3, d=6, seed=0, scale=20.0):
    rng = np.random.default_rng(seed)
    centers = (np.eye(k, d) * scale).astype(np.float32)
    return np.concatenate([centers[i] + rng.normal(size=(n_per, d))
                           for i in range(k)]).astype(np.float32)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(8, 4)).astype(np.float32),
            "b.c": rng.integers(0, 10, (3,)).astype(np.int32),
            "__meta__": np.frombuffer(b'{"x": 1}', np.uint8).copy(),
            "scalar": np.asarray(3, np.int64)}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype and np.array_equal(a[k], b[k])
        for k in a)


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------

def test_manager_writes_the_reference_format(tmp_path):
    """The same flat dict saved by both managers: identical manifests and
    leaf files, and each restores the other's."""
    t = _tree()
    CheckpointManager(str(tmp_path / "port")).save(5, t)
    JManager(str(tmp_path / "ref")).save(5, t)
    pd, rd = tmp_path / "port" / "step_00000005", tmp_path / "ref" / "step_00000005"
    assert sorted(os.listdir(pd)) == sorted(os.listdir(rd))
    for name in os.listdir(pd):
        assert (pd / name).read_bytes() == (rd / name).read_bytes(), name
    assert _equal(JManager(str(tmp_path / "port")).restore_dict(5), t)
    assert _equal(CheckpointManager(str(tmp_path / "ref")).restore_dict(5), t)
    # torch leaves snapshot to numpy
    CheckpointManager(str(tmp_path / "torch")).save(1, {"x": torch.arange(4)})
    np.testing.assert_array_equal(CheckpointManager(str(tmp_path / "torch")).restore_dict(1)["x"],
                                  np.arange(4))


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    step, got = mgr.restore_latest()
    assert step == 4 and _equal(got, _tree(4))
    mgr.delete(4)
    assert mgr.all_steps() == [3]


def test_manager_damaged_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    os.remove(tmp_path / "step_00000002" / "leaf_00000.npy")
    step, got = mgr.restore_latest()
    assert step == 1 and _equal(got, _tree(1))


def test_tmp_dir_never_restored(tmp_path):
    """A write that crashed before its rename leaves ``step_XXXXXXXX.tmp``:
    neither the manager nor ``load_state`` takes it."""
    mgr = CheckpointManager(str(tmp_path / "a"))
    mgr.save(1, _tree(1))
    os.makedirs(tmp_path / "a" / "step_00000009.tmp")
    assert mgr.all_steps() == [1]
    st = tsp.PipelineState(points=torch.ones(4, 2), provenance=("prepare",))
    tio.save_state(str(tmp_path / "b"), st)
    os.rename(tmp_path / "b" / "step_00000000", tmp_path / "b" / "step_00000000.tmp")
    with pytest.raises(FileNotFoundError, match="no intact"):
        tio.load_state(str(tmp_path / "b"), device=CPU)


def test_load_state_defaults_to_the_card(tmp_path):
    """``load_state`` and ``state_from_tree`` put the tensors on the card
    unless the caller names another device, as every entry point of the
    port does: without a card they raise rather than fall back to the CPU."""
    st = tsp.PipelineState(points=torch.ones(4, 2), provenance=("prepare",))
    tio.save_state(str(tmp_path), st)
    tree = tio.state_to_tree(st)
    if torch.cuda.is_available():
        assert tio.load_state(str(tmp_path))[0].points.device.type == "cuda"
        assert tio.state_from_tree(tree)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tio.load_state(str(tmp_path))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tio.state_from_tree(tree)


def test_manager_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, _tree(7), blocking=False)
    mgr.wait()
    step, got = mgr.restore_latest()
    assert step == 7 and _equal(got, _tree(7))


# ---------------------------------------------------------------------------
# the state codec
# ---------------------------------------------------------------------------

def _coarse_state(x, pipe):
    """A state with every slot filled: points and search points, the fine and
    coarse graphs, the coarse embedding, the coarsen hand-off and a result."""
    st = tsp.PipelineState(points=torch.as_tensor(x), search_points=torch.as_tensor(x[:, :3]),
                           gen_embed=_gen(1), gen_cluster=_gen(2), device=torch.device(CPU))
    for name in ("prepare", "coarsen", "embed", "cluster"):
        st = getattr(pipe, f"_stage_{name}")(st)
    return st


def _assert_same_data(a, b, *, generators=True):
    """Every data slot of two port states bitwise equal."""
    def eq(x, y):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y)

    def graph_eq(g, h):
        for f in ("row", "col", "val"):
            eq(getattr(g.adj, f), getattr(h.adj, f))
        assert g.adj.shape == h.adj.shape and g.adj.sorted_rows == h.adj.sorted_rows
        eq(g.deg, h.deg)
        eq(g.inv_sqrt_deg, h.inv_sqrt_deg)

    eq(a.points, b.points)
    eq(a.search_points, b.search_points)
    graph_eq(a.graph, b.graph)
    for f in ("embedding", "eigenvalues", "residuals"):
        eq(getattr(a.embedding, f), getattr(b.embedding, f))
    assert (a.embedding.restarts, a.embedding.converged) == \
        (b.embedding.restarts, b.embedding.converged)
    for f in ("labels", "embedding", "eigenvalues", "eig_residuals", "kmeans_inertia"):
        eq(getattr(a.result, f), getattr(b.result, f))
    assert a.result.reports == b.result.reports
    graph_eq(a.reduction.fine_graph, b.reduction.fine_graph)
    eq(a.reduction.prolong, b.reduction.prolong)
    assert a.reduction.info == b.reduction.info
    assert (a.provenance, a.reductions, a.reports) == (b.provenance, b.reductions, b.reports)
    if generators:
        for f in ("gen_embed", "gen_cluster"):
            assert torch.equal(getattr(a, f).get_state(), getattr(b, f).get_state())


def test_state_round_trip_every_slot_bitwise(tmp_path):
    x = _blobs()
    pipe = tsp.SpectralPipeline(n_clusters=3, stages=_COARSEN,
                                coarsen=tsp.CoarsenConfig(min_nodes=16))
    st = _coarse_state(x, pipe)
    assert st.reduction is not None and st.result is not None
    tio.save_state(str(tmp_path), st, pipe)
    st2, pipe_dict = tio.load_state(str(tmp_path), pipe, device=CPU)
    assert pipe_dict == pipe.to_dict()
    _assert_same_data(st, st2)
    # a prebuilt-graph input round-trips too
    w, _ = sbm_graph(20, 2, 0.5, 0.05, seed=1)
    g = convert.coo(w, device=CPU)
    st3, _ = tio.state_from_tree(tio.state_to_tree(tsp.PipelineState(input_graph=g)),
                                device=CPU)
    for f in ("row", "col", "val"):
        assert torch.equal(getattr(g, f), getattr(st3.input_graph, f))


def _reference_state():
    """The reference's state after prepare → coarsen → embed → cluster on the
    blobs, with its PRNG keys."""
    x = _blobs()
    pipe = jsp.SpectralPipeline(n_clusters=3, stages=_COARSEN, coarsen=JCoarsen(min_nodes=16))
    _, ke, kk = jax.random.split(jax.random.PRNGKey(0), 3)
    st = jsp.PipelineState(points=x, search_points=x[:, :3], key_embed=ke, key_cluster=kk)
    for name in ("prepare", "coarsen", "embed", "cluster"):
        st = getattr(pipe, f"_stage_{name}")(st)
    return st, pipe


def _tree_equal_to_reference(jst, tst):
    """The data slots of a reference state and a port state bitwise equal
    (indices compared as values: the reference keeps int32, the port int64)."""
    jt, tt = jio.state_to_tree(jst), tio.state_to_tree(tst)
    data = [k for k in jt if k not in ("__meta__", "key_embed", "key_cluster")]
    assert sorted(data) == sorted(k for k in tt if k not in ("__meta__", "gen_embed",
                                                             "gen_cluster"))
    for k in data:
        a, b = np.asarray(jt[k]), np.asarray(tt[k])
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=k)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    jm, tm = (json.loads(bytes(t["__meta__"]).decode()) for t in (jt, tt))
    assert jm["provenance"] == tm["provenance"] and jm["reductions"] == tm["reductions"]


def test_reference_checkpoint_restored_by_port(tmp_path):
    jst, jpipe = _reference_state()
    jio.save_state(str(tmp_path), jst, jpipe)
    tpipe = convert.pipeline(jpipe.to_dict())
    tst, pipe_dict = tio.load_state(str(tmp_path), tpipe, device=CPU)
    assert pipe_dict == jpipe.to_dict()
    _tree_equal_to_reference(jst, tst)
    # the documented rule: each key's words (w0, w1) seed a generator w0·2³² + w1
    for gen, key in ((tst.gen_embed, jst.key_embed), (tst.gen_cluster, jst.key_cluster)):
        w0, w1 = (int(v) for v in np.asarray(key))
        assert gen.initial_seed() == (w0 << 32) | w1


def test_port_checkpoint_restored_by_reference(tmp_path):
    x = _blobs()
    pipe = tsp.SpectralPipeline(n_clusters=3, stages=_COARSEN,
                                coarsen=tsp.CoarsenConfig(min_nodes=16))
    tst = _coarse_state(x, pipe)
    tio.save_state(str(tmp_path), tst, pipe)
    jst, pipe_dict = jio.load_state(str(tmp_path))
    assert pipe_dict == pipe.to_dict()
    assert jst.key_embed is None and jst.key_cluster is None  # generators are the port's
    _tree_equal_to_reference(jst, tst)


def test_sharded_checkpoint_raises_naming_a12():
    tree = tio.state_to_tree(tsp.PipelineState(input_graph=convert.coo(
        sbm_graph(10, 2, 0.5, 0.1, seed=0)[0], device=CPU)))
    meta = json.loads(bytes(tree["__meta__"]).decode())
    meta["input_graph"]["kind"] = "sharded"
    tree["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    with pytest.raises(NotImplementedError, match="A12"):
        tio.state_from_tree(tree, device=CPU)


# ---------------------------------------------------------------------------
# run(checkpoint_dir=, resume_from=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages,fail_at", [
    (tsp.DEFAULT_STAGES, "embed"),
    (_COARSEN, "refine"),
    (("prepare", "sparsify", "embed", "cluster"), "cluster"),
])
def test_checkpoint_on_error_then_resume(tmp_path, monkeypatch, stages, fail_at):
    """A PipelineError saves the completed-stage prefix; resume skips those
    stages and lands bitwise on the uninterrupted run's labels."""
    x = _blobs(seed=4)
    pipe = tsp.SpectralPipeline(n_clusters=3, stages=stages,
                                coarsen=tsp.CoarsenConfig(min_nodes=16))
    fresh = pipe.run(x, _gen(7), device=CPU)

    def fail(self, st):
        raise PipelineError(fail_at, "forced failure", remedy="none")

    with monkeypatch.context() as m:
        m.setattr(tsp.SpectralPipeline, f"_stage_{fail_at}", fail)
        with pytest.raises(PipelineError) as ei:
            pipe.run(x, _gen(7), checkpoint_dir=str(tmp_path), device=CPU)
    assert ei.value.checkpoint == str(tmp_path)
    assert "resume_from" in str(ei.value)
    st, _ = tio.load_state(str(tmp_path), device=CPU)
    done = stages[:stages.index(fail_at)]
    assert [p.split("[")[0] for p in st.provenance] == list(done)
    out = pipe.run(resume_from=str(tmp_path), device=CPU)
    assert torch.equal(out.labels, fresh.labels)
    assert torch.equal(out.embedding, fresh.embedding)


def test_resume_rejects_conflicting_inputs(tmp_path):
    x = _blobs(n_per=30, seed=6)
    pipe = tsp.SpectralPipeline(n_clusters=3)
    tio.save_state(str(tmp_path), pipe.run_state(x, _gen(), device=CPU), pipe)
    for kw in (dict(data=x), dict(generator=_gen()), dict(points=x)):
        with pytest.raises(ValueError, match="resume_from"):
            pipe.run(resume_from=str(tmp_path), device=CPU, **kw)
    done = pipe.run(resume_from=str(tmp_path), device=CPU)  # nothing left to run
    assert done.labels.shape == (90,)


def test_resume_of_a_reference_checkpoint_runs_the_rest():
    """The reference's prefix (prepare → coarsen → embed) finished by the port:
    refine and cluster run with the generators made from its keys."""
    jst, jpipe = _reference_state()
    jst = dataclasses.replace(jst, result=None, provenance=jst.provenance[:3])
    tpipe = convert.pipeline(jpipe.to_dict())
    tst, _ = tio.state_from_tree(jio.state_to_tree(jst, jpipe), device=CPU)
    out = tpipe.run_stages(tst)
    assert out.provenance[-2:] == ("refine", "cluster")
    assert to_np(out.result.labels).shape == (120,)
    assert np.unique(to_np(out.result.labels)).size == 3
