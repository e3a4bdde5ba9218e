"""The GNN family in the port (``repro_torch.models.gnn``, its configs, the
shape adapters of ``configs.cells`` and ``convert.gnn_params`` /
``convert.graph_batch``) against the reference (``repro.models.gnn``) on
the CPU.

Inputs are numpy draws from a seed, fed to both packages; weights are the
reference's ``init_params(cfg, PRNGKey(0))`` carried across by
``convert.gnn_params``.  The tiny graph is ``tests/test_arch_smoke.py``'s
(40 nodes, 120 edges, src and dst drawn independently, so it has self
loops and duplicate edges); the ``graph_reg`` batch is the ``molecule``
layout at small size (4 graphs × 10 nodes, 30 edges each, a graph id a
node).

Tolerances: the scatter functions within 1e-6 (their gradients too);
``forward`` and ``loss`` within 1e-5 of max|out|; gradients within 1e-4 of
each leaf's max|g|; one train step's loss within 1e-5 relative and the
parameters within 1e-5 of max|p| over the tree (not of each leaf's own
max: AdamW's step lr·m̂/(√v̂ + ε) is steep where a gradient is within
rounding of ε, and such an element may differ by a good part of lr); remat on and off within 1e-6;
the chunked paths within 1e-5 of the reference's chunked path.  Two
models are worse conditioned than those gates, and the reference shows it
on itself (moving its inputs by one ulp, measured in
:func:`test_reference_conditioning`):

* equiformer-v2's equivariant RMS norm divides each l > 0 channel by its
  RMS, ~1e-2 after the first layer, so fp32 rounding in the attention's
  sums (~4e-8) comes out ~100× larger: the reference's own ``forward``
  moves up to 6e-5 of max|out| when the positions move by one ulp.  Its
  ``forward`` is held within 5e-4 of max|out| and its gradients within
  1e-3 of each leaf's max|g| (``loss`` stays at 1e-5).
* pna's std aggregator is ``sqrt(max(E[m²] − E[m]², 1e-8))``: at a node
  with one distinct incoming message the variance is rounding noise, and
  whether the clamp holds decides a gradient of ~1/(2·1e-4).  The
  reference's own gradients move 3.8e-4 of a leaf's max under a one-ulp
  change of the node features; its gradients are held within 1e-3.  The
  same clamp makes the reference's jitted loss differ from its own eager
  loss by 5.8e-5 relative on the ``graph_reg`` batch (the port's equals
  the eager one): pna's train-step loss is held within 2e-4 of the
  reference's jitted step.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import cells as j_cells
from repro.models.gnn import chunked as j_chunked
from repro.models.gnn import graph as JG
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import state as j_state
from repro_torch import _tree, convert
from repro_torch.configs import ARCHS, ASSIGNED
from repro_torch.configs import cells
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.models.gnn import chunked
from repro_torch.models.gnn import equiformer_v2 as teq
from repro_torch.models.gnn import graph as G
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import _grads_of, init_state, make_train_step

from tests._parity import to_np

GNN_ARCHS = ["gcn-cora", "pna", "nequip", "equiformer-v2"]
GEOMETRIC = ("nequip", "equiformer-v2")
CASES = [(a, t) for a in GNN_ARCHS for t in ("node_class", "graph_reg")]
FWD_FRAC = {"equiformer-v2": 5e-4}
GRAD_FRAC = {"pna": 1e-3, "equiformer-v2": 1e-3}
STEP_LOSS_RTOL = {"pna": 2e-4}


def _close(got, want, frac):
    want = np.asarray(want, np.float64)
    got = to_np(got).astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-30))


def _graph_arrays(geometric, task, n=40, e=120, d_in=32, n_classes=4, seed=0):
    """numpy fields of a GraphBatch: the tiny graph (node_class), or 4
    molecules of 10 nodes and 30 edges each (graph_reg)."""
    rng = np.random.default_rng(seed)
    if task == "graph_reg":
        g = 4
        gid = np.repeat(np.arange(g), n // g).astype(np.int32)
        base = np.repeat(np.arange(g) * (n // g), e // g)
        src = (base + rng.integers(0, n // g, e)).astype(np.int32)
        dst = (base + rng.integers(0, n // g, e)).astype(np.int32)
        labels, lmask = rng.normal(size=g).astype(np.float32), np.ones(g, np.float32)
    else:
        g, gid = 1, None
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
        labels, lmask = rng.integers(0, n_classes, n).astype(np.int32), np.ones(n, np.float32)
    return dict(
        node_feat=rng.normal(size=(n, d_in)).astype(np.float32), edge_src=src, edge_dst=dst,
        edge_mask=np.ones(e, np.float32), labels=labels, label_mask=lmask,
        positions=(rng.normal(size=(n, 3)) * 2).astype(np.float32) if geometric else None,
        species=rng.integers(0, 5, n).astype(np.int32) if geometric else None,
        graph_id=gid, n_graphs=g)


def _batches(arrays):
    jb = JG.GraphBatch(**{k: v if k == "n_graphs" or v is None else jnp.asarray(v)
                          for k, v in arrays.items()})
    return jb, convert.graph_batch(jb, device="cpu")


def _configs(name, task, **kw):
    def one(arch):
        cfg = arch.smoke_config
        if name in GEOMETRIC:
            return dataclasses.replace(cfg, n_classes=4, task=task, **kw)
        return dataclasses.replace(cfg, d_in=32, n_classes=4, task=task, **kw)

    return one(J_ARCHS[name]), one(ARCHS[name])


def _models(name):
    return j_cells._gnn_model(J_ARCHS[name]), cells._gnn_model(ARCHS[name])


def _setup(name, task, **kw):
    jcfg, tcfg = _configs(name, task, **kw)
    jm, tm = _models(name)
    jb, tb = _batches(_graph_arrays(name in GEOMETRIC, task))
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    return jm, tm, jcfg, tcfg, jb, tb, jp, convert.gnn_params(jp, device="cpu")


def _tgrads(tm, tcfg, tp, tb):
    return _grads_of(lambda p, b: tm.loss(p, b, tcfg), tp, tb)


# ---------------------------------------------------------------------------
# configs, registry, shape adapters, conversion
# ---------------------------------------------------------------------------

def _asdict(cfg):
    d = dataclasses.asdict(cfg)
    dt = d.pop("dtype")
    return d, (dt if isinstance(dt, torch.dtype) else jnp.dtype(dt)).__str__().replace(
        "torch.", "")


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_configs_match_reference_field_for_field(name):
    for which in ("config", "smoke_config"):
        assert _asdict(getattr(ARCHS[name], which)) == _asdict(getattr(J_ARCHS[name], which))
    assert ARCHS[name].family == J_ARCHS[name].family == "gnn"
    assert ARCHS[name].notes == J_ARCHS[name].notes
    assert ({k: dataclasses.asdict(v) for k, v in ARCHS[name].shapes.items()}
            == {k: dataclasses.asdict(v) for k, v in J_ARCHS[name].shapes.items()})


def test_registry_order_and_assigned_equal_the_reference():
    assert list(ARCHS) == list(J_ARCHS)
    assert [a.name for a in ASSIGNED] == [a.name for a in J_ASSIGNED]


def test_gnn_assigned_config_dims():
    assert ARCHS["gcn-cora"].config.d_hidden == 16 and ARCHS["gcn-cora"].config.n_layers == 2
    assert ARCHS["pna"].config.d_hidden == 75 and ARCHS["pna"].config.n_layers == 4
    c = ARCHS["nequip"].config
    assert (c.n_layers, c.channels, c.l_max, c.n_rbf, c.cutoff) == (5, 32, 2, 8, 5.0)
    assert c.edge_chunk == 1 << 20
    c = ARCHS["equiformer-v2"].config
    assert (c.n_layers, c.channels, c.l_max, c.m_max, c.n_heads) == (12, 128, 6, 2, 8)
    assert c.edge_chunk == 1 << 18 and c.dtype == torch.bfloat16


@pytest.mark.parametrize("name", GNN_ARCHS)
@pytest.mark.parametrize("shape", list(GNN_SHAPES))
def test_gnn_shape_config_matches_reference(name, shape):
    got = cells.gnn_shape_config(ARCHS[name], GNN_SHAPES[shape])
    want = j_cells.gnn_shape_config(J_ARCHS[name], J_ARCHS[name].shapes[shape])
    assert _asdict(got) == _asdict(want)
    assert cells._gnn_model(ARCHS[name]).__name__.rsplit(".", 1)[1] == \
        j_cells._gnn_model(J_ARCHS[name]).__name__.rsplit(".", 1)[1]


def test_pad_div_matches_reference():
    for x in (1, 31, 32, 33, 2449029, 61859140, 169984):
        assert cells._pad_div(x) == j_cells._pad_div(x)
    assert cells._pad_div(10, 4) == j_cells._pad_div(10, 4) == 12


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_init_params_has_the_reference_tree(name):
    """Same leaves in the same order, shapes and dtypes (the reference's by
    ``eval_shape``), at SMOKE and at the published config's dtype; drawn
    on the CPU from the port's stream, reproducibly."""
    jm, tm = _models(name)
    for which in ("smoke_config", "config"):
        jcfg, tcfg = getattr(J_ARCHS[name], which), getattr(ARCHS[name], which)
        if which == "config" and name == "equiformer-v2":  # the bf16 tree at SMOKE widths
            jcfg = dataclasses.replace(J_ARCHS[name].smoke_config, dtype=jnp.bfloat16)
            tcfg = dataclasses.replace(ARCHS[name].smoke_config, dtype=torch.bfloat16)
        want = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
        got = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
        assert [(tuple(a.shape), str(a.dtype).replace("torch.", "")) for a in _tree.leaves(got)] \
            == [(tuple(a.shape), a.dtype.name) for a in jax.tree.leaves(want)]
    again = tm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(got), _tree.leaves(again)))


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_init_params_refuses_a_missing_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cells._gnn_model(ARCHS[name]).init_params(ARCHS[name].smoke_config, torch.Generator())


def test_convert_graph_batch_keeps_fields_and_dtypes():
    jb, tb = _batches(_graph_arrays(True, "graph_reg"))
    assert [f.name for f in dataclasses.fields(G.GraphBatch)] == \
        [f.name for f in dataclasses.fields(JG.GraphBatch)]
    for f in dataclasses.fields(G.GraphBatch):
        j, t = getattr(jb, f.name), getattr(tb, f.name)
        if f.name == "n_graphs":
            assert t == j == 4 and isinstance(t, int)
        else:
            assert str(t.dtype).replace("torch.", "") == np.asarray(j).dtype.name
            assert np.array_equal(to_np(t), np.asarray(j))
    assert (tb.n_nodes, tb.n_edges) == (jb.n_nodes, jb.n_edges) == (40, 120)
    jm, _ = _models("pna")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      jm.init_params(J_ARCHS["pna"].smoke_config, jax.random.PRNGKey(0)))
    tp = convert.gnn_params(jp, device="cpu")
    assert all(t.dtype == torch.bfloat16 and np.array_equal(
        to_np(t.float()), np.asarray(j, np.float32))
        for t, j in zip(_tree.leaves(tp), jax.tree.leaves(jp)))


# ---------------------------------------------------------------------------
# scatter helpers
# ---------------------------------------------------------------------------

def _segments(seed=3, e=50, n=9, d=4):
    """Messages with ties (duplicated rows), an empty segment (node 7) and a
    fully masked segment (node 8: every logit −inf)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, 7, e).astype(np.int32)
    dst[-4:] = 8
    msg = rng.normal(size=(e, d)).astype(np.float32)
    msg[0] = msg[1] = 5.0
    dst[1] = dst[0]  # a tie at the maximum of one segment
    msg[5, 0] = msg[6, 0] = 3.0
    dst[6] = dst[5]
    logits = msg.copy()
    logits[-4:] = -np.inf
    return msg, logits, dst, n


SCATTERS = ["scatter_sum", "scatter_mean", "scatter_max", "scatter_min", "scatter_softmax"]


@pytest.mark.parametrize("fn", SCATTERS)
def test_scatter_matches_reference(fn):
    msg, logits, dst, n = _segments()
    x = logits if fn == "scatter_softmax" else msg
    want = np.asarray(getattr(JG, fn)(jnp.asarray(x), jnp.asarray(dst), n))
    got = getattr(G, fn)(torch.from_numpy(x), torch.from_numpy(dst), n)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-6, atol=1e-6)
    if fn in ("scatter_max", "scatter_min"):  # empty segments stay at ∓inf
        assert np.isneginf(to_np(got)[7]).all() if fn == "scatter_max" else \
            np.isposinf(to_np(got)[7]).all()
    if fn == "scatter_softmax":  # fully masked destination: zeros, not NaN
        assert not to_np(got)[-4:].any()


@pytest.mark.parametrize("fn", SCATTERS)
def test_scatter_gradients_match_jax_grad(fn):
    """Gradients of Σ w·fn(x) against ``jax.grad``: ties split evenly in
    both, empty and masked segments give no gradient."""
    msg, logits, dst, n = _segments()
    x = logits if fn == "scatter_softmax" else msg
    w = np.random.default_rng(4).normal(size=(x.shape[0] if fn == "scatter_softmax" else n,
                                              x.shape[1])).astype(np.float32)

    def jloss(a):
        out = getattr(JG, fn)(a, jnp.asarray(dst), n)
        return jnp.where(jnp.isfinite(out), out * w, 0.0).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = getattr(G, fn)(xt, torch.from_numpy(dst), n)
    torch.where(torch.isfinite(out), out * torch.from_numpy(w), 0.0).sum().backward()
    np.testing.assert_allclose(to_np(xt.grad), want, rtol=1e-6, atol=1e-6)
    if fn == "scatter_max":  # the tie in one segment: half each
        assert to_np(xt.grad)[0, 0] == to_np(xt.grad)[1, 0] != 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_degree_matches_reference(masked):
    _, _, dst, n = _segments()
    mask = (np.arange(dst.shape[0]) % 3 != 0).astype(np.float32) if masked else None
    want = JG.degree(jnp.asarray(dst), n, None if mask is None else jnp.asarray(mask))
    got = G.degree(torch.from_numpy(dst), n, None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("how", ["mean", "sum"])
@pytest.mark.parametrize("with_ids", [False, True])
def test_graph_readout_matches_reference(how, with_ids):
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(20, 3)).astype(np.float32)
    gid = np.sort(rng.integers(0, 5, 20)).astype(np.int32)
    gid[gid == 2] = 3  # graph 2 has no node: the mean divides by max(count, 1)
    want = JG.graph_readout(jnp.asarray(vals), jnp.asarray(gid) if with_ids else None, 5, how)
    got = G.graph_readout(torch.from_numpy(vals), torch.from_numpy(gid) if with_ids else None,
                          5, how)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_masked_node_ce_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(30, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 30).astype(np.int32)
    for mask in (rng.integers(0, 2, 30).astype(np.float32), np.zeros(30, np.float32)):
        want = JG.masked_node_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
        got = G.masked_node_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                               torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the four archs at SMOKE size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,task", CASES)
def test_forward_and_loss_match_reference(name, task):
    jm, tm, jcfg, tcfg, jb, tb, jp, tp = _setup(name, task)
    want = np.asarray(jm.forward(jp, jb, jcfg))
    got = tm.forward(tp, tb, tcfg)
    _close(got, want, FWD_FRAC.get(name, 1e-5))
    np.testing.assert_allclose(float(tm.loss(tp, tb, tcfg)), float(jm.loss(jp, jb, jcfg)),
                               rtol=1e-5)


@pytest.mark.parametrize("name,task", CASES)
def test_gradients_match_jax_grad(name, task):
    jm, tm, jcfg, tcfg, jb, tb, jp, tp = _setup(name, task)
    want = jax.tree.leaves(jax.grad(lambda p: jm.loss(p, jb, jcfg))(jp))
    _, got = _tgrads(tm, tcfg, tp, tb)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, GRAD_FRAC.get(name, 1e-4))


@pytest.mark.parametrize("name,task", CASES)
def test_train_step_matches_reference(name, task):
    """One ``make_train_step`` step against the reference's ``jax.jit(step)``."""
    jm, tm, jcfg, tcfg, jb, tb, jp, tp = _setup(name, task)
    jstep = jax.jit(j_state.make_train_step(lambda p, b: jm.loss(p, b, jcfg), JAdamW(lr=1e-3)))
    jstate, jmet = jstep(j_state.init_state(jp), jb)
    step = make_train_step(lambda p, b: tm.loss(p, b, tcfg), AdamWConfig(lr=1e-3))
    state, met = step(init_state(tp), tb)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=STEP_LOSS_RTOL.get(name, 1e-5))
    want = [np.asarray(w, np.float64) for w in jax.tree.leaves(jstate.params)]
    scale = max(np.abs(w).max() for w in want)
    for p, w in zip(_tree.leaves(state.params), want):
        np.testing.assert_allclose(to_np(p).astype(np.float64), w, rtol=0, atol=1e-5 * scale)
    assert int(state.step) == 1


@pytest.mark.parametrize("name,task", [c for c in CASES if c[0] in GEOMETRIC])
def test_remat_on_and_off_give_the_same_gradients(name, task):
    _, tm, _, tcfg, _, tb, _, tp = _setup(name, task)
    loss_on, on = _tgrads(tm, tcfg, tp, tb)
    loss_off, off = _tgrads(tm, dataclasses.replace(tcfg, remat=False), tp, tb)
    assert float(loss_on) == float(loss_off)
    for a, b in zip(on, off):
        _close(a, b, 1e-6)


def test_equiformer_bf16_matches_reference_and_keeps_h_in_bf16(monkeypatch):
    """The SMOKE config in bf16 against the reference run in bf16 (the
    weights the reference's bf16 tree, carried across exactly); each
    layer's ``h`` leaves in bf16, as the reference's does."""
    jm, tm, jcfg, tcfg, jb, tb, _, _ = _setup("equiformer-v2", "graph_reg")
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.gnn_params(jp, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in _tree.leaves(tp))
    assert jm.forward(jp, jb, jcfg).dtype == jnp.bfloat16
    seen = []
    orig = teq.remat

    def spy(layer, cfg, tensors):
        run = orig(layer, cfg, tensors)

        def wrapped(*a):
            out = run(*a)
            seen.append(out.dtype)
            return out

        return wrapped

    monkeypatch.setattr(teq, "remat", spy)
    got = float(tm.loss(tp, tb, tcfg))
    want = float(jm.loss(jp, jb, jcfg))
    assert seen == [torch.bfloat16] * tcfg.n_layers
    assert math.isfinite(got) and abs(got - want) <= 2e-2 * abs(want)
    _, grads = _tgrads(tm, tcfg, tp, tb)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# the chunked paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GEOMETRIC)
def test_chunked_path_matches_reference_chunked(name):
    """edge_chunk = 32 on 120 edges: 4 chunks, the last ragged (24 edges
    and 8 of padding).  equiformer's chunked attention normalizes the
    softmax within each chunk (the reference's approximation), so both
    sides run it."""
    jm, tm, jcfg, tcfg, jb, tb, jp, tp = _setup(name, "graph_reg", edge_chunk=32)
    _close(tm.forward(tp, tb, tcfg), np.asarray(jm.forward(jp, jb, jcfg)),
           FWD_FRAC.get(name, 1e-5))
    np.testing.assert_allclose(float(tm.loss(tp, tb, tcfg)), float(jm.loss(jp, jb, jcfg)),
                               rtol=1e-5)
    want = jax.tree.leaves(jax.grad(lambda p: jm.loss(p, jb, jcfg))(jp))
    _, got = _tgrads(tm, tcfg, tp, tb)
    for g, w in zip(got, want):
        _close(g, w, GRAD_FRAC.get(name, 1e-5))


def test_chunked_nequip_equals_unchunked():
    _, tm, _, tcfg, _, tb, _, tp = _setup("nequip", "graph_reg")
    loss_c, gc = _tgrads(tm, dataclasses.replace(tcfg, edge_chunk=32), tp, tb)
    loss_u, gu = _tgrads(tm, tcfg, tp, tb)
    _close(tm.forward(tp, tb, dataclasses.replace(tcfg, edge_chunk=32)),
           to_np(tm.forward(tp, tb, tcfg)), 1e-5)
    np.testing.assert_allclose(float(loss_c), float(loss_u), rtol=1e-5)
    for a, b in zip(gc, gu):
        _close(a, to_np(b), 1e-5)


def test_equiformer_chunked_softmax_is_per_chunk():
    """The reference's documented approximation, ported as it is: with
    several chunks the attention differs from the unchunked one; with one
    chunk holding every edge it is the same."""
    _, tm, _, tcfg, _, tb, _, tp = _setup("equiformer-v2", "graph_reg")
    full = to_np(tm.forward(tp, tb, tcfg))
    one = to_np(tm.forward(tp, tb, dataclasses.replace(tcfg, edge_chunk=120)))
    four = to_np(tm.forward(tp, tb, dataclasses.replace(tcfg, edge_chunk=32)))
    np.testing.assert_array_equal(one, full)
    assert np.abs(four - full).max() > 1e-3 * np.abs(full).max()


def _toy(args, x):
    w, b = args["w"], args["b"]
    idx, v = x
    return torch.zeros(5, 3, dtype=w.dtype).index_add(0, idx, torch.tanh(v @ w) + b)


def _toy_inputs(seed=7):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(4, 3))).requires_grad_()
    b = torch.from_numpy(rng.normal(size=3)).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 5, (6, 7)))
    v = torch.from_numpy(rng.normal(size=(6, 7, 4))).requires_grad_()
    return {"b": b, "w": w}, (idx, v)


@pytest.mark.parametrize("with_x", [False, True])
def test_sum_over_chunks_matches_autograd_of_the_plain_sum(with_x):
    args, xs = _toy_inputs()
    g = torch.from_numpy(np.random.default_rng(8).normal(size=(5, 3)))
    proto = torch.empty((5, 3), dtype=torch.float64, device="meta")
    fn = chunked.sum_over_chunks_with_x_grads if with_x else chunked.sum_over_chunks
    out = fn(_toy, args, xs, proto)
    plain = sum(_toy(args, (xs[0][i], xs[1][i])) for i in range(6))
    torch.testing.assert_close(out, plain, rtol=1e-12, atol=1e-12)
    leaves = [args["b"], args["w"], xs[1]]
    got = torch.autograd.grad(out, leaves, g, allow_unused=True)
    want = torch.autograd.grad(plain, leaves, g)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    if with_x:
        torch.testing.assert_close(got[2], want[2], rtol=1e-12, atol=1e-12)
    else:
        assert got[2] is None


def test_sum_over_chunks_matches_reference():
    """The toy sum and its argument cotangents against the reference's
    ``custom_vjp`` (float64 on both sides)."""
    rng = np.random.default_rng(9)
    w, b = rng.normal(size=(4, 3)), rng.normal(size=3)
    idx, v = rng.integers(0, 5, (6, 7)), rng.normal(size=(6, 7, 4))
    g = rng.normal(size=(5, 3))
    with jax.enable_x64(True):
        def jf(args, x):
            return jax.ops.segment_sum(jnp.tanh(x[1] @ args["w"]) + args["b"], x[0], 5)

        def jl(args):
            out = j_chunked.sum_over_chunks(jf, args, (jnp.asarray(idx), jnp.asarray(v)),
                                            jax.ShapeDtypeStruct((5, 3), jnp.float64))
            return (out * g).sum(), out

        (_, jout), jg = jax.value_and_grad(jl, has_aux=True)(
            {"b": jnp.asarray(b), "w": jnp.asarray(w)})
        jout, jg = np.asarray(jout), {k: np.asarray(a) for k, a in jg.items()}
    args = {"b": torch.from_numpy(b).requires_grad_(), "w": torch.from_numpy(w).requires_grad_()}
    out = chunked.sum_over_chunks(_toy, args, (torch.from_numpy(idx), torch.from_numpy(v)),
                                  torch.empty((5, 3), dtype=torch.float64, device="meta"))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(to_np(out), jout, rtol=1e-12, atol=1e-12)
    for k in ("b", "w"):
        np.testing.assert_allclose(to_np(args[k].grad), jg[k], rtol=1e-12, atol=1e-12)


def test_sum_over_chunks_saves_only_its_inputs():
    """Autograd keeps the Function's inputs and nothing of a chunk's working
    set: the tensors saved for the backward pass are exactly the leaves."""
    args, xs = _toy_inputs()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        chunked.sum_over_chunks(_toy, args, xs,
                                torch.empty((5, 3), dtype=torch.float64, device="meta"))
    assert len(saved) == 4
    assert all(any(s is t for t in (args["b"], args["w"], *xs)) for s in saved)


@pytest.mark.parametrize("name", GEOMETRIC)
def test_remat_reruns_the_chunked_forward(name, monkeypatch):
    """Under remat the checkpointed layer's recompute calls the chunked
    Function's forward again (once more a layer); without remat it runs
    once a layer.  Gradients agree either way."""
    _, tm, _, tcfg, _, tb, _, tp = _setup(name, "graph_reg", edge_chunk=32)
    calls = []
    orig = chunked._SumOverChunks.forward

    def counted(ctx, *a):
        calls.append(1)
        return orig(ctx, *a)

    monkeypatch.setattr(chunked._SumOverChunks, "forward", staticmethod(counted))
    _, on = _tgrads(tm, tcfg, tp, tb)
    n_on = len(calls)
    calls.clear()
    _, off = _tgrads(tm, dataclasses.replace(tcfg, remat=False), tp, tb)
    assert (n_on, len(calls)) == (2 * tcfg.n_layers, tcfg.n_layers)
    for a, b in zip(on, off):
        _close(a, to_np(b), 1e-6)


def test_reference_conditioning():
    """The measurements behind equiformer-v2's and pna's wider gates: the
    reference moved by one ulp of its inputs, against itself."""
    def ulp(a, seed):
        up = np.random.default_rng(seed).random(a.shape) < 0.5
        return np.nextafter(a, np.where(up, np.float32(np.inf), np.float32(-np.inf))
                            .astype(np.float32)).astype(np.float32)

    jm, _, jcfg, _, jb, _, jp, _ = _setup("equiformer-v2", "node_class")
    base = np.asarray(jm.forward(jp, jb, jcfg))
    moved = max(np.abs(np.asarray(jm.forward(jp, dataclasses.replace(
        jb, positions=jnp.asarray(ulp(np.asarray(jb.positions), s)), ), jcfg)) - base).max()
        for s in range(3)) / np.abs(base).max()
    assert 1e-5 < moved < FWD_FRAC["equiformer-v2"]
    jm, _, jcfg, _, jb, _, jp, _ = _setup("pna", "node_class")
    g0 = jax.tree.leaves(jax.grad(lambda p: jm.loss(p, jb, jcfg))(jp))
    jb2 = dataclasses.replace(jb, node_feat=jnp.asarray(ulp(np.asarray(jb.node_feat), 0)))
    g1 = jax.tree.leaves(jax.grad(lambda p: jm.loss(p, jb2, jcfg))(jp))
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                      / max(np.abs(np.asarray(a)).max(), 1e-30)) for a, b in zip(g0, g1))
    assert 1e-4 < moved < GRAD_FRAC["pna"]


@pytest.mark.parametrize("n_layers", [2, 12])
def test_equiformer_full_width_against_reference(n_layers):
    """The published equiformer-v2 widths (l_max 6, m_max 2, 128 channels,
    8 heads) in fp32 on 4 molecules of 30 nodes and 64 edges.  At 2 layers
    the port holds the reference's loss within 1e-5 relative and both are
    invariant under rotation + translation within 5e-5 (tests/test_e3.py's
    gate).  At the published 12 layers the model is too ill-conditioned in
    fp32 for that gate: the equivariant RMS norm divides each l > 0 channel
    by an RMS that starts at sqrt(eps) = 1e-3, and rounding grows with
    depth, so the reference's own loss moves by more than 5e-5 under the
    rotation — ROADMAP queue C; the card's figure is printed, not gated."""
    from scipy.spatial.transform import Rotation

    from repro_torch.configs.base import GNN_SHAPES

    rng = np.random.default_rng(0)
    g, n1, e1 = 4, 30, 64
    n, e = g * n1, g * e1
    base = np.repeat(np.arange(g) * n1, e1)
    arrays = dict(
        node_feat=np.zeros((n, 1), np.float32),
        edge_src=(base + rng.integers(0, n1, e)).astype(np.int32),
        edge_dst=(base + rng.integers(0, n1, e)).astype(np.int32),
        edge_mask=np.ones(e, np.float32), labels=rng.normal(size=g).astype(np.float32),
        label_mask=np.ones(g, np.float32),
        positions=(rng.normal(size=(n, 3)) * 2).astype(np.float32),
        species=rng.integers(0, 10, n).astype(np.int32),
        graph_id=np.repeat(np.arange(g), n1).astype(np.int32), n_graphs=g)
    jcfg = dataclasses.replace(j_cells.gnn_shape_config(
        J_ARCHS["equiformer-v2"], J_ARCHS["equiformer-v2"].shapes["molecule"]),
        dtype=jnp.float32, n_layers=n_layers)
    tcfg = dataclasses.replace(cells.gnn_shape_config(
        ARCHS["equiformer-v2"], GNN_SHAPES["molecule"]), dtype=torch.float32,
        n_layers=n_layers)
    jm, tm = _models("equiformer-v2")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.gnn_params(jp, device="cpu")
    R = Rotation.from_euler("zyz", [0.5, 0.9, 1.3]).as_matrix().astype(np.float32)
    moved = dict(arrays, positions=arrays["positions"] @ R.T + 5.0)
    jloss = jax.jit(lambda p, b: jm.loss(p, b, jcfg))
    (jb, tb), (jb2, tb2) = _batches(arrays), _batches(moved)
    j1, j2 = float(jloss(jp, jb)), float(jloss(jp, jb2))
    with torch.no_grad():
        t1, t2 = float(tm.loss(tp, tb, tcfg)), float(tm.loss(tp, tb2, tcfg))
    assert all(map(math.isfinite, (j1, j2, t1, t2)))
    if n_layers == 2:
        np.testing.assert_allclose(t1, j1, rtol=1e-5)
        assert abs(t1 - t2) < 5e-5 * abs(t1) and abs(j1 - j2) < 5e-5 * abs(j1)
    else:
        assert abs(j1 - j2) > 5e-5 * abs(j1)
