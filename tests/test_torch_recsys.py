"""The AutoInt recsys model in the port (``repro_torch.models.recsys``,
``repro_torch.configs.autoint``) against the reference's
(``repro.models.recsys``, ``repro.configs.autoint``) on the CPU, and the
three recsys cases of ``tests/test_arch_smoke.py`` run on the port.

Weights are the reference's ``init_params`` at the SMOKE config, carried
across by ``convert.autoint_params``; ids, bags, labels and candidates are
numpy draws.  Tolerances: embedding bags rtol 1e-6 (a sum of ≤ 4 rows in
another order; ``max`` exactly); logits, the loss, query embeddings and
retrieval scores within 1e-5 of max|value| (two attention layers of fp32
GEMMs summed in another order); gradients within 1e-4 of each leaf's
max|g|; one train step's loss rtol 1e-5 and parameters within 1e-5 of each
leaf's max|p|, save at most 1e-4 of the elements, within the lr a step can
move them (AdamW is steep at gradients within rounding of ε).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import recsys as j_rs
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import state as j_state
from repro_torch import _tree, convert
from repro_torch.configs import ARCHS
from repro_torch.models import recsys as rs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import _grads_of, init_state, make_train_step

from tests._parity import to_np

CFG, JCFG = ARCHS["autoint"].smoke_config, J_ARCHS["autoint"].smoke_config
B = 16


def _close(got, want, frac=1e-5):
    want = np.asarray(want, np.float64)
    got = to_np(got).astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-30))


def _batch(cfg, seed=0, n=B):
    rng = np.random.default_rng(seed)
    b = {"ids": rng.integers(0, cfg.rows_per_table, (n, cfg.n_fields - cfg.n_multihot)),
         "bag_ids": rng.integers(0, cfg.rows_per_table,
                                 (n, cfg.n_multihot, cfg.hot_per_field)),
         "labels": rng.integers(0, 2, (n,))}
    b = {k: v.astype(np.int32) for k, v in b.items()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


@pytest.fixture(scope="module")
def weights():
    jp = j_rs.init_params(JCFG, jax.random.PRNGKey(0))
    # b_out starts at 0: give it a value so that it matters
    jp = dict(jp, b_out=jnp.asarray([0.3], jnp.float32))
    return jp, convert.autoint_params(jp, device="cpu")


def test_configs_match_reference_field_for_field():
    for which in ("config", "smoke_config"):
        j, t = getattr(J_ARCHS["autoint"], which), getattr(ARCHS["autoint"], which)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert str(td.pop("dtype")).replace("torch.", "") == jnp.dtype(jd.pop("dtype")).name
        assert td == jd
    assert ARCHS["autoint"].family == J_ARCHS["autoint"].family == "recsys"
    assert ({k: dataclasses.asdict(v) for k, v in ARCHS["autoint"].shapes.items()}
            == {k: dataclasses.asdict(v) for k, v in J_ARCHS["autoint"].shapes.items()})


def test_init_params_has_the_reference_tree():
    """Same keys, shapes and dtypes (the reference's by ``eval_shape``);
    drawn on the CPU from the port's stream, the tables at scale 0.01."""
    want = jax.eval_shape(lambda: j_rs.init_params(JCFG, jax.random.PRNGKey(0)))
    got = rs.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    assert [(tuple(a.shape), str(a.dtype).replace("torch.", "")) for a in _tree.leaves(got)] \
        == [(tuple(a.shape), a.dtype.name) for a in jax.tree.leaves(want)]
    assert abs(float(got["tables"].std()) / 0.01 - 1.0) < 0.05
    again = rs.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(got), _tree.leaves(again)))


@pytest.mark.parametrize("combine", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(combine, weighted):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (6, 4)).astype(np.int32)
    w = rng.uniform(0.0, 2.0, (6, 4)).astype(np.float32) if weighted else None
    if weighted:
        w[2] = 0.0  # an all-zero bag: the mean divides by max(Σw, 1e-9)
    want = j_rs.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              None if w is None else jnp.asarray(w), combine=combine)
    got = rs.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids).long(),
                           None if w is None else torch.from_numpy(w), combine=combine)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        rs.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids).long(), combine="min")


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_embedding_bag_ragged_matches_reference(combine):
    rng = np.random.default_rng(2)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    flat = rng.integers(0, 40, 23).astype(np.int32)
    bags = np.sort(rng.integers(0, 7, 23)).astype(np.int32)
    bags[bags == 3] = 4  # bag 3 empty: zeros (the mean divides by max(count, 1))
    want = j_rs.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(bags),
                                     7, combine=combine)
    got = rs.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat).long(),
                                  torch.from_numpy(bags).long(), 7, combine=combine)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert not to_np(got[3]).any()


def test_forward_loss_and_serving_match_reference(weights):
    jp, tp = weights
    jb, tb = _batch(CFG, seed=3)
    with torch.no_grad():
        _close(rs.forward_logits(tp, tb, CFG), j_rs.forward_logits(jp, jb, JCFG))
        tl = float(rs.train_loss(tp, tb, CFG))
        tq = rs.query_embedding(tp, tb, CFG)
    jl = float(j_rs.train_loss(jp, jb, JCFG))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    jq = j_rs.query_embedding(jp, jb, JCFG)
    _close(tq, jq)
    cand = np.random.default_rng(4).normal(size=(100, 64)).astype(np.float32)
    _close(rs.retrieval_scores(tq, torch.from_numpy(cand)),
           j_rs.retrieval_scores(jnp.asarray(to_np(tq)), jnp.asarray(cand)))


def test_train_loss_gradients_match_jax_grad(weights):
    """Every leaf, the dense table gradient included (rows no id touches are
    exact zeros on both sides), and ``w_query``, which the loss does not use,
    zeros."""
    jp, tp = weights
    jb, tb = _batch(CFG, seed=5)
    jl, jg = jax.value_and_grad(lambda p: j_rs.train_loss(p, jb, JCFG))(jp)
    tl, tg = _grads_of(lambda p, b: rs.train_loss(p, b, CFG), tp, tb)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for g, w in zip(tg, jax.tree.leaves(jg)):
        _close(g, w, frac=1e-4)
    tables = _tree.unflatten(tp, tg)["tables"]
    assert np.array_equal(to_np(tables) == 0, np.asarray(jg["tables"]) == 0)
    assert not to_np(_tree.unflatten(tp, tg)["w_query"]).any()


def test_one_train_step_matches_reference(weights):
    jp, tp = weights
    jb, tb = _batch(CFG, seed=6)
    opt = dict(lr=1e-3, warmup_steps=0)
    jst, jm = jax.jit(j_state.make_train_step(lambda p, b: j_rs.train_loss(p, b, JCFG),
                                              JAdamW(**opt)))(j_state.init_state(jp), jb)
    tst = init_state(_tree.map(torch.clone, tp))
    tst, tm = make_train_step(lambda p, b: rs.train_loss(p, b, CFG), AdamWConfig(**opt))(tst, tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    off = total = 0
    for g, w in zip(_tree.leaves(tst.params), jax.tree.leaves(jst.params)):
        err = np.abs(to_np(g).astype(np.float64) - np.asarray(w, np.float64))
        assert err.max() <= opt["lr"]
        off += int((err > 1e-5 * np.abs(np.asarray(w)).max()).sum())
        total += err.size
    assert off <= 1e-4 * total


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py's recsys cases, on the port
# ---------------------------------------------------------------------------

def test_autoint_train_and_serve():
    cfg = ARCHS["autoint"].smoke_config
    rng = np.random.default_rng(0)
    params = rs.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {
        "ids": torch.from_numpy(rng.integers(0, cfg.rows_per_table,
                                             (B, cfg.n_fields - cfg.n_multihot))),
        "bag_ids": torch.from_numpy(rng.integers(0, cfg.rows_per_table,
                                                 (B, cfg.n_multihot, cfg.hot_per_field))),
        "labels": torch.from_numpy(rng.integers(0, 2, (B,))),
    }
    state = init_state(params)
    step = make_train_step(lambda p, b: rs.train_loss(p, b, cfg), AdamWConfig(lr=1e-3))
    state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    logits = rs.forward_logits(state.params, batch, cfg)
    assert logits.shape == (B,) and torch.isfinite(logits).all()
    q = rs.query_embedding(state.params, batch, cfg)
    scores = rs.retrieval_scores(q, torch.from_numpy(rng.normal(size=(100, 64))).float())
    assert scores.shape == (B, 100) and torch.isfinite(scores).all()


def test_autoint_assigned_config():
    c = ARCHS["autoint"].config
    assert (c.n_fields, c.embed_dim, c.n_attn_layers, c.n_heads, c.d_attn) == (39, 16, 3, 2, 32)


def test_embedding_bag_matches_manual():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, (6, 4)))
    out = rs.embedding_bag(table, ids, combine="mean")
    want = np.stack([to_np(table)[to_np(ids)[i]].mean(0) for i in range(6)])
    # sum-then-divide vs numpy mean: fp32 reduction order differs by ~1 ulp
    np.testing.assert_allclose(to_np(out), want, rtol=1e-5, atol=1e-7)
    # ragged path agrees on rectangular input
    out2 = rs.embedding_bag_ragged(table, ids.reshape(-1), torch.arange(6).repeat_interleave(4),
                                   6, combine="mean")
    np.testing.assert_allclose(to_np(out2), want, rtol=1e-6)
