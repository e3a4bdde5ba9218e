"""Training in the port (``repro_torch.train``, the LM gradients, remat, the
token stream, ``TrainState`` checkpoints) against the reference's
(``repro.train``, ``jax.grad``, ``repro.data.tokens``, ``repro.ckpt``) on
the CPU.

Weights are the reference's (``tests/test_torch_transformer.py``'s
perturbed init) carried across by ``convert``; tokens are numpy draws.
Tolerances: gradients within 1e-4 of each leaf's max|g| (fp32 GEMMs and
reductions summed in another order, through two layers and the backward
pass); remat off, ``"nothing"`` and ``"dots"`` bit for bit (the same
operations recomputed on one device); a train step's loss rtol 1e-5,
``grad_norm`` rtol 1e-4, ``lr`` within 2 fp32 ulps, parameters after two
steps within 1e-5 of each leaf's max|p| but for at most 1e-4 of the tree's
elements, which stay within the 2·lr the two steps can move them (AdamW's
step is lr·m̂/(√v̂ + ε) with ε = 1e-8: for a gradient within rounding of ε
it is steep, and the two packages' last-bit differences in such a gradient
move the parameter by up to lr), moments within 1e-4 of max|m|; a resumed
run bit for bit the uninterrupted one; the token stream and checkpoints bit
for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as JManager
from repro.data.tokens import MarkovTokenStream as JStream
from repro.models import common as j_cm
from repro.models import transformer as j_tfm
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import loop as j_loop
from repro.train import state as j_state
from repro_torch import _tree, convert
from repro_torch.ckpt import CheckpointManager
from repro_torch.data.tokens import MarkovTokenStream
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.state import TrainState, _grads_of, init_state, make_train_step

from tests._parity import to_np
from tests.test_torch_transformer import LM_ARCHS, _cfgs, _reference_params

GRAD_FRAC = 1e-4


def _leaves_close(got, want, frac):
    got, want = _tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        g = to_np(g).astype(np.float64)
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=frac * max(np.abs(w).max(), 1e-30))


def _params_close(got, want, frac, max_move):
    """``_leaves_close``, but at most 1e-4 of the tree's elements may be off
    by up to ``max_move``."""
    off = total = 0
    for g, w in zip(_tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float64)
        err = np.abs(to_np(g).astype(np.float64) - w)
        assert err.max() <= max_move
        off += int((err > frac * max(np.abs(w).max(), 1e-30)).sum())
        total += err.size
    assert off <= 1e-4 * total, (off, total)


def _batch(vocab, shape, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(toks).long()})


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LM_ARCHS)
def test_train_loss_gradients_match_jax_grad(name):
    """The port's autograd gradient of ``train_loss`` = ``jax.grad`` of the
    reference's, every leaf, on 40 tokens in chunks of 16 (one padded); and
    remat off, ``"nothing"`` and ``"dots"`` give the same gradients."""
    jcfg, tcfg = _cfgs(name, attn_chunk=16)
    jp = _reference_params(jcfg, seed=11)
    jb, tb = _batch(jcfg.vocab, (2, 40), seed=12)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: j_tfm.train_loss(p, b, jcfg)))(jp, jb)
    tp = convert.transformer_params(jp, device="cpu")
    grads = {}
    for remat, policy in ((False, "nothing"), (True, "nothing"), (True, "dots")):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        loss, g = _grads_of(lambda p, b: tfm.train_loss(p, b, cfg), tp, tb)
        grads[remat, policy] = (loss, g)
    loss, g = grads[False, "nothing"]
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    _leaves_close(_tree.unflatten(tp, g), jg, GRAD_FRAC)
    for key, (l2, g2) in grads.items():
        assert torch.equal(l2, loss), key
        assert all(torch.equal(a, b) for a, b in zip(g2, g)), key


CASES = [  # (causal, Sq, Sk, G, chunk, q_offset)
    (True, 24, 24, 1, 16, 0),
    (True, 24, 24, 2, 16, 0),
    (True, 24, 24, 4, 16, 0),
    (True, 16, 24, 2, 8, 8),
    (True, 16, 16, 2, 16, -4),  # the first 4 queries see no key: fully masked rows
    (False, 12, 20, 4, 8, 0),
]


@pytest.mark.parametrize("causal,sq,sk,g,chunk,q_offset", CASES)
def test_flash_attention_gradients_match_jax_grad(causal, sq, sk, g, chunk, q_offset):
    """Gradients through the online-softmax loop (running max, the
    ``isfinite`` guards, padded and fully masked chunks) are finite and
    equal ``jax.grad``'s, for GQA groups of 1, 2 and 4."""
    rng = np.random.default_rng(sq * 100 + sk + g)
    B, Hkv, dh = 2, 2, 8
    q = rng.normal(size=(B, sq, Hkv * g, dh)).astype(np.float32)
    k = rng.normal(size=(B, sk, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, sk, Hkv, dh)).astype(np.float32)
    w = rng.normal(size=(B, sq, Hkv * g, dh)).astype(np.float32)

    def jloss(q, k, v):
        o = j_cm.flash_attention(q, k, v, causal=causal, chunk=chunk, q_offset=q_offset)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = cm.flash_attention(*ts, causal=causal, chunk=chunk, q_offset=q_offset)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for gt, gw in zip(got, want):
        assert torch.isfinite(gt).all()
        np.testing.assert_allclose(to_np(gt), np.asarray(gw), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(gw)).max())
    if q_offset < 0:  # no key visible: zero output, zero gradient
        assert not to_np(got[0][:, :-q_offset]).any()


# ---------------------------------------------------------------------------
# the train step and the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_train_step_matches_reference(name, accum):
    """``make_train_step`` (microbatches of 2 rows at ``accum`` 2) against the
    reference's jitted step: loss, grad_norm and lr of two steps, then the
    parameters and moments; the step count an int32 tensor."""
    jcfg, tcfg = _cfgs(name)
    opt = dict(lr=1e-3, warmup_steps=1)
    jp = _reference_params(jcfg, seed=13)
    jst = j_state.init_state(jp)
    tst = init_state(convert.transformer_params(jp, device="cpu"))
    jstep = jax.jit(j_state.make_train_step(lambda p, b: j_tfm.train_loss(p, b, jcfg),
                                            JAdamW(**opt), accum_steps=accum))
    tstep = make_train_step(lambda p, b: tfm.train_loss(p, b, tcfg), AdamWConfig(**opt),
                            accum_steps=accum)
    for i in range(2):
        jb, tb = _batch(jcfg.vocab, (4, 16), seed=20 + i)
        jst, jm = jstep(jst, jb)
        tst, tm = tstep(tst, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(
            jm["grad_norm"])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 2 * 2.0 ** -23 * float(jm["lr"])
        assert all(t.device.type == "cpu" and t.dim() == 0 for t in tm.values())
    assert int(tst.step) == int(tst.opt["step"]) == 2 and tst.step.dtype == torch.int32
    _params_close(tst.params, jst.params, 1e-5, 2 * opt["lr"])
    _leaves_close(tst.opt["m"], jst.opt["m"], 1e-4)


def test_train_step_updates_in_place():
    """The state's tensors are updated where they lie (the reference donates
    them): the same storage, advanced."""
    cfg = _cfgs("qwen3-0.6b")[1]
    st = init_state(tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    ptrs = [t.data_ptr() for t in _tree.leaves((st.params, st.opt["m"], st.opt["v"]))]
    before = st.params["embed"].clone()
    step = make_train_step(lambda p, b: tfm.train_loss(p, b, cfg), AdamWConfig(warmup_steps=0))
    st2, _ = step(st, _batch(cfg.vocab, (2, 8), seed=3)[1])
    assert [t.data_ptr() for t in _tree.leaves((st2.params, st2.opt["m"], st2.opt["v"]))] == ptrs
    assert not torch.equal(st2.params["embed"], before)
    assert not any(t.requires_grad for t in _tree.leaves(st2.params))
    with pytest.raises(ValueError, match="equal microbatches"):
        make_train_step(lambda p, b: tfm.train_loss(p, b, cfg), AdamWConfig(),
                        accum_steps=3)(st2, _batch(cfg.vocab, (2, 8), seed=3)[1])


def test_train_loop_resume(tmp_path):
    """``tests/test_ckpt.py::test_train_loop_resume`` on the port: the
    interrupted run resumes from its checkpoint and ends bit for bit where
    the uninterrupted run does — and where the reference's does (rtol 1e-6)."""
    w0 = np.ones(4, np.float32)
    opt = dict(lr=1e-2, warmup_steps=0)

    def loss_fn(p, b):
        return ((p["w"] - b["target"]) ** 2).sum()

    def batches(step):
        return {"target": torch.full((4,), float(step % 3))}

    def fresh():
        return init_state({"w": torch.from_numpy(w0.copy())})

    step_fn = make_train_step(loss_fn, AdamWConfig(**opt))
    quiet = lambda *_: None  # noqa: E731
    ref = run_training(step_fn, fresh(), batches,
                       TrainLoopConfig(total_steps=20, ckpt_dir=None, log_every=100), log=quiet)
    d = str(tmp_path / "ck")
    run_training(step_fn, fresh(), batches,
                 TrainLoopConfig(total_steps=12, ckpt_dir=d, ckpt_every=5, log_every=100),
                 log=quiet)
    lines = []
    st2 = run_training(step_fn, fresh(), batches,
                       TrainLoopConfig(total_steps=20, ckpt_dir=d, ckpt_every=5, log_every=100),
                       log=lines.append)
    assert lines[0] == "[resume] restored checkpoint at step 12"
    assert torch.equal(st2.params["w"], ref.params["w"]) and int(st2.step) == 20
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(st2), _tree.leaves(ref)))

    jst = j_loop.run_training(
        jax.jit(j_state.make_train_step(loss_fn, JAdamW(**opt))),
        j_state.init_state({"w": jnp.asarray(w0)}),
        lambda s: {"target": jnp.full((4,), float(s % 3), jnp.float32)},
        j_loop.TrainLoopConfig(total_steps=20, log_every=100), log=quiet)
    np.testing.assert_allclose(to_np(st2.params["w"]), np.asarray(jst.params["w"]), rtol=1e-6)


def test_loop_logs_the_reference_lines():
    """The loop's log and straggler lines are the reference's, word for word
    (the step times aside)."""
    cfg = TrainLoopConfig(total_steps=4, log_every=2, step_timeout_s=-1.0)
    lines, jlines = [], []
    step_fn = make_train_step(lambda p, b: (p["w"] ** 2).sum(), AdamWConfig(warmup_steps=0))
    run_training(step_fn, init_state({"w": torch.ones(3)}), lambda s: {}, cfg,
                 log=lines.append)
    jstep = jax.jit(j_state.make_train_step(lambda p, b: (p["w"] ** 2).sum(),
                                            JAdamW(warmup_steps=0)))
    j_loop.run_training(jstep, j_state.init_state({"w": jnp.ones(3)}), lambda s: {},
                        j_loop.TrainLoopConfig(**dataclasses.asdict(cfg)), log=jlines.append)
    strip = lambda ln: ln.split(" dt=")[0].split(" step time ")[0]  # noqa: E731
    assert len(lines) == len(jlines) == 4
    assert [strip(ln) for ln in lines] == [strip(ln) for ln in jlines]
    assert lines[1].endswith(" exceeded -1.0s — multi-host deployment would trigger "
                             "elastic restart here")


# ---------------------------------------------------------------------------
# TrainState checkpoints, both packages
# ---------------------------------------------------------------------------

def _reference_state(name="qwen3-0.6b"):
    jcfg = _cfgs(name)[0]
    jst = j_state.init_state(_reference_params(jcfg, seed=14))
    step = jax.jit(j_state.make_train_step(lambda p, b: j_tfm.train_loss(p, b, jcfg),
                                           JAdamW(lr=1e-3)))
    jst, _ = step(jst, _batch(jcfg.vocab, (2, 8), seed=15)[0])
    return jst


def test_train_state_checkpoint_cross_loads(tmp_path):
    """A ``TrainState`` checkpoint of either package restores into the
    other's template bit for bit (the leaves in ``jax.tree.flatten``'s
    order), and the manifests' treedefs are the same text."""
    jst = _reference_state()
    tst = convert.train_state(jst, device="cpu")
    assert int(tst.step) == 1 and tst.opt["step"].dtype == torch.int32

    JManager(str(tmp_path / "ref")).save(1, jst)
    got = CheckpointManager(str(tmp_path / "ref")).restore(1, tst)
    assert isinstance(got, TrainState)
    for a, b in zip(_tree.leaves(got), jax.tree.leaves(jst)):
        assert a.dtype != torch.float32 or to_np(a).tobytes() == np.asarray(b).tobytes()
        np.testing.assert_array_equal(to_np(a), np.asarray(b))

    CheckpointManager(str(tmp_path / "port")).save(1, tst)
    back = JManager(str(tmp_path / "port")).restore(1, jst)
    for a, b in zip(jax.tree.leaves(back), _tree.leaves(tst)):
        np.testing.assert_array_equal(np.asarray(a), to_np(b))
    import json

    mf = [json.load(open(tmp_path / d / "step_00000001" / "manifest.json"))
          for d in ("ref", "port")]
    assert mf[0] == mf[1]


def test_bf16_train_state_round_trips(tmp_path):
    """bf16 parameters are written as the reference writes them (2-byte
    records, manifest dtype ``bfloat16``) and restore bit for bit onto the
    template's device."""
    cfg = _cfgs("qwen3-0.6b", dtype="bfloat16")[1]
    st = init_state(tfm.init_params(cfg, torch.Generator().manual_seed(1), device="cpu"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, st, blocking=False)
    mgr.wait()
    step, got = mgr.restore_latest(st)
    assert step == 3
    for a, b in zip(_tree.leaves(got), _tree.leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    leaf = np.load(tmp_path / "step_00000003" / "leaf_00000.npy")
    assert leaf.dtype.kind == "V" and leaf.dtype.itemsize == 2
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(3, {"w": st.params["embed"]})


def test_async_save_is_a_snapshot(tmp_path):
    """An async save holds the values at the call even when the tensors are
    updated in place right after (a CPU tensor's numpy view would not)."""
    w = torch.zeros(1 << 16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w}, blocking=False)
    w.add_(1.0)
    mgr.wait()
    assert not mgr.restore_dict(1)["w"].any()


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard,num_shards", [(0, 0, 1), (7, 0, 1), (3, 1, 4), (12, 3, 4)])
def test_token_stream_matches_reference_bitwise(step, shard, num_shards):
    kw = dict(seed=5, shard=shard, num_shards=num_shards)
    j, t = JStream(1000, **kw), MarkovTokenStream(1000, **kw)
    j._step = t._step = step
    for _ in range(2):  # and the next batch
        jb, tb = j.next_batch(3, 50), t.next_batch(3, 50)
        assert tb.keys() == jb.keys()
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(t.prefs, j.prefs)
