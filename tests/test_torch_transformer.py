"""The LM serving path of the model zoo in the port
(``repro_torch.models.transformer``, ``repro_torch.configs``) against the
reference's (``repro.models.transformer``, ``repro.configs``) on the CPU.

For each of the five LM archs' ``SMOKE`` configs, the reference's parameter
tree (its norms and biases perturbed, so that every leaf matters) goes
through ``convert.transformer_params``; the same numpy tokens go through
both.  Tolerance: fp32 logits and caches within 1e-5 of the largest |value|
(two layers of fp32 GEMMs summed in another order differ by ~1e-6 of it),
aux within rtol 1e-4; bf16 logits within 2⁻⁴ of the largest |logit| (each
of ~10 roundings to bf16 on the way moves a value by up to 2⁻⁹ of its
scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import transformer as j_tfm
from repro_torch import convert
from repro_torch.configs import ARCHS, ASSIGNED
from repro_torch.models import transformer as tfm

from tests._parity import to_np

LM_ARCHS = ["glm4-9b", "qwen2-7b", "qwen3-0.6b", "granite-moe-3b-a800m", "olmoe-1b-7b"]
B, S = 2, 12


def _close(got, want, frac=1e-5):
    got, want = to_np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1e-30))


def _cfgs(name, dtype=None, **changes):
    """The reference's and the port's SMOKE config of ``name``, changed alike
    (``dtype`` by name)."""
    jcfg = dataclasses.replace(J_ARCHS[name].smoke_config, **changes)
    tcfg = dataclasses.replace(ARCHS[name].smoke_config, **changes)
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype))
        tcfg = dataclasses.replace(tcfg, dtype=getattr(torch, dtype))
    return jcfg, tcfg


def _reference_params(jcfg, seed=0):
    """The reference's init, with its constant leaves (norms at 1, biases at
    0) perturbed from a seed, as numpy arrays."""
    params = j_tfm.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("norm", "ln1", "ln2", "'bq'", "'bk'", "'bv'")):
            return (a.astype(np.float32) + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


@pytest.fixture(scope="module", params=LM_ARCHS)
def arch_run(request):
    """One arch's SMOKE config through both packages: forward, prefill and
    one decode step on a cache padded by 4 slots."""
    jcfg, tcfg = _cfgs(request.param)
    jp = _reference_params(jcfg)
    tp = convert.transformer_params(jp, device="cpu")
    toks = _tokens(jcfg)
    nxt = np.random.default_rng(2).integers(0, jcfg.vocab, size=(B,))
    jfwd = jax.jit(lambda p, t: j_tfm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    jpre = jax.jit(lambda p, t: j_tfm.prefill(p, t, jcfg))(jp, jnp.asarray(toks))
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))
              for k, v in jpre[1].items()}
    jdec = jax.jit(lambda p, c, cl, t: j_tfm.decode_step(p, c, cl, t, jcfg))(
        jp, jcache, jnp.full((B,), S, jnp.int32), jnp.asarray(nxt, jnp.int32))
    with torch.no_grad():
        tfwd = tfm.forward(tp, torch.from_numpy(toks), tcfg)
        tpre = tfm.prefill(tp, torch.from_numpy(toks), tcfg)
        tcache = convert.transformer_params({k: np.asarray(v) for k, v in jcache.items()},
                                            device="cpu")
        tdec = tfm.decode_step(tp, tcache, torch.full((B,), S), torch.from_numpy(nxt), tcfg)
    return dict(name=request.param, tcfg=tcfg, tp=tp, toks=toks, nxt=nxt,
                j=dict(fwd=jfwd, pre=jpre, dec=jdec), t=dict(fwd=tfwd, pre=tpre, dec=tdec))


def test_forward_matches_reference(arch_run):
    (jl, jaux), (tl, taux) = arch_run["j"]["fwd"], arch_run["t"]["fwd"]
    assert tl.shape == (B, S, arch_run["tcfg"].vocab_padded)
    _close(tl, jl)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4, atol=1e-7)


def test_prefill_matches_reference(arch_run):
    (jl, jc), (tl, tc) = arch_run["j"]["pre"], arch_run["t"]["pre"]
    _close(tl, jl)
    for k in ("k", "v"):
        _close(tc[k], jc[k])


def test_decode_step_matches_reference(arch_run):
    (jl, jc), (tl, tc) = arch_run["j"]["dec"], arch_run["t"]["dec"]
    _close(tl, jl)
    for k in ("k", "v"):  # the new row at S, the rest as prefilled
        _close(tc[k], jc[k])
        assert not to_np(tc[k][:, :, S + 1:]).any()


def test_decode_step_equals_forward_on_the_extended_sequence(arch_run):
    """The reference's check (tests/test_arch_smoke.py), in the port: the
    prefill's logits are the forward's last position, and one decode step's
    are the forward's on the sequence extended by the decoded token."""
    tp, cfg, toks, nxt = (arch_run[k] for k in ("tp", "tcfg", "toks", "nxt"))
    fwd_logits, _ = arch_run["t"]["fwd"]
    _close(arch_run["t"]["pre"][0][:, 0], to_np(fwd_logits[:, -1]), frac=2e-3)
    with torch.no_grad():
        ext, _ = tfm.forward(tp, torch.from_numpy(np.concatenate([toks, nxt[:, None]], 1)), cfg)
    _close(arch_run["t"]["dec"][0][:, 0], to_np(ext[:, -1]), frac=5e-3)


def test_decode_step_updates_the_cache_in_place(arch_run):
    tp, cfg, toks, nxt = (arch_run[k] for k in ("tp", "tcfg", "toks", "nxt"))
    cache = tfm.make_cache(cfg, B, S + 2, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    cl = torch.tensor([3, 5])
    with torch.no_grad():
        _, out = tfm.decode_step(tp, cache, cl, torch.from_numpy(nxt), cfg)
    assert out is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
    written = cache["k"].abs().sum((0, 3, 4)) > 0  # [B, S + 2]
    assert written.nonzero().tolist() == [[0, 3], [1, 5]]


def test_bf16_forward_and_decode_match_reference():
    jcfg, tcfg = _cfgs("qwen3-0.6b", dtype="bfloat16")
    assert tcfg.dtype == torch.bfloat16
    jp = _reference_params(jcfg, seed=3)
    tp = convert.transformer_params(jp, device="cpu")
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens(jcfg, seed=4)
    jl, _ = jax.jit(lambda p, t: j_tfm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    _, jc = jax.jit(lambda p, t: j_tfm.prefill(p, t, jcfg))(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = tfm.forward(tp, torch.from_numpy(toks), tcfg)
    assert tl.dtype == torch.bfloat16
    _close(tl.float(), np.asarray(jl.astype(jnp.float32)), frac=2.0 ** -4)
    jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))) for k, v in jc.items()}
    nxt = np.arange(B)
    jd, _ = jax.jit(lambda p, c, cl, t: j_tfm.decode_step(p, c, cl, t, jcfg))(
        jp, jcache, jnp.full((B,), S, jnp.int32), jnp.asarray(nxt, jnp.int32))
    tcache = convert.transformer_params({k: np.asarray(v) for k, v in jcache.items()},
                                        device="cpu")
    with torch.no_grad():
        td, _ = tfm.decode_step(tp, tcache, torch.full((B,), S), torch.from_numpy(nxt), tcfg)
    _close(td.float(), np.asarray(jd.astype(jnp.float32)), frac=2.0 ** -4)


def test_padded_vocab_logits_are_masked():
    """vocab 500 pads to 512: the 12 padded logits are −1e30 on both sides,
    the rest match."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", vocab=500)
    assert tcfg.vocab_padded == jcfg.vocab_padded == 512
    jp = _reference_params(jcfg, seed=5)
    toks = _tokens(jcfg, seed=6)
    jl, _ = jax.jit(lambda p, t: j_tfm.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = tfm.forward(convert.transformer_params(jp, device="cpu"),
                            torch.from_numpy(toks), tcfg)
    assert (to_np(tl[..., 500:]) == -1e30).all() and (np.asarray(jl[..., 500:]) == -1e30).all()
    _close(tl[..., :500], np.asarray(jl[..., :500]))
    assert int(tl.argmax(-1).max()) < 500


def test_train_loss_forward_matches_reference():
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    jp = _reference_params(jcfg, seed=7)
    toks = _tokens(jcfg, seed=8)
    batch = {"tokens": toks, "labels": toks}
    want = float(jax.jit(lambda p, b: j_tfm.train_loss(p, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(tfm.train_loss(convert.transformer_params(jp, device="cpu"),
                                   {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_init_params_has_the_reference_tree(name):
    """Same keys, shapes and dtypes as the reference's init (its shapes by
    ``eval_shape``, nothing allocated); drawn on the CPU from the port's
    stream, the same bits from the same seed."""
    jcfg, tcfg = J_ARCHS[name].smoke_config, ARCHS[name].smoke_config
    want = jax.eval_shape(lambda k: j_tfm.init_params(jcfg, k), jax.random.PRNGKey(0))
    got = tfm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat_w = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
              for p, a in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype).replace("torch.", ""))
              for p, a in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_g == flat_w
    again = tfm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                                 jax.tree_util.tree_leaves(again)))
    wq = got["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("name", LM_ARCHS)
def test_configs_match_reference_field_for_field(name):
    for which in ("config", "smoke_config"):
        j, t = getattr(J_ARCHS[name], which), getattr(ARCHS[name], which)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert str(td.pop("dtype")).replace("torch.", "") == jnp.dtype(jd.pop("dtype")).name
        assert td == jd
        # arithmetic only, nothing allocated
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.q_dim, t.kv_dim, t.vocab_padded) == (j.q_dim, j.kv_dim, j.vocab_padded)
    assert ARCHS[name].family == J_ARCHS[name].family == "lm"
    assert ({k: dataclasses.asdict(v) for k, v in ARCHS[name].shapes.items()}
            == {k: dataclasses.asdict(v) for k, v in J_ARCHS[name].shapes.items()})


def test_registry_holds_the_lm_archs_and_the_pipeline():
    # and every other arch of the reference's registry, in its order (the
    # GNNs' and AutoInt's configs: tests/test_torch_gnn.py, test_torch_recsys.py)
    from repro.configs import ASSIGNED as J_ASSIGNED

    assert list(ARCHS) == list(J_ARCHS)
    assert [a.name for a in ASSIGNED] == [a.name for a in J_ASSIGNED]
    assert set(LM_ARCHS) < set(ARCHS) and "spectral" in ARCHS
    assert dataclasses.asdict(ARCHS["spectral"].config) == dataclasses.asdict(
        J_ARCHS["spectral"].config)
    granite = ARCHS["granite-moe-3b-a800m"].config
    assert granite.vocab_padded == 49184
    from repro_torch.models.moe import n_experts_padded

    assert n_experts_padded(granite.moe) == 48
