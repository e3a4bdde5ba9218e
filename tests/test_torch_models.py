"""The model zoo's layer substrate in the port (``repro_torch.models.common``,
``repro_torch.models.moe``) against the reference's
(``repro.models.common``, ``repro.models.moe``) on the CPU: the same numpy
inputs from a seed through both.

Tolerances: fp32 functions agree within rtol = atol = 1e-5 (one order of
summation apart); bf16 outputs within one bf16 ulp of the output's scale
(2⁻⁷ relative), since an fp32 difference of an ulp can round either way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as j_cm
from repro.models import moe as j_moe
from repro_torch import convert
from repro_torch.models import common as cm
from repro_torch.models import moe

from tests._parity import to_np

F32 = dict(rtol=1e-5, atol=1e-5)


def _bf16_close(got, want):
    got, want = to_np(got.float()), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * 2.0 ** -7)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, convert.transformer_params(np.asarray(j), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x, tx = _pair(rng.normal(size=(3, 5, 64)) * 3.0, dtype)
    g, tg = _pair(1.0 + 0.1 * rng.normal(size=(64,)), dtype)
    got, want = cm.rmsnorm(tx, tg), j_cm.rmsnorm(x, g)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(to_np(got), np.asarray(want), **F32)
    else:  # rounded to bf16 before the multiply by g, as the reference
        _bf16_close(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x, tx = _pair(rng.normal(size=(2, 7, 4, 32)), dtype)
    pos = rng.integers(0, 3000, size=(2, 7))
    got = cm.apply_rope(tx, torch.from_numpy(pos), 1e6)
    want = j_cm.apply_rope(x, jnp.asarray(pos, jnp.int32), 1e6)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":  # angles up to 3000 rad: cos/sin of fp32 agree to ~3e-4 abs
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-3)
    else:
        _bf16_close(got, np.asarray(want.astype(jnp.float32)))


def test_rope_halves_not_pairs():
    """Position p rotates (x_i, x_{i+d/2}) by p·θ^{-2i/d}."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 1] = 1.0
    out = cm.apply_rope(x, torch.tensor([[3]]), 100.0)
    angle = 3 * 100.0 ** (-2 / 8)
    np.testing.assert_allclose(to_np(out[0, 0, 0]),
                               [0, np.cos(angle), 0, 0, 0, np.sin(angle), 0, 0], atol=1e-6)


# (causal, Sq, Sk, G, chunk, q_offset): Sk a multiple of chunk or not, G ∈
# {1, 2, 4}, q_offset > 0 (chunked prefill) and < 0 (rows with no key: fully
# masked, zeros)
FLASH_GRID = [
    (True, 16, 16, 1, 8, 0),
    (True, 16, 16, 2, 5, 0),
    (True, 12, 21, 4, 8, 9),
    (False, 10, 21, 2, 8, 0),
    (False, 9, 16, 1, 16, 0),
    (True, 6, 19, 4, 4, 13),
    (True, 8, 8, 2, 3, -3),
    (False, 7, 13, 4, 64, 0),
]


@pytest.mark.parametrize("causal,sq,sk,g,chunk,q_offset", FLASH_GRID)
def test_flash_attention_matches_reference(causal, sq, sk, g, chunk, q_offset):
    rng = np.random.default_rng(sq * 100 + sk + g)
    B, hkv, dh = 2, 2, 16
    q = rng.normal(size=(B, sq, hkv * g, dh)).astype(np.float32)
    k = rng.normal(size=(B, sk, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, sk, hkv, dh)).astype(np.float32)
    want = np.asarray(j_cm.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, chunk=chunk, q_offset=q_offset))
    got = to_np(cm.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal, chunk=chunk,
                                   q_offset=q_offset))
    np.testing.assert_allclose(got, want, **F32)
    if q_offset < 0:  # the first rows see no key: zeros on both sides
        assert not np.abs(got[:, :-q_offset]).any()


def test_flash_attention_bf16_matches_reference():
    rng = np.random.default_rng(7)
    q, tq = _pair(rng.normal(size=(2, 11, 4, 16)), "bfloat16")
    k, tk = _pair(rng.normal(size=(2, 11, 2, 16)), "bfloat16")
    v, tv = _pair(rng.normal(size=(2, 11, 2, 16)), "bfloat16")
    got = cm.flash_attention(tq, tk, tv, chunk=4)
    want = j_cm.flash_attention(q, k, v, chunk=4)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("g", [1, 4])
def test_decode_attention_ragged_cache_len(g):
    rng = np.random.default_rng(g)
    B, S, hkv, dh = 4, 24, 2, 16
    q = rng.normal(size=(B, 1, hkv * g, dh)).astype(np.float32)
    kc = rng.normal(size=(B, S, hkv, dh)).astype(np.float32)
    vc = rng.normal(size=(B, S, hkv, dh)).astype(np.float32)
    cl = np.array([1, 24, 7, 13])
    want = np.asarray(j_cm.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                            jnp.asarray(cl, jnp.int32)))
    tkc = torch.from_numpy(kc)
    got = to_np(cm.decode_attention(torch.from_numpy(q), tkc, torch.from_numpy(vc),
                                    torch.from_numpy(cl)))
    np.testing.assert_allclose(got, want, **F32)
    # positions at or past cache_len do not matter
    tkc[2, 7:] = 1e6
    again = to_np(cm.decode_attention(torch.from_numpy(q), tkc, torch.from_numpy(vc),
                                      torch.from_numpy(cl)))
    np.testing.assert_array_equal(again[2], got[2])


def test_swiglu_and_cross_entropy_match_reference():
    rng = np.random.default_rng(3)
    x, wg, wu, wd = (rng.normal(size=s).astype(np.float32) * 0.3
                     for s in ((5, 16), (16, 32), (16, 32), (32, 16)))
    want = np.asarray(j_cm.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    got = to_np(cm.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))))
    np.testing.assert_allclose(got, want, **F32)
    logits = rng.normal(size=(2, 6, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, size=(2, 6))
    for z in (0.0, 1e-3):
        want = float(j_cm.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z))
        got = float(cm.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                          z_loss=z))
        assert abs(got - want) <= 1e-5 * abs(want)


def _moe_params(cfg, d, seed):
    E = j_moe.n_experts_padded(cfg)
    assert E == moe.n_experts_padded(moe.MoEConfig(cfg.n_experts, cfg.top_k, cfg.d_ff_expert))
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, E)) * 0.5,
         "w_gate": rng.normal(size=(E, d, cfg.d_ff_expert)) / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, cfg.d_ff_expert)) / np.sqrt(d),
         "w_down": rng.normal(size=(E, cfg.d_ff_expert, d)) / np.sqrt(cfg.d_ff_expert)}
    return {k: v.astype(np.float32) for k, v in p.items()}


_j_moe_ffn = jax.jit(j_moe.moe_ffn_gspmd, static_argnums=2)


def _moe_cfgs(cf):
    kw = dict(n_experts=10, top_k=3, d_ff_expert=24, capacity_factor=cf)
    return j_moe.MoEConfig(**kw), moe.MoEConfig(**kw)


@pytest.mark.parametrize("capacity_factor,T", [(1.25, 40), (0.05, 600)])
def test_moe_ffn_matches_reference(capacity_factor, T):
    """y and all three aux values; at capacity factor 0.05 the capacity
    (32 slots an expert) drops tokens."""
    jcfg, tcfg = _moe_cfgs(capacity_factor)
    d = 16
    p = _moe_params(jcfg, d, seed=T)
    x = np.random.default_rng(T + 1).normal(size=(T, d)).astype(np.float32)
    y, aux = _j_moe_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_ffn(convert.transformer_params(p, device="cpu"), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to_np(ty), np.asarray(y), **F32)
    assert set(taux) == set(aux)
    for k in aux:
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-5, atol=1e-7)
    assert (float(taux["dropped_frac"]) > 0.1) == (capacity_factor < 1)


def test_moe_ties_keep_the_lower_expert():
    """Equal router probabilities (duplicated router columns) route to the
    lower expert first, as ``lax.top_k`` does; padded experts get nothing."""
    jcfg, tcfg = _moe_cfgs(1.25)
    d = 16
    p = _moe_params(jcfg, d, seed=5)
    p["router"][:, 3] = p["router"][:, 7]
    p["router"][:, 4] = p["router"][:, 1]
    x = np.random.default_rng(6).normal(size=(64, d)).astype(np.float32)
    *_, ids = moe.route(convert.transformer_params(p, device="cpu"), torch.from_numpy(x), tcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    probs = jax.nn.softmax(j_moe._mask_padded_experts(jnp.asarray(x) @ jp["router"], 10), -1)
    _, want = jax.lax.top_k(probs, 3)
    np.testing.assert_array_equal(to_np(ids), np.asarray(want))
    assert int(ids.max()) < 10
    y, _ = _j_moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, _ = moe.moe_ffn(convert.transformer_params(p, device="cpu"), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(to_np(ty), np.asarray(y), **F32)


def test_moe_ffn_bf16_matches_reference():
    jcfg, tcfg = _moe_cfgs(1.25)
    d = 16
    p = {k: jnp.asarray(v).astype(jnp.bfloat16 if k != "router" else jnp.float32)
         for k, v in _moe_params(jcfg, d, seed=9).items()}
    x = jnp.asarray(np.random.default_rng(10).normal(size=(48, d)), jnp.bfloat16)
    y, _ = _j_moe_ffn(p, x, jcfg)
    tp = convert.transformer_params({k: np.asarray(v) for k, v in p.items()}, device="cpu")
    ty, _ = moe.moe_ffn(tp, convert.transformer_params(np.asarray(x), device="cpu"), tcfg)
    assert ty.dtype == torch.bfloat16
    # a bf16 rounding of the expert GEMMs' inputs can move a slot's output by
    # an ulp; the sum of K = 3 slots by a few
    got, want = to_np(ty.float()), np.asarray(y.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.abs(want).max() * 2.0 ** -8)


def test_convert_bfloat16_round_trip_is_exact():
    a = jnp.asarray(np.random.default_rng(11).normal(size=(33, 7)), jnp.bfloat16)
    t = convert.transformer_params({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(t.float()), np.asarray(a.astype(jnp.float32)))


def test_normal_init_chunks_reproduce_one_draw(monkeypatch):
    """A parameter drawn in row chunks equals the same draw made at once."""
    from repro_torch import _random

    whole = cm.normal_init(_random.Stream((5, 6)), (3, 40, 50), torch.float32, 0.5, "cpu")
    monkeypatch.setattr(cm, "_DRAW_CHUNK", 120)
    chunked = cm.normal_init(_random.Stream((5, 6)), (3, 40, 50), torch.float32, 0.5, "cpu")
    assert torch.equal(whole, chunked)
    assert abs(float(whole.std()) - 0.5) < 0.02
