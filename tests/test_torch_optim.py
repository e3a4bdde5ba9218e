"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``) on the CPU, and each case of ``tests/test_optim.py`` run
on the port.

Inputs are numpy draws from a seed, given to both packages.  Tolerances:
the schedule within 2 fp32 ulps (``cos`` and ``pow`` are two libraries'
fp32 functions); ``global_norm`` rtol 1e-6 (sums of squares in another
order); after 5 AdamW steps, fp32 parameters within 1e-6 of each leaf's
max|p| and moments rtol 1e-5 (the gradient norm's rounding scales every
clipped gradient), bf16 parameters within one bf16 ulp of |p| (a last-bit
difference before the rounding to bf16 may round the other way); the int8
codes, scales and residuals bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro_torch import optim as t_optim
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm, schedule
from repro_torch.optim.compress import compress_int8, decompress_int8, ef_compress

from tests._parity import to_np

SHAPES = {"w": (16, 12), "b": (12,), "block": {"a": (3, 5, 4), "g": (7,)}}


def _draw(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _jax(tree, dtype):
    if isinstance(tree, dict):
        return {k: _jax(v, dtype) for k, v in tree.items()}
    return jnp.asarray(tree, dtype)


def _torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dtype)


def _pairs(j, t):
    if isinstance(j, dict):
        for k in j:
            yield from _pairs(j[k], t[k])
    else:
        yield np.asarray(j, np.float32), to_np(t.float())


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

def test_schedule_matches_reference():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg = j_adamw.AdamWConfig(**cfg.__dict__)
    steps = np.arange(0, cfg.total_steps + 6, dtype=np.int32)
    want = np.array([float(j_adamw.schedule(jcfg, jnp.asarray(s))) for s in steps], np.float32)
    got = np.array([float(schedule(cfg, torch.tensor(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=0)
    assert got[0] == 0.0 and got[-1] == got[cfg.total_steps]  # flat past total_steps


def test_global_norm_and_clipping_match_reference():
    rng = np.random.default_rng(0)
    g = _draw(rng, SHAPES, scale=3.0)
    want = float(j_adamw.global_norm(_jax(g, jnp.float32)))
    got = float(global_norm(_torch(g, torch.float32)))
    assert abs(got - want) <= 1e-6 * want
    # clipping: a gradient of norm ≫ grad_clip scales to the clip; metrics unclipped
    cfg = AdamWConfig(grad_clip=0.5, warmup_steps=0, weight_decay=0.0)
    p = _draw(rng, SHAPES)
    tp = _torch(p, torch.float32)
    _, opt, m = adamw_update(tp, _torch(g, torch.float32), adamw_init(tp), cfg)
    jopt = j_adamw.adamw_update(_jax(p, jnp.float32), _jax(g, jnp.float32),
                                j_adamw.adamw_init(_jax(p, jnp.float32)),
                                j_adamw.AdamWConfig(**cfg.__dict__))[1]
    assert abs(float(m["grad_norm"]) - want) <= 1e-6 * want
    for jm, tm in _pairs(jopt["m"], opt["m"]):
        np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-9)
    # m after one step is (1 − β1)·g·clip/‖g‖: its norm is (1 − β1)·clip
    assert abs(float(global_norm(opt["m"])) - 0.1 * 0.5) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_after_5_steps(dtype):
    rng = np.random.default_rng(1)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8, grad_clip=2.0)
    jcfg = j_adamw.AdamWConfig(**cfg.__dict__)
    p0 = _draw(rng, SHAPES)
    jp, tp = _jax(p0, getattr(jnp, dtype)), _torch(p0, getattr(torch, dtype))
    jopt, topt = j_adamw.adamw_init(jp), adamw_init(tp)
    for _ in range(5):
        g = _draw(rng, SHAPES, scale=rng.uniform(0.1, 2.0))
        jp, jopt, jm = j_adamw.adamw_update(jp, _jax(g, getattr(jnp, dtype)), jopt, jcfg)
        tp, topt, tm = adamw_update(tp, _torch(g, getattr(torch, dtype)), topt, cfg)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 2 * 2.0 ** -23 * float(jm["lr"])
    assert int(topt["step"]) == int(jopt["step"]) == 5 and topt["step"].dtype == torch.int32
    for name in ("m", "v"):
        for j, t in _pairs(jopt[name], topt[name]):
            assert t.dtype == np.float32
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())
    for j, t in _pairs(jp, tp):
        if dtype == "float32":
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6 * np.abs(j).max())
        else:
            np.testing.assert_allclose(t, j, rtol=2.0 ** -8, atol=0)
    assert all(x.dtype == getattr(torch, dtype) for x in
               [tp["w"], tp["b"], tp["block"]["a"], tp["block"]["g"]])


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.5])
def test_int8_codes_match_reference_bitwise(scale):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(513,)) * scale).astype(np.float32)
    x[:4] = [0.5, -0.5, 1.5, -2.5]  # halves: both round to even
    x[4] = 127.0 * 0.5 / 127.0
    jq, js = j_compress.compress_int8(jnp.asarray(x))
    tq, ts = compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
    assert to_np(ts).tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(to_np(decompress_int8(tq, ts)),
                                  np.asarray(j_compress.decompress_int8(jq, js)))
    assert decompress_int8(tq, ts, torch.bfloat16).dtype == torch.bfloat16


def test_round_half_to_even_on_both():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5, 127.0], np.float32)
    jq, _ = j_compress.compress_int8(jnp.asarray(x))
    tq, _ = compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(tq), np.asarray(jq))


def test_ef_compress_matches_reference_bitwise():
    rng = np.random.default_rng(3)
    jr, tr = jnp.zeros((64,)), torch.zeros(64)
    for _ in range(10):
        g = rng.normal(size=(64,)).astype(np.float32)
        jq, js, jr = j_compress.ef_compress(jnp.asarray(g), jr)
        tq, ts, tr = ef_compress(torch.from_numpy(g), tr)
        np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
        assert to_np(ts).tobytes() == np.asarray(js).tobytes()
        assert to_np(tr).tobytes() == np.asarray(jr).tobytes()


def test_package_exports_the_reference_names():
    import repro.optim as j

    ported = {n for n in dir(j) if not n.startswith("_")} - {"adamw", "compress"}
    assert ported - set(dir(t_optim)) == set()


# ---------------------------------------------------------------------------
# tests/test_optim.py, on the port
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=0)
    p = {"w": torch.tensor([3.0, -2.0, 1.0])}
    opt = adamw_init(p)
    for _ in range(200):
        g = {"w": 2 * p["w"]}  # d/dw of ||w||²
        p, opt, m = adamw_update(p, g, opt, cfg)
    assert float(p["w"].abs().max()) < 1e-2


def test_grad_clip():
    cfg = AdamWConfig(grad_clip=1.0, warmup_steps=0)
    p = {"w": torch.zeros(3)}
    opt = adamw_init(p)
    g = {"w": torch.tensor([100.0, 0.0, 0.0])}
    _, _, metrics = adamw_update(p, g, opt, cfg)
    assert float(metrics["grad_norm"]) > 99  # reported unclipped


def test_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    s = [float(schedule(cfg, torch.tensor(i))) for i in (0, 5, 10, 55, 100)]
    assert s[0] == 0.0 and abs(s[1] - 0.5) < 1e-6 and abs(s[2] - 1.0) < 1e-6
    assert s[2] > s[3] > s[4] >= 0.1 - 1e-6


def test_int8_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(1000,)) * 5).astype(np.float32))
    q, s = compress_int8(x)
    err = (decompress_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) / 2 + 1e-6  # half-ULP of the quantizer


def test_error_feedback_converges():
    """EF invariant: sum of transmitted values tracks sum of true gradients
    (residual stays bounded) — the property that preserves SGD convergence."""
    rng = np.random.default_rng(1)
    resid = torch.zeros(64)
    sent_total = torch.zeros(64)
    true_total = torch.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
        q, s, resid = ef_compress(g, resid)
        sent_total = sent_total + decompress_int8(q, s)
        true_total = true_total + g
    drift = float((sent_total + resid - true_total).abs().max())
    assert drift < 1e-4
    assert float(resid.abs().max()) < 1.0


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10**6), scale=st.floats(1e-3, 1e3))
def test_property_compression_relative_error(seed, scale):
    x = torch.from_numpy((np.random.default_rng(seed).normal(size=(256,)) * scale)
                         .astype(np.float32))
    q, s = compress_int8(x)
    rel = float((decompress_int8(q, s) - x).abs().max() / x.abs().max())
    assert rel <= 1.0 / 127 + 1e-6


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6
