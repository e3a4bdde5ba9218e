"""The port's counter-based random stream (:mod:`repro_torch._random`) and
the draws rewired onto it.

Tolerances: raw Philox words are compared exactly — against the published
known answers of Philox4x32-10 and against a plain numpy uint64 version on
10⁵ random (counter, key) pairs; uniforms, Rademacher signs and chunked
draws are exact too (integer arithmetic and exact float scaling).  Moments
of 4·10⁵ values are held within about 5 standard errors (normal mean
±0.01, variance ±0.01; Rademacher mean ±0.01; Gumbel mean within 0.01 of
Euler's γ).  The streams of two generators are compared by their sample
correlation, which must stay below 0.01 at 4·10⁵ values.
"""
import numpy as np
import pytest
import torch

from repro_torch import _random
from repro_torch._device import cpu_generator, fold_in
from repro_torch.core import chebyshev as tch
from repro_torch.core import kmeans as tkm

MASK = 0xFFFFFFFF
KNOWN = [  # (counter, key, output) of Philox4x32-10 (Random123's known answers)
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK,) * 4, (MASK, MASK), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def philox_numpy(ctr: np.ndarray, key) -> np.ndarray:
    """Plain Philox4x32-10 in numpy uint64 ([4, N] counters, one key)."""
    c = [ctr[i].astype(np.uint64) for i in range(4)]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    mask = np.uint64(MASK)
    for _ in range(10):
        p0, p1 = c[0] * m0, c[2] * m1  # < 2^64: exact in uint64
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & mask]
        k0, k1 = (k0 + np.uint64(0x9E3779B9)) & mask, (k1 + np.uint64(0xBB67AE85)) & mask
    return np.stack(c).astype(np.int64)


@pytest.mark.parametrize("ctr,key,want", KNOWN)
def test_philox_known_answers(ctr, key, want):
    got = _random.philox4x32(torch.tensor(ctr, dtype=torch.int64)[:, None], key)
    assert got[:, 0].tolist() == list(want)
    assert philox_numpy(np.array(ctr, np.int64)[:, None], key)[:, 0].tolist() == list(want)


def test_philox_matches_numpy_on_random_pairs():
    """10⁵ (counter, key) pairs: 100 random keys (some near 2³² − 1) × 1000
    random counters, a quarter of their words within 3 of 2³² − 1."""
    rng = np.random.default_rng(0)
    for i in range(100):
        key = tuple(int(v) for v in rng.integers(0, 1 << 32, 2))
        if i % 10 == 0:
            key = (MASK - i // 10, MASK - (i // 10) % 3)
        ctr = rng.integers(0, 1 << 32, (4, 1000), dtype=np.int64)
        near = rng.random((4, 1000)) < 0.25
        ctr[near] = MASK - rng.integers(0, 4, int(near.sum()))
        got = _random.philox4x32(torch.from_numpy(ctr), key).numpy()
        np.testing.assert_array_equal(got, philox_numpy(ctr, key))
        assert got.min() >= 0 and got.max() <= MASK


def test_words_layout_and_chunk_invariance():
    """Row r of a [rows, cols] draw is counter row row0 + r, its words the
    blocks 0, 1, … in order: any split into row chunks gives the same rows."""
    key = (12345, 678)
    whole = _random.words(key, 3, 11, 9, "cpu")
    ctr = np.array([[b, r, 3, 0] for r in range(11) for b in range(3)], np.int64).T
    want = philox_numpy(ctr, key).T.reshape(11, 12)[:, :9]
    np.testing.assert_array_equal(whole.numpy(), want)
    parts = [_random.words(key, 3, min(4, 11 - r), 9, "cpu", row0=r) for r in range(0, 11, 4)]
    assert torch.equal(torch.cat(parts), whole)
    with pytest.raises(ValueError, match="counter range"):
        _random.words(key, 1 << 32, 1, 1, "cpu")


@pytest.mark.parametrize("col0,cols", [(0, 9), (1, 7), (4, 5), (6, 3), (10, 1)])
def test_a_column_window_is_those_columns_of_the_whole_draw(col0, cols):
    """``col0`` draws only the window's Philox blocks, and gives the bits of
    the whole draw's columns there (how a rank draws its own columns of the
    k-means++ Gumbel rows); so does each derived draw."""
    key = (12345, 678)
    whole = _random.words(key, 3, 5, 11, "cpu", row0=2)
    got = _random.words(key, 3, 5, cols, "cpu", row0=2, col0=col0)
    assert torch.equal(got, whole[:, col0:col0 + cols])
    g = _random.gumbel(key, 3, (5, 11), "cpu")
    assert torch.equal(_random.gumbel(key, 3, (5, cols), "cpu", col0=col0),
                       g[:, col0:col0 + cols])


def test_uniform_and_rademacher_come_from_the_words():
    key = (7, 8)
    w = _random.words(key, 0, 5, 64, "cpu")
    u = _random.uniform(key, 0, (5, 64), "cpu")
    assert torch.equal(u, (w >> 8).float() / 2 ** 24)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    s = _random.rademacher(key, 0, (5, 64 * 32 - 5), "cpu")  # value j: bit j % 32 of word j // 32
    j = torch.arange(s.shape[1])
    bit = (w[:, j // 32] >> (j % 32)) & 1
    assert torch.equal(s, bit.float() * 2 - 1)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_kmeanspp_gumbel_rows_do_not_depend_on_the_chunking(chunk, monkeypatch):
    """The k − 1 Gumbel rows of k-means++ drawn ``chunk`` rows a pass equal
    one [k − 1, n] draw; so does the seeding itself."""
    key, k, n = (99, 100), 71, 333
    whole = _random.gumbel(key, 1, (k - 1, n), "cpu")
    rows = [_random.gumbel(key, 1, (min(chunk, k - 1 - r), n), "cpu", row0=r)
            for r in range(0, k - 1, chunk)]
    assert torch.equal(torch.cat(rows), whole)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(n, 5)).astype(np.float32))
    monkeypatch.setattr(tkm, "GUMBEL_CHUNK", k)
    want = tkm.kmeanspp_init(x, k, cpu_generator(3))
    monkeypatch.setattr(tkm, "GUMBEL_CHUNK", chunk)
    assert torch.equal(tkm.kmeanspp_init(x, k, cpu_generator(3)), want)


def test_one_seed_gives_the_same_draws():
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(400, 6)).astype(np.float32))
    draws = {}
    for seed in (0, 1):
        a = draws[seed] = tch.draw_signals(cpu_generator(seed), 300, 4, 37, "cpu")
        b = tch.draw_signals(cpu_generator(seed), 300, 4, 37, "cpu")
        assert all(torch.equal(p, q) for p, q in zip(a, b))
        assert a[0].shape == (300,) and a[1].shape == (300, 4) and a[2].shape == (300, 37)
        for init in (tkm.kmeanspp_init, tkm.random_init):
            assert torch.equal(init(x, 9, cpu_generator(seed)), init(x, 9, cpu_generator(seed)))
    assert not any(torch.equal(p, q) for p, q in zip(draws[0], draws[1]))


def test_generator_advances_by_one_key():
    """An entry point takes one two-word draw from its generator."""
    gen, ref = cpu_generator(5), cpu_generator(5)
    tch.draw_signals(gen, 50, 2, 9, "cpu")
    torch.randint(0, 1 << 32, (2,), generator=ref, dtype=torch.int64)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=ref))


def test_fold_in_gives_independent_streams():
    base = cpu_generator(11)
    keys = [_random.key_from_generator(fold_in(base, i)) for i in range(4)]
    assert len(set(keys)) == 4
    z = [_random.normal(k, 0, 400_000, "cpu") for k in keys[:2]]
    assert abs(float(torch.corrcoef(torch.stack(z))[0, 1])) < 0.01
    # and reproducible: the same fold gives the same key
    assert _random.key_from_generator(fold_in(cpu_generator(11), 2)) == keys[2]


def test_moments():
    key = (2024, 10)
    z = _random.normal(key, 0, (1000, 400), "cpu")
    assert abs(float(z.mean())) < 0.01 and abs(float(z.var()) - 1.0) < 0.01
    assert bool(torch.isfinite(z).all())
    s = _random.rademacher(key, 1, (1000, 400), "cpu")
    assert set(s.unique().tolist()) == {-1.0, 1.0} and abs(float(s.mean())) < 0.01
    g = _random.gumbel(key, 2, (1000, 400), "cpu")
    assert abs(float(g.mean()) - 0.5772156649) < 0.01
    u = _random.uniform(key, 3, 400_000, "cpu")
    assert abs(float(u.mean()) - 0.5) < 0.002
    idx = torch.cat([_random.index(key, d, 7, "cpu") for d in range(700)])
    assert int(idx.min()) == 0 and int(idx.max()) == 6


@pytest.mark.parametrize("n,k", [(50, 50), (1000, 37), (10, 1)])
def test_random_init_returns_k_distinct_rows(n, k):
    x = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 3)
    c = tkm.random_init(x, k, cpu_generator(n))
    assert c.shape == (k, 3)
    assert len(set(c[:, 0].tolist())) == k
