"""The port's E(3) substrate (``repro_torch.models.gnn.e3``) against the
reference's (``repro.models.gnn.e3``) on the CPU, and the port's own copies
of ``tests/test_e3.py``'s identities.

Tolerances: the host tables (``su2_cg``, ``real_cg``, the Wigner-d terms)
bitwise; ``real_sph_harm`` within 1e-6 absolute (the same recurrences in
fp32; the outputs are O(1)); ``real_wigner_D`` and ``block_diag_wigner``
within 1e-5 absolute for every l ≤ 6 (d^l is a sum of up to 2l + 1 terms
of powers up to 2l of cos(β/2) and sin(β/2), whose last ulp differs between
two libms; the port also computes the complex product in real arithmetic);
the identities at the reference test's own tolerances.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import e3 as je
from repro_torch.models.gnn import e3
from repro_torch.models.gnn.graph import GraphBatch

from tests._parity import to_np

PATHS_L3 = [(l1, l2, l3) for l1 in range(4) for l2 in range(4) for l3 in range(4)
            if abs(l1 - l2) <= l3 <= l1 + l2]


@pytest.mark.parametrize("l1,l2,l3", PATHS_L3)
def test_cg_tables_bitwise_equal_to_reference(l1, l2, l3):
    np.testing.assert_array_equal(e3.su2_cg(l1, l2, l3), je.su2_cg(l1, l2, l3))
    got, want = e3.real_cg(l1, l2, l3), je.real_cg(l1, l2, l3)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l", range(7))
def test_host_wigner_tables_bitwise_equal_to_reference(l):
    assert e3._wigner_d_terms(l) == je._wigner_d_terms(l)
    for a, b in zip(e3._wigner_tables(l)[:4], je._wigner_tables(l)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(e3._real_basis_change(l), je._real_basis_change(l))
    assert e3.irrep_slices(l) == je.irrep_slices(l) and e3.irrep_dim(l) == je.irrep_dim(l)


def _vectors(n=300, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v[:4] = [[0, 0, 1], [0, 0, -1], [0, 0, 2.5], [0, 0, -0.3]]  # the poles
    return v


@pytest.mark.parametrize("normalize", [True, False])
def test_real_sph_harm_matches_reference(normalize):
    v = _vectors()
    if not normalize:
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    want = je.real_sph_harm(6, jnp.asarray(v), normalize_input=normalize)
    got = e3.real_sph_harm(6, torch.from_numpy(v), normalize_input=normalize)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=0, atol=1e-6)


def _angles(n=400, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    b = rng.uniform(0, np.pi, n).astype(np.float32)
    b[:3] = [0.0, np.float32(np.pi), 0.0]
    a[2] = 0.0
    return a, b


@pytest.mark.parametrize("l", range(7))
def test_real_wigner_D_matches_reference(l):
    a, b = _angles()
    want = np.asarray(je.real_wigner_D(l, jnp.asarray(a), jnp.asarray(b)))
    got = e3.real_wigner_D(l, torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (len(a), 2 * l + 1, 2 * l + 1)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-5)
    # d^l's terms share (m′, m) entries: every one of them is summed
    d = to_np(e3._complex_wigner_d_beta(l, torch.from_numpy(b)))
    np.testing.assert_allclose(d, np.asarray(je._complex_wigner_d_beta(l, jnp.asarray(b))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(d[0], np.eye(2 * l + 1), atol=1e-6)  # β = 0
    # a batch shape of two axes
    got2 = e3.real_wigner_D(l, torch.from_numpy(a[:12]).reshape(3, 4),
                            torch.from_numpy(b[:12]).reshape(3, 4))
    np.testing.assert_allclose(to_np(got2).reshape(12, 2 * l + 1, 2 * l + 1), to_np(got)[:12],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("l_max", [2, 6])
def test_block_diag_wigner_matches_reference(l_max):
    a, b = _angles(64)
    want = np.asarray(je.block_diag_wigner(l_max, jnp.asarray(a), jnp.asarray(b)))
    got = e3.block_diag_wigner(l_max, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-5)


def test_edge_alignment_angles_match_reference():
    v = _vectors()
    v[4] = 0.0  # a zero-length vector (a self loop): finite angles
    wa, wb = je.edge_alignment_angles(jnp.asarray(v))
    ga, gb = e3.edge_alignment_angles(torch.from_numpy(v))
    np.testing.assert_allclose(to_np(ga), np.asarray(wa), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(gb), np.asarray(wb), rtol=0, atol=1e-6)
    assert np.isfinite(to_np(ga)).all() and np.isfinite(to_np(gb)).all()


# ---------------------------------------------------------------------------
# the identities of tests/test_e3.py, on the port
# ---------------------------------------------------------------------------

def _rotmat(a, b, c):
    def Rz(t):
        co, si = np.cos(t), np.sin(t)
        return np.array([[co, -si, 0], [si, co, 0], [0, 0, 1]])

    def Ry(t):
        co, si = np.cos(t), np.sin(t)
        return np.array([[co, 0, si], [0, 1, 0], [-si, 0, co]])

    return Rz(a) @ Ry(b) @ Rz(c)


def _euler(R):
    b = np.arccos(np.clip(R[2, 2], -1, 1))
    return np.arctan2(R[1, 2], R[0, 2]), b, np.arctan2(R[2, 1], -R[2, 0])


def _D(l, R):
    a, b, c = _euler(R)
    t = lambda x: torch.tensor([x], dtype=torch.float32)  # noqa: E731
    return to_np(e3.real_wigner_D(l, t(a), t(b)))[0] @ to_np(e3.real_wigner_D(l, t(c), t(0.0)))[0]


def test_sh_orthonormal():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(200000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    Y = np.concatenate([to_np(y) for y in e3.real_sph_harm(3, torch.from_numpy(v))], axis=1)
    Gm = 4 * np.pi * (Y.T @ Y) / len(v)
    assert np.abs(Gm - np.eye(16)).max() < 0.02  # MC tolerance


@pytest.mark.parametrize("path", [(1, 1, 2), (1, 1, 0), (2, 1, 1), (2, 2, 2)])
def test_gaunt_identity(path):
    l1, l2, l3 = path
    v = torch.from_numpy(np.random.default_rng(1).normal(size=(512, 3)).astype(np.float32))
    C = e3.real_cg(l1, l2, l3)
    y1, y2, y3 = (to_np(e3.real_sph_harm(l, v)[l]) for l in (l1, l2, l3))
    lhs = np.einsum("abc,na,nb->nc", C, y1, y2)
    const = (lhs * y3).sum(1) / (y3 * y3).sum(1)
    assert const.std() < 1e-5
    assert np.abs(lhs - const[:, None] * y3).max() < 1e-5


def test_cg_111_is_cross_product():
    C = e3.real_cg(1, 1, 1)
    rng = np.random.default_rng(2)
    for _ in range(5):  # real l=1 basis is (y, z, x)
        u3, w3 = rng.normal(size=3), rng.normal(size=3)
        out = np.einsum("abc,a,b->c", C, u3[[1, 2, 0]], w3[[1, 2, 0]])
        out_xyz = np.array([out[2], out[0], out[1]])
        cross = np.cross(u3, w3)
        mask = np.abs(cross) > 1e-9
        ratio = out_xyz[mask] / cross[mask]
        assert np.abs(ratio - ratio[0]).max() < 1e-5


@pytest.mark.parametrize("l", [1, 2, 4, 6])
def test_wigner_equivariance_and_homomorphism(l):
    R1 = _rotmat(0.3, 1.2, -0.7)
    R2 = _rotmat(-1.1, 0.4, 2.0)
    assert np.abs(_D(l, R1 @ R2) - _D(l, R1) @ _D(l, R2)).max() < 5e-6
    v = np.random.default_rng(l).normal(size=(100, 3)).astype(np.float32)
    Yv = to_np(e3.real_sph_harm(l, torch.from_numpy(v))[l])
    YRv = to_np(e3.real_sph_harm(l, torch.from_numpy(v @ R1.T.astype(np.float32)))[l])
    assert np.abs(YRv - Yv @ _D(l, R1).T).max() < 5e-6


def test_edge_alignment_concentrates_on_zhat():
    vecs = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 3)).astype(np.float32))
    al, be = e3.edge_alignment_angles(vecs)
    for l in (1, 2, 3):
        Yv = e3.real_sph_harm(l, vecs)[l]
        D = e3.real_wigner_D(l, al, be)
        aligned = torch.einsum("nsr,nr->ns", D.transpose(1, 2), Yv)
        zhat = e3.real_sph_harm(l, torch.tensor([[0.0, 0.0, 1.0]]))[l][0]
        assert float((aligned - zhat[None]).abs().max()) < 1e-5


@pytest.mark.parametrize("model", ["nequip", "equiformer"])
@pytest.mark.parametrize("edge_chunk", [None, 16])
def test_model_rotation_invariance(model, edge_chunk):
    """The reference's gate (``tests/test_e3.py``) on the port: rotating and
    translating the positions moves the loss by less than 5e-5 relative —
    through the chunked path too (nequip's chunks are exact; equiformer's
    per-chunk softmax is still invariant)."""
    rng = np.random.default_rng(0)
    n, e = 24, 60
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 2
    src = torch.from_numpy(rng.integers(0, n, e))
    dst = torch.from_numpy(rng.integers(0, n, e))
    species = torch.from_numpy(rng.integers(0, 5, n))

    def mk(p):
        return GraphBatch(
            node_feat=torch.zeros((n, 1)), edge_src=src, edge_dst=dst, edge_mask=torch.ones(e),
            labels=torch.zeros(1), label_mask=torch.ones(1), positions=torch.from_numpy(p),
            species=species, graph_id=torch.zeros(n, dtype=torch.int64), n_graphs=1)

    R = _rotmat(0.5, 0.9, 1.3).astype(np.float32)
    if model == "nequip":
        from repro_torch.models.gnn.nequip import NequIPConfig, init_params, loss

        cfg = NequIPConfig(n_layers=2, channels=8, n_species=5, edge_chunk=edge_chunk)
    else:
        from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config, init_params, loss

        cfg = EquiformerV2Config(n_layers=2, channels=16, l_max=3, m_max=2, n_heads=4,
                                 n_species=5, edge_chunk=edge_chunk)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    l1 = float(loss(params, mk(pos), cfg))
    l2 = float(loss(params, mk(pos @ R.T + 5.0), cfg))
    assert abs(l1 - l2) < 5e-5 * max(abs(l1), 1.0)
    assert dataclasses.is_dataclass(mk(pos))
