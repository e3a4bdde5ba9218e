"""The precision argument of the tensor-core k-means assignment
(``csrc/kmeans_assign.cu``), on the CPU: its "3xTF32" product emulated in
torch, then the labels held to the fp32 plain version (``kmeans_assign_ref``)
and to the JAX reference's ``kmeans_assign`` (its Pallas kernel in interpret
mode, as the reference's own tests run it), all from the same numpy inputs.

The kernel splits every operand into ``hi = tf32(a)`` and ``lo = tf32(a −
hi)`` (as ``cvt.rna``: round to nearest, ties away from zero, low 13 bits
cleared) and accumulates ``lo·hi + hi·lo + hi·hi`` in fp32, a fresh partial
per 32-deep slice.  The emulation rounds on the int32 view the same way and
takes the three products of each slice as fp32 matrix products, small terms
first.  It cannot reproduce the tensor cores' summation order within a
slice, so it is held to the same gates as the card: labels equal
on tie-free data (blobs, every centroid duplicated across the kernel's
128-wide centroid tiles — exact ties that must go to the lower index — and a
spectral embedding of the DTI point cloud with its k-means centroids), min
distances at 1e-5 of ‖x‖² + ‖c‖² (the terms they cancel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kmeans_assign.ops import kmeans_assign as j_assign
from repro_torch.core import kmeans as tkm
from repro_torch.core.spectral import EigConfig, GraphConfig, KMeansConfig, SpectralPipeline
from repro_torch.data.pointcloud import dti_like_pointcloud
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref

TF32_MASK = -0x2000  # 0xffffe000: sign, exponent and the 10 TF32 mantissa bits
SLICE = 32  # the kernel's depth per ring slice, one fresh partial each


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 (kept in fp32), round to nearest with ties away from zero:
    add half a TF32 unit to the magnitude bits, then clear the low 13."""
    return ((a.contiguous().view(torch.int32) + 0x1000) & TF32_MASK).view(torch.float32)


def split_tf32(a: torch.Tensor):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def assign_3xtf32(x: torch.Tensor, c: torch.Tensor):
    """(labels, dist²) with the kernel's product: per 32-deep slice a fresh
    partial lo·hi + hi·lo + hi·hi, added to the running sum in fp32."""
    xh, xl = split_tf32(x)
    ch, cl = split_tf32(c)
    dot = torch.zeros(x.shape[0], c.shape[0])
    for k0 in range(0, x.shape[1], SLICE):
        sl = slice(k0, k0 + SLICE)
        dot += (xl[:, sl] @ ch[:, sl].T + xh[:, sl] @ cl[:, sl].T) + xh[:, sl] @ ch[:, sl].T
    s = (c * c).sum(1)[None, :] - 2.0 * dot
    val, lab = torch.min(s, dim=1)  # first occurrence: ties low
    return lab.to(torch.int32), torch.clamp(val + (x * x).sum(1), min=0.0)


def _blobs(n, k, d, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)).astype(np.float32)
    x = (c[rng.integers(0, k, n)] + noise * rng.normal(size=(n, d))).astype(np.float32)
    return x, c


def _duplicated(n, k, d, seed):
    x, c = _blobs(n, k, d, seed)
    return x, np.concatenate([c, c])


def _dti_embedding():
    """A 12-cluster spectral embedding of the 4000-voxel DTI point cloud
    (the exact path on the CPU) and the centroids of its k-means labels."""
    pos, prof, _, _ = dti_like_pointcloud(4000, 90, 6, eps=1.8, seed=0, neighbors="none",
                                          device="cpu")
    pipe = SpectralPipeline(n_clusters=12,
                            graph=GraphConfig(knn_k=16, measure="cross_correlation"),
                            eig=EigConfig(tol=1e-4, block_size=4, representation="blockell"),
                            kmeans=KMeansConfig(iter="fused"))
    res = pipe.run(prof, torch.Generator().manual_seed(0), points=pos, device="cpu")
    emb = res.embedding.float()
    c = tkm.update_centroids(emb, res.labels, 12, torch.zeros(12, emb.shape[1]))
    return emb.numpy(), c.numpy()


FIXTURES = {
    "blobs-1-1-1": lambda: _blobs(1, 1, 1, 2),
    "blobs-129-65-17": lambda: _blobs(129, 65, 17, 66),
    "blobs-1000-37-90": lambda: _blobs(1000, 37, 90, 38),
    "blobs-513-500-33": lambda: _blobs(513, 500, 33, 501),
    "blobs-300-130-257": lambda: _blobs(300, 130, 257, 131),
    "duplicated-700-130-16": lambda: _duplicated(700, 130, 16, 700),
    "duplicated-2000-300-90": lambda: _duplicated(2000, 300, 90, 2000),
    "dti-embedding-4000": _dti_embedding,
}


@pytest.mark.parametrize("case", list(FIXTURES))
def test_3xtf32_labels_equal_fp32_and_reference(case):
    x, c = FIXTURES[case]()
    xt, ct = torch.as_tensor(x), torch.as_tensor(c)
    got_l, got_d = assign_3xtf32(xt, ct)
    want_l, want_d = kmeans_assign_ref(xt, ct)
    ref_l, _ = j_assign(jnp.asarray(x), jnp.asarray(c), impl="pallas", interpret=True)
    np.testing.assert_array_equal(got_l.numpy(), want_l.numpy())
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    np.testing.assert_allclose(got_d.numpy(), want_d.numpy(), rtol=0, atol=1e-5 * scale)
    if case.startswith("duplicated"):
        assert int(got_l.max()) < c.shape[0] // 2  # every tie went to the lower copy


@pytest.mark.parametrize("seed", [0, 1])
def test_split_is_two_tf32_values_within_2_pow_minus_22(seed):
    """hi and lo carry 10 mantissa bits each (low 13 bits clear), and hi + lo
    is a to within 2⁻²² of |a| — the error of the dropped lo·lo term."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor((rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096))
                        .astype(np.float32))
    hi, lo = split_tf32(a)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - a.double()).abs()
    assert bool((err <= 2.0 ** -22 * a.double().abs()).all())
    # the product of two split operands: three terms close the gap to fp64
    b = torch.as_tensor(rng.normal(size=4096).astype(np.float32))
    bh, bl = split_tf32(b)
    three = (lo.double() * bh.double() + hi.double() * bl.double() + hi.double() * bh.double())
    exact = a.double() * b.double()
    assert bool(((three - exact).abs() <= 2.0 ** -20 * exact.abs()).all())
