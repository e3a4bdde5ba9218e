"""The CUDA kernels against their plain versions on the card, on ragged
small shapes (run on a machine with a card; every test here skips without
one).

Tolerances: kNN ids equal and distances exact on integer lattices; on random
data distances at rtol 1e-5 and ids equal except at near-ties, where the
float64 distance of each differing id must match within rtol 1e-5 (both sum
fp32 squares, in different orders); k-means labels equal on tie-free data, counts exact,
sums at rtol 1e-5 / atol 1e-4 (atomics add in a varying order), min distances
at 1e-5 of ‖x‖² + ‖c‖² (the terms they cancel); ELL SpMM at
rtol 1e-5 / atol 1e-6 (fused multiply-adds against a plain reduction), and
its raw kernel on any width at rtol 1e-5 plus 1e-6 of the row's Σ|vals·x|,
and so the ELL SpMV and the fused Chebyshev step, whose epilogue adds two
more roundings; the k-means assignment as the fused iteration's labels and
distances; LSH codes equal wherever every projection is at least 1e-4 from
0 in float64 (nearer, the two summation orders may take different signs),
tie-breaks at rtol 1e-5 (at d = 90 within the bound 2(d + 1)·2⁻²⁴·Σ|x_j·p_j|
of two summation orders, and codes compared where every projection clears
it), and codes and tie-breaks bitwise equal to the kernel the hashing
kernel replaced (the same fused multiply-adds in the same order); the
random stream's raw words, uniforms and Rademacher signs bitwise equal on
the card and the CPU, its normals and Gumbels within rtol 1e-6 / atol 2e-6
(``log``, ``cos`` and ``sin`` round differently); block Lanczos
eigenvalues within 1e-5 of a float64 dense solve; the scalable path's
labels ARI ≥ 0.99 between the card and the CPU from one seed.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import _random
from repro_torch.core import chebyshev as tch
from repro_torch.core import kmeans as tkm
from repro_torch.core.spectral import EigConfig, GraphConfig, KMeansConfig, SpectralPipeline
from repro_torch.data.pointcloud import dti_like_pointcloud
from repro_torch.kernels.ell_spmm.kernel import ell_spmm_cheb_cuda, ell_spmm_cuda
from repro_torch.kernels.ell_spmm.ops import ell_spmm, ell_spmm_cheb_step
from repro_torch.kernels.ell_spmm.ref import ell_spmm_cheb_ref, ell_spmm_ref
from repro_torch.kernels.ell_spmv.kernel import ell_spmv_cuda
from repro_torch.kernels.ell_spmv.ops import ell_spmv
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
from repro_torch.kernels.kmeans_iter.ops import kmeans_iter
from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref
from repro_torch.kernels.knn_topk.kernel import choose_splits, knn_topk_cuda
from repro_torch.kernels.knn_topk.ops import knn_topk
from repro_torch.kernels.knn_topk.ref import knn_topk_ref
from repro_torch.kernels.lsh_candidates.ops import hash_codes, make_planes
from repro_torch.kernels.lsh_candidates.ref import hash_codes_ref
from repro_torch.serve.metrics import adjusted_rand_index
from repro_torch.sparse import formats as tf
from repro_torch.sparse.ops import spmm_coo, spmv_coo

pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the Hopper kernels run only on the card")


def knn_ids_equal_up_to_near_ties(queries, x, got_idx, want_idx, want_d,
                                  rtol: float = 1e-5) -> int:
    """Assert that every neighbour slot whose id differs between two kNN
    results is a near-tie: the float64 distance from the query to the
    differing id matches the expected distance at that rank within ``rtol``
    (fp32 rounding may order such a pair either way).  Returns the count of
    differing slots."""
    q64, x64 = queries.double().cpu().numpy(), x.double().cpu().numpy()
    got_idx, want_idx = got_idx.cpu().numpy(), want_idx.cpu().numpy()
    want_d = want_d.cpu().numpy()
    rows, slots = np.nonzero(got_idx != want_idx)
    assert (got_idx[rows, slots] >= 0).all(), "a valid slot was left unfilled"
    d_got = ((q64[rows] - x64[got_idx[rows, slots]]) ** 2).sum(1)
    want = want_d[rows, slots].astype(np.float64)
    np.testing.assert_allclose(d_got, want, rtol=rtol, atol=1e-6)
    return int(rows.size)


# the kernel stages tiles of 1024 candidates at d <= 4: n below one tile,
# one more than a tile, and query sets whose start tile is in the middle, the
# last one, or clamped (ids past every candidate)
@pytest.mark.parametrize("side,n,k,lo,hi,off", [
    (5, None, 16, 0, None, 0), (7, None, 8, 0, None, 0), (6, None, 33, 0, None, 0),
    (4, None, 63, 0, None, 0), (11, 1025, 16, 0, None, 0), (11, 1025, 33, 0, None, 0),
    (11, 1025, 16, 600, 900, 600), (13, 2197, 16, 1024, 2197, 1024),
    (11, 1025, 16, 0, 300, 1025)])
def test_knn_lattice_exact(side, n, k, lo, hi, off):
    """On an integer lattice most neighbour shells tie, so the (distance, id)
    insertion rule alone decides the ids: equal to the plain version's, with
    exact distances.  ``off`` past the candidates: the queries are the
    lattice shifted by half a step (ties stay exact, no query is a
    candidate)."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = torch.as_tensor(g[:n].astype(np.float32), device="cuda")
    q = None
    if hi is not None:
        q = x[lo:hi] if off == lo else x[lo:hi] + 0.5
    d, i = knn_topk(x, k, queries=q, query_offset=off)
    rd, ri = knn_topk_ref(x, k, queries=q, query_offset=off)
    assert torch.equal(i, ri) and torch.equal(d, rd)


@pytest.mark.parametrize("n,d,k,off", [(1000, 3, 16, 0), (333, 7, 5, 0), (257, 20, 128, 0),
                                       (300, 90, 10, 40), (1025, 3, 16, 0), (1025, 3, 16, 900),
                                       (700, 3, 8, 0), (2049, 3, 16, 1024), (1000, 4, 16, 0),
                                       (500, 2, 5, 0), (129, 1, 3, 0), (1025, 3, 64, 0)])
def test_knn_random(n, d, k, off):
    """d = 3 (the coordinates the kernel computes alone), d = 1, 2, 4 (the
    zero padding computed too) and wider d read through L1; n below one
    1024-candidate tile and one more than a tile; offset query sets."""
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, d, generator=gen).cuda()
    q = x[off:off + 100] if off else None
    got = knn_topk(x, k, queries=q, query_offset=off)
    want = knn_topk_ref(x, k, queries=q, query_offset=off)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    knn_ids_equal_up_to_near_ties(x if q is None else q, x, got[1], want[1], want[0])


def _kmeans_blobs(n, k, d, seed):
    """Blobs around the centroids: every point's nearest centroid is clear by
    far more than fp32 rounding, so labels are defined.  At d = 1 random
    centroids crowd a line: they are spaced 1 apart instead (tie-free)."""
    gen = torch.Generator().manual_seed(seed)
    c = torch.randn(k, d, generator=gen)
    if d == 1 and k > 1:
        c = torch.randperm(k, generator=gen).float()[:, None]
    x = c[torch.randint(k, (n,), generator=gen)] + 0.05 * torch.randn(n, d, generator=gen)
    return x.cuda(), c.cuda()


def _check_kmeans_iter(x, c):
    gl, gd, gs, gn = kmeans_iter(x, c)
    wl, wd, ws, wn = kmeans_iter_ref(x, c)
    assert torch.equal(gl, wl)
    assert torch.equal(gn, wn)
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (129, 65, 17), (1000, 37, 90), (513, 500, 33),
                                   (1, 130, 500), (700, 65, 1), (300, 130, 257),
                                   (2000, 500, 500), (1000, 130, 92)])
def test_kmeans_iter(n, k, d):
    """The kmeans_assign grid: d not a multiple of 4 (4-byte copies and
    one-column REDs), k not a multiple of the 128-wide centroid tile, n = 1,
    and the embedding's width (16-byte copies and REDs)."""
    _check_kmeans_iter(*_kmeans_blobs(n, k, d, k))


def test_kmeans_iter_misaligned_rows():
    """x at an offset of one float: rows are not 16-byte aligned, so the
    kernel takes its 4-byte copies and one-column REDs (d = 92 would
    otherwise take 16-byte ones)."""
    x, c = _kmeans_blobs(1001, 37, 92, 3)
    xv = x.reshape(-1)[1:1 + 1000 * 92].view(1000, 92)
    assert xv.data_ptr() % 16 != 0
    _check_kmeans_iter(xv, c)


def test_kmeans_iter_runs_of_equal_labels():
    """Rows sorted by their blob, as an embedding in voxel order comes: long
    runs of one label within and across the kernel's 128-row blocks, each
    added as one run."""
    x, c = _kmeans_blobs(5000, 40, 64, 11)
    order = torch.argmin(torch.cdist(x, c), dim=1).argsort(stable=True)
    _check_kmeans_iter(x[order].contiguous(), c)


@pytest.mark.parametrize("n,b,width", [(100, 4, None), (257, 3, 8), (1000, 8, 16),
                                       (1000, 1, None), (513, 5, 24), (777, 9, 12),
                                       (300, 508, 40), (3001, 4, 8), (3001, 4, 12),
                                       (3001, 8, 24), (3001, 4, 40), (3001, 8, 40)])
def test_ell_spmm(n, b, width):
    """Through the wrapper: b = 1, 3, 5, 9 padded to a multiple of 4, b = 4
    and 8 on the streamed slot pass, b = 12 and 508 on the row-band ×
    column-slab pass; widths 8/12/24/40 at a row count that leaves the streamed pass a
    ragged last block."""
    rng = np.random.default_rng(n + b)
    r, c = rng.integers(0, n, 12 * n), rng.integers(0, n, 12 * n)
    v = rng.random(12 * n).astype(np.float32)
    m = tf.csr_to_blockell(tf.coo_to_csr(tf.coo_from_edges(r, c, v, (n, n), device="cuda")),
                           width=width)
    x = torch.randn(n, b, device="cuda")
    got = ell_spmm(m, x)
    nb, br, w = m.cols.shape
    want = ell_spmm_ref(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w))[:n]
    want = want + spmm_coo(m.tail, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows,w,b", [(1, 8, 4), (1001, 8, 4), (1003, 12, 8), (4999, 24, 4),
                                      (3001, 40, 8), (777, 5, 4), (513, 13, 8), (100, 600, 4),
                                      (301, 40, 16), (9, 6145, 4), (1003, 12, 12),
                                      (777, 5, 16), (1001, 8, 508)])
def test_ell_spmm_kernel_any_width(rows, w, b):
    """The raw kernel on [rows, W] slots.  At b <= 8 the streamed slot pass
    takes a run of whole rows (a multiple of 4, about 2048 slots), so these
    row counts leave a ragged last block; W = 5, 13 (not a multiple of 4)
    keep every slot's product apart and leave runs whose length is not a
    multiple of the 4-slot chunks it streams.  At b = 12, 16 and 508, and
    at W = 6145, where not even four rows fit the streamed pass's shared
    memory, the row-band × column-slab pass takes them: it stages a band's
    slots with 16-byte copies (W = 8, 12), 4-byte ones (W = 5) or, where
    they exceed its shared memory (W = 40 at b = 16: 256-row bands; W =
    6145), reads them from device memory.  Tolerance as for ell_spmv:
    rtol 1e-5, plus 1e-6 of the row's Σ|vals·x| per column."""
    rng = np.random.default_rng(rows + w + b)
    n = max(rows, 10)
    cols = torch.as_tensor(rng.integers(0, n, (rows, w)), dtype=torch.int32, device="cuda")
    vals = torch.as_tensor(rng.random((rows, w)), dtype=torch.float32, device="cuda")
    x = torch.randn(n, b, device="cuda")
    got, want = ell_spmm_cuda(x, cols, vals), ell_spmm_ref(x, cols, vals)
    mag = (vals[:, :, None] * x[cols.long()]).abs().sum(1)
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6 * mag + 1e-6).all())


def test_ell_spmm_kernel_refuses_what_it_cannot_stream():
    """The streamed pass reads 16-byte chunks of slots and float4 rows of x:
    a misaligned view of the slots and b not a multiple of 4 raise."""
    x = torch.randn(10, 4, device="cuda")
    cols = torch.zeros(9 * 8 + 1, dtype=torch.int32, device="cuda")[1:].view(9, 8)
    vals = torch.zeros(9, 8, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        ell_spmm_cuda(x, cols, vals)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ell_spmm_cuda(x, cols.clone(), torch.zeros(73, device="cuda")[1:].view(9, 8))
    with pytest.raises(ValueError, match="multiple of 4"):
        ell_spmm_cuda(torch.randn(10, 3, device="cuda"), cols.clone(), vals)


def _random_blockell(n, width):
    rng = np.random.default_rng(n)
    r, c = rng.integers(0, n, 12 * n), rng.integers(0, n, 12 * n)
    v = rng.random(12 * n).astype(np.float32)
    return tf.csr_to_blockell(tf.coo_to_csr(tf.coo_from_edges(r, c, v, (n, n), device="cuda")),
                              width=width)


@pytest.mark.parametrize("n,width", [(100, None), (257, 8), (1000, 16), (3001, 40), (3001, 8),
                                     (3001, 12), (3001, 24), (1000, 40)])
def test_ell_spmv(n, width):
    m = _random_blockell(n, width)
    x = torch.randn(n, device="cuda")
    got = ell_spmv(m, x)
    nb, br, w = m.cols.shape
    want = ell_spmv_ref(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w))[:n]
    torch.testing.assert_close(got, want + spmv_coo(m.tail, x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows,w", [(1, 8), (1001, 8), (1003, 12), (4999, 24), (3001, 40),
                                    (777, 5), (513, 13), (100, 600)])
def test_ell_spmv_kernel_any_width(rows, w):
    """The raw kernel on [rows, W] slots: a block takes a run of whole rows
    (a multiple of 4, about 2048 slots), so these row counts leave a ragged
    last block, and W = 5, 13 leave runs whose length is not a multiple of
    the 4-slot chunks it streams.  Tolerance: rtol 1e-5, plus 1e-6 of the
    row's Σ|vals·x| — the two sum W rounded products in different orders,
    and at W = 600 a row that cancels to near 0 carries that error."""
    rng = np.random.default_rng(rows + w)
    n = max(rows, 10)
    cols = torch.as_tensor(rng.integers(0, n, (rows, w)), dtype=torch.int32, device="cuda")
    vals = torch.as_tensor(rng.random((rows, w)), dtype=torch.float32, device="cuda")
    x = torch.randn(n, device="cuda")
    got, want = ell_spmv_cuda(x, cols, vals), ell_spmv_ref(x, cols, vals)
    mag = (vals * x[cols.long()]).abs().sum(1)
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6 * mag + 1e-6).all())


def test_ell_spmv_kernel_refuses_what_it_cannot_stream():
    """The kernel streams 16-byte chunks of slots and keeps four rows'
    products in shared memory: a misaligned view or W > MAX_W raises."""
    from repro_torch.kernels.ell_spmv.kernel import MAX_W

    x = torch.randn(10, device="cuda")
    cols = torch.zeros(9 * 8 + 1, dtype=torch.int32, device="cuda")[1:].view(9, 8)
    vals = torch.zeros(9, 8, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        ell_spmv_cuda(x, cols, vals)
    wide = torch.zeros(1, MAX_W + 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="W <="):
        ell_spmv_cuda(x, wide, wide.float())


def _lattice_blockell(side, width, permute):
    """The graph of a raster-ordered lattice (each voxel joined to the
    voxels within √2), whose rows name neighbours in a few narrow windows
    of ids as the DTI graph's do; with ``permute``, the same graph with its
    ids shuffled."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    d2 = ((g[:, None] - g[None]) ** 2).sum(-1)
    r, c = np.nonzero((d2 > 0) & (d2 <= 2))
    n = g.shape[0]
    if permute:
        perm = np.random.default_rng(side).permutation(n)
        r, c = perm[r], perm[c]
        order = np.lexsort((c, r))
        r, c = r[order], c[order]
    v = np.random.default_rng(side + 1).random(r.size).astype(np.float32)
    return tf.csr_to_blockell(tf.coo_to_csr(tf.coo_from_edges(r, c, v, (n, n), device="cuda")),
                              width=width)


@pytest.mark.parametrize("graph,n,b,width", [
    ("random", 100, 4, None), ("random", 257, 3, 8), ("random", 1000, 12, 16),
    ("random", 513, 508, 24), ("lattice", 1000, 508, None), ("permuted", 1000, 508, None),
    ("lattice", 1331, 516, None), ("lattice", 1331, 4, None), ("permuted", 1331, 12, None),
    ("lattice", 1000, 508, 8), ("random", 300, 508, 600), ("random", 3001, 16, 40),
    ("random", 12000, 508, None)])
def test_ell_spmm_cheb_step(graph, n, b, width):
    """Through the wrapper, on the band × slab pass: random graphs and a
    raster-ordered lattice's (n not a multiple of the band), its
    row-permuted copy, b = 4 (one lane a row, a band of 1024 rows), 12, 508 and 516
    (a last slab of one column group); width 8 on the lattice leaves a COO
    tail; width 600 is too wide to stage a band's slots in shared memory and
    takes the pass that reads them from device memory; 12,000 nodes make
    many bands of scattered ids."""
    m = (_random_blockell(n, width) if graph == "random"
         else _lattice_blockell(round(n ** (1 / 3)), width, graph == "permuted"))
    assert m.shape[0] == n
    if width == 8 and graph == "lattice":
        assert m.tail.nnz > 0
    x, prev = torch.randn(n, b, device="cuda"), torch.randn(n, b, device="cuda")
    ca = torch.tensor(0.37, device="cuda")
    cb = torch.tensor(-1.25, device="cuda")
    got = ell_spmm_cheb_step(m, x, prev, ca, cb)
    nb, br, w = m.cols.shape
    want = ell_spmm_cheb_ref(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w), prev,
                             ca, cb) + ca * spmm_coo(m.tail, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,w,b", [(1, 8, 4), (1001, 8, 508), (777, 5, 12), (513, 13, 16),
                                      (300, 40, 516), (5000, 40, 16), (100, 600, 508),
                                      (9, 6145, 4)])
def test_ell_spmm_cheb_kernel_any_width(rows, w, b):
    """The raw fused step on [rows, W] slots: W = 5, 13 (not a multiple of 4)
    stage the band's slots with 4-byte copies; at b = 16 a row takes 4
    lanes, so a band grows to 256 rows: 5000 rows of 40 random columns make
    20 bands, the last ragged, whose 80 KB of slots exceed the staging
    limit and are read from device memory, as at W = 600 and 6145.  Tolerance: rtol 1e-5, plus 1e-6
    of Σ|vals·x| (as for the SpMM) and of |cb·x| + |prev| (the epilogue's
    two more roundings)."""
    rng = np.random.default_rng(rows + w + b)
    cols = torch.as_tensor(rng.integers(0, rows, (rows, w)), dtype=torch.int32, device="cuda")
    vals = torch.as_tensor(rng.random((rows, w)), dtype=torch.float32, device="cuda")
    x, prev = torch.randn(rows, b, device="cuda"), torch.randn(rows, b, device="cuda")
    coef = torch.tensor([0.37, -1.25], device="cuda")
    got = ell_spmm_cheb_cuda(x, cols, vals, prev, coef)
    want = ell_spmm_cheb_ref(x, cols, vals, prev, coef[0], coef[1])
    mag = 0.37 * (vals[:, :, None] * x[cols.long()]).abs().sum(1) + 1.25 * x.abs() + prev.abs()
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6 * mag + 1e-6).all())


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (129, 65, 17), (1000, 37, 90), (513, 500, 33),
                                   (1, 130, 500), (700, 65, 1), (300, 130, 257),
                                   (2000, 500, 500), (1000, 130, 92)])
def test_kmeans_assign(n, k, d):
    gen = torch.Generator().manual_seed(k + 1)
    c = torch.randn(k, d, generator=gen)
    if d == 1 and k > 1:  # random centroids crowd a line: space them 1 apart (tie-free)
        c = torch.randperm(k, generator=gen).float()[:, None]
    x = c[torch.randint(k, (n,), generator=gen)] + 0.05 * torch.randn(n, d, generator=gen)
    x, c = x.cuda(), c.cuda()
    gl, gd = kmeans_assign(x, c)
    wl, wd = kmeans_assign_ref(x, c)
    assert torch.equal(gl, wl)
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)


def test_kmeans_assign_misaligned_rows():
    """x at an offset of one float: rows are not 16-byte aligned, so the
    kernel takes its 4-byte copies (d = 92 would otherwise take 16-byte)."""
    gen = torch.Generator().manual_seed(3)
    c = torch.randn(37, 92, generator=gen)
    x = c[torch.randint(37, (1001,), generator=gen)] + 0.05 * torch.randn(1001, 92, generator=gen)
    x, c = x.cuda(), c.cuda()
    xv = x.reshape(-1)[1:1 + 1000 * 92].view(1000, 92)
    assert xv.data_ptr() % 16 != 0
    gl, gd = kmeans_assign(xv, c)
    wl, wd = kmeans_assign_ref(xv, c)
    assert torch.equal(gl, wl)
    scale = float((xv * xv).sum(1).max() + (c * c).sum(1).max())
    torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("which", ["assign", "iter"])
@pytest.mark.parametrize("n,k,d", [(700, 130, 16), (2000, 300, 90), (1000, 500, 500)])
def test_kmeans_assign_ties_across_tiles(n, k, d, which):
    """Every centroid twice, in different tiles of the kernels' sweep (shared
    by the assignment and the fused iteration): each point ties exactly
    between j and j + k, and the lower index must win whichever tile a block
    sweeps first."""
    gen = torch.Generator().manual_seed(n)
    c = torch.randn(k, d, generator=gen)
    x = c[torch.randint(k, (n,), generator=gen)] + 0.05 * torch.randn(n, d, generator=gen)
    x, c2 = x.cuda(), torch.cat([c, c]).cuda()
    if which == "assign":
        gl, _ = kmeans_assign(x, c2)
        wl, _ = kmeans_assign_ref(x, c2)
    else:
        gl, _, gs, gn = kmeans_iter(x, c2)
        wl, _, ws, wn = kmeans_iter_ref(x, c2)
        assert torch.equal(gn, wn)
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-4)
    assert int(gl.max()) < k
    assert torch.equal(gl, wl)


@pytest.mark.parametrize("n,d,t,b", [(1000, 3, 16, 16), (300, 8, 4, 24), (77, 20, 3, 1)])
def test_hash_codes(n, d, t, b):
    gen = torch.Generator().manual_seed(n)
    x = (torch.rand(n, d, generator=gen) * 50).cuda()
    planes = torch.randn(t, d, b + 1, generator=gen).cuda()
    gc, gt = hash_codes(x, planes)
    wc, wt = hash_codes_ref(x, planes)
    proj = torch.einsum("nd,tdb->tnb", x.double(), planes.double())[..., :-1]
    clear = (proj.abs() >= 1e-4).all(-1)  # [T, n]
    assert clear.float().mean() > 0.9
    assert torch.equal(gc[clear], wc[clear])
    torch.testing.assert_close(gt, wt, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 3, 8, 9, 90])
@pytest.mark.parametrize("t", [1, 16])
@pytest.mark.parametrize("b", [1, 16, 24])
def test_hash_codes_grid(d, t, b):
    """Unrolled widths (1, 3, 8, 9: d ≤ 16 unrolls), the runtime-d form (90; at d = 90 and
    24 bits the planes are staged in chunks of tables), n ragged against the
    128-point blocks."""
    n = 1000 + 7 * d + t
    gen = torch.Generator().manual_seed(100 * d + 10 * t + b)
    x = (torch.rand(n, d, generator=gen) * 50 - 10).cuda()
    planes = torch.randn(t, d, b + 1, generator=gen).cuda()
    gc, gt = hash_codes(x, planes)
    wc, wt = hash_codes_ref(x, planes)
    proj = torch.einsum("nd,tdb->tnb", x.double(), planes.double())
    if d <= 20:
        clear = (proj.abs() >= 1e-4)[..., :-1].all(-1)
        torch.testing.assert_close(gt, wt, rtol=1e-5, atol=1e-5)
    else:  # two fp32 sums of d terms in different orders differ by at most
        # 2(d + 1)·2⁻²⁴·Σ|terms|: codes compared where every projection
        # clears that (and 1e-4), tie-breaks within it
        slack = 2 * (d + 1) * 2.0 ** -24 * torch.einsum("nd,tdb->tnb", x.double().abs(),
                                                         planes.double().abs())
        clear = (proj.abs() >= torch.clamp(slack, min=1e-4))[..., :-1].all(-1)
        assert bool(((gt - wt).double().abs() <= slack[..., -1]).all())
    assert clear.float().mean() > 0.9
    assert torch.equal(gc[clear], wc[clear])


@pytest.mark.parametrize("n,d", [(256, 12), (256, 16), (37, 16), (1000, 16), (1000, 17)])
def test_hash_codes_query_batch_widths(n, d):
    """Query batches at the serving path's widths (256 rows and fewer: a
    table and a warp a block) and on either side of the unrolled d ≤ 16,
    16 tables of 16 bits: tie-breaks within the bound of two fp32
    summation orders, 2(d + 1)·2⁻²⁴·Σ|x_j·p_j| (at d ≥ 16 a tie near 0 can
    differ from the plain version by more than rtol 1e-5), codes equal
    wherever every projection clears that bound and 1e-4."""
    gen = torch.Generator().manual_seed(10 * n + d)
    x = (torch.randn(n, d, generator=gen) * 8).cuda()
    planes = make_planes(d, 16, 16, 0).cuda()
    gc, gt = hash_codes(x, planes)
    wc, wt = hash_codes_ref(x, planes)
    proj = torch.einsum("nd,tdb->tnb", x.double(), planes.double())
    slack = 2 * (d + 1) * 2.0 ** -24 * torch.einsum("nd,tdb->tnb", x.double().abs(),
                                                     planes.double().abs())
    assert bool(((gt - wt).double().abs() <= slack[..., -1]).all())
    clear = (proj.abs() >= torch.clamp(slack, min=1e-4))[..., :-1].all(-1)
    assert clear.float().mean() > 0.9
    assert torch.equal(gc[clear], wc[clear])


def _replaced_hash_codes():
    path = Path(__file__).resolve().parents[1] / "tools" / "hash_codes_variants.py"
    spec = importlib.util.spec_from_file_location("hash_codes_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parent_hash_codes


def test_hash_codes_bitwise_equal_to_the_replaced_kernel():
    """The scalable path's shape (the 142,541-voxel lattice, d = 3, 16 tables
    of 16 bits), a random one, and query batches of the serving path's
    width (a block a table, fewer threads): codes and tie-breaks bit for
    bit."""
    parent = _replaced_hash_codes()
    pos, _, _, _ = dti_like_pointcloud(142541, 1, 1, neighbors="none", seed=0)
    gen = torch.Generator().manual_seed(3)
    cases = [(pos, make_planes(3, 16, 16, 0).cuda()),
             ((torch.rand(3001, 9, generator=gen) - 0.5).cuda(),
              torch.randn(5, 9, 23, generator=gen).cuda()),
             ((torch.randn(256, 16, generator=gen) * 8).cuda(), make_planes(16, 16, 16, 0).cuda()),
             ((torch.randn(37, 12, generator=gen) * 8).cuda(), make_planes(12, 3, 16, 0).cuda())]
    for x, planes in cases:
        gc, gt = hash_codes(x, planes)
        wc, wt = parent(x, planes)
        assert torch.equal(gc, wc)
        assert torch.equal(gt.view(torch.int32), wt.view(torch.int32))


def test_random_stream_card_equals_cpu():
    """Raw Philox words on 2²⁰ random counters under 16 random keys (a
    quarter of the words within 3 of 2³² − 1), the filter's draws and a
    k-means++ Gumbel block: the card's bits are the CPU's."""
    rng = np.random.default_rng(21)
    for _ in range(16):
        key = tuple(int(v) for v in rng.integers(0, 1 << 32, 2))
        ctr = rng.integers(0, 1 << 32, (4, 1 << 16), dtype=np.int64)
        near = rng.random(ctr.shape) < 0.25
        ctr[near] = 0xFFFFFFFF - rng.integers(0, 4, int(near.sum()))
        c = torch.from_numpy(ctr)
        assert torch.equal(_random.philox4x32(c.cuda(), key).cpu(), _random.philox4x32(c, key))
    card = tch.draw_signals(torch.Generator().manual_seed(7), 20011, 8, 508, "cuda")
    cpu = tch.draw_signals(torch.Generator().manual_seed(7), 20011, 8, 508, "cpu")
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-6, atol=2e-6)
    assert torch.equal(card[1].cpu(), cpu[1]) and torch.equal(card[2].cpu(), cpu[2])
    key = (31337, 4242)
    assert torch.equal(_random.uniform(key, 1, (64, 20011), "cuda").cpu(),
                       _random.uniform(key, 1, (64, 20011), "cpu"))
    torch.testing.assert_close(_random.gumbel(key, 1, (64, 20011), "cuda").cpu(),
                               _random.gumbel(key, 1, (64, 20011), "cpu"), rtol=1e-6, atol=2e-6)
    x = torch.randn(3000, 5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(tkm.random_init(x.cuda(), 40, torch.Generator().manual_seed(2)).cpu(),
                       tkm.random_init(x, 40, torch.Generator().manual_seed(2)))


def test_scalable_path_card_matches_cpu():
    """LSH graph → Chebyshev embedding → two-pass k-means at n = 2000 on the
    card and on the CPU from one seed: the same partition."""
    pos, prof, _, _ = dti_like_pointcloud(2000, 90, 4, eps=1.8, seed=0, neighbors="none")
    pipe = SpectralPipeline(
        n_clusters=8,
        graph=GraphConfig(knn_k=16, measure="cross_correlation", method="lsh"),
        eig=EigConfig(tol=1e-4, solver="chebyshev", representation="blockell"),
        kmeans=KMeansConfig(iter="two_pass"))
    card = pipe.run(prof, torch.Generator().manual_seed(0), points=pos)
    cpu = pipe.run(prof.cpu(), torch.Generator().manual_seed(0), points=pos.cpu(), device="cpu")
    assert adjusted_rand_index(card.labels, cpu.labels) >= 0.99
    torch.testing.assert_close(card.eigenvalues.cpu(), cpu.eigenvalues, rtol=0, atol=1e-3)


def test_block_lanczos_on_card_matches_float64_reference():
    """The DTI graph at n = 4000: the card's block Lanczos eigenvalues
    against a dense float64 solve of the same operator.  Both runs converge
    to tol 1e-4, so Ritz values are within ~3e-6; 1e-5 holds them there.
    (Regression: with the projected eigenproblem in float32 on the card,
    every eigenvalue sat ~5.5e-5 low.)"""
    pos, prof, _, _ = dti_like_pointcloud(4000, 90, 6, eps=1.8, seed=0, neighbors="none")
    pipe = SpectralPipeline(
        n_clusters=12, graph=GraphConfig(knn_k=16, measure="cross_correlation"),
        eig=EigConfig(tol=1e-4, block_size=4, representation="blockell"))
    g = pipe.build_graph(prof, points=pos)
    emb = pipe.embed(g, torch.Generator().manual_seed(0))
    a = g.adj
    dense = torch.zeros(a.shape, dtype=torch.float64)
    dense.index_put_((a.row.cpu(), a.col.cpu()), a.val.cpu().double(), accumulate=True)
    truth = (1 - torch.linalg.eigvalsh(dense).flip(0)[:12]).float()
    torch.testing.assert_close(emb.eigenvalues.cpu(), truth, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,hub", [(3001, 0), (1000, 400)])
def test_device_builders_card_equal_cpu(n, hub):
    """``coo_from_edges`` (sorted, duplicates summed), ``coo_to_csr`` and
    ``csr_to_blockell`` on the card: bit for bit the CPU's build (the
    summed duplicates are exact in float64, whatever order the card's
    atomics add them in)."""
    rng = np.random.default_rng(n)
    r, c = rng.integers(0, n, 12 * n), rng.integers(0, n // 3, 12 * n)
    r[:hub] = 7  # a row far past the width: the tail
    v = rng.random(12 * n).astype(np.float32)
    built = {}
    for dev in ("cuda", "cpu"):
        coo = tf.coo_from_edges(*(torch.as_tensor(a, device=dev) for a in (r, c, v)), (n, n),
                                sum_duplicates=True)
        built[dev] = coo, tf.csr_to_blockell(tf.coo_to_csr(coo))
    (gc, ge), (wc, we) = built["cuda"], built["cpu"]
    for a, b in ((gc.row, wc.row), (gc.col, wc.col), (gc.val, wc.val), (ge.cols, we.cols),
                 (ge.vals, we.vals), (ge.tail.row, we.tail.row), (ge.tail.col, we.tail.col),
                 (ge.tail.val, we.tail.val)):
        assert torch.equal(a.cpu(), b)
    assert ge.width == we.width and (hub == 0 or ge.tail.nnz > 1)


def test_check_points_on_card():
    from repro_torch.core import health as th
    from repro_torch.core.health import PipelineError

    x = torch.zeros(40, 3, device="cuda")
    x[:20, 0] = torch.arange(1, 21, device="cuda", dtype=torch.float32)
    x[20:, 0] = -0.0  # 21 distinct rows: -0.0 counts as 0.0
    th.check_points(x, 21)
    with pytest.raises(PipelineError, match=r"\(21 of 40 rows are unique\)"):
        th.check_points(x, 22)
    x[3, 1] = float("nan")
    with pytest.raises(PipelineError, match="1 non-finite"):
        th.check_points(x, 2)


def test_reductions_card_match_cpu():
    """The sparsifier (its Gumbel keys drawn on each device: equal to a few
    ulps; the card's degrees summed by atomics in another order) keeps at
    least 99 % of the CPU's coordinates; the coarsening's matching and
    prolongation are equal, coarse weights at rtol 1e-6."""
    from repro_torch.core import reduce as tred
    from repro_torch.core.spectral import _raw_weights

    pos, prof, _, _ = dti_like_pointcloud(3000, 90, 4, eps=1.8, seed=0, neighbors="none")
    pipe = SpectralPipeline(n_clusters=8, graph=GraphConfig(knn_k=16, measure="cross_correlation"))
    w = _raw_weights(pipe.build_graph(prof, points=pos))
    wc = w.to("cpu")
    s_card = tred.sparsify_coo(w, tred.SparsifyConfig(target_nnz_ratio=0.4))
    s_cpu = tred.sparsify_coo(wc, tred.SparsifyConfig(target_nnz_ratio=0.4))
    key = lambda m: set((m.row.cpu() * m.shape[1] + m.col.cpu()).tolist())  # noqa: E731
    assert s_card.nnz == s_cpu.nnz
    assert len(key(s_card) & key(s_cpu)) >= 0.99 * len(key(s_cpu))  # parallel edges: a set
    (gc, gp), (cc, cp) = (tred.coarsen_coo(m, tred.CoarsenConfig(levels=2)) for m in (w, wc))
    assert torch.equal(gp.cpu(), cp) and torch.equal(gc.row.cpu(), cc.row)
    torch.testing.assert_close(gc.val.cpu(), cc.val, rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [3, 16])
def test_knn_query_rows_independent_of_row_count(d):
    """The out-of-sample form (queries past the pool, ``query_offset = n``):
    a query's neighbours are bitwise the same whether it rides with 0, 36,
    127, 128 or 255 other rows (one block with spare threads, or two)."""
    gen = torch.Generator().manual_seed(d)
    x = torch.randn(5000, d, generator=gen).cuda()
    q = torch.randn(256, d, generator=gen).cuda()
    fd, fi = knn_topk(x, 10, queries=q, query_offset=5000)
    rd, ri = knn_topk_ref(x, 10, queries=q, query_offset=5000)
    torch.testing.assert_close(fd, rd, rtol=1e-5, atol=1e-6)
    knn_ids_equal_up_to_near_ties(q, x, fi, ri, rd)
    for r in (1, 37, 128, 129):
        d_r, i_r = knn_topk(x, 10, queries=q[:r].contiguous(), query_offset=5000)
        assert torch.equal(d_r, fd[:r]) and torch.equal(i_r, fi[:r])


@pytest.mark.parametrize("nq,nc,d,k,off", [
    (256, 20000, 16, 10, 20000), (37, 5000, 3, 16, 0), (129, 3001, 9, 33, 3001),
    (256, 4000, 12, 128, 100), (1, 3000, 16, 10, 3000), (300, 900, 5, 7, 0)])
def test_knn_splits_bitwise(nq, nc, d, k, off):
    """The candidate split: S = 1, 2, 7, the binding's choice and more
    slices than tiles give the same bits (distances and ids), a NaN query
    included; the rows equal the plain version's up to near-ties.  Queries
    past the candidates (``off = nc``) are drawn apart from them."""
    gen = torch.Generator().manual_seed(nq + nc + d)
    x = torch.randn(nc, d, generator=gen).cuda()
    q = (torch.randn(nq, d, generator=gen).cuda() if off >= nc
         else x[off:off + nq].clone())
    q[nq // 2, 0] = float("nan")
    dp = -(-d // 4) * 4
    xp = torch.nn.functional.pad(x, (0, dp - d)).contiguous()
    qp = torch.nn.functional.pad(q, (0, dp - d)).contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-nc // max(1, min(1024, 12288 // dp)))
    base = knn_topk_cuda(qp, xp, k, query_offset=off, d=d, splits=1)
    for s in {2, 7, tiles + 3, choose_splits(nq, nc, dp, sms)}:
        got = knn_topk_cuda(qp, xp, k, query_offset=off, d=d, splits=s)
        assert torch.equal(got[0].view(torch.int32), base[0].view(torch.int32))
        assert torch.equal(got[1], base[1])
    rd, ri = knn_topk_ref(x, k, queries=q, query_offset=off)
    keep = torch.arange(nq, device="cuda") != nq // 2
    assert torch.equal(base[1][nq // 2], ri[nq // 2])
    torch.testing.assert_close(base[0][keep], rd[keep], rtol=1e-5, atol=1e-6)
    knn_ids_equal_up_to_near_ties(q[keep], x, base[1][keep], ri[keep], rd[keep])


@pytest.mark.parametrize("n,d,k,off", [(1000, 3, 16, 0), (1000, 3, 16, 1000), (300, 16, 10, 0),
                                       (300, 16, 10, 300), (8, 2, 10, 0), (8, 16, 10, 8)])
def test_knn_nan_rows_match_plain(n, d, k, off):
    """A NaN coordinate in a candidate and in a query: the kernel's rows are
    bitwise the plain version's — a NaN distance ranks after +inf (the
    query itself) and keeps its id, as a stable sort puts it.  Integer
    coordinates make every distance exact, so ties break by id alone; n = 8
    with k = 10 leaves slots empty after the NaN candidate."""
    gen = torch.Generator().manual_seed(n + d)
    x = torch.randint(-3, 4, (n, d), generator=gen).float()
    x[n // 2, d - 1] = float("nan")
    q = None
    if off:
        q = torch.randint(-3, 4, (40, d), generator=gen).float()
        q[7, 0] = float("nan")
        q = q.cuda()
    x = x.cuda()
    got = knn_topk(x, k, queries=q, query_offset=off)
    want = knn_topk_ref(x, k, queries=q, query_offset=off)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got[0]).any())


def test_oos_nan_query_card_matches_cpu():
    """A NaN query served from an index on the card: its row is NaN (the
    serving gate's failure) and its neighbours are the CPU's; the other rows
    are those of the clean batch."""
    from repro_torch.serve import OOSConfig, build_index, serve_fn

    rng = np.random.default_rng(4)
    centers = np.eye(4, 8, dtype=np.float32) * 3.0
    pool = (centers[rng.integers(4, size=800)] + 0.3 * rng.normal(size=(800, 8))).astype(
        np.float32)
    queries = (centers[rng.integers(4, size=40)] + 0.3 * rng.normal(size=(40, 8))).astype(
        np.float32)
    res = SpectralPipeline(n_clusters=4, eig=EigConfig(block_size=4)).run(
        pool, torch.Generator().manual_seed(0), device="cpu")
    card, cpu = (build_index(pool, res, config=OOSConfig(), device=dev) for dev in ("cuda", "cpu"))
    bad = queries.copy()
    bad[3, 5] = np.nan
    got, want, clean = serve_fn(card, bad), serve_fn(cpu, bad), serve_fn(card, queries)
    assert bool(torch.isnan(got.embedding[3]).all()) and bool(torch.isnan(got.weight_sum[3]))
    assert torch.equal(got.neighbors.cpu(), want.neighbors)
    keep = [i for i in range(40) if i != 3]
    for f in ("labels", "dist2", "embedding", "weight_sum", "neighbors"):
        assert torch.equal(getattr(got, f)[keep], getattr(clean, f)[keep])


@pytest.mark.parametrize("method", ["exact", "lsh"])
def test_oos_serving_card_matches_cpu(method):
    """One CPU training result served from an index on the card and from one
    on the CPU: labels equal; exact neighbours equal and embedding rows
    within 1e-5; LSH neighbours equal in ≥ 99 % of slots (the card's hash
    sums in another order, so a projection within rounding of 0 may take the
    other sign); the tables sorted and the candidates routed bitwise alike
    from the same hash output; outputs on the card."""
    from repro_torch.kernels.lsh_candidates.ops import routed_candidates, sorted_tables
    from repro_torch.serve import OOSConfig, build_index, serve_fn

    rng = np.random.default_rng(3)
    centers = np.eye(4, 8, dtype=np.float32) * 3.0
    pool = (centers[rng.integers(4, size=2000)] + 0.3 * rng.normal(size=(2000, 8))).astype(
        np.float32)
    queries = (centers[rng.integers(4, size=300)] + 0.3 * rng.normal(size=(300, 8))).astype(
        np.float32)
    res = SpectralPipeline(n_clusters=4, eig=EigConfig(block_size=4)).run(
        pool, torch.Generator().manual_seed(0), device="cpu")
    cfg = OOSConfig(method=method)
    card, cpu = (build_index(pool, res, config=cfg, device=dev) for dev in ("cuda", "cpu"))
    got, want = serve_fn(card, queries), serve_fn(cpu, queries)
    assert got.labels.is_cuda and got.embedding.is_cuda
    assert torch.equal(got.labels.cpu(), want.labels)
    if method == "exact":
        assert torch.equal(got.neighbors.cpu(), want.neighbors)
        torch.testing.assert_close(got.embedding.cpu(), want.embedding, rtol=1e-5, atol=1e-5)
        return
    assert float((got.neighbors.cpu() == want.neighbors).float().mean()) >= 0.99
    planes = make_planes(8, 16, 16, 0)
    pc, pt = hash_codes(card.points, planes)
    tables = sorted_tables(pc, pt)
    for a, b in zip(tables, sorted_tables(pc.cpu(), pt.cpu())):
        assert torch.equal(a.cpu(), b)
    qc, qt = hash_codes(torch.as_tensor(queries).cuda(), planes)
    tables_cpu = type(tables)(*(t.cpu() for t in tables))
    assert torch.equal(routed_candidates(tables, qc, qt, win=60).cpu(),
                       routed_candidates(tables_cpu, qc.cpu(), qt.cpu(), win=60))


# ---------------------------------------------------------------------------
# the GNN family: SMOKE configs on the card against the CPU
# ---------------------------------------------------------------------------

def _gnn_graph(geometric, task, n=40, e=120, seed=0):
    """tests/test_arch_smoke.py's tiny graph (node_class), or 4 molecules of
    10 nodes and 30 edges (graph_reg), as a port GraphBatch on the CPU."""
    from repro_torch.models.gnn.graph import GraphBatch

    rng = np.random.default_rng(seed)
    if task == "graph_reg":
        g = 4
        gid = torch.from_numpy(np.repeat(np.arange(g), n // g))
        base = np.repeat(np.arange(g) * (n // g), e // g)
        src, dst = base + rng.integers(0, n // g, e), base + rng.integers(0, n // g, e)
        labels, lmask = torch.from_numpy(rng.normal(size=g).astype(np.float32)), torch.ones(g)
    else:
        g, gid = 1, None
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
        labels, lmask = torch.from_numpy(rng.integers(0, 4, n)), torch.ones(n)
    return GraphBatch(
        node_feat=torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32)),
        edge_src=torch.from_numpy(src), edge_dst=torch.from_numpy(dst),
        edge_mask=torch.ones(e), labels=labels, label_mask=lmask,
        positions=torch.from_numpy((rng.normal(size=(n, 3)) * 2).astype(np.float32))
        if geometric else None,
        species=torch.from_numpy(rng.integers(0, 5, n)) if geometric else None,
        graph_id=gid, n_graphs=g)


@pytest.mark.parametrize("name", ["gcn-cora", "pna", "nequip", "equiformer-v2"])
@pytest.mark.parametrize("task", ["node_class", "graph_reg"])
def test_gnn_smoke_card_matches_cpu(name, task):
    """3 ``make_train_step`` steps of each GNN's SMOKE config (fp32, TF32
    off) from one set of weights on the card and on the CPU: losses within
    1e-5 relative, parameters within 1e-5 of max|p| over the tree (the
    card's ``index_add`` sums with atomics, in no fixed order)."""
    import dataclasses

    from repro_torch import _tree, convert
    from repro_torch.configs import ARCHS
    from repro_torch.configs.cells import OPT_CFG, _gnn_model
    from repro_torch.train.state import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = ARCHS[name]
    mod = _gnn_model(arch)
    geometric = name in ("nequip", "equiformer-v2")
    cfg = dataclasses.replace(arch.smoke_config, n_classes=4, task=task,
                              **({} if geometric else {"d_in": 32}))
    params = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _gnn_graph(geometric, task)
    step = make_train_step(lambda p, b: mod.loss(p, b, cfg), OPT_CFG)
    cpu = init_state(params)
    card = init_state(convert.gnn_params(params, device="cuda"))
    card_batch = convert.graph_batch(batch, device="cuda")
    for _ in range(3):
        cpu, cm = step(cpu, batch)
        card, gm = step(card, card_batch)
        assert abs(float(gm["loss"]) - float(cm["loss"])) <= 1e-5 * abs(float(cm["loss"]))
    want = [p.double() for p in _tree.leaves(cpu.params)]
    scale = max(float(p.abs().max()) for p in want)
    for a, b in zip(_tree.leaves(card.params), want):
        assert a.is_cuda and float((a.cpu().double() - b).abs().max()) <= 1e-5 * scale
