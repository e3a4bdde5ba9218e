"""The CUDA kernels against their plain versions on the card, on ragged
small shapes (run on a machine with a card; every test here skips without
one).

Tolerances: kNN ids equal and distances exact on integer lattices; on random
data distances at rtol 1e-5 and ids equal except at near-ties, where the
float64 distance of each differing id must match within rtol 1e-5 (both sum
fp32 squares, in different orders); k-means labels equal on tie-free data, counts exact,
sums at rtol 1e-5 / atol 1e-4 (atomics add in a varying order), min distances
at 1e-5 of ‖x‖² + ‖c‖² (the terms they cancel); ELL SpMM at
rtol 1e-5 / atol 1e-6 (fused multiply-adds against a plain reduction),
and so the ELL SpMV and the fused Chebyshev step, whose epilogue adds two
more roundings; the k-means assignment as the fused iteration's labels and
distances; LSH codes equal wherever every projection is at least 1e-4 from
0 in float64 (nearer, the two summation orders may take different signs),
tie-breaks at rtol 1e-5; block Lanczos eigenvalues within 1e-5 of a float64
dense solve; the scalable path's labels ARI ≥ 0.99 between the card and the
CPU from one seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.spectral import EigConfig, GraphConfig, KMeansConfig, SpectralPipeline
from repro_torch.data.pointcloud import dti_like_pointcloud
from repro_torch.kernels.ell_spmm.ops import ell_spmm, ell_spmm_cheb_step
from repro_torch.kernels.ell_spmm.ref import ell_spmm_cheb_ref, ell_spmm_ref
from repro_torch.kernels.ell_spmv.kernel import ell_spmv_cuda
from repro_torch.kernels.ell_spmv.ops import ell_spmv
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
from repro_torch.kernels.kmeans_iter.ops import kmeans_iter
from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref
from repro_torch.kernels.knn_topk.ops import knn_topk
from repro_torch.kernels.knn_topk.ref import knn_topk_ref
from repro_torch.kernels.lsh_candidates.ops import hash_codes
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


@pytest.mark.parametrize("side,k", [(5, 16), (7, 8), (6, 33), (4, 63)])
def test_knn_lattice_exact(side, k):
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = torch.as_tensor(g.astype(np.float32), device="cuda")
    d, i = knn_topk(x, k)
    rd, ri = knn_topk_ref(x, k)
    assert torch.equal(i, ri) and torch.equal(d, rd)


@pytest.mark.parametrize("n,d,k,off", [(1000, 3, 16, 0), (333, 7, 5, 0), (257, 20, 128, 0),
                                       (300, 90, 10, 40)])
def test_knn_random(n, d, k, off):
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, d, generator=gen).cuda()
    q = x[off:off + 100] if off else None
    got = knn_topk(x, k, queries=q, query_offset=off)
    want = knn_topk_ref(x, k, queries=q, query_offset=off)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    knn_ids_equal_up_to_near_ties(x if q is None else q, x, got[1], want[1], want[0])


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (129, 65, 17), (1000, 37, 90), (513, 500, 33)])
def test_kmeans_iter(n, k, d):
    """Blobs around the centroids: every point's nearest centroid is clear by
    far more than fp32 rounding, so labels are defined."""
    gen = torch.Generator().manual_seed(k)
    c = torch.randn(k, d, generator=gen)
    x = c[torch.randint(k, (n,), generator=gen)] + 0.05 * torch.randn(n, d, generator=gen)
    x, c = x.cuda(), c.cuda()
    gl, gd, gs, gn = kmeans_iter(x, c)
    wl, wd, ws, wn = kmeans_iter_ref(x, c)
    assert torch.equal(gl, wl)
    assert torch.equal(gn, wn)
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,b,width", [(100, 4, None), (257, 3, 8), (1000, 8, 16)])
def test_ell_spmm(n, b, width):
    rng = np.random.default_rng(n)
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


@pytest.mark.parametrize("n,b,width", [(100, 4, None), (257, 3, 8), (1000, 12, 16),
                                       (513, 508, 24)])
def test_ell_spmm_cheb_step(n, b, width):
    m = _random_blockell(n, width)
    x, prev = torch.randn(n, b, device="cuda"), torch.randn(n, b, device="cuda")
    ca = torch.tensor(0.37, device="cuda")
    cb = torch.tensor(-1.25, device="cuda")
    got = ell_spmm_cheb_step(m, x, prev, ca, cb)
    nb, br, w = m.cols.shape
    want = ell_spmm_cheb_ref(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w), prev,
                             ca, cb) + ca * spmm_coo(m.tail, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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
