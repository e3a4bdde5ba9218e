"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py [--profile]

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — the three CUDA kernels from ``src/repro_torch/csrc``, with nvcc,
   all at once;
3. each kernel against its plain PyTorch version on the card, on a ragged
   small grid and at the main path's shapes, with timings (CUDA events),
   the time of a PyTorch library call computing the same function where one
   exists, and the least time the card could take (``bound_ms``);
4. the main path at full size: the DTI workflow (142,541 voxels, 90-d
   profiles, spatial kNN k = 16, cross-correlation weights, 500 clusters)
   through ``SpectralPipeline.run_state``, with the kernels' launch counters
   zeroed just before and read just after;
5. end to end at the example's default size (n = 4000, 12 clusters): the
   card against the CPU from one seed.

With ``--profile`` the main path runs once more under ``torch.profiler``
(device busy share, top kernels).  The line before the last is the kernel
table as JSON; the last line is
``{"ok": true, "device": {...}}``.  A copy of the numbers goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.spectral import (EigConfig, GraphConfig, KMeansConfig,  # noqa: E402
                                       SpectralPipeline)
from repro_torch.data.pointcloud import dti_like_pointcloud  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ell_spmm import ops as ell_ops  # noqa: E402
from repro_torch.kernels.ell_spmm.kernel import ell_spmm_cuda  # noqa: E402
from repro_torch.kernels.ell_spmm.ref import ell_spmm_ref  # noqa: E402
from repro_torch.kernels.kmeans_iter import ops as km_ops  # noqa: E402
from repro_torch.kernels.kmeans_iter.kernel import kmeans_iter_cuda  # noqa: E402
from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref  # noqa: E402
from repro_torch.kernels.knn_topk import ops as knn_ops  # noqa: E402
from repro_torch.kernels.knn_topk.kernel import knn_topk_cuda  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_ref  # noqa: E402
from repro_torch.sparse.ops import spmm_coo  # noqa: E402
from repro_torch.serve.metrics import adjusted_rand_index  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the tensor
# cores and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

N_FULL, D_PROFILE, N_REGIONS, K_FULL, KNN_K = 142541, 90, 250, 500, 16


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and operations /
    fp32 peak."""
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES * 1e3, n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def near_tie_swaps(x, got_idx, want_idx, want_d) -> int:
    """Count of neighbour slots whose ids differ; raises unless each differing
    id is as near (float64, rtol 1e-5) as the plain version's id at that rank
    — a near-tie that fp32 rounding may order either way."""
    diff = got_idx != want_idx
    rows = torch.nonzero(diff)[:, 0]
    x64 = x.double()
    d_got = ((x64[rows] - x64[got_idx[diff].long()]) ** 2).sum(1)
    want = want_d[diff].double()
    check(bool(((d_got - want).abs() <= 1e-5 * want + 1e-6).all()),
          "knn_topk: a differing id is not a near-tie")
    return int(diff.sum())


def purity(labels, truth) -> float:
    """Share of points in the majority latent region of their cluster."""
    labels = np.asarray(labels.cpu() if hasattr(labels, "cpu") else labels)
    _, ti = np.unique(np.asarray(truth.cpu() if hasattr(truth, "cpu") else truth),
                      return_inverse=True)
    _, li = np.unique(labels, return_inverse=True)
    table = np.zeros((li.max() + 1, ti.max() + 1), np.int64)
    np.add.at(table, (li, ti), 1)
    return float(table.max(1).sum() / labels.size)


def lattice(n: int) -> torch.Tensor:
    pos, _, _, _ = dti_like_pointcloud(n, 1, 1, neighbors="none", seed=0)
    return pos


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def knn_phase() -> dict:
    dev = torch.device("cuda")
    # ragged grid: tie-free random data and small lattices
    gen = torch.Generator().manual_seed(1)
    before = knn_ops.knn_topk.launches
    for n, d, k in ((777, 3, 16), (300, 5, 7), (129, 20, 33), (65, 90, 128)):
        x = torch.randn(n, d, generator=gen).to(dev)
        gd, gi = knn_ops.knn_topk(x, k)
        wd, wi = knn_topk_ref(x, k)
        torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-6)
        near_tie_swaps(x, gi, wi, wd)
    for n, k in ((1000, 16), (343, 63)):
        x = lattice(n)
        gd, gi = knn_ops.knn_topk(x, k)
        wd, wi = knn_topk_ref(x, k)
        check(torch.equal(gd, wd) and torch.equal(gi, wi), f"knn_topk lattice n={n} k={k}")
    # main path: the 142,541-voxel lattice, k = 16, through the wrapper that
    # Stage 1 calls — exact equality required
    x = lattice(N_FULL)
    gd, gi = knn_ops.knn_topk(x, KNN_K)
    t0 = time.perf_counter()
    wd, wi = knn_topk_ref(x, KNN_K)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mism = int((gi != wi).sum())
    err = float((gd - wd).abs().max())
    check(mism == 0 and err == 0.0, f"knn_topk lattice main shape: {mism} id mismatches, "
                                    f"max |Δd| {err}")
    ties = int((wd[:, 1:] == wd[:, :-1]).sum())
    # main shape on random points in the same box: ids equal unless a near-tie
    u = (torch.rand(N_FULL, 3, generator=gen) * 52).to(dev)
    rd, ri = knn_ops.knn_topk(u, KNN_K)
    pd, pi = knn_topk_ref(u, KNN_K)
    torch.testing.assert_close(rd, pd, rtol=1e-5, atol=1e-6)
    swaps = near_tie_swaps(u, ri, pi, pd)
    check(knn_ops.knn_topk.launches == before + 8, "knn_topk wrapper did not launch its kernel")
    # the kernel alone, on the wrapper's zero-padded input
    xp = torch.nn.functional.pad(x, (0, 1)).contiguous()
    ms = cuda_ms(lambda: knn_topk_cuda(xp, xp, KNN_K), iters=10)

    def library():  # cdist + topk, chunked so one [chunk, n] tile is live
        out = []
        for s in range(0, N_FULL, 8192):
            d2 = torch.cdist(x[s:s + 8192], x) ** 2
            d2[torch.arange(d2.shape[0], device=dev), torch.arange(s, s + d2.shape[0],
                                                                   device=dev)] = math.inf
            out.append(torch.topk(d2, KNN_K, largest=False))
        return out

    library_ms = cuda_ms(library, iters=2)
    n_ops = 2.0 * N_FULL * N_FULL * 3  # one subtract and one fma per pair and coordinate
    n_bytes = 2 * N_FULL * 3 * 4 + N_FULL * KNN_K * 8
    bms, by = bound(n_bytes, n_ops)
    log(f"[kernel] knn_topk (tol: lattice exact; random rtol 1e-5, ids equal up to near-ties): "
        f"lattice n={N_FULL} k={KNN_K} ids equal, max|Δd|=0 "
        f"({ties} tied neighbour pairs); random: {swaps} ids swapped at "
        f"near-ties; kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} library_ms={library_ms:.1f} "
        f"bound_ms={bms:.3f} ({by})")
    return dict(name="knn_topk", route="cuda", source="src/repro_torch/csrc/knn_topk.cu",
                replaces="src/repro/kernels/knn_topk/kernel.py:91", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def kmeans_phase() -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)

    def compare(x, c, tag):
        gl, gd, gs, gn = km_ops.kmeans_iter(x, c)
        wl, wd, ws, wn = kmeans_iter_ref(x, c)
        check(torch.equal(gl, wl), f"kmeans_iter labels differ ({tag})")
        check(torch.equal(gn, wn), f"kmeans_iter counts differ ({tag})")
        # dmin cancels ‖x‖² + ‖c‖² against 2x·c: its error scales with them
        scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
        torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-4)
        return max(float((gd - wd).abs().max()), float((gs - ws).abs().max()))

    def blobs(n, k, d, noise):  # tie-free: every point sits near its own centroid
        c = torch.randn(k, d, generator=gen)
        x = c[torch.randint(k, (n,), generator=gen)] + noise * torch.randn(n, d, generator=gen)
        return x.to(dev), c.to(dev)

    before = km_ops.kmeans_iter.launches
    for n, k, d in ((1, 1, 1), (1000, 37, 90), (513, 500, 33), (4097, 129, 257)):
        compare(*blobs(n, k, d, 0.05), f"n={n} k={k} d={d}")
    x, c = blobs(N_FULL, K_FULL, K_FULL, 0.02)
    err = compare(x, c, "main shape")
    check(km_ops.kmeans_iter.launches == before + 5, "kmeans_iter wrapper did not launch its kernel")
    cn = (c * c).sum(1)
    ms = cuda_ms(lambda: kmeans_iter_cuda(x, c, cn), iters=10)
    plain_ms = cuda_ms(lambda: kmeans_iter_ref(x, c), iters=3)
    n_ops = 2.0 * N_FULL * K_FULL * K_FULL
    n_bytes = (N_FULL * K_FULL + K_FULL * K_FULL + K_FULL) * 4 + N_FULL * 8 \
        + K_FULL * (K_FULL + 1) * 4
    bms, by = bound(n_bytes, n_ops)
    log(f"[kernel] kmeans_iter (tol: labels and counts exact, sums rtol 1e-5 atol 1e-4, "
        f"dmin atol 1e-5·(‖x‖²+‖c‖²)): n={N_FULL} k={K_FULL} d={K_FULL} labels and counts equal, "
        f"max|Δ| sums/dmin={err:.2e}; kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"library_ms=null bound_ms={bms:.3f} ({by})")
    return dict(name="kmeans_iter", route="cuda", source="src/repro_torch/csrc/kmeans_iter.cu",
                replaces="src/repro/kernels/kmeans_iter/kernel.py:98", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)


def ell_phase(pos, prof) -> dict:
    dev = torch.device("cuda")
    from repro_torch.sparse import formats as tf

    def compare(m, x):
        nb, br, w = m.cols.shape
        got = ell_ops.ell_spmm(m, x)
        want = ell_spmm_ref(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w))
        want = want[: m.shape[0]] + spmm_coo(m.tail, x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        return float((got - want).abs().max())

    rng = np.random.default_rng(3)
    before = ell_ops.ell_spmm.launches
    for n, b, width in ((100, 4, None), (257, 3, 8), (1000, 8, 16)):
        r, c = rng.integers(0, n, 12 * n), rng.integers(0, n, 12 * n)
        v = rng.random(12 * n).astype(np.float32)
        m = tf.csr_to_blockell(tf.coo_to_csr(tf.coo_from_edges(r, c, v, (n, n), device=dev)),
                               width=width)
        compare(m, torch.randn(n, b, device=dev))
    # main path: the normalized DTI kNN graph in the pipeline's BlockELL layout
    pipe = main_pipeline(K_FULL)
    state = pipe.build_graph(prof, points=pos)
    op = pipe.operator(state)
    m = op.a
    x = torch.randn(N_FULL, 4, device=dev)
    err = compare(m, x)
    check(ell_ops.ell_spmm.launches == before + 4, "ell_spmm wrapper did not launch its kernel")
    nb, br, w = m.cols.shape
    cols, vals = m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w)
    ms = cuda_ms(lambda: ell_spmm_cuda(x, cols, vals), iters=50)
    plain_ms = cuda_ms(lambda: ell_spmm_ref(x, cols, vals), iters=10)
    a = state.adj
    csr = torch.sparse_coo_tensor(torch.stack([a.row, a.col]), a.val, a.shape).coalesce() \
        .to_sparse_csr()
    library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x), iters=50)
    rows = nb * br
    n_bytes = rows * w * 8 + N_FULL * 4 * 4 + rows * 4 * 4
    n_ops = 2.0 * rows * w * 4
    bms, by = bound(n_bytes, n_ops)
    log(f"[kernel] ell_spmm (tol: rtol 1e-5 atol 1e-6): rows={rows} W={w} b=4 "
        f"tail={m.tail.nnz} max|Δy|={err:.2e}; "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} "
        f"bound_ms={bms:.4f} ({by})")
    return dict(name="ell_spmm", route="cuda", source="src/repro_torch/csrc/ell_spmm.cu",
                replaces="src/repro/kernels/ell_spmm/kernel.py:53", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# phases 4-5: the pipeline
# ---------------------------------------------------------------------------

def main_pipeline(n_clusters: int) -> SpectralPipeline:
    return SpectralPipeline(
        n_clusters=n_clusters,
        graph=GraphConfig(knn_k=KNN_K, measure="cross_correlation"),
        eig=EigConfig(tol=1e-4, block_size=4, representation="blockell"),
        kmeans=KMeansConfig(iter="fused"))


COUNTERS = (("knn_topk", knn_ops.knn_topk), ("ell_spmm", ell_ops.ell_spmm),
            ("kmeans_iter", km_ops.kmeans_iter))


def main_path(pos, prof, region) -> dict:
    pipe = main_pipeline(K_FULL)
    for _, fn in COUNTERS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = pipe.run_state(prof, torch.Generator().manual_seed(0), points=pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in COUNTERS}
    res = state.result
    for name, n in launches.items():
        check(n > 0, f"main path never launched {name}")
    check(bool(torch.isfinite(res.embedding).all()), "non-finite embedding")
    check(bool(torch.isfinite(res.eigenvalues).all()), "non-finite eigenvalues")
    check(bool(torch.isfinite(res.kmeans_inertia)), "non-finite inertia")
    labels = res.labels.cpu().numpy()
    check(labels.shape == (N_FULL,) and labels.min() >= 0 and labels.max() < K_FULL,
          "labels out of range")
    reports = [r.to_dict() for r in res.reports]
    live = int(np.unique(labels).size)
    pur = purity(labels, region)
    log(f"[main] n={N_FULL} clusters={K_FULL}: points→labels {wall:.2f} s; stages "
        + ", ".join(f"{r['stage']} {r['wall_s']:.2f} s" for r in reports))
    emb = reports[1]
    log(f"[main] lanczos restarts={res.lanczos_restarts} converged={emb['converged']} "
        f"residual_max={emb['residual_max']:.3e} attempts={emb['attempts']} "
        f"escalations={emb['escalations']}")
    log(f"[main] kmeans iterations={res.kmeans_iterations} non-empty={live}/{K_FULL} "
        f"purity={pur:.4f} cluster escalations={reports[2]['escalations']}")
    log(f"[main] launches {launches}; peak device memory allocated {peak_gb:.3f} GB")
    return dict(wall_s=wall, peak_gb=peak_gb, reports=reports, restarts=res.lanczos_restarts,
                kmeans_iterations=res.kmeans_iterations, non_empty=live, purity=pur,
                launches=launches, eig_min=float(res.eigenvalues.min()),
                eig_max=float(res.eigenvalues.max()))


def end_to_end() -> dict:
    k = 12
    out = {}
    for dev in ("cuda", "cpu"):
        pos, prof, _, region = dti_like_pointcloud(4000, 90, max(k // 2, 4), eps=1.8, seed=0,
                                                   neighbors="none", device=dev)
        t0 = time.perf_counter()
        res = main_pipeline(k).run(prof, torch.Generator().manual_seed(0), points=pos,
                                   device=dev)
        out[dev] = (res, time.perf_counter() - t0, purity(res.labels, region))
    ari = adjusted_rand_index(out["cuda"][0].labels, out["cpu"][0].labels)
    diff = (out["cuda"][0].eigenvalues.cpu() - out["cpu"][0].eigenvalues).abs()
    dev_ev = float(diff.max())
    log(f"[e2e] n=4000 k={k}: card {out['cuda'][1]:.2f} s vs CPU {out['cpu'][1]:.2f} s; "
        f"ARI={ari:.4f} max|Δλ|={dev_ev:.2e} (at λ_{int(diff.argmax())}) purity "
        f"card={out['cuda'][2]:.3f} cpu={out['cpu'][2]:.3f}")
    for dev, (res, _, _) in out.items():
        log(f"[e2e] {dev}: restarts={res.lanczos_restarts} kmeans_iters="
            f"{res.kmeans_iterations} residual_max={float(res.eig_residuals.max()):.2e} "
            f"λ={[round(v, 6) for v in res.eigenvalues.cpu().tolist()]}")
    check(ari >= 0.99, f"card vs CPU labels ARI {ari:.4f} < 0.99")
    check(dev_ev <= 1e-4, f"card vs CPU eigenvalues differ by {dev_ev:.2e} > 1e-4")
    return dict(ari=ari, max_eig_diff=dev_ev, card_s=out["cuda"][1], cpu_s=out["cpu"][1])


def profile_main_path(pos, prof) -> dict:
    """The main path once more under ``torch.profiler`` (device activity
    only): device busy share of the wall and the kernels that take the most
    device time.  The table goes to ``chiprun_out/profile_main.txt``."""
    from torch.profiler import ProfilerActivity, profile

    pipe = main_pipeline(K_FULL)
    with profile(activities=[ProfilerActivity.CUDA]) as prof_:
        t0 = time.perf_counter()
        pipe.run_state(prof, torch.Generator().manual_seed(0), points=pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof_.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    (ROOT / "chiprun_out" / "profile_main.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] main path {wall:.2f} s wall, device busy {busy:.2f} s "
        f"({100 * busy / wall:.1f} %)")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.1f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    return dict(wall_s=wall, device_busy_s=busy,
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} devices={torch.cuda.device_count()}")
    log(smi)
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: " + " | ".join(regs[:6]))
    log(f"[build] {len(logs)} kernels built in {build_s:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    pos, prof, _, region = dti_like_pointcloud(N_FULL, D_PROFILE, N_REGIONS, eps=1.8,
                                               seed=0, neighbors="none")
    kernels = [knn_phase(), kmeans_phase(), ell_phase(pos, prof)]
    t_main = time.perf_counter()
    main_rec = main_path(pos, prof, region)
    t_e2e = time.perf_counter()
    e2e = end_to_end()
    t_done = time.perf_counter()
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    profiled = profile_main_path(pos, prof) if "--profile" in sys.argv[1:] else None
    for kern in kernels:
        kern["launches"] = main_rec["launches"][kern["name"]]
    summary = dict(device=smi, torch=torch.__version__, cuda=torch.version.cuda,
                   build_s=build_s, kernels=kernels, main=main_rec, e2e=e2e,
                   profile=profiled,
                   phase_s=dict(kernels=t_main - t_start, main=t_e2e - t_main,
                                e2e=t_done - t_e2e, total=time.perf_counter() - t_start))
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    log(f"[done] {summary['phase_s']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
