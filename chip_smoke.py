"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py [--profile]

Four paths of the DTI workflow (142,541 voxels, 90-d profiles, spatial kNN
k = 16, cross-correlation weights, 500 clusters), all through
``SpectralPipeline.run_state``:

* the first path — exact kNN graph → block Lanczos → fused k-means
  (kernels ``knn_topk``, ``ell_spmm``, ``kmeans_iter``);
* the scalable path — LSH kNN graph → Chebyshev filter embedding →
  two-pass k-means (kernels ``hash_codes``, ``ell_spmv``,
  ``ell_spmm_cheb``, ``kmeans_assign``, and ``ell_spmm``);
* the sparsify path — the first path with the graph sparsified to 40 % of
  its entries before the eigensolve;
* the coarsen path — the scalable path on the graph coarsened by one level
  of heavy-edge matching, the embedding lifted back and refined on the
  fine graph (``ell_spmm`` at b = 500 on 142,541 rows).

Phases (any failure raises, so the script exits non-zero and prints no
result line):

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — the CUDA kernels from ``src/repro_torch/csrc``, one nvcc per
   source, all started together;
   random — the counter-based stream (``repro_torch._random``) on the card:
   Philox's known answers, the card's bits against the CPU's, the paths'
   draws made with no host → device copy, and their times;
3. each kernel against its plain PyTorch version on the card, on a ragged
   small grid and at its path's shapes, through the wrapper its path calls,
   with timings (CUDA events; ``torch.profiler`` device time, cold, for the
   short kernels and beside the events for ``knn_topk`` and
   ``ell_spmm_cheb``), the time of a PyTorch library call computing the same
   function where one exists, and the least time the card could take
   (``bound_ms``);
   guard — the Stage-1 input guard ``health.check_points`` on the full
   points: its time, no device → host copy above 1 KB, and its verdicts
   equal to a host version's (full points, one NaN, duplicate rows);
   blockell — both full graphs' BlockELL layouts built on the card,
   bitwise equal to a numpy build of the reference's layout, both timed,
   and no host → device copy in ``SpectralPipeline.operator``;
4. each path at full size, with every kernel's launch counter zeroed just
   before and read just after, and every stage timed; then the first two
   paths' k-means kernels once more on their final embeddings against
   their plain versions (differing labels must be float64 near-ties), and
   the labels to ``chiprun_out/``; the reduced paths held to their
   unreduced paths (sizes, purity, ARI, eigenvalue drift), and the sparse
   kernels held to their plain versions on the sparsified, coarse and fine
   layouts those paths built;
   resume — the first path stopped by a forced error after ``prepare``,
   its checkpoint saved under ``build/``, resumed, held to the
   uninterrupted run's labels;
   sharded — the sharded plan (``repro_torch.core.distributed_pipeline``):
   the layout path (the first path's graph partitioned onto 4 row blocks
   on the card, bitwise the reference's numpy layout, run by
   ``Plan(variant="gspmd")``: purity within 0.01 and eigenvalues within
   1e-4 of the first path's); the mesh path on a world-size-1 NCCL
   ``DeviceMesh`` (Stage 1 gather and ring bitwise the single-device
   ``knn_topk``; the first path from raw points with the gather and the
   ring exchange and the scalable path's LSH Stage 1 on the ring, each
   within 0.01 of its unsharded path's purity, counters zeroed around each;
   ``kmeans_sharded`` one all-reduce a Lloyd iteration; the layout path's
   graph as a one-block ShardedCOO under ``variant="shard_map"``, one
   all-gather an operator product); card vs CPU at n = 4000 against one gloo rank (ARI ≥ 0.99);
   4 gloo ranks sharing the card with the gather exchange (every rank the
   same labels and eigenvalues, held to the world-size-1 run; the ring is
   left out, gloo cannot send from a CUDA tensor); ``knn_topk``,
   ``kmeans_iter`` and ``hash_codes`` at a 4-rank plan's shapes (the
   ``@shard`` rows, their launches counted at world size 1); both
   examples on the card at their default sizes, and the DTI example's
   ``--device-stage1 --n 4000`` purity on the card within 0.01 of the
   CPU's;
5. end to end at the example's default size (n = 4000, 12 clusters), each
   path: the card against the CPU from one seed, the card run
   ``CARD_RUNS`` times, each run held to the CPU's, and the runs' labels
   and degrees compared with the first card run's bitwise;
6. serve — the serving path (``repro_torch.serve``) at the serving cell's
   size: ``launch/serve.py``'s blob pool (n = 160,000, 16 centres, d = 16)
   trained, its exact and LSH indexes built, 2,048 held-out queries served
   in batches of 256 with the launch counters zeroed just before and read
   just after; OOS labels against a full re-clustering (ARI ≥ 0.95, both
   searches), the persisted LSH tables against the rehash path (agreement
   1.0), ``routed_candidates`` card = CPU, pad-row invariance, a registry
   load onto the card bitwise the published index, per-label latency
   through the micro-batcher, every kernel of the path held at each shape
   the path gave it (``knn_topk`` all pairs on the pool and on a query
   batch, ``hash_codes`` on the pool and on a query batch, ``kmeans_iter``
   on the trained embedding) and timed at the serving shapes (the kernel
   line's ``@serve`` rows), the
   launcher's ``serve`` mode (exit code 32 with ``nan-query`` on 64
   requests) and ``cluster`` mode (exit code 2 with ``nan-graph`` on 4), and
   the card against the CPU at n = 4000 (OOS labels ARI ≥ 0.99); with
   ``--profile`` the serving of the queries under ``torch.profiler`` too.

7. decode — the model zoo's serving path (``launch/serve.py --mode
   decode``) at published widths and depths in bf16: qwen3-0.6b (batch 8,
   a 1,024-token prompt, 2,048 cache slots, 64 steps) and
   granite-moe-3b-a800m (batch 8, 512 + 32 tokens in 1,024 slots) through
   the launcher with the launch counters zeroed just before and read just
   after (the path runs none of the repo's kernels), then on the
   launcher's parameters and prompt: prefill ms, decode ms a step, tok/s,
   peak memory and the step's bound; gates: every logit finite, a second
   decode bitwise the first, no device → host copy in the decode loop, one
   decode step = the forward on the extended sequence within 2⁻⁴ of
   max|logit| (the MoE model dropless); and each LM arch's SMOKE config
   card = CPU in fp32 (logits within 1e-5 of max|logit|, greedy tokens
   equal); with ``--profile`` the decode loops' device busy share.
8. train — the training path (``launch/train.py``, ``train/``, ``optim/``)
   with the launch counters zeroed just before and read just after (it
   runs none of the repo's kernels): qwen3-0.6b at its published widths
   and depth in bf16 through ``launch.train.main`` (8 steps of batch 8 ×
   1,024 tokens, LM_ACCUM = 2, remat ``"nothing"``, OPT_CFG): step ms (the
   median of steps 2–8), tokens/s, peak memory and the step's bound; gates:
   every loss and grad_norm finite, every parameter leaf changed, no device
   → host copy inside a step; one step each with remat off, ``"nothing"``
   and ``"dots"`` from one state (losses bitwise equal, grad_norm within
   1e-2, ``"nothing"`` the lowest peak); the step-8 state (6.6 GB) through
   ``CheckpointManager`` and back onto the card bitwise; the launcher's
   resume at ``--smoke`` (6 then 10 steps against 10, within 1e-6 of
   max|p|, bitwise reported); AutoInt at its published config (2.5 GB of
   tables): 5 train steps at batch 65,536 (bound, peak, the loss changes),
   ``serve_p99`` p50/p99, ``serve_bulk``, ``retrieval_cand``; and each LM
   arch's and AutoInt's SMOKE config card = CPU in fp32 over 3 steps
   (losses within 1e-5, parameters within 1e-5 of max|p|); with
   ``--profile`` one qwen3 step's
   device busy share.
9. gnn — the GNN family's training (``models/gnn/``, ``data/sampler.py``)
   with the launch counters zeroed just before and read just after (it
   runs none of the repo's kernels): gcn-cora, pna, nequip and
   equiformer-v2 at their published configs through ``gnn_shape_config``
   and ``make_train_step(loss, OPT_CFG)`` on runs G1–G6 (``GNN_RUNS``:
   Cora's size and ogb_products for gcn-cora, a ``NeighborSampler``
   subgraph of a Reddit-size CSR for pna, 128 molecules for nequip and
   equiformer-v2 in bf16, nequip on 4.2 M edges in 5 chunks), batches drawn
   on the card from a seed: step ms, nodes and edges a second, peak memory,
   the step's bound (``gnn_bound``), the sampler's host ms; gates: every
   loss and grad_norm finite, every leaf the loss reaches got a gradient
   and, in fp32, changed; nequip's chunked step's peak below its unchunked
   step's on one graph of 2.62 M edges; each GNN's SMOKE config card = CPU
   over 3 steps on the tiny graph and the molecule layout (losses and
   parameters within 1e-5, two card runs' spread printed); rotation +
   translation moving the loss of tests/test_e3.py's configs by < 5e-5 on
   the card (at full width in fp32, printed); with ``--profile`` one step of
   each run's device busy share.

With ``--profile`` each path runs once more under ``torch.profiler``
(device busy share, top kernels, host → device copies) and once more under
the host clocks of ``tools/host_clock.py`` (the draws, the host assembly,
the host reads).  The line before the last is the kernel
table as JSON (each kernel's launches from its own path); the last line is
``{"ok": true, "device": {...}}``.  A copy of the numbers goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.core.chebyshev as cheb  # noqa: E402
from repro_torch import _random, _tree, convert  # noqa: E402
from repro_torch._device import cpu_generator  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
import repro_torch.core.health as health  # noqa: E402
import repro_torch.core.kmeans as tkm  # noqa: E402
import repro_torch.core.reduce as red  # noqa: E402
from repro_torch.core.health import PipelineError  # noqa: E402
from repro_torch.core.spectral import (EigConfig, GraphConfig, KMeansConfig,  # noqa: E402
                                       Plan, SpectralPipeline)
from repro_torch.data.pointcloud import dti_like_pointcloud  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ell_spmm import ops as ell_ops  # noqa: E402
from repro_torch.kernels.ell_spmm.kernel import ell_spmm_cheb_cuda, ell_spmm_cuda  # noqa: E402
from repro_torch.kernels.ell_spmm.ref import ell_spmm_cheb_ref, ell_spmm_ref  # noqa: E402
from repro_torch.kernels.ell_spmv import ops as spmv_ops  # noqa: E402
from repro_torch.kernels.ell_spmv.kernel import ell_spmv_cuda  # noqa: E402
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref  # noqa: E402
from repro_torch.kernels.kmeans_assign import ops as ka_ops  # noqa: E402
from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda  # noqa: E402
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref  # noqa: E402
from repro_torch.kernels.kmeans_iter import ops as km_ops  # noqa: E402
from repro_torch.kernels.kmeans_iter.kernel import kmeans_iter_cuda  # noqa: E402
from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref  # noqa: E402
from repro_torch.kernels.knn_topk import ops as knn_ops  # noqa: E402
from repro_torch.kernels.knn_topk.kernel import knn_topk_cuda  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_ref  # noqa: E402
from repro_torch.kernels.lsh_candidates import ops as lsh_ops  # noqa: E402
from repro_torch.kernels.lsh_candidates.kernel import hash_codes_cuda  # noqa: E402
from repro_torch.kernels.lsh_candidates.ref import hash_codes_ref  # noqa: E402
from repro_torch.sparse import distributed as tdist  # noqa: E402
from repro_torch.sparse.ops import spmm_coo, spmv_coo  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs.cells import LM_ACCUM, OPT_CFG  # noqa: E402
from repro_torch.data.tokens import MarkovTokenStream  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train.state import TrainState, _grads_of, init_state, make_train_step  # noqa: E402
from repro_torch.serve import (BatchConfig, EmbeddingRegistry, MicroBatcher,  # noqa: E402
                               OOSConfig, OOSResult, adjusted_rand_index, build_index,
                               serve_fn)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the tensor
# cores, TF32 on the tensor cores, and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12

N_FULL, D_PROFILE, N_REGIONS, K_FULL, KNN_K = 142541, 90, 250, 500, 16
LSH_TABLES, LSH_BITS = 16, 16  # GraphConfig's defaults
HASH_EPS = 1e-4  # |projection| below which a sign bit may go either way


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


def bound(n_bytes: float, n_ops: float, peak: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and operations /
    ``peak`` (the fp32 SIMT peak unless the work runs on the tensor cores)."""
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES * 1e3, n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kmeans_bound(n_bytes: float, n: int = N_FULL, k: int = K_FULL, d: int = K_FULL):
    """The k-means distance products at fp32 accuracy on the tensor cores:
    three TF32 products (3xTF32) of 2·n·k·d flops each."""
    return bound(n_bytes, 3 * 2.0 * n * k * d, PEAK_TF32_FLOPS)


def iter_bytes(n: int, k: int, d: int) -> int:
    """A Lloyd iteration's bytes: x, c and ‖c‖² read once; labels and dmin,
    sums and counts written once."""
    return (n * d + k * d + k) * 4 + n * 8 + k * (d + 1) * 4


def kmeans_library(x, c, chunk: int = 16384):
    """A Lloyd iteration's statistics as a composition of library calls,
    chunked: cdist + argmin + index_add_."""
    k, d = c.shape
    sums = torch.zeros(k, d + 1, device=x.device)
    for s in range(0, x.shape[0], chunk):
        xb = x[s:s + chunk]
        lab = torch.cdist(xb, c).argmin(1)
        sums[:, :d].index_add_(0, lab, xb)
        sums[:, d].index_add_(0, lab, torch.ones_like(lab, dtype=torch.float32))
    return sums


def hold_iter(x, c, tag: str, order_bound: bool = False) -> float:
    """``kmeans_iter`` through its wrapper against its plain version: labels
    and counts equal, dmin at 1e-5·(‖x‖²+‖c‖²) (it cancels those terms
    against 2x·c, so its error scales with them), sums at rtol 1e-5 / atol
    1e-4.  With ``order_bound`` (clusters of ~10⁴ rows, where fp32 sums in
    two orders differ by more than 1e-5) each sum, the kernel's and the
    plain version's, must instead lie within the bound of fp32 summation in
    any order of the float64 sum: |ŝ − s| ≤ γ_m·Σ|x|, γ_m = m·u/(1 − m·u),
    u = 2⁻²⁴, m the cluster's count.  Returns the larger max|Δ| of sums and
    dmin between the kernel and its plain version."""
    gl, gd, gs, gn = km_ops.kmeans_iter(x, c)
    wl, wd, ws, wn = kmeans_iter_ref(x, c)
    check(torch.equal(gl, wl), f"kmeans_iter labels differ ({tag})")
    check(torch.equal(gn, wn), f"kmeans_iter counts differ ({tag})")
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)
    if order_bound:
        own, x64 = gl.long(), x.double()
        exact = torch.zeros(gs.shape, dtype=torch.float64, device=x.device).index_add_(0, own, x64)
        mag = torch.zeros_like(exact).index_add_(0, own, x64.abs())
        mu = gn.double()[:, None] * 2.0 ** -24
        slack = mu / (1 - mu) * mag
        for name, sums in (("kernel", gs), ("plain version", ws)):
            check(bool(((sums.double() - exact).abs() <= slack).all()),
                  f"kmeans_iter sums of the {name} outside fp32 summation's bound ({tag})")
    else:
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-4)
    return max(float((gd - wd).abs().max()), float((gs - ws).abs().max()))


def launch_ms(fn, copies, iters: int):
    """Each of ``iters`` launches of ``fn(*copy)`` (rotating over ``copies``)
    timed alone between its own events, sorted: the spread of single
    launches, where ``cuda_ms`` gives their mean."""
    it = itertools.cycle(copies)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for _ in range(len(copies)):
        fn(*next(it))
    for start, end in pairs:
        start.record()
        fn(*next(it))
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in pairs)


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def issue_ms(lane_ops: float) -> float:
    """Milliseconds for ``lane_ops`` fp32 instructions (a multiply-add
    counts one): one a lane a clock, 128 lanes an SM, at the card's maximum
    SM clock."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return lane_ops / (sms * 128 * mhz * 1e6) * 1e3


def cold_ms(fn, copies, iters: int) -> float:
    """``cuda_ms`` of ``fn(*copy)`` rotating over ``copies`` of its inputs,
    enough bytes that no launch finds its operands in the 50 MB L2."""
    it = itertools.cycle(copies)
    return cuda_ms(lambda: fn(*next(it)), iters=iters, warmup=len(copies))


def device_ms(fn, copies, iters: int) -> float:
    """Device milliseconds per call of ``fn(*copy)``, rotating over
    ``copies``: the summed durations of the kernels (and copies) the calls
    launch, from ``torch.profiler``'s device records.  Unlike ``cuda_ms`` it
    leaves out the idle gaps a host slower than the card opens between short
    launches."""
    from torch.profiler import ProfilerActivity, profile

    it = itertools.cycle(copies)
    for _ in range(len(copies)):
        fn(*next(it))
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no device records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*next(it))
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages())
        if total > 0:
            return total / 1e3 / iters
    raise SmokeFailure("torch.profiler recorded no device time in three tries")


def near_tie_swaps(x, got_idx, want_idx, want_d, queries=None) -> int:
    """Count of neighbour slots whose ids differ; raises unless each differing
    id is as near (float64, rtol 1e-5) as the plain version's id at that rank
    — a near-tie that fp32 rounding may order either way.  ``queries``
    defaults to the candidates ``x`` (all pairs)."""
    diff = got_idx != want_idx
    rows = torch.nonzero(diff)[:, 0]
    x64 = x.double()
    q64 = x64 if queries is None else queries.double()
    d_got = ((q64[rows] - x64[got_idx[diff].long()]) ** 2).sum(1)
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
# phase 2b: the random stream
# ---------------------------------------------------------------------------

PHILOX_KNOWN = (  # Random123's known answers of Philox4x32-10: counter, key, output
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)))


def h2d_copies(fn) -> tuple:
    """(count, device ms) of the host → device copies ``fn()`` makes, from
    ``torch.profiler``'s device records."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if "HtoD" in e.key]
    return sum(e.count for e in hits), sum(e.self_device_time_total for e in hits) / 1e3


def random_phase() -> dict:
    """The counter-based stream on the card: Philox's known answers; the
    card's raw words equal to the CPU's on 2²⁰ random counters under 16
    random keys (a quarter of the words within 3 of 2³² − 1); the filter's
    draws at the scalable path's shape (normal [n], Rademacher [n, 8] and
    [n, 508]) and a 64-row k-means++ Gumbel block bitwise (words, signs) or
    within rtol 1e-6 / atol 2e-6 (after ``log``/``cos``/``sin``) of the
    same call on the CPU; no host → device copy in ``draw_signals`` or
    ``kmeanspp_init``; and the draws' times on the card."""
    dev = torch.device("cuda")
    for ctr, key, want in PHILOX_KNOWN:
        got = _random.philox4x32(torch.tensor(ctr, dtype=torch.int64, device=dev)[:, None], key)
        check(got[:, 0].tolist() == list(want), f"Philox known answer for counter {ctr}")
    rng = np.random.default_rng(21)
    for _ in range(16):
        key = tuple(int(v) for v in rng.integers(0, 1 << 32, 2))
        ctr = rng.integers(0, 1 << 32, (4, 1 << 16), dtype=np.int64)
        near = rng.random(ctr.shape) < 0.25
        ctr[near] = 0xFFFFFFFF - rng.integers(0, 4, int(near.sum()))
        c = torch.from_numpy(ctr)
        check(torch.equal(_random.philox4x32(c.to(dev), key).cpu(), _random.philox4x32(c, key)),
              "Philox words differ between the card and the CPU")
    r = K_FULL + 8

    def signals(device):
        return cheb.draw_signals(torch.Generator().manual_seed(3), N_FULL, 8, r, device)

    card, cpu = signals(dev), signals("cpu")
    check(torch.equal(card[1].cpu(), cpu[1]) and torch.equal(card[2].cpu(), cpu[2]),
          "draw_signals: Rademacher draws differ between the card and the CPU")
    normal_err = float((card[0].cpu() - cpu[0]).abs().max())
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-6, atol=2e-6)
    sketch = card[2]
    balance = float(sketch.mean())
    check(abs(balance) < 1e-3 and abs(float(card[0].var()) - 1.0) < 0.02,
          "draw_signals: moments off")
    del card, cpu, sketch
    key = (31337, 4242)
    gd, gc = _random.gumbel(key, 1, (64, N_FULL), dev), _random.gumbel(key, 1, (64, N_FULL), "cpu")
    gumbel_err = float((gd.cpu() - gc).abs().max())
    torch.testing.assert_close(gd.cpu(), gc, rtol=1e-6, atol=2e-6)
    del gd, gc
    # copies and times at the paths' shapes: k-means++ at k = 500 on a
    # [n, 16] block (the seeding's draws are the same at any width)
    x = torch.randn(N_FULL, 16, generator=torch.Generator().manual_seed(5)).to(dev)
    copies = dict(draw_signals=h2d_copies(lambda: signals(dev)),
                  kmeanspp_init=h2d_copies(
                      lambda: tkm.kmeanspp_init(x, K_FULL, torch.Generator().manual_seed(5))))
    for name, (count, _) in copies.items():
        check(count == 0, f"{name} copied {count} tensors from the host to the card")
    signals_ms = cuda_ms(lambda: signals(dev), iters=5)
    gumbel_ms = cuda_ms(lambda: [_random.gumbel(key, 1, (min(64, K_FULL - 1 - s), N_FULL), dev,
                                                row0=s) for s in range(0, K_FULL - 1, 64)],
                        iters=5)
    seed_ms = cuda_ms(lambda: tkm.kmeanspp_init(x, K_FULL, torch.Generator().manual_seed(5)),
                      iters=3)
    del x
    log(f"[random] Philox4x32-10 known answers hold on the card; 2^20 blocks under 16 keys "
        f"equal to the CPU's; draw_signals n={N_FULL} R={r}: Rademacher bitwise equal, normal "
        f"max|Δ|={normal_err:.2e}, sketch mean {balance:+.2e}; Gumbel [64 × {N_FULL}] "
        f"max|Δ|={gumbel_err:.2e}; host→device copies: draw_signals "
        f"{copies['draw_signals'][0]}, "
        f"kmeanspp_init {copies['kmeanspp_init'][0]}")
    log(f"[random] on the card: draw_signals {signals_ms:.3f} ms; the {K_FULL - 1} Gumbel rows "
        f"of k-means++ in chunks of 64 {gumbel_ms:.3f} ms; kmeanspp_init k={K_FULL} on "
        f"[{N_FULL} × 16] {seed_ms:.2f} ms (events)")
    return dict(normal_err=normal_err, gumbel_err=gumbel_err, sketch_mean=balance,
                h2d_copies={k: v[0] for k, v in copies.items()}, draw_signals_ms=signals_ms,
                gumbel_rows_ms=gumbel_ms, kmeanspp_init_ms=seed_ms)


# ---------------------------------------------------------------------------
# phase 2c: the Stage-1 guard and the BlockELL build on the card
# ---------------------------------------------------------------------------

def d2h_copy_bytes(fn) -> list:
    """Sizes in bytes of the device → host copies ``fn()`` makes, from the
    memcpy records of ``torch.profiler``'s device trace."""
    from torch.profiler import ProfilerActivity, profile

    path = ROOT / "chiprun_out" / "d2h_trace.json"
    for _ in range(3):  # the profiler now and then returns no device records
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        if any(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") for e in events):
            break
    else:
        raise SmokeFailure("torch.profiler recorded no device events in three tries")
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    check(all("bytes" in e.get("args", {}) for e in copies),
          "the profiler's device → host copy records carry no byte counts")
    return [int(e["args"]["bytes"]) for e in copies]


def host_check_points(x, n_clusters: int):
    """The reference's input guard (``src/repro/core/health.py``) in numpy on
    a host copy of ``x``: the detail of the error it raises, or None."""
    xnp = x.cpu().numpy()
    bad = int(np.size(xnp) - np.isfinite(xnp).sum())
    if bad:
        return f"input points contain {bad} non-finite value(s)"
    if xnp.shape[0] < n_clusters:
        return f"n_clusters={n_clusters} exceeds the number of points n={xnp.shape[0]}"
    distinct = np.unique(xnp, axis=0).shape[0]
    if distinct < n_clusters:
        return (f"n_clusters={n_clusters} exceeds the number of distinct points ({distinct} "
                f"of {xnp.shape[0]} rows are unique)")
    return None


def guard_phase(prof) -> dict:
    """``health.check_points`` on the full [n × 90] points: CUDA-event and
    host-clock times, no device → host copy above 1 KB (the profiler must
    see the 51 MB copy of the points that the host version makes), and its
    verdicts equal to the host version's on the points, a copy with one NaN
    and a copy of 300 distinct rows (signed zeros in the first column)."""
    dev = prof.device
    ms = cuda_ms(lambda: health.check_points(prof, K_FULL), iters=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    health.check_points(prof, K_FULL)
    card_s = time.perf_counter() - t0
    big = [b for b in d2h_copy_bytes(lambda: health.check_points(prof, K_FULL)) if b > 1024]
    probe = sum(d2h_copy_bytes(lambda: prof.cpu()))
    check(probe >= prof.numel() * 4, f"the profiler saw {probe} bytes of a 51 MB copy")
    check(not big, f"check_points copied {big} bytes from the card to the host")
    t0 = time.perf_counter()
    host_check_points(prof, K_FULL)
    host_s = time.perf_counter() - t0
    nan = prof.clone()
    nan[77, 5] = float("nan")
    dup = prof[torch.arange(N_FULL, device=dev) % 300].clone()
    dup[:, 0] = 0.0
    dup[1::2, 0] = -0.0
    verdicts = {}
    for tag, x in (("points", prof), ("one NaN", nan), ("duplicate rows", dup)):
        want = host_check_points(x, K_FULL)
        try:
            health.check_points(x, K_FULL)
            got = None
        except PipelineError as e:
            got = e.detail
        check(got == want, f"check_points on {tag}: {got!r}, the host version {want!r}")
        verdicts[tag] = got
    del nan, dup
    log(f"[guard] check_points [{N_FULL} × {D_PROFILE}]: {ms:.2f} ms (events), {card_s:.4f} s "
        f"host clock; host version (copy + np.isfinite + np.unique rows) {host_s:.3f} s; "
        f"device→host copies above 1 KB: {len(big)} (the profiler saw the points' own copy: "
        f"{probe} bytes); verdicts equal to the host version's: {verdicts}")
    return dict(ms=ms, card_s=card_s, host_s=host_s, big_d2h=big, verdicts=verdicts)


def host_blockell(adj, block_rows: int = 8, width_quantile: float = 0.95,
                  lane_multiple: int = 8):
    """The reference's BlockELL layout (``src/repro/sparse/formats.py``:
    ``coo_to_csr`` then ``csr_to_blockell``) in numpy from a host copy of a
    row-sorted COO: ``(width, cols, vals, (tail row, col, val))``."""
    row, col, val = (a.cpu().numpy() for a in (adj.row, adj.col, adj.val))
    n = adj.shape[0]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n), out=indptr[1:])
    deg = np.diff(indptr)
    q = int(np.quantile(deg, width_quantile)) if n else lane_multiple
    width = max(lane_multiple, int(np.ceil(max(q, 1) / lane_multiple) * lane_multiple))
    pad_rows = -(-n // block_rows) * block_rows
    cols = np.zeros((pad_rows, width), np.int32)
    vals = np.zeros((pad_rows, width), val.dtype)
    nnz_row = np.repeat(np.arange(n, dtype=np.int64), deg)
    slot = np.arange(col.size, dtype=np.int64) - np.repeat(indptr[:-1], deg)
    body = slot < width
    cols[nnz_row[body], slot[body]] = col[body]
    vals[nnz_row[body], slot[body]] = val[body]
    spill = ~body
    if spill.any():
        tail = (nnz_row[spill], col[spill].astype(np.int64), val[spill])
    else:
        tail = (np.zeros(1, np.int64), np.zeros(1, np.int64), np.zeros(1, val.dtype))
    return width, cols, vals, tail


def blockell_phase(pos, prof) -> dict:
    """Both full graphs' BlockELL layouts: built on the card by
    ``SpectralPipeline.operator`` and in numpy from a host copy (the
    reference's host builder), held bitwise
    (width, slots, tail); times of both (the numpy build with its upload);
    host → device copies in ``operator`` (must be 0)."""
    out = {}
    for tag, make in (("first", main_pipeline), ("scalable", scalable_pipeline)):
        pipe = make(K_FULL)
        state = pipe.build_graph(prof, points=pos)
        m = pipe.operator(state).a
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        width, cols, vals, tail = host_blockell(state.adj)
        upload = (torch.from_numpy(cols).cuda(), torch.from_numpy(vals).cuda())
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        del upload
        same = (m.width == width
                and np.array_equal(m.cols.reshape(-1, m.width).cpu().numpy(), cols)
                and np.array_equal(m.vals.reshape(-1, m.width).cpu().numpy(), vals)
                and all(np.array_equal(a.cpu().numpy(), b)
                        for a, b in zip((m.tail.row, m.tail.col, m.tail.val), tail)))
        check(same, f"blockell ({tag} graph): the card's layout differs from the numpy build")
        ms = cuda_ms(lambda: pipe.operator(state), iters=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.operator(state)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        copies, _ = h2d_copies(lambda: pipe.operator(state))
        check(copies == 0, f"SpectralPipeline.operator copied {copies} tensors to the card")
        log(f"[blockell] {tag} graph: nnz={state.adj.nnz} W={m.width} rows={m.cols.shape[0] * m.block_rows} "
            f"tail={m.tail.nnz}: card build bitwise equal to the numpy build; card "
            f"{ms:.2f} ms (events), {card_s:.4f} s host clock; numpy build + upload "
            f"{host_s:.3f} s; host→device copies in operator: {copies}")
        out[tag] = dict(nnz=state.adj.nnz, width=m.width, tail=m.tail.nnz, ms=ms,
                        card_s=card_s, host_s=host_s, h2d_copies=copies)
        del state, m
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def knn_phase():
    """The ``knn_topk`` record, and the exact neighbours (ids, dist²) of the
    full-size lattice for the scalable path's recall."""
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
    # the kernel alone, on the wrapper's zero-padded input (3 real coordinates)
    xp = torch.nn.functional.pad(x, (0, 1)).contiguous()
    up = torch.nn.functional.pad(u, (0, 1)).contiguous()
    # warm events and cold device time (rotating over 24 copies of the padded
    # lattice, 55 MB) in turns: events, device, device, events
    copies = [(xp.clone(),) for _ in range(24)]
    turns = [cuda_ms(lambda: knn_topk_cuda(xp, xp, KNN_K, d=3), iters=10) if i in (0, 3) else
             device_ms(lambda q: knn_topk_cuda(q, q, KNN_K, d=3), copies, iters=5)
             for i in range(4)]
    del copies
    ms, cold_ms = 0.5 * (turns[0] + turns[3]), 0.5 * (turns[1] + turns[2])
    random_ms = cuda_ms(lambda: knn_topk_cuda(up, up, KNN_K, d=3), iters=10)

    def library():  # cdist + topk, chunked so one [chunk, n] tile is live
        out = []
        for s in range(0, N_FULL, 8192):
            d2 = torch.cdist(x[s:s + 8192], x) ** 2
            d2[torch.arange(d2.shape[0], device=dev), torch.arange(s, s + d2.shape[0],
                                                                   device=dev)] = math.inf
            out.append(torch.topk(d2, KNN_K, largest=False))
        return out

    library_ms = cuda_ms(library, iters=2)
    # bound in issue slots: the function needs d multiply-adds a pair
    # (‖c‖² − 2q·c, ‖c‖² in the padding lane, −2q formed once); the kernel's
    # direct form Σ (q − c)², d subtracts and d multiply-adds, is a choice
    # of this kernel (exact on the lattice) and takes twice that
    n_bytes = 2 * N_FULL * 3 * 4 + N_FULL * KNN_K * 8
    t_ops, t_bytes = issue_ms(float(N_FULL) * N_FULL * 3), n_bytes / PEAK_HBM_BYTES * 1e3
    bms, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"[kernel] knn_topk (tol: lattice exact; random rtol 1e-5, ids equal up to near-ties): "
        f"lattice n={N_FULL} k={KNN_K} ids equal, max|Δd|=0 "
        f"({ties} tied neighbour pairs); random: {swaps} ids swapped at "
        f"near-ties; kernel_ms={ms:.3f} (random points {random_ms:.3f}; device cold "
        f"{cold_ms:.3f}; in turns events/device/device/events "
        + " / ".join(f"{t:.3f}" for t in turns) + f") plain_ms={plain_ms:.1f} "
        f"library_ms={library_ms:.1f} bound_ms={bms:.3f} ({by}, in fp32 issue slots; the "
        f"direct form's {2 * t_ops:.3f})")
    return dict(name="knn_topk", route="cuda", source="src/repro_torch/csrc/knn_topk.cu",
                replaces="src/repro/kernels/knn_topk/kernel.py:91", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, random_ms=random_ms, device_cold_ms=cold_ms), (wi, wd)


def kmeans_phase() -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)

    def blobs(n, k, d, noise):  # tie-free: every point sits near its own centroid
        c = torch.randn(k, d, generator=gen)
        x = c[torch.randint(k, (n,), generator=gen)] + noise * torch.randn(n, d, generator=gen)
        return x.to(dev), c.to(dev)

    before = km_ops.kmeans_iter.launches
    # kmeans_assign's shapes: d not a multiple of 4, k not a multiple of the
    # 128-wide centroid tile, n = 1; the tile is shared, the epilogue is not
    for n, k, d in ((1, 1, 1), (1000, 37, 90), (513, 500, 33), (4097, 129, 257),
                    (1, 130, 500), (700, 65, 17), (3000, 130, 500)):
        hold_iter(*blobs(n, k, d, 0.05), f"n={n} k={k} d={d}")
    for n, k, d in ((2000, 300, 90), (3000, K_FULL, K_FULL)):
        x, c = blobs(n, k, d, 0.05)  # every centroid twice: exact ties across tiles
        hold_iter(x, torch.cat([c, c]), f"duplicated centroids k={k} d={d}")
    x, c = blobs(N_FULL, K_FULL, K_FULL, 0.02)
    err = hold_iter(x, c, "main shape")
    check(km_ops.kmeans_iter.launches == before + 10,
          "kmeans_iter wrapper did not launch its kernel")
    cn = (c * c).sum(1)
    ms = cuda_ms(lambda: kmeans_iter_cuda(x, c, cn), iters=10)
    plain_ms = cuda_ms(lambda: kmeans_iter_ref(x, c), iters=3)
    library_ms = cuda_ms(lambda: kmeans_library(x, c), iters=3)
    bms, by = kmeans_bound(iter_bytes(N_FULL, K_FULL, K_FULL))
    log(f"[kernel] kmeans_iter (tol: labels and counts exact, sums rtol 1e-5 atol 1e-4, "
        f"dmin atol 1e-5·(‖x‖²+‖c‖²)): n={N_FULL} k={K_FULL} d={K_FULL} labels and counts equal, "
        f"max|Δ| sums/dmin={err:.2e}; kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.3f} (a composition: chunked cdist + argmin + index_add_) "
        f"bound_ms={bms:.3f} ({by}, 3×TF32)")
    return dict(name="kmeans_iter", route="cuda", source="src/repro_torch/csrc/kmeans_iter.cu",
                replaces="src/repro/kernels/kmeans_iter/kernel.py:98", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def hold_spmm(m, x) -> float:
    """``ell_spmm`` through its wrapper against the plain gather plus the COO
    tail (rtol 1e-5, atol 1e-6); returns max|Δy|."""
    nb, br, w = m.cols.shape
    got = ell_ops.ell_spmm(m, x)
    want = ell_spmm_ref(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w))
    want = want[: m.shape[0]] + spmm_coo(m.tail, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    return float((got - want).abs().max())


def hold_spmv(m, x) -> float:
    """``ell_spmv`` through its wrapper against the plain gather plus the COO
    tail (rtol 1e-5, atol 1e-6); returns max|Δy|."""
    nb, br, w = m.cols.shape
    got = spmv_ops.ell_spmv(m, x)
    want = ell_spmv_ref(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w))
    want = want[: m.shape[0]] + spmv_coo(m.tail, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    return float((got - want).abs().max())


def cheb_coefs(dev):
    """A Chebyshev step's (ca, cb) as the filter passes them: device scalars."""
    return torch.tensor(1.98, device=dev), torch.tensor(-0.02, device=dev)


def hold_cheb(m, x, prev) -> float:
    """The fused Chebyshev step through its wrapper against the plain step
    plus ``ca·(A_tail x)`` (rtol 1e-5, atol 1e-5); returns max|Δy|."""
    ca, cb = cheb_coefs(x.device)
    nb, br, w = m.cols.shape
    got = ell_ops.ell_spmm_cheb_step(m, x, prev, ca, cb)
    want = ell_spmm_cheb_ref(x, m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w),
                             prev, ca, cb) + ca * spmm_coo(m.tail, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    return float((got - want).abs().max())


def hold_layout(tag: str, what: str, m, widths, spmv: bool = False, cheb_width=None) -> dict:
    """The sparse kernels a reduced path launches, held against their plain
    versions on the BlockELL layout that path built (its own row width and
    tail): ``ell_spmm`` at each of ``widths``, ``ell_spmv`` and the
    Chebyshev step at ``cheb_width`` where the path runs them."""
    dev = m.cols.device
    gen = torch.Generator().manual_seed(8)
    n = m.shape[0]

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    err = {f"ell_spmm b={b}": hold_spmm(m, randn(n, b)) for b in widths}
    if spmv:
        err["ell_spmv"] = hold_spmv(m, randn(n))
    if cheb_width is not None:
        err[f"ell_spmm_cheb b={cheb_width}"] = hold_cheb(m, randn(n, cheb_width),
                                                         randn(n, cheb_width))
    nb, br, w = m.cols.shape
    log(f"[{tag}] kernels on the {what} layout (rows={nb * br} W={w} tail={m.tail.nnz}) "
        f"against their plain versions: " + ", ".join(f"{k} max|Δy|={v:.2e}"
                                                     for k, v in err.items()))
    return dict(rows=nb * br, width=w, tail=m.tail.nnz, max_abs_err=err)


def ell_phase(pos, prof) -> dict:
    """``ell_spmm`` through its wrapper against the plain gather plus the COO
    tail: ragged small graphs, then the first path's BlockELL graph at
    b = 4 (Lanczos), 8 (the scalable path's moments) and 508 (its
    Rayleigh-Ritz product).  Timed at b = 4 and 8 warm (back to back on one
    copy of the slots) and cold (rotating over three copies, 137 MB, so that
    no launch finds its slots in the 50 MB L2, as the Lanczos loop meets
    them between its Gram-Schmidt GEMMs), in four turns that alternate the
    kernel and ``torch.sparse.mm`` (cold over three CSR copies), each with
    CUDA events and as device time (``device_ms``).  The record's ``ms`` and
    ``library_ms`` are the device-time cold means at b = 4."""
    dev = torch.device("cuda")
    from repro_torch.sparse import formats as tf

    rng = np.random.default_rng(3)
    before = ell_ops.ell_spmm.launches
    for n, b, width in ((100, 4, None), (257, 3, 8), (1000, 8, 16)):
        r, c = rng.integers(0, n, 12 * n), rng.integers(0, n, 12 * n)
        v = rng.random(12 * n).astype(np.float32)
        m = tf.csr_to_blockell(tf.coo_to_csr(tf.coo_from_edges(r, c, v, (n, n), device=dev)),
                               width=width)
        hold_spmm(m, torch.randn(n, b, device=dev))
    # main path: the normalized DTI kNN graph in the pipeline's BlockELL layout
    pipe = main_pipeline(K_FULL)
    state = pipe.build_graph(prof, points=pos)
    m = pipe.operator(state).a
    xs = {b: torch.randn(N_FULL, b, device=dev) for b in (4, 8)}
    err = {b: hold_spmm(m, x) for b, x in xs.items()}
    err[508] = hold_spmm(m, torch.randn(N_FULL, K_FULL + 8, device=dev))
    check(ell_ops.ell_spmm.launches == before + 6, "ell_spmm wrapper did not launch its kernel")
    nb, br, w = m.cols.shape
    cols, vals = m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w)
    plain_ms = cuda_ms(lambda: ell_spmm_ref(xs[4], cols, vals), iters=10)
    csrs = [_csr(state.adj) for _ in range(3)]
    copies = [(cols.clone(), vals.clone()) for _ in range(3)]
    rows = nb * br
    out = {}
    for b, x in xs.items():
        calls = dict(kernel=(ell_spmm_cuda, [(x, cols, vals)], [(x, *cv) for cv in copies]),
                     library=(torch.sparse.mm, [(csrs[0], x)], [(csr, x) for csr in csrs]))
        turns = {f"{who} {how}": [] for who in calls
                 for how in ("warm", "cold", "device warm", "device cold")}
        for turn in range(4):
            for who in tuple(calls)[::1 if turn % 2 == 0 else -1]:
                fn, one, three = calls[who]
                turns[f"{who} warm"].append(cold_ms(fn, one, iters=100))
                turns[f"{who} cold"].append(cold_ms(fn, three, iters=99))
                turns[f"{who} device warm"].append(device_ms(fn, one, iters=100))
                turns[f"{who} device cold"].append(device_ms(fn, three, iters=99))
        mean = {key: sum(v) / len(v) for key, v in turns.items()}
        bms, by = bound(rows * w * 8 + N_FULL * b * 4 + rows * b * 4, 2.0 * rows * w * b)
        out[b] = dict(turns=turns, mean=mean, bound_ms=bms, bound_by=by)
        log(f"[kernel] ell_spmm (tol: rtol 1e-5 atol 1e-6): rows={rows} W={w} b={b} "
            f"tail={m.tail.nnz} max|Δy|={err[b]:.2e}; kernel_ms device cold="
            f"{mean['kernel device cold']:.4f} warm={mean['kernel device warm']:.4f} (events: "
            f"cold {mean['kernel cold']:.4f}, warm {mean['kernel warm']:.4f}) library_ms "
            f"(torch.sparse.mm, CSR) device cold={mean['library device cold']:.4f} warm="
            f"{mean['library device warm']:.4f} (events: cold {mean['library cold']:.4f}, warm "
            f"{mean['library warm']:.4f}) bound_ms={bms:.4f} ({by})")
        for key, ts in turns.items():
            log(f"[kernel] ell_spmm b={b} turns, {key}: " + " / ".join(f"{t:.4f}" for t in ts)
                + " ms")
    del csrs, copies, calls
    log(f"[kernel] ell_spmm b={K_FULL + 8}: max|Δy|={err[508]:.2e} against the plain version; "
        f"plain_ms (b=4)={plain_ms:.3f}")
    return dict(name="ell_spmm", route="cuda", source="src/repro_torch/csrc/ell_spmm.cu",
                replaces="src/repro/kernels/ell_spmm/kernel.py:53", max_abs_err=max(err.values()),
                ms=out[4]["mean"]["kernel device cold"], plain_ms=plain_ms,
                bound_ms=out[4]["bound_ms"], bound_by=out[4]["bound_by"],
                library_ms=out[4]["mean"]["library device cold"], widths=out)


def _csr(adj):
    return torch.sparse_coo_tensor(torch.stack([adj.row, adj.col]), adj.val, adj.shape) \
        .coalesce().to_sparse_csr()


def hold_hash(x, planes):
    """``hash_codes`` through its wrapper against its plain version: codes
    equal wherever every projection is at least ``HASH_EPS`` from 0 in
    float64, tie-breaks at rtol 1e-5 (for d > 20, within the bound of two
    summation orders, and codes compared where every projection clears it).
    Returns (pairs near 0, codes that differ, max|Δtie|)."""
    gc, gt = lsh_ops.hash_codes(x, planes)
    wc, wt = hash_codes_ref(x, planes)
    proj = torch.einsum("nd,tdb->tnb", x.double(), planes.double())
    d = x.shape[1]
    if d <= 20:
        clear = (proj.abs() >= HASH_EPS)[..., :-1].all(-1)
        torch.testing.assert_close(gt, wt, rtol=1e-5, atol=1e-5)
    else:  # two fp32 sums of d terms in different orders differ by at
        # most 2(d + 1)·2⁻²⁴·Σ|terms|, above HASH_EPS at d = 90
        slack = 2 * (d + 1) * 2.0 ** -24 * torch.einsum(
            "nd,tdb->tnb", x.double().abs(), planes.double().abs())
        clear = (proj.abs() >= torch.clamp(slack, min=HASH_EPS))[..., :-1].all(-1)
        check(bool(((gt - wt).double().abs() <= slack[..., -1]).all()),
              "hash_codes: tie-breaks differ by more than two summation orders can")
    check(torch.equal(gc[clear], wc[clear]), "hash_codes: codes differ away from 0")
    return int((~clear).sum()), int((gc != wc).sum()), float((gt - wt).abs().max())


def hash_phase(pos) -> dict:
    """``hash_codes`` on the lattice positions with the scalable path's planes
    (16 tables of 16 bits, seed 0), after a grid of random shapes (d ∈ {1,
    3, 8, 9, 90}: the unrolled widths and the runtime-d form; 1 and 16
    tables; 1, 16 and 24 bits; n ragged). Codes are compared exactly wherever
    every projection is at least ``HASH_EPS`` from 0 in float64 (nearer, the
    two summation orders may take different signs); tie-breaks at rtol 1e-5.
    At d = 90 the difference two summation orders can make,
    2(d + 1)·2⁻²⁴·Σ|x_j·p_j|, exceeds both: codes are compared where every
    projection clears it, and tie-breaks must keep within it. Timed as device
    time cold (rotating over 8 copies of x, each launch writing its own 18 MB
    of outputs) and with events warm."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    before = lsh_ops.hash_codes.launches
    grid = list(itertools.product((1, 3, 8, 9, 90), (1, 16), (1, 16, 24)))
    for d, t, b in grid:
        hold_hash((torch.rand(1000 + 7 * d + t, d, generator=gen) * 50).to(dev),
                torch.randn(t, d, b + 1, generator=gen).to(dev))
    planes = lsh_ops.make_planes(3, LSH_TABLES, LSH_BITS, 0).to(dev)
    near, differ, err = hold_hash(pos, planes)
    check(lsh_ops.hash_codes.launches == before + len(grid) + 1,
          "hash_codes wrapper did not launch its kernel")
    copies = [(pos.clone(),) for _ in range(8)]
    ms = device_ms(lambda x: hash_codes_cuda(x, planes), copies, iters=80)
    warm_ms = cuda_ms(lambda: hash_codes_cuda(pos, planes), iters=50)
    plain_ms = cuda_ms(lambda: hash_codes_ref(pos, planes), iters=10)
    pows = 2 ** torch.arange(LSH_BITS, device=dev, dtype=torch.int32)

    def library(x):  # x @ P, then the pack
        proj = x @ planes  # [T, n, n_bits + 1]
        return ((proj[..., :-1] >= 0).int() * pows).sum(-1), proj[..., -1]

    library_ms = device_ms(library, copies, iters=80)
    library_warm_ms = cuda_ms(lambda: library(pos), iters=50)
    cols = LSH_BITS + 1
    n_bytes = N_FULL * 3 * 4 + LSH_TABLES * 3 * cols * 4 + LSH_TABLES * N_FULL * 8
    n_ops = 2.0 * N_FULL * LSH_TABLES * cols * 3
    bms, by = bound(n_bytes, n_ops)
    log(f"[kernel] hash_codes (tol: codes exact where every |proj| >= {HASH_EPS:g}, "
        f"tie rtol 1e-5; at d = 90 the bound of two summation orders): {len(grid)} random "
        f"shapes; n={N_FULL} d=3 T={LSH_TABLES} bits={LSH_BITS}: {near} (table, point) pairs "
        f"near 0, {differ} codes differ; "
        f"max|Δtie|={err:.2e}; kernel_ms device cold={ms:.4f} (events warm {warm_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms device cold={library_ms:.4f} (events warm "
        f"{library_warm_ms:.4f}) bound_ms={bms:.4f} ({by})")
    return dict(name="hash_codes", route="cuda", source="src/repro_torch/csrc/hash_codes.cu",
                replaces="src/repro/kernels/lsh_candidates/kernel.py:48", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                warm_events_ms=warm_ms)


def spmv_phase(state, op) -> dict:
    """``ell_spmv`` through ``BlockEllOperator.mv`` on the scalable path's
    BlockELL graph, against the plain gather plus the COO tail; widths 8, 12,
    24 and 40 at a row count that leaves the kernel a ragged last block.

    Timed warm (back to back on one copy of the slots, which nearly fill the
    L2) and cold (rotating over three copies, 137 MB), in four turns that
    alternate the kernel, ``torch.sparse.mm`` and a device copy of the same
    slot bytes (the card's streaming rate at this size, as a yardstick).
    The record's ``ms`` and ``library_ms`` are the cold means of device time
    (``device_ms``) — the slot stream from HBM, as the bound counts it,
    without the gaps a slow host leaves between launches of this length."""
    dev = torch.device("cuda")
    from repro_torch.sparse import formats as tf

    rng = np.random.default_rng(5)
    before = spmv_ops.ell_spmv.launches
    for n, width in ((100, None), (257, 8), (3001, 8), (3001, 12), (3001, 24), (3001, 40)):
        r, c = rng.integers(0, n, 12 * n), rng.integers(0, n, 12 * n)
        v = rng.random(12 * n).astype(np.float32)
        hold_spmv(tf.csr_to_blockell(tf.coo_to_csr(tf.coo_from_edges(r, c, v, (n, n),
                                                                     device=dev)),
                                     width=width), torch.randn(n, device=dev))
    m = op.a
    x = torch.randn(N_FULL, device=dev)
    err = hold_spmv(m, x)
    # the same function (the tail's index-add sums in a varying order)
    torch.testing.assert_close(op.mv(x), spmv_ops.ell_spmv(m, x), rtol=1e-6, atol=1e-7)
    check(spmv_ops.ell_spmv.launches == before + 9, "ell_spmv wrapper did not launch its kernel")
    nb, br, w = m.cols.shape
    cols, vals = m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w)
    plain_ms = cuda_ms(lambda: ell_spmv_ref(x, cols, vals), iters=20)
    csr, xc = _csr(state.adj), x[:, None]
    slots = [(x, cols.clone(), vals.clone()) for _ in range(3)]
    csrs = [(_csr(state.adj), xc) for _ in range(3)]
    dst = (torch.empty_like(cols), torch.empty_like(vals))

    def copy(_, c, v):  # reads and writes the slot bytes once
        dst[0].copy_(c)
        dst[1].copy_(v)

    turns = dict(warm=[], cold=[], device_cold=[], library_warm=[], library_cold=[],
                 library_device_cold=[], copy=[])
    for turn in range(4):
        for who in ("kernel", "library", "copy")[::1 if turn % 2 == 0 else -1]:
            if who == "library":
                turns["library_warm"].append(cuda_ms(lambda: torch.sparse.mm(csr, xc),
                                                     iters=100))
                turns["library_cold"].append(cold_ms(torch.sparse.mm, csrs, iters=99))
                turns["library_device_cold"].append(device_ms(torch.sparse.mm, csrs, iters=99))
            elif who == "copy":
                turns["copy"].append(cold_ms(copy, slots, iters=99))
            else:
                turns["warm"].append(cuda_ms(lambda: ell_spmv_cuda(x, cols, vals), iters=100))
                turns["cold"].append(cold_ms(ell_spmv_cuda, slots, iters=99))
                turns["device_cold"].append(device_ms(ell_spmv_cuda, slots, iters=99))
    clock = sm_clock()
    single = launch_ms(ell_spmv_cuda, slots, iters=300)
    del slots, csrs, dst
    mean = {key: sum(v) / len(v) for key, v in turns.items()}
    q = {f"p{p}": single[min(len(single) - 1, len(single) * p // 100)] for p in (0, 10, 50, 90)}
    q["max"] = single[-1]
    rows = nb * br
    bms, by = bound(rows * w * 8 + N_FULL * 4 + rows * 4, 2.0 * rows * w)
    log(f"[kernel] ell_spmv (tol: rtol 1e-5 atol 1e-6): rows={rows} W={w} tail={m.tail.nnz} "
        f"max|Δy|={err:.2e}; kernel_ms device cold={mean['device_cold']:.4f} (events: cold "
        f"{mean['cold']:.4f}, warm {mean['warm']:.4f}) plain_ms={plain_ms:.4f} library_ms "
        f"(torch.sparse.mm, CSR) device cold={mean['library_device_cold']:.4f} (events: cold "
        f"{mean['library_cold']:.4f}, warm {mean['library_warm']:.4f}) bound_ms={bms:.4f} "
        f"({by})")
    for key, ts in turns.items():
        log(f"[kernel] ell_spmv turns, {key}: " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
            + (f" ({2 * rows * w * 8 / (sum(ts) / len(ts)) / 1e9:.2f} TB/s)"
               if key == "copy" else ""))
    log(f"[kernel] ell_spmv single cold launches (300, each between its own events): "
        + " ".join(f"{key}={v:.4f}" for key, v in q.items()) + f" ms; clocks.sm, power.draw "
        f"after the turns: {clock}")
    return dict(name="ell_spmv", route="cuda", source="src/repro_torch/csrc/ell_spmv.cu",
                replaces="src/repro/kernels/ell_spmv/kernel.py:37", max_abs_err=err,
                ms=mean["device_cold"], plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=mean["library_device_cold"], turns=turns, single_cold=q)


def cheb_step_phase(state, op) -> dict:
    """The fused Chebyshev step through ``BlockEllOperator.cheb_step`` at the
    filter's width (R = 500 + 8 = 508), against the plain step plus
    ``ca·(A_tail x)``; (ca, cb) are device scalars, as in the filter."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    r = K_FULL + 8
    ca, cb = cheb_coefs(dev)
    from repro_torch.sparse import formats as tf
    rng = np.random.default_rng(7)
    before = ell_ops.ell_spmm_cheb_step.launches
    # b = 4 (one lane a row), 3 and 515 (padded; a last slab of one column
    # group), and W = 600, too wide to stage a band's slots in shared memory
    for n, b, width in ((100, 4, None), (257, 3, 8), (1000, 12, 16), (301, 515, 24),
                        (300, 508, 600)):
        rr, c = rng.integers(0, n, 12 * n), rng.integers(0, n, 12 * n)
        v = rng.random(12 * n).astype(np.float32)
        m = tf.csr_to_blockell(tf.coo_to_csr(tf.coo_from_edges(rr, c, v, (n, n), device=dev)),
                               width=width)
        hold_cheb(m, torch.randn(n, b, device=dev), torch.randn(n, b, device=dev))
    m = op.a
    x = torch.randn(N_FULL, r, generator=gen).to(dev)
    prev = torch.randn(N_FULL, r, generator=gen).to(dev)
    err = hold_cheb(m, x, prev)
    torch.testing.assert_close(op.cheb_step(x, prev, ca, cb),
                               ell_ops.ell_spmm_cheb_step(m, x, prev, ca, cb),
                               rtol=1e-6, atol=1e-6)
    check(ell_ops.ell_spmm_cheb_step.launches == before + 8,
          "ell_spmm_cheb_step wrapper did not launch its kernel")
    nb, br, w = m.cols.shape
    cols, vals = m.cols.reshape(nb * br, w), m.vals.reshape(nb * br, w)
    coef = torch.stack([ca, cb])
    ms = cuda_ms(lambda: ell_spmm_cheb_cuda(x, cols, vals, prev, coef), iters=20)
    # cold: device time rotating over three copies of the slots (x and prev,
    # 290 MB each, are read from HBM at any rate)
    cold_ms = device_ms(lambda c, v: ell_spmm_cheb_cuda(x, c, v, prev, coef),
                        [(cols.clone(), vals.clone()) for _ in range(3)], iters=12)
    plain_ms = cuda_ms(lambda: ell_spmm_cheb_ref(x, cols, vals, prev, ca, cb), iters=3)
    csr = _csr(state.adj)
    library_ms = cuda_ms(lambda: ca * torch.sparse.mm(csr, x) + cb * x - prev, iters=10)
    rows = nb * br
    n_bytes = rows * w * 8 + 3 * N_FULL * r * 4  # slots; x, prev read and y written once
    bms, by = bound(n_bytes, 2.0 * rows * w * r + 3.0 * N_FULL * r)
    log(f"[kernel] ell_spmm_cheb (tol: rtol 1e-5 atol 1e-5): rows={rows} W={w} b={r} "
        f"tail={m.tail.nnz} max|Δy|={err:.2e}; kernel_ms={ms:.4f} (device cold "
        f"{cold_ms:.4f}) plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} (torch.sparse.mm, CSR, + the AXPYs) "
        f"bound_ms={bms:.4f} ({by})")
    return dict(name="ell_spmm_cheb", route="cuda", source="src/repro_torch/csrc/ell_spmm.cu",
                replaces="src/repro/kernels/ell_spmm/kernel.py:79", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                device_cold_ms=cold_ms)


def assign_phase() -> dict:
    """``kmeans_assign`` on tie-free blobs: ragged shapes (d not a multiple
    of 4, k not a multiple of the 128-wide centroid tile, n = 1), every
    centroid duplicated across tiles, and the embedding's shape (n = 142,541
    rows of width 500, 500 centroids)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8)

    def blobs(n, k, d, noise):
        c = torch.randn(k, d, generator=gen)
        x = c[torch.randint(k, (n,), generator=gen)] + noise * torch.randn(n, d, generator=gen)
        return x.to(dev), c.to(dev)

    def compare(x, c, tag):
        gl, gd = ka_ops.kmeans_assign(x, c)
        wl, wd = kmeans_assign_ref(x, c)
        check(torch.equal(gl, wl), f"kmeans_assign labels differ ({tag})")
        scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
        torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)
        return float((gd - wd).abs().max())

    before = ka_ops.kmeans_assign.launches
    for n, k, d in ((1, 1, 1), (1000, 37, 90), (513, 500, 33), (4097, 129, 257),
                    (1, 130, 500), (700, 65, 17), (3000, 130, 500)):
        compare(*blobs(n, k, d, 0.05), f"n={n} k={k} d={d}")
    for n, k, d in ((2000, 300, 90), (3000, K_FULL, K_FULL)):
        x, c = blobs(n, k, d, 0.05)  # every centroid twice: exact ties across tiles
        compare(x, torch.cat([c, c]), f"duplicated centroids k={k} d={d}")
    x, c = blobs(N_FULL, K_FULL, K_FULL, 0.02)
    err = compare(x, c, "main shape")
    check(ka_ops.kmeans_assign.launches == before + 10,
          "kmeans_assign wrapper did not launch its kernel")
    cn = (c * c).sum(1)
    # the assignment and the fused iteration (its superset) on these inputs,
    # in turns: assign, iter, iter, assign
    turns = [cuda_ms(lambda: fn(x, c, cn), iters=10)
             for fn in (kmeans_assign_cuda, kmeans_iter_cuda, kmeans_iter_cuda,
                        kmeans_assign_cuda)]
    ms = 0.5 * (turns[0] + turns[3])
    plain_ms = cuda_ms(lambda: kmeans_assign_ref(x, c), iters=3)

    def library():  # chunked cdist + min
        return [torch.cdist(x[s:s + 16384], c).min(1) for s in range(0, N_FULL, 16384)]

    library_ms = cuda_ms(library, iters=3)
    n_bytes = (N_FULL * K_FULL + K_FULL * K_FULL + K_FULL) * 4 + N_FULL * 8
    bms, by = kmeans_bound(n_bytes)
    flops = 2.0 * N_FULL * K_FULL * K_FULL
    log(f"[kernel] kmeans_assign (tol: labels exact, dmin atol 1e-5·(‖x‖²+‖c‖²)): n={N_FULL} "
        f"k={K_FULL} d={K_FULL} labels equal, max|Δdmin|={err:.2e}; kernel_ms={ms:.4f} "
        f"({flops / ms / 1e9:.1f} TFLOP/s of fp32-accurate products, "
        f"{3 * flops / ms / 1e9:.1f} TFLOP/s on the tensor cores) "
        f"plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} (chunked cdist + min) "
        f"bound_ms={bms:.4f} ({by}, 3×TF32); in turns assign/iter/iter/assign on these inputs: "
        + " / ".join(f"{t:.4f}" for t in turns) + f" ms (iter − assign "
        f"{0.5 * (turns[1] + turns[2]) - ms:.4f} ms: the accumulation epilogue and its zero fill)")
    return dict(name="kmeans_assign", route="cuda",
                source="src/repro_torch/csrc/kmeans_assign.cu",
                replaces="src/repro/kernels/kmeans_assign/kernel.py:61", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def hold_iter_near_ties(x, c, tag: str):
    """``kmeans_iter`` through its wrapper against its plain version on real
    data: dmin at 1e-5·(‖x‖²+‖c‖²), a label may differ only at a float64
    near-tie within that, counts and sums those of the kernel's own labels.
    Returns (the differing rows, the largest gap, the scale)."""
    gl, gd, gs, gn = km_ops.kmeans_iter(x, c)
    wl, wd, _, _ = kmeans_iter_ref(x, c)
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)
    rows = torch.nonzero(gl != wl)[:, 0]
    x64, c64 = x[rows].double(), c.double()
    d_got = ((x64 - c64[gl[rows].long()]) ** 2).sum(1)
    d_want = ((x64 - c64[wl[rows].long()]) ** 2).sum(1)
    gap = float((d_got - d_want).abs().max()) if rows.numel() else 0.0
    check(gap <= 1e-5 * scale, f"kmeans_iter {tag}: a differing label is not a "
                               f"near-tie (float64 gap {gap:.3e})")
    own = gl.long()
    check(torch.equal(gn, torch.bincount(own, minlength=c.shape[0]).float()),
          f"kmeans_iter {tag}: counts are not those of its labels")
    torch.testing.assert_close(gs, torch.zeros_like(gs).index_add_(0, own, x), rtol=1e-5,
                               atol=1e-4)
    return rows, gap, scale


def iter_on_embedding(emb, labels) -> dict:
    """``kmeans_iter`` against its plain version on real data: the first
    path's final embedding and the centroids of its final labels.  A label
    may differ only at a near-tie (as for ``kmeans_assign``); counts and
    sums are those of the kernel's own labels.  Then the iteration and the
    assignment in turns on these inputs (iter, assign, assign, iter): the
    difference is the accumulation epilogue's exposed time, here on rows in
    voxel order, where neighbouring rows often share a label."""
    x = emb.float().contiguous()
    c = tkm.update_centroids(x, labels, K_FULL, torch.zeros(K_FULL, x.shape[1], device=x.device))
    rows, gap, scale = hold_iter_near_ties(x, c, "on the embedding")
    cn = (c * c).sum(1)
    turns = [cuda_ms(lambda: fn(x, c, cn), iters=10)
             for fn in (kmeans_iter_cuda, kmeans_assign_cuda, kmeans_assign_cuda,
                        kmeans_iter_cuda)]
    log(f"[kernel] kmeans_iter on the first path's embedding [{x.shape[0]} × {x.shape[1]}] and "
        f"final centroids: {rows.numel()} labels differ from the plain version, each a near-tie "
        f"in float64 (largest gap {gap:.3e}, gate {1e-5 * scale:.3e}); counts and sums those "
        f"of its labels; in turns iter/assign/assign/iter: "
        + " / ".join(f"{t:.4f}" for t in turns) + " ms")
    return dict(differing=int(rows.numel()), max_gap=gap, turns=turns)


def assign_on_embedding(emb, labels) -> dict:
    """``kmeans_assign`` against its plain version on real data: the
    scalable path's final embedding and the centroids of its final labels.
    A label may differ only at a near-tie: the two centroids' float64
    distances to the row agree within 1e-5·(‖x‖²+‖c‖²), the dmin gate."""
    x = emb.float().contiguous()
    c = tkm.update_centroids(x, labels, K_FULL, torch.zeros(K_FULL, x.shape[1], device=x.device))
    gl, gd = ka_ops.kmeans_assign(x, c)
    wl, wd = kmeans_assign_ref(x, c)
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    torch.testing.assert_close(gd, wd, rtol=0, atol=1e-5 * scale)
    rows = torch.nonzero(gl != wl)[:, 0]
    x64, c64 = x[rows].double(), c.double()
    d_got = ((x64 - c64[gl[rows].long()]) ** 2).sum(1)
    d_want = ((x64 - c64[wl[rows].long()]) ** 2).sum(1)
    gap = float((d_got - d_want).abs().max()) if rows.numel() else 0.0
    check(gap <= 1e-5 * scale, f"kmeans_assign on the embedding: a differing label is not a "
                               f"near-tie (float64 gap {gap:.3e})")
    log(f"[kernel] kmeans_assign on the scalable path's embedding [{x.shape[0]} × {x.shape[1]}] "
        f"and final centroids: {rows.numel()} labels differ from the plain version, each a "
        f"near-tie in float64 (largest gap {gap:.3e}, gate {1e-5 * scale:.3e})")
    return dict(differing=int(rows.numel()), max_gap=gap)


# ---------------------------------------------------------------------------
# phases 4-5: the pipeline
# ---------------------------------------------------------------------------

def main_pipeline(n_clusters: int) -> SpectralPipeline:
    return SpectralPipeline(
        n_clusters=n_clusters,
        graph=GraphConfig(knn_k=KNN_K, measure="cross_correlation"),
        eig=EigConfig(tol=1e-4, block_size=4, representation="blockell"),
        kmeans=KMeansConfig(iter="fused"))


def scalable_pipeline(n_clusters: int) -> SpectralPipeline:
    """``examples/dti_pointcloud.py --graph-method lsh --solver chebyshev
    --kmeans-iter two_pass``: 16 tables of 16 bits, m = 1536 candidates;
    degree-64 filter on R = k + 8 signals, λ_cut by bisection."""
    return SpectralPipeline(
        n_clusters=n_clusters,
        graph=GraphConfig(knn_k=KNN_K, measure="cross_correlation", method="lsh"),
        eig=EigConfig(tol=1e-4, solver="chebyshev", representation="blockell"),
        kmeans=KMeansConfig(iter="two_pass"))


def sparsify_pipeline(n_clusters: int) -> SpectralPipeline:
    """The first path with the sparsify stage: 40 % of the graph's entries."""
    return dataclasses.replace(main_pipeline(n_clusters),
                               stages=("prepare", "sparsify", "embed", "cluster"),
                               sparsify=red.SparsifyConfig(target_nnz_ratio=0.4))


def coarsen_pipeline(n_clusters: int) -> SpectralPipeline:
    """The scalable path with coarsen and refine: one level of heavy-edge
    matching (2 rounds), 2 smoothing products on the fine graph."""
    return dataclasses.replace(scalable_pipeline(n_clusters),
                               stages=("prepare", "coarsen", "embed", "refine", "cluster"),
                               coarsen=red.CoarsenConfig())


STAGES = ("prepare", "sparsify", "coarsen", "embed", "refine", "cluster")


class StageClock:
    """Times every stage of the pipelines run inside it (host clock between
    synchronisations) and keeps the output state of the stages in ``keep``."""

    def __init__(self, keep=()):
        self.walls, self.states, self.keep = {}, {}, keep

    def __enter__(self):
        self.saved = {name: getattr(SpectralPipeline, f"_stage_{name}") for name in STAGES}
        for name, fn in self.saved.items():
            def timed(pipe, st, _fn=fn, _name=name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(pipe, st)
                torch.cuda.synchronize()
                self.walls[_name] = time.perf_counter() - t0
                if _name in self.keep:
                    self.states[_name] = out
                return out

            setattr(SpectralPipeline, f"_stage_{name}", timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(SpectralPipeline, f"_stage_{name}", fn)


COUNTERS = (("knn_topk", knn_ops.knn_topk), ("ell_spmm", ell_ops.ell_spmm),
            ("kmeans_iter", km_ops.kmeans_iter), ("ell_spmv", spmv_ops.ell_spmv),
            ("ell_spmm_cheb", ell_ops.ell_spmm_cheb_step),
            ("kmeans_assign", ka_ops.kmeans_assign), ("hash_codes", lsh_ops.hash_codes))
MAIN_KERNELS = ("knn_topk", "ell_spmm", "kmeans_iter")
SCALABLE_KERNELS = ("hash_codes", "ell_spmv", "ell_spmm_cheb", "kmeans_assign")
COARSEN_KERNELS = ("hash_codes", "ell_spmv", "ell_spmm", "ell_spmm_cheb", "kmeans_assign")


def drive(pipe, pos, prof, region, tag: str, kernels, keep=()):
    """One full-size run of ``pipe`` with every launch counter zeroed just
    before and read just after and every stage timed; fails unless each of
    ``kernels`` launched and the outputs are finite and in range.  Returns
    the result, the record and the stage clock (with the output states of
    the stages in ``keep``)."""
    for _, fn in COUNTERS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with StageClock(keep) as clock:
        t0 = time.perf_counter()
        state = pipe.run_state(prof, torch.Generator().manual_seed(0), points=pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in COUNTERS}
    res = state.result
    for name in kernels:
        check(launches[name] > 0, f"{tag} path never launched {name}")
    check(bool(torch.isfinite(res.embedding).all()), f"{tag}: non-finite embedding")
    check(bool(torch.isfinite(res.eigenvalues).all()), f"{tag}: non-finite eigenvalues")
    check(bool(torch.isfinite(res.kmeans_inertia)), f"{tag}: non-finite inertia")
    labels = res.labels.cpu().numpy()
    check(labels.shape == (N_FULL,) and labels.min() >= 0 and labels.max() < K_FULL,
          f"{tag}: labels out of range")
    ev = res.eigenvalues
    check(bool(((ev >= -1e-3) & (ev <= 2.0 + 1e-3)).all()),
          f"{tag}: Laplacian eigenvalues outside [0, 2]")
    reports = [r.to_dict() for r in res.reports]
    live = int(np.unique(labels).size)
    pur = purity(labels, region)
    log(f"[{tag}] n={N_FULL} clusters={K_FULL}: points→labels {wall:.2f} s; stages "
        + ", ".join(f"{name} {t:.3f} s" for name, t in clock.walls.items())
        + f"; provenance {state.provenance}")
    log(f"[{tag}] kmeans iterations={res.kmeans_iterations} non-empty={live}/{K_FULL} "
        f"purity={pur:.4f} cluster escalations={reports[2]['escalations']}")
    log(f"[{tag}] launches {launches}; peak device memory allocated {peak_gb:.3f} GB")
    return res, dict(wall_s=wall, peak_gb=peak_gb, reports=reports, stage_walls=clock.walls,
                     kmeans_iterations=res.kmeans_iterations, non_empty=live, purity=pur,
                     launches=launches, eig_min=float(ev.min()), eig_max=float(ev.max()),
                     reductions=[i._asdict() for i in state.reductions]), clock


def main_path(pos, prof, region):
    res, rec, _ = drive(main_pipeline(K_FULL), pos, prof, region, "main", MAIN_KERNELS)
    emb = rec["reports"][1]
    log(f"[main] lanczos restarts={res.lanczos_restarts} converged={emb['converged']} "
        f"residual_max={emb['residual_max']:.3e} attempts={emb['attempts']} "
        f"escalations={emb['escalations']}")
    rec["restarts"] = res.lanczos_restarts
    rec["iter_on_embedding"] = iter_on_embedding(res.embedding, res.labels)
    np.save(ROOT / "chiprun_out" / "main_labels.npy", res.labels.cpu().numpy())
    return res, rec


class CutSpy:
    """Records the spectral interval and the mapped cut of the Chebyshev
    solver's last run, to report λ_cut (the solver returns Ritz pairs only)."""

    def __enter__(self):
        self.saved = cheb.estimate_spectral_bounds, cheb.find_cut_from_moments
        bounds, cut = self.saved

        def spy_bounds(*a, **kw):
            self.lo, self.hi = bounds(*a, **kw)
            return self.lo, self.hi

        def spy_cut(*a, **kw):
            self.a = cut(*a, **kw)
            return self.a

        cheb.estimate_spectral_bounds, cheb.find_cut_from_moments = spy_bounds, spy_cut
        return self

    def __exit__(self, *exc):
        cheb.estimate_spectral_bounds, cheb.find_cut_from_moments = self.saved

    def laplacian_cut(self) -> float:
        """λ_cut in Laplacian units (1 − the adjacency's passband edge)."""
        lo, hi, a = float(self.lo), float(self.hi), float(self.a)
        return 1.0 - (a * (hi - lo) + (hi + lo)) / 2.0


def scalable_path(pos, prof, region, exact, first):
    """The scalable path at full size, then LSH recall@16 against the exact
    kNN of the lattice and agreement with the first path's labels."""
    pipe = scalable_pipeline(K_FULL)
    with CutSpy() as spy:
        res, rec, _ = drive(pipe, pos, prof, region, "scalable", SCALABLE_KERNELS)
    rec["assign_on_embedding"] = assign_on_embedding(res.embedding, res.labels)
    np.save(ROOT / "chiprun_out" / "scalable_labels.npy", res.labels.cpu().numpy())
    emb = rec["reports"][1]
    lam_cut = spy.laplacian_cut()
    fell_back = "fallback_lanczos" in emb["escalations"]
    log(f"[scalable] chebyshev λ_cut={lam_cut:.6f} (Laplacian units; interval "
        f"[{float(spy.lo):.5f}, {float(spy.hi):.5f}]) residual_max={emb['residual_max']:.3e} "
        f"attempts={emb['attempts']} escalations={emb['escalations']}"
        + (" — FELL BACK TO LANCZOS" if fell_back else ""))
    # Stage 1's neighbours once more, outside the timed run, for recall
    g = pipe.graph
    cand = lsh_ops.lsh_candidates(pos, m=lsh_ops.default_candidates(KNN_K, g.n_tables),
                                  n_tables=g.n_tables, n_bits=g.n_bits, seed=g.lsh_seed)
    ld, li = knn_ops.knn_topk_rerank(pos, cand, KNN_K)
    ei, ed = exact
    recall_ids = float((li[:, :, None] == ei[:, None, :]).any(-1).float().mean())
    recall_dist = float((ld == ed).float().mean())  # tie-aware: the same k-th distances
    first_res, first_rec = first
    ari = adjusted_rand_index(res.labels, first_res.labels)
    log(f"[scalable] LSH recall@{KNN_K} against the exact kNN: ids {recall_ids:.5f}, "
        f"distances {recall_dist:.5f} (a tied neighbour of another id counts for distances)")
    log(f"[scalable] purity {rec['purity']:.4f} (first path {first_rec['purity']:.4f}); "
        f"ARI between the two paths' labels {ari:.4f}")
    rec.update(lambda_cut=lam_cut, fell_back_to_lanczos=fell_back, recall_ids=recall_ids,
               recall_dist=recall_dist, ari_vs_first=ari)
    return res, rec


def reduced_path(tag, pipe, kernels, pos, prof, region, base) -> dict:
    """A reduced path at full width against its unreduced path ``base``
    (result, record) from this run: sizes before and after, purity (gate:
    no worse than the base's less 0.02), ARI of the labels and top-k
    eigenvalue drift against the base's.  sparsify must keep exactly
    2·target_upper_count(nnz, ratio) entries; coarsen must leave at most
    0.95·n nodes and a prolongation that is a partition onto [0, n_after).
    After the run, each sparse kernel is held against its plain version on
    the layouts this path built and at the widths it gives them: the
    sparsified graph at the Lanczos block; the coarse graph at the moment
    probes' and the sketch's widths, its SpMV and its Chebyshev step; the
    fine graph at refine's embedding width."""
    res, rec, clock = drive(pipe, pos, prof, region, tag, kernels,
                            keep=("sparsify", "coarsen"))
    base_res, base_rec = base
    info = rec["reductions"][0]
    if info["kind"] == "sparsify":
        want = 2 * red.target_upper_count(info["nnz_before"], pipe.sparsify.target_nnz_ratio)
        check(info["nnz_after"] == want,
              f"{tag}: kept {info['nnz_after']} entries, not 2·target_upper_count = {want}")
        graph = clock.states.pop("sparsify").graph
        rec["layouts"] = dict(sparsified=hold_layout(
            tag, "sparsified", pipe.operator(graph).a, (pipe.eig.block_size,)))
    else:
        n_after = info["n_after"]
        check(n_after <= 0.95 * info["n_before"], f"{tag}: {n_after} nodes left of {N_FULL}")
        st = clock.states.pop("coarsen")
        prolong = st.reduction.prolong
        sizes = torch.bincount(prolong, minlength=n_after)
        check(prolong.shape == (N_FULL,) and int(prolong.min()) == 0
              and int(prolong.max()) == n_after - 1 and bool((sizes > 0).all()),
              f"{tag}: the prolongation is not a partition onto [0, {n_after})")
        rec["coarse_sizes"] = torch.bincount(sizes).tolist()
        ccfg = pipe._cheb_config(n_after)
        r = cheb.resolved_signals(ccfg)
        rec["layouts"] = dict(
            coarse=hold_layout(tag, "coarse", pipe.operator(st.graph).a, (ccfg.n_probes, r),
                               spmv=True, cheb_width=r),
            fine=hold_layout(tag, "fine", pipe.operator(st.reduction.fine_graph).a,
                             (res.embedding.shape[1],)))
        del st
    ari = adjusted_rand_index(res.labels, base_res.labels)
    drift = red.topk_eigenvalue_drift(base_res.eigenvalues, res.eigenvalues, K_FULL)
    emb = rec["reports"][1]
    log(f"[{tag}] {info['kind']}: n {info['n_before']}→{info['n_after']}, nnz "
        f"{info['nnz_before']}→{info['nnz_after']}; purity {rec['purity']:.4f} (unreduced "
        f"{base_rec['purity']:.4f}); ARI against the unreduced path's labels {ari:.4f}; top-"
        f"{K_FULL} eigenvalue drift {drift:.4e}; embed attempts={emb['attempts']} "
        f"escalations={emb['escalations']} residual_max={emb['residual_max']:.3e}"
        + (f"; coarse node sizes (count of coarse nodes of each size) {rec['coarse_sizes']}"
           if "coarse_sizes" in rec else ""))
    check(rec["purity"] >= base_rec["purity"] - 0.02,
          f"{tag}: purity {rec['purity']:.4f} below the unreduced path's "
          f"{base_rec['purity']:.4f} less 0.02")
    rec.update(ari_vs_unreduced=ari, eig_drift=drift)
    return rec


def resume_phase(pos, prof, first_res) -> dict:
    """The first path at full width, stopped after ``prepare`` by a forced
    ``PipelineError`` in ``embed``: ``run_stages`` saves the completed
    prefix (``state_io.save_state``) under ``build/``; ``run(resume_from=)``
    loads it onto the card (``load_state``) and runs embed and cluster.
    Gate: labels ARI ≥ 0.99 against the uninterrupted run of this script
    (the fused k-means epilogue's atomic adds keep the two from being
    bitwise equal)."""
    import shutil

    pipe = main_pipeline(K_FULL)
    ckpt = ROOT / "build" / "resume_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    embed = SpectralPipeline._stage_embed

    def fail(self, st):
        raise PipelineError("embed", "forced failure (chip_smoke resume phase)")

    SpectralPipeline._stage_embed = fail
    t0 = time.perf_counter()
    try:
        pipe.run_state(prof, torch.Generator().manual_seed(0), points=pos,
                       checkpoint_dir=str(ckpt))
        raise SmokeFailure("resume: the forced failure did not raise")
    except PipelineError as e:
        check(getattr(e, "checkpoint", None) == str(ckpt), "resume: no checkpoint saved")
    finally:
        SpectralPipeline._stage_embed = embed
    saved_s = time.perf_counter() - t0
    size_mb = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file()) / 1e6
    t0 = time.perf_counter()
    state = pipe.run_state(resume_from=str(ckpt))
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    labels = state.result.labels
    check(labels.device.type == "cuda", "resume: the resumed run left the card")
    ari = adjusted_rand_index(labels, first_res.labels)
    same = bool(torch.equal(labels, first_res.labels))
    log(f"[resume] first path: prepare + checkpoint {saved_s:.2f} s ({size_mb:.1f} MB under "
        f"build/); resume (load + embed + cluster) {resumed_s:.2f} s; provenance "
        f"{state.provenance}; ARI against the uninterrupted run {ari:.4f}; labels bitwise "
        f"equal: {same}")
    check(ari >= 0.99, f"resume: ARI {ari:.4f} < 0.99 against the uninterrupted run")
    return dict(saved_s=saved_s, size_mb=size_mb, resumed_s=resumed_s, ari=ari, bitwise=same)


# card runs of each end-to-end check: the card's atomic sums round differently
# from run to run, so one card run that agrees with the CPU can be a lucky one
CARD_RUNS = 4


def end_to_end(make_pipe, tag: str, ev_tol: float) -> dict:
    """n = 4000, 12 clusters: the card against the CPU from one seed.  Each
    of ``CARD_RUNS`` card runs is held to the one CPU run; whether each
    run's labels and degrees are bitwise the first card run's is printed
    too."""
    k = 12
    out = {}
    for dev in ["cpu"] + ["cuda"] * CARD_RUNS:
        pos, prof, _, region = dti_like_pointcloud(4000, 90, max(k // 2, 4), eps=1.8, seed=0,
                                                   neighbors="none", device=dev)
        t0 = time.perf_counter()
        st = make_pipe(k).run_state(prof, torch.Generator().manual_seed(0), points=pos,
                                    device=dev)
        out.setdefault(dev, []).append((st, time.perf_counter() - t0,
                                        purity(st.result.labels, region)))
    cpu, cpu_s, cpu_pur = out["cpu"][0]
    first = out["cuda"][0][0]
    runs = []
    for i, (st, card_s, card_pur) in enumerate(out["cuda"]):
        res = st.result
        ari = adjusted_rand_index(res.labels, cpu.result.labels)
        diff = (res.eigenvalues.cpu() - cpu.result.eigenvalues).abs()
        dev_ev = float(diff.max())
        log(f"[{tag}] n=4000 k={k} (card run {i}): card {card_s:.2f} s vs CPU {cpu_s:.2f} s; "
            f"ARI={ari:.4f} max|Δλ|={dev_ev:.2e} (at λ_{int(diff.argmax())}) purity "
            f"card={card_pur:.3f} cpu={cpu_pur:.3f}")
        log(f"[{tag}] card run {i}: labels bitwise those of card run 0: "
            f"{bool(torch.equal(res.labels, first.result.labels))}; degrees: "
            f"{bool(torch.equal(st.graph.deg, first.graph.deg))}")
        runs.append(dict(ari=ari, max_eig_diff=dev_ev, card_s=card_s))
    for dev, st in (("cuda", first), ("cpu", cpu)):
        res = st.result
        log(f"[{tag}] {dev}: restarts={res.lanczos_restarts} kmeans_iters="
            f"{res.kmeans_iterations} residual_max={float(res.eig_residuals.max()):.2e} "
            f"λ={[round(v, 6) for v in res.eigenvalues.cpu().tolist()]}")
    for i, run in enumerate(runs):
        check(run["ari"] >= 0.99, f"{tag}: card run {i} vs CPU labels ARI {run['ari']:.4f} < 0.99")
        check(run["max_eig_diff"] <= ev_tol, f"{tag}: card run {i} vs CPU eigenvalues differ by "
              f"{run['max_eig_diff']:.2e} > {ev_tol:g}")
    return dict(ari=min(r["ari"] for r in runs),
                max_eig_diff=max(r["max_eig_diff"] for r in runs),
                card_s=runs[0]["card_s"], cpu_s=cpu_s, runs=runs)


def profile_path(pipe, pos, prof, tag: str) -> dict:
    """A path once more under ``torch.profiler`` (device activity only):
    device busy share of the wall, the kernels that take the most device
    time, and the host → device copies.  The table goes to
    ``chiprun_out/profile_<tag>.txt``.  Then once more under the host clocks
    of ``tools/host_clock.py``: the draws, the host assembly and the host
    reads."""
    from torch.profiler import ProfilerActivity, profile

    from tools.host_clock import breakdown, describe

    with profile(activities=[ProfilerActivity.CUDA]) as prof_:
        t0 = time.perf_counter()
        pipe.run_state(prof, torch.Generator().manual_seed(0), points=pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof_.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    (ROOT / "chiprun_out" / f"profile_{tag}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40))
    h2d = [e for e in events if "HtoD" in e.key]
    h2d_ms = sum(e.self_device_time_total for e in h2d) / 1e3
    h2d_calls = sum(e.count for e in h2d)
    log(f"[profile] {tag} path {wall:.2f} s wall, device busy {busy:.2f} s "
        f"({100 * busy / wall:.1f} %); host→device copies {h2d_ms:.1f} ms over {h2d_calls} calls")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.1f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    clocks = breakdown(lambda: pipe.run_state(prof, torch.Generator().manual_seed(0),
                                              points=pos))
    log(describe(tag, clocks))
    return dict(wall_s=wall, device_busy_s=busy, h2d_ms=h2d_ms, h2d_calls=h2d_calls,
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top],
                host_clock=clocks)


# ---------------------------------------------------------------------------
# phase 6: serving
# ---------------------------------------------------------------------------

# the serving cell: launch/serve.py's training pool (Gaussian blobs, 16
# centres × 8.0, d = 16) at 8 times the n of the reference's
# BENCH_serving.json, OOSConfig.from_graph_config's defaults (knn_k = 10,
# σ = 1), 2,048 held-out queries in batches of 256
N_SERVE, K_SERVE, D_SERVE, Q_SERVE, B_SERVE, KNN_SERVE = 160_000, 16, 16, 2048, 256, 10
SERVE_KERNELS = ("knn_topk", "hash_codes", "kmeans_iter")


def serve_pipeline() -> SpectralPipeline:
    """The serving cell's training pipeline: the launcher's defaults but a
    Lanczos block of k = 16, as the reference's ``BENCH_serving.json`` run
    trained for its parity gate — the kNN graph of the blobs has 16
    components, and single-vector Lanczos (b = 1) resolves only part of the
    16-fold eigenvalue 0 (ROADMAP R3, held in both packages by
    ``tests/test_torch_serve.py``)."""
    return SpectralPipeline(n_clusters=K_SERVE, eig=EigConfig(block_size=K_SERVE))


def serve_data(n: int):
    """``launch/serve.py``'s training pool (its rng, its draws) for ``n``
    points, then ``Q_SERVE`` held-out rows drawn after it from the same
    centres; and the true blobs of both."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(K_SERVE, D_SERVE)) * 8.0
    pool = np.concatenate([centers[i] + rng.normal(size=(n // K_SERVE, D_SERVE))
                           for i in range(K_SERVE)]).astype(np.float32)
    tru = rng.integers(K_SERVE, size=Q_SERVE)
    queries = (centers[tru] + rng.normal(size=(Q_SERVE, D_SERVE))).astype(np.float32)
    return pool, queries, np.repeat(np.arange(K_SERVE), n // K_SERVE), tru


def serve_all(index, queries):
    """``serve_fn`` over ``queries`` in batches of ``B_SERVE``: the outputs
    concatenated, and each batch's host-clock milliseconds (synchronised)."""
    outs, ms = [], []
    for s in range(0, queries.shape[0], B_SERVE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(serve_fn(index, queries[s:s + B_SERVE]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return OOSResult(*(torch.cat(f) for f in zip(*outs))), ms


def knn_serve_record(pool, q) -> dict:
    """``knn_topk`` at the serving shape ([256 queries × 160,000 pool × 16],
    k = 10, query_offset = n) through the wrapper ``oos_embed`` calls,
    against its plain version (distances rtol 1e-5, ids equal up to
    near-ties); real rows bitwise the same at 1, 37, 128, 129 and 256 query
    rows (one block with spare threads, two blocks); timed with events
    against ``torch.cdist`` + ``topk``."""
    n = pool.shape[0]
    gd, gi = knn_ops.knn_topk(pool, KNN_SERVE, queries=q, query_offset=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wd, wi = knn_topk_ref(pool, KNN_SERVE, queries=q, query_offset=n)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-6)
    swaps = near_tie_swaps(pool, gi, wi, wd, queries=q)
    check(bool((gi >= 0).all() & (gi < n).all()), "knn_topk@serve: an id outside the pool")
    for r in (1, 37, 128, 129):
        rd, ri = knn_ops.knn_topk(pool, KNN_SERVE, queries=q[:r].contiguous(), query_offset=n)
        check(torch.equal(rd, gd[:r]) and torch.equal(ri, gi[:r]),
              f"knn_topk@serve: rows change with the batch's row count ({r} rows)")
    # a NaN query (the launcher's injected fault): its row is the plain
    # version's — NaN distances, the lowest ids — and no other row moves
    qn = q.clone()
    qn[5, 3] = float("nan")
    nd, ni = knn_ops.knn_topk(pool, KNN_SERVE, queries=qn, query_offset=n)
    pd, pi = knn_topk_ref(pool, KNN_SERVE, queries=qn[5:6], query_offset=n + 5)
    rest = torch.arange(q.shape[0], device=q.device) != 5
    check(torch.equal(ni[5:6], pi) and bool(torch.isnan(nd[5]).all() & torch.isnan(pd).all())
          and torch.equal(nd[rest], gd[rest]) and torch.equal(ni[rest], gi[rest]),
          "knn_topk@serve: a NaN query's row differs from the plain version's")
    ms = cuda_ms(lambda: knn_topk_cuda(q, pool, KNN_SERVE, query_offset=n, d=D_SERVE), iters=20)
    library_ms = cuda_ms(lambda: torch.topk(torch.cdist(q, pool) ** 2, KNN_SERVE,
                                            largest=False), iters=20)
    n_bytes = (n + q.shape[0]) * D_SERVE * 4 + q.shape[0] * KNN_SERVE * 8
    t_ops, t_bytes = issue_ms(float(q.shape[0]) * n * D_SERVE), n_bytes / PEAK_HBM_BYTES * 1e3
    bms, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    err = float((gd - wd).abs().max())
    log(f"[serve] kernel knn_topk@serve (tol: rtol 1e-5, ids equal up to near-ties; rows "
        f"bitwise the same at 1/37/128/129/256 rows; a NaN query's row bitwise the plain "
        f"version's): [{q.shape[0]} × {n} × {D_SERVE}] "
        f"k={KNN_SERVE} offset={n}: {swaps} ids swapped at near-ties, max|Δd|={err:.2e}; "
        f"kernel_ms={ms:.4f} (events) plain_ms={plain_ms:.2f} library_ms={library_ms:.4f} "
        f"(cdist + topk) bound_ms={bms:.4f} ({by}, fp32 issue slots)")
    return dict(name="knn_topk@serve", route="cuda", source="src/repro_torch/csrc/knn_topk.cu",
                replaces="src/repro/kernels/knn_topk/kernel.py:91", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                near_tie_swaps=swaps)


def hash_serve_record(q) -> dict:
    """``hash_codes`` on one batch of query rows ([256 × 16], 16 tables of 16
    bits, seed 0) against its plain version (``hold_hash``), timed as
    profiler device time against ``x @ P`` + the pack."""
    dev = q.device
    planes = lsh_ops.make_planes(D_SERVE, LSH_TABLES, LSH_BITS, 0).to(dev)
    near, differ, err = hold_hash(q, planes)
    copies = [(q.clone(),) for _ in range(8)]
    ms = device_ms(lambda x: hash_codes_cuda(x, planes), copies, iters=80)
    plain_ms = cuda_ms(lambda: hash_codes_ref(q, planes), iters=20)
    pows = 2 ** torch.arange(LSH_BITS, device=dev, dtype=torch.int32)

    def library(x):  # x @ P, then the pack
        proj = x @ planes
        return ((proj[..., :-1] >= 0).int() * pows).sum(-1), proj[..., -1]

    library_ms = device_ms(library, copies, iters=80)
    cols = LSH_BITS + 1
    nq = q.shape[0]
    bms, by = bound(nq * D_SERVE * 4 + LSH_TABLES * D_SERVE * cols * 4 + LSH_TABLES * nq * 8,
                    2.0 * nq * LSH_TABLES * cols * D_SERVE)
    log(f"[serve] kernel hash_codes@serve (tol: codes exact where every |proj| >= "
        f"{HASH_EPS:g}, tie rtol 1e-5): [{nq} × {D_SERVE}] T={LSH_TABLES} bits={LSH_BITS}: "
        f"{near} (table, point) pairs near 0, {differ} codes differ, max|Δtie|={err:.2e}; "
        f"kernel_ms device={ms:.4f} plain_ms={plain_ms:.4f} library_ms device={library_ms:.4f} "
        f"bound_ms={bms:.5f} ({by})")
    return dict(name="hash_codes@serve", route="cuda", source="src/repro_torch/csrc/hash_codes.cu",
                replaces="src/repro/kernels/lsh_candidates/kernel.py:48", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def hold_pool_search(pool) -> dict:
    """Stage 1 of the serving cell's training, all pairs of the pool
    ([160,000 × 16], k = 10) through the wrapper Stage 1 calls, against its
    plain version: distances rtol 1e-5, ids equal up to near-ties."""
    gd, gi = knn_ops.knn_topk(pool, KNN_SERVE)
    wd, wi = knn_topk_ref(pool, KNN_SERVE)
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-6)
    swaps = near_tie_swaps(pool, gi, wi, wd)
    err = float((gd - wd).abs().max())
    log(f"[serve] knn_topk on the pool (tol: rtol 1e-5, ids equal up to near-ties): "
        f"[{pool.shape[0]} × {D_SERVE}] k={KNN_SERVE}: {swaps} ids swapped at near-ties, "
        f"max|Δd|={err:.2e}")
    return dict(near_tie_swaps=swaps, max_abs_err=err)


def kmeans_serve_record(emb, labels) -> dict:
    """``kmeans_iter`` at the serving cell's training shape: the trained
    embedding [160,000 × 16] and the k = 16 centroids of its final labels,
    held with ``hold_iter`` (10,000 rows a cluster: sums to fp32
    summation's bound); timed with events against its plain version and
    the library composition."""
    x = emb.float().contiguous()
    n, d = x.shape
    c = tkm.update_centroids(x, labels, K_SERVE, torch.zeros(K_SERVE, d, device=x.device))
    err = hold_iter(x, c, "the serving cell's embedding", order_bound=True)
    cn = (c * c).sum(1)
    ms = cuda_ms(lambda: kmeans_iter_cuda(x, c, cn), iters=20)
    plain_ms = cuda_ms(lambda: kmeans_iter_ref(x, c), iters=5)
    library_ms = cuda_ms(lambda: kmeans_library(x, c), iters=5)
    bms, by = kmeans_bound(iter_bytes(n, K_SERVE, d), n, K_SERVE, d)
    log(f"[serve] kernel kmeans_iter@serve (tol: labels and counts exact, sums within fp32 "
        f"summation's bound γ_m·Σ|x| of the float64 sums, dmin atol 1e-5·(‖x‖²+‖c‖²)): "
        f"the trained embedding [{n} × {d}] and the "
        f"centroids of its labels, k={K_SERVE}: labels and counts equal, max|Δ| sums/dmin="
        f"{err:.2e}; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(chunked cdist + argmin + index_add_) bound_ms={bms:.5f} ({by})")
    return dict(name="kmeans_iter@serve", route="cuda", source="src/repro_torch/csrc/kmeans_iter.cu",
                replaces="src/repro/kernels/kmeans_iter/kernel.py:98", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def profile_serve(index, queries, tag: str) -> dict:
    """``serve_all`` once more under ``torch.profiler`` (device activity
    only): the device's busy share of the wall and the kernels that take
    the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof_:
        t0 = time.perf_counter()
        serve_all(index, queries)
        wall = time.perf_counter() - t0
    events = prof_.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] serve {tag}: {Q_SERVE} queries in {wall * 1e3:.1f} ms wall, device busy "
        f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f} %)")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return dict(wall_s=wall, device_busy_s=busy,
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])


def pad_invariance(index, queries, tag: str) -> None:
    """A batch of ``B_SERVE`` rows holding 1, 37 and 256 real rows (zero
    rows after them) returns the same real rows, bitwise."""
    outs = {}
    for r in (1, 37, B_SERVE):
        b = torch.zeros(B_SERVE, D_SERVE, device=queries.device)
        b[:r] = queries[:r]
        outs[r] = serve_fn(index, b)
    for f in OOSResult._fields:
        a, b, c = (getattr(outs[r], f) for r in (1, 37, B_SERVE))
        check(torch.equal(a[:1], b[:1]) and torch.equal(b[:37], c[:37]),
              f"serve ({tag}): OOSResult.{f} changes with the pad rows")


def run_launcher(argv) -> tuple:
    """``launch.serve.main(argv)`` in process: (exit code, its stdout lines,
    host seconds), the lines echoed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = launch_serve.main(argv)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"[launcher] {ln[:400]}")
    return rc, lines, wall


def serve_card_vs_cpu() -> dict:
    """n = 4000 (250 points a blob): train, build both indexes and serve the
    2,048 held-out queries on the card and on the CPU from one seed; OOS
    labels ARI ≥ 0.99 between the two, exact and LSH."""
    pool, queries, _, _ = serve_data(4000)
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = serve_pipeline()
        res = pipe.run(pool, torch.Generator().manual_seed(0), device=dev)
        cfg = OOSConfig.from_graph_config(pipe.graph)
        out[dev] = dict(train=res.labels.cpu(), **{
            m: serve_fn(build_index(pool, res, config=dataclasses.replace(cfg, method=m),
                                    device=dev), queries).labels.cpu()
            for m in ("exact", "lsh")})
    ari = {m: adjusted_rand_index(out["cuda"][m], out["cpu"][m]) for m in ("train", "exact", "lsh")}
    same = {m: bool(torch.equal(out["cuda"][m], out["cpu"][m])) for m in ("exact", "lsh")}
    log(f"[serve] card vs CPU at n=4000: ARI train {ari['train']:.4f}, OOS exact "
        f"{ari['exact']:.4f}, OOS LSH {ari['lsh']:.4f}; OOS labels bitwise equal: {same}")
    for m in ("exact", "lsh"):
        check(ari[m] >= 0.99, f"serve card vs CPU: OOS {m} ARI {ari[m]:.4f} < 0.99")
    return dict(ari=ari, bitwise=same)


def serve_phase() -> tuple:
    """The serving path at the serving cell's size: train the pool as
    ``serve_online`` does, build the exact and the LSH index, serve the
    held-out queries in batches of 256 — every launch counter zeroed just
    before and read just after.  Then its gates (OOS ARI ≥ 0.95 against a
    full re-clustering of pool + queries, exact and LSH; persisted LSH
    tables against the rehash path, label agreement 1.0;
    ``routed_candidates`` on the card = on the CPU, bitwise; pad-row
    invariance; a registry load onto the card bitwise the published
    index), per-label latency through the micro-batcher, every kernel of the
    path held at the shapes the path gave it (``knn_topk`` on the pool and
    on a query batch, ``hash_codes`` on the pool and on a query batch,
    ``kmeans_iter`` on the trained embedding), the launcher's two modes with
    their faults injected, and the card against the CPU at n = 4000.
    Returns the three kernel records and the phase's record."""
    import shutil

    dev = torch.device("cuda")
    pool_np, queries_np, truth, query_truth = serve_data(N_SERVE)
    pool, queries = torch.from_numpy(pool_np).to(dev), torch.from_numpy(queries_np).to(dev)
    pipe = serve_pipeline()
    cfg = OOSConfig.from_graph_config(pipe.graph)
    for _, fn in COUNTERS:
        fn.launches = 0
    t0 = time.perf_counter()
    res = pipe.run(pool, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trained = {name: fn.launches for name, fn in COUNTERS}
    t0 = time.perf_counter()
    exact = build_index(pool, res, config=cfg)
    lsh = build_index(pool, res, config=dataclasses.replace(cfg, method="lsh"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    before = {name: fn.launches for name, fn in COUNTERS}
    served, exact_ms = serve_all(exact, queries)
    mid = {name: fn.launches for name, fn in COUNTERS}
    served_lsh, lsh_ms = serve_all(lsh, queries)
    launches = {name: fn.launches for name, fn in COUNTERS}
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"serve path never launched {name}")
    n_batches = Q_SERVE // B_SERVE
    per_batch = dict(knn_topk=(mid["knn_topk"] - before["knn_topk"]) / n_batches,
                     hash_codes=(launches["hash_codes"] - mid["hash_codes"]) / n_batches)
    rep = [r.to_dict() for r in res.reports]
    train_ari = adjusted_rand_index(res.labels, truth)
    log(f"[serve] n={N_SERVE} k={K_SERVE} d={D_SERVE}: train {train_s:.2f} s (restarts "
        f"{res.lanczos_restarts}, embed converged={rep[1]['converged']} residual_max="
        f"{rep[1]['residual_max']:.2e}, k-means iterations {res.kmeans_iterations}); train "
        f"labels ARI against the blobs {train_ari:.4f}; both indexes built in {build_s:.3f} s")
    log(f"[serve] launches: training {trained}; serving {Q_SERVE} queries in "
        f"{n_batches} batches of {B_SERVE} (exact, then LSH) "
        f"{ {k: launches[k] - before[k] for k in launches} }; a batch: {per_batch}")
    log(f"[serve] serve_fn a batch of {B_SERVE} (host clock, synchronised): exact "
        + " ".join(f"{t:.2f}" for t in exact_ms) + " ms; LSH "
        + " ".join(f"{t:.2f}" for t in lsh_ms) + " ms")
    # the gates
    full = pipe.run(torch.cat([pool, queries]), torch.Generator().manual_seed(1))
    full_q = full.labels[N_SERVE:]
    ari = dict(exact=adjusted_rand_index(served.labels, full_q),
               lsh=adjusted_rand_index(served_lsh.labels, full_q),
               exact_vs_truth=adjusted_rand_index(served.labels, query_truth))
    profiled = ({tag: profile_serve(index, queries, tag) for tag, index in
                 (("exact", exact), ("lsh", lsh))} if "--profile" in sys.argv[1:] else None)
    rehash, _ = serve_all(dataclasses.replace(lsh, lsh_tables=None), queries)
    agree = float((rehash.labels == served_lsh.labels).float().mean())
    for name, out in (("exact", served), ("lsh", served_lsh)):
        check(health.numeric_problems({"embedding": out.embedding, "dist2": out.dist2}) == (),
              f"serve ({name}): non-finite rows")
    log(f"[serve] OOS labels against a full re-clustering of pool + queries (n="
        f"{N_SERVE + Q_SERVE}): ARI exact {ari['exact']:.4f}, LSH {ari['lsh']:.4f}; exact "
        f"against the queries' blobs {ari['exact_vs_truth']:.4f}; LSH persisted tables against "
        f"the rehash path: label agreement {agree:.4f}")
    check(ari["exact"] >= 0.95, f"serve: exact OOS ARI {ari['exact']:.4f} < 0.95")
    check(ari["lsh"] >= 0.95, f"serve: LSH OOS ARI {ari['lsh']:.4f} < 0.95")
    check(agree == 1.0, f"serve: persisted/rehash LSH label agreement {agree:.4f} < 1")
    q1 = queries[:B_SERVE].contiguous()
    planes = lsh_ops.make_planes(D_SERVE, cfg.n_tables, cfg.n_bits, cfg.lsh_seed)
    qc, qt = lsh_ops.hash_codes(q1, planes)
    win = lsh_ops.default_candidates(cfg.knn_k, cfg.n_tables) // cfg.n_tables
    card = lsh_ops.routed_candidates(lsh.lsh_tables, qc, qt, win=win)
    tables_cpu = lsh_ops.LshTables(*(t.cpu() for t in lsh.lsh_tables))
    check(torch.equal(card.cpu(), lsh_ops.routed_candidates(tables_cpu, qc.cpu(), qt.cpu(),
                                                            win=win)),
          "serve: routed_candidates on the card differs from the CPU's")
    for name, index in (("exact", exact), ("lsh", lsh)):
        pad_invariance(index, queries, name)
    reg_dir = ROOT / "build" / "serve_registry"
    shutil.rmtree(reg_dir, ignore_errors=True)
    registry = EmbeddingRegistry(str(reg_dir))
    for index in (exact, lsh):
        _, loaded = registry.load(registry.publish(index))
        check(loaded.device.type == "cuda", "registry: load() left the card")
        check(all(torch.equal(getattr(loaded, f), getattr(index, f))
                  for f in ("points", "embedding", "centroids", "labels"))
              and loaded.config == index.config
              and (index.lsh_tables is None) == (loaded.lsh_tables is None)
              and (index.lsh_tables is None
                   or all(torch.equal(a, b) for a, b in zip(loaded.lsh_tables, index.lsh_tables))),
              "registry: the loaded index differs from the published one")
    log(f"[serve] routed_candidates card = CPU bitwise ({card.shape[0]} × {card.shape[1]}); "
        f"pad rows change no real row (1, 37, 256 real rows, exact and LSH); registry "
        f"publish → load onto the card bitwise (versions {registry.versions()})")
    # per-label latency through the micro-batcher: full batches, then single rows
    lat = dict(full=[], single=[])
    with MicroBatcher(functools.partial(serve_fn, exact), D_SERVE,
                      BatchConfig(batch_size=B_SERVE, max_wait_s=0.01)) as mb:
        for s in range(0, Q_SERVE, B_SERVE):
            t0 = time.perf_counter()
            out = mb.label(queries_np[s:s + B_SERVE], timeout=60.0)
            lat["full"].append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(out.labels, served.labels[s:s + B_SERVE].cpu().numpy()),
                  "serve: the batcher's labels differ from serve_fn's")
        for i in range(16):
            t0 = time.perf_counter()
            mb.label(queries_np[i], timeout=60.0)
            lat["single"].append((time.perf_counter() - t0) * 1e3)
        stats = dataclasses.asdict(mb.stats)
    log(f"[serve] micro-batcher (max wait 10 ms): a full batch of {B_SERVE} "
        + " ".join(f"{t:.2f}" for t in lat["full"]) + f" ms ({np.median(lat['full']) / B_SERVE * 1e3:.2f} "
        f"µs a label, median); one row " + " ".join(f"{t:.2f}" for t in lat["single"])
        + f" ms; stats {stats}")
    # every kernel of the path at the shapes it gave them: training's search
    # and k-means, the index build's hash of the pool, and a query batch
    pool_search = hold_pool_search(pool)
    near, differ, err = hold_hash(pool, planes.to(dev))
    log(f"[serve] hash_codes on the pool (as build_index runs it; tol as hash_codes@serve): "
        f"[{N_SERVE} × {D_SERVE}]: {near} (table, point) pairs near 0, {differ} codes differ, "
        f"max|Δtie|={err:.2e}")
    q = queries[:B_SERVE].contiguous()
    records = [knn_serve_record(pool, q), hash_serve_record(q),
               kmeans_serve_record(res.embedding, res.labels)]
    for r in records:
        r["launches"] = launches[r["name"].split("@")[0]]
    # the launcher, in process, at the serving cell's size and at its docstring's
    launcher_dir = ROOT / "build" / "serve_launcher_registry"
    shutil.rmtree(launcher_dir, ignore_errors=True)
    rc, lines, serve_wall = run_launcher([
        "--mode", "serve", "--n", str(N_SERVE), "--clusters", str(K_SERVE), "--dim",
        str(D_SERVE), "--requests", "64", "--rows-per-request", "4", "--batch-size",
        str(B_SERVE), "--inject-fault", "nan-query", "--registry-dir", str(launcher_dir)])
    summary = json.loads(lines[-1])
    check(rc == 32, f"launcher --mode serve returned {rc}, not 32 (the odd requests)")
    rc2, lines2, cluster_wall = run_launcher([
        "--mode", "cluster", "--n", "20000", "--clusters", "64", "--requests", "4",
        "--inject-fault", "nan-graph"])
    check(rc2 == 2, f"launcher --mode cluster returned {rc2}, not 2")
    shutil.rmtree(reg_dir, ignore_errors=True)
    shutil.rmtree(launcher_dir, ignore_errors=True)
    log(f"[serve] launcher: serve mode exit {rc} in {serve_wall:.2f} s (p50 {summary['p50_ms']} "
        f"ms, p99 {summary['p99_ms']} ms, fill {summary['fill']}, batches {summary['batches']}, "
        f"train_ari_vs_served {summary['train_ari_vs_served']}); cluster mode exit {rc2} in "
        f"{cluster_wall:.2f} s")
    e2e = serve_card_vs_cpu()
    rec = dict(train_s=train_s, pool_search=pool_search,
               pool_hash=dict(near_zero=near, codes_differ=differ, max_abs_err=err), build_s=build_s, train_ari=train_ari, restarts=res.lanczos_restarts,
               embed_report=rep[1], launches=launches, launches_training=trained,
               launches_per_batch=per_batch, batch_ms=dict(exact=exact_ms, lsh=lsh_ms),
               ari=ari, rehash_agreement=agree, batcher_ms=lat, batcher_stats=stats,
               launcher=dict(serve=summary, serve_wall_s=serve_wall, cluster_wall_s=cluster_wall,
                             cluster_lines=[ln for ln in lines2 if ln.startswith("[req")]),
               card_vs_cpu=e2e, profile=profiled)
    return records, rec


# ---------------------------------------------------------------------------
# phase 7: the sharded plan
# ---------------------------------------------------------------------------

SHARDS = 4  # row blocks of the layout path, and the ranks the @shard shapes are cut for
N_SHARD = N_FULL - N_FULL % SHARDS  # the row-block Stage 1 needs n % S == 0
NL_SHARD = N_SHARD // SHARDS


def host_partition(row, col, val, n: int, num_shards: int):
    """The reference's ``partition_coo_by_rows``, its numpy loop: per-shard
    (row_local, col, val) buckets, each in the edges' order, padded with
    (0, 0, 0) to the fullest bucket."""
    n_pad = tdist.padded_rows(n, num_shards)
    rps = n_pad // num_shards
    owner = row // rps
    e_max = max(int(np.bincount(owner, minlength=num_shards).max()), 1)
    rl = np.zeros((num_shards, e_max), np.int64)
    cl = np.zeros((num_shards, e_max), np.int64)
    vl = np.zeros((num_shards, e_max), val.dtype)
    for s in range(num_shards):
        sel = owner == s
        k = int(sel.sum())
        rl[s, :k] = row[sel] - s * rps
        cl[s, :k] = col[sel]
        vl[s, :k] = val[sel]
    return rl.reshape(-1), cl.reshape(-1), vl.reshape(-1), rps, e_max


def layout_path(pos, prof, region, first) -> dict:
    """The single-process layout path at full size: the first path's graph,
    built on the card and partitioned onto 4 row blocks there (bitwise the
    reference's numpy layout), then ``Plan(variant="gspmd")`` — the
    index-add over the global rows — with the first path's Lanczos (b = 4)
    and fused k-means.  Gates: purity within 0.01 of the first path's,
    eigenvalues within 1e-4 of its (index-add sums round differently from
    run to run on the card, so not bitwise)."""
    from repro_torch.core.similarity import build_knn_graph

    first_res, first_rec = first
    g = main_pipeline(K_FULL).graph
    w = build_knn_graph(prof, g.knn_k, points=pos, measure=g.measure)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm = tdist.partition_coo_by_rows(w, SHARDS)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    rl, cl, vl, rps, e_max = host_partition(w.row.cpu().numpy(), w.col.cpu().numpy(),
                                            w.val.cpu().numpy(), N_FULL, SHARDS)
    check((sm.rows_per_shard, sm.edges_per_shard, sm.shape) == (rps, e_max, (SHARDS * rps,) * 2)
          and np.array_equal(sm.row_local.cpu().numpy(), rl)
          and np.array_equal(sm.col.cpu().numpy(), cl)
          and np.array_equal(sm.val.cpu().numpy().view(np.uint32), vl.view(np.uint32)),
          "sharded: the ShardedCOO built on the card is not the host layout bitwise")
    pipe = dataclasses.replace(main_pipeline(K_FULL), eig=EigConfig(tol=1e-4, block_size=4),
                               plan=Plan(variant="gspmd"))
    for _, fn in COUNTERS:
        fn.launches = 0
    with StageClock() as clock:
        t0 = time.perf_counter()
        state = pipe.run_state(sm, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS}
    check(launches["kmeans_iter"] > 0, "sharded layout path never launched kmeans_iter")
    res = state.result
    labels = res.labels[:N_FULL]
    check(res.labels.shape == (SHARDS * rps,) and bool(torch.isfinite(res.embedding).all()),
          "sharded layout path: labels or embedding malformed")
    pur = purity(labels, region)
    ari = adjusted_rand_index(labels, first_res.labels)
    ev = float((res.eigenvalues - first_res.eigenvalues).abs().max())
    log(f"[sharded] layout path: {SHARDS} row blocks of {rps} rows, {e_max} edges a bucket "
        f"(partitioned on the card in {build_ms:.1f} ms, bitwise the host layout); "
        f"points graph→labels {wall:.2f} s; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in clock.walls.items())
        + f"; launches {launches}; restarts={res.lanczos_restarts} kmeans iterations="
        f"{res.kmeans_iterations}; purity {pur:.4f} (first path {first_rec['purity']:.4f}); "
        f"ARI against the first path {ari:.4f}; max|Δλ| against the first path {ev:.2e}")
    check(abs(pur - first_rec["purity"]) <= 0.01,
          f"sharded layout path: purity {pur:.4f} not within 0.01 of the first path's")
    check(ev <= 1e-4, f"sharded layout path: eigenvalues differ by {ev:.2e} > 1e-4")
    return dict(build_ms=build_ms, rows_per_shard=rps, edges_per_shard=e_max, wall_s=wall,
                stage_walls=clock.walls, launches=launches, purity=pur, ari_vs_first=ari,
                max_eig_diff=ev, restarts=res.lanczos_restarts,
                kmeans_iterations=res.kmeans_iterations), w


def mesh_operator_path(w, region, first, mesh) -> dict:
    """The layout path's graph ``w`` partitioned onto the world-size-1 NCCL
    mesh's one row block, under ``Plan(device="sharded",
    variant="shard_map")``: the degree pass
    and every Stage-2 product through ``ShardedCooOperator``'s mesh path
    (a rank's bucket, then one all-gather), Stage 3 through
    ``kmeans_sharded``.  Gates, from the collective counter: one all-gather
    a product, plus the degree pass's and the labels'; one all-reduce a
    Lloyd iteration plus the inertia's; purity within 0.01 and eigenvalues
    within 1e-4 of the first path's."""
    from repro_torch.core.operator import ShardedCooOperator

    class Counted(ShardedCooOperator):  # counts the products Stage 2 asks for
        products = 0

        def mv(self, x):
            Counted.products += 1
            return super().mv(x)

        def mm(self, x):
            Counted.products += 1
            return super().mm(x)

    first_res, first_rec = first
    sm = tdist.partition_coo_by_rows(w, 1)
    plan = Plan(device="sharded", variant="shard_map", mesh=mesh)
    pipe = dataclasses.replace(main_pipeline(K_FULL), eig=EigConfig(tol=1e-4, block_size=4),
                               plan=plan)
    op = Counted(pipe.prepare(sm).adj, variant=plan.variant, mesh=mesh, axis=plan.axis)
    for _, fn in COUNTERS:
        fn.launches = 0
    tdist.COLLECTIVES.reset()
    with StageClock() as clock:
        t0 = time.perf_counter()
        state = pipe.run_state(sm, torch.Generator().manual_seed(0), operator=op)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS}
    calls = dict(tdist.COLLECTIVES.calls)
    res = state.result
    pur = purity(res.labels[:N_FULL], region)
    ev = float((res.eigenvalues - first_res.eigenvalues).abs().max())
    log(f"[sharded] mesh operator path (the layout path's graph on one row block, shard_map, "
        f"world size 1): {wall:.2f} s; stages " + ", ".join(f"{k} {v:.3f} s" for k, v in clock.walls.items())
        + f"; {Counted.products} operator products, collectives {calls}; launches {launches}; "
        f"kmeans iterations={res.kmeans_iterations}; purity {pur:.4f} (first path "
        f"{first_rec['purity']:.4f}); max|Δλ| against the first path {ev:.2e}")
    check(Counted.products > 0 and calls["all_gather"] == Counted.products + 2,
          f"sharded mesh operator: {calls['all_gather']} all-gathers for "
          f"{Counted.products} products (want one a product, plus the degree pass and labels)")
    check(calls["psum"] == res.kmeans_iterations + 1,
          f"sharded mesh operator: {calls['psum']} all-reduces for {res.kmeans_iterations} "
          f"Lloyd iterations")
    check(launches["kmeans_iter"] > 0, "sharded mesh operator path never launched kmeans_iter")
    check(abs(pur - first_rec["purity"]) <= 0.01,
          f"sharded mesh operator: purity {pur:.4f} not within 0.01 of the first path's")
    check(ev <= 1e-4, f"sharded mesh operator: eigenvalues differ by {ev:.2e} > 1e-4")
    return dict(wall_s=wall, stage_walls=clock.walls, products=Counted.products,
                collectives=calls, launches=launches, purity=pur, max_eig_diff=ev,
                kmeans_iterations=res.kmeans_iterations)


def sharded_pipe(make, n_clusters: int, mesh, exchange: str) -> SpectralPipeline:
    return dataclasses.replace(make(n_clusters), plan=Plan(
        device="sharded", variant="shard_map", mesh=mesh, stage1_exchange=exchange))


def mesh_paths(pos, prof, region, mesh, first, scalable) -> dict:
    """The mesh path at full size on a world-size-1 NCCL mesh: Stage 1 alone
    (``make_knn_rowblock``, gather and ring) bitwise the single-device
    ``knn_topk``; the first path from raw points under the sharded plan with
    the gather and the ring exchange, and the scalable path's LSH Stage 1 on
    the ring, each driven with the launch counters zeroed just before and
    read just after and held to its unsharded path's purity (within 0.01);
    ``kmeans_sharded`` on the gather run's embedding making one all-reduce a
    Lloyd iteration and one for the inertia."""
    from repro_torch.core.distributed_pipeline import kmeans_sharded, make_knn_rowblock

    sd, si = knn_ops.knn_topk(pos, KNN_K)
    for exch in ("gather", "ring"):
        d, i = make_knn_rowblock(mesh, KNN_K, exchange=exch)(pos)
        check(torch.equal(i, si) and torch.equal(d.view(torch.int32), sd.view(torch.int32)),
              f"sharded: the {exch} Stage 1 is not bitwise the single-device knn_topk")
    out = {}
    for tag, make, kernels, base, exch in (
            ("gather", main_pipeline, MAIN_KERNELS, first, "gather"),
            ("ring", main_pipeline, MAIN_KERNELS, first, "ring"),
            ("lsh-ring", scalable_pipeline, SCALABLE_KERNELS, scalable, "ring")):
        tdist.COLLECTIVES.reset()
        res, rec, _ = drive(sharded_pipe(make, K_FULL, mesh, exch), pos, prof, region,
                            f"shard-{tag}", kernels)
        rec["collectives"] = dict(tdist.COLLECTIVES.calls)
        log(f"[shard-{tag}] collectives {rec['collectives']}; purity {rec['purity']:.4f} "
            f"(unsharded {base[1]['purity']:.4f})")
        check(abs(rec["purity"] - base[1]["purity"]) <= 0.01,
              f"sharded {tag}: purity {rec['purity']:.4f} not within 0.01 of the unsharded "
              f"path's {base[1]['purity']:.4f}")
        out[tag] = rec
        if tag == "gather":
            emb = res.embedding
    tdist.COLLECTIVES.reset()
    km = kmeans_sharded(emb, KMeansConfig(k=K_FULL), torch.Generator().manual_seed(0),
                        mesh=mesh)
    calls = dict(tdist.COLLECTIVES.calls)
    log(f"[sharded] kmeans_sharded on the gather run's embedding: {km.iterations} Lloyd "
        f"iterations, collectives {calls}")
    check(calls["psum"] == km.iterations + 1,
          f"kmeans_sharded made {calls['psum']} all-reduces for {km.iterations} iterations")
    out["kmeans_sharded"] = dict(iterations=km.iterations, collectives=calls)
    return out


def card_vs_cpu_sharded(mesh, tmp: Path) -> tuple:
    """n = 4000, 12 clusters: the first path under the sharded plan (gather)
    on the card's world-size-1 mesh against one gloo rank on the CPU, from
    one seed; ARI ≥ 0.99.  Returns the record, the spec of the run and the
    card's result (labels, eigenvalues, purity against the regions)."""
    from repro_torch.testing.dist import pipeline_rank, run_ranks

    k = 12
    pos, prof, _, region = dti_like_pointcloud(4000, 90, max(k // 2, 4), eps=1.8, seed=0,
                                               neighbors="none", device="cuda")
    pipe = sharded_pipe(main_pipeline, k, mesh, "gather")
    t0 = time.perf_counter()
    res = pipe.run(prof, torch.Generator().manual_seed(0), points=pos)
    card = res.labels.cpu().numpy()
    card_s = time.perf_counter() - t0
    spec = dict(x=prof.cpu().numpy(), points=pos.cpu().numpy(), pipeline=pipe.to_dict(),
                device="cpu", mesh=((1,), ("data",)))
    t0 = time.perf_counter()
    cpu = run_ranks(pipeline_rank, 1, spec, tmpdir=str(tmp / "cpu"), backend="gloo",
                    timeout=120.0, join_timeout=300.0)[0]["labels"]
    cpu_s = time.perf_counter() - t0
    ari = adjusted_rand_index(card, cpu)
    log(f"[sharded] card vs CPU at n=4000 k={k} (sharded plan, gather; card world size 1 "
        f"over NCCL, CPU one gloo rank): ARI {ari:.4f}; card {card_s:.2f} s, CPU rank "
        f"{cpu_s:.2f} s with its start-up")
    check(ari >= 0.99, f"sharded card vs CPU: ARI {ari:.4f} < 0.99")
    region = region.cpu().numpy()
    return dict(ari=ari, card_s=card_s, cpu_s=cpu_s), spec, dict(
        labels=card, eigenvalues=res.eigenvalues.cpu().numpy(), region=region,
        purity=purity(card, region), embedding=res.embedding.cpu().numpy())


def ranks_on_one_card(spec, card, tmp: Path) -> dict:
    """4 gloo ranks sharing the card, the gather exchange: first
    ``kmeans_sharded`` on 4 ranks of the world-size-1 run's embedding must
    give the labels and iterations of ``kmeans`` on it; then the n = 4000
    sharded path on 4 ranks, gated against the world-size-1 run ``card``:
    every rank the same labels and eigenvalues (bitwise), ARI ≥ 0.99,
    eigenvalues within 1e-4, purity within 0.01.  The ring exchange is left
    out here: gloo cannot send from a CUDA tensor (its send/receive fails
    with ``writev ... Bad address`` or hangs), so the ring runs on several
    ranks only on the CPU."""
    from repro_torch.testing.dist import kmeans_rank, pipeline_rank, run_ranks

    emb = card["embedding"]
    want = tkm.kmeans(torch.as_tensor(emb, device="cuda"), KMeansConfig(k=12),
                      torch.Generator().manual_seed(0))
    got = run_ranks(kmeans_rank, SHARDS,
                    dict(x=emb, cfg=dict(k=12), seed=0, device="cuda",
                         mesh=((SHARDS,), ("data",))),
                    tmpdir=str(tmp / "ranks_kmeans"), backend="gloo", timeout=60.0,
                    join_timeout=180.0)
    same = [bool(np.array_equal(g["labels"], want.labels.cpu().numpy())) for g in got]
    log(f"[sharded] kmeans_sharded on {SHARDS} gloo ranks on the one card, the world-size-1 "
        f"embedding: labels equal to kmeans' {same}, iterations "
        f"{[g['iterations'] for g in got]} (kmeans {want.iterations}), all-reduces "
        f"{got[0]['calls']['psum']}")
    check(all(same) and all(g["iterations"] == want.iterations for g in got),
          "sharded: kmeans_sharded on 4 ranks on one card differs from kmeans")
    t0 = time.perf_counter()
    outs = run_ranks(pipeline_rank, SHARDS,
                     dict(spec, device="cuda", mesh=((SHARDS,), ("data",))),
                     tmpdir=str(tmp / "ranks_gather"), backend="gloo", timeout=120.0,
                     join_timeout=400.0)
    wall = time.perf_counter() - t0
    labels, vals = outs[0]["labels"], outs[0]["eigenvalues"]
    ari = adjusted_rand_index(labels, card["labels"])
    pur = purity(labels, card["region"])
    ev = float(np.abs(vals - card["eigenvalues"]).max())
    log(f"[sharded] {SHARDS} gloo ranks on the one card at n=4000, gather exchange: "
        f"{wall:.2f} s with start-up; purity {pur:.4f} (world size 1: {card['purity']:.4f}), "
        f"max|Δλ| {ev:.2e}, ARI {ari:.4f} against the world-size-1 run; k-means iterations "
        f"{outs[0]['kmeans_iterations']}; collectives of rank 0 {outs[0]['calls']}")
    check(all(np.array_equal(o["labels"], labels) for o in outs),
          f"sharded: {SHARDS} ranks on one card disagree on the labels")
    check(all(np.array_equal(o["eigenvalues"].view(np.uint32), vals.view(np.uint32))
              for o in outs),
          f"sharded: {SHARDS} ranks on one card disagree on the eigenvalues")
    check(ari >= 0.99, f"sharded: {SHARDS} ranks on one card, ARI {ari:.4f} < 0.99 against "
                       f"the world-size-1 run")
    check(ev <= 1e-4, f"sharded: {SHARDS} ranks on one card, eigenvalues differ by {ev:.2e} "
                      f"> 1e-4 from the world-size-1 run")
    check(abs(pur - card["purity"]) <= 0.01,
          f"sharded: {SHARDS} ranks on one card, purity {pur:.4f} not within 0.01 of the "
          f"world-size-1 run's {card['purity']:.4f}")
    return dict(kmeans_iterations=want.iterations,
                gather=dict(wall_s=wall, ari=ari, purity=pur, max_eig_diff=ev,
                            calls=outs[0]["calls"]))


def knn_shard_record(pos) -> dict:
    """``knn_topk`` at a 4-rank plan's shapes on the lattice's first 142,540
    points: each 35,635-row block against the whole pool at offset r·n/4
    (gather; the four blocks bitwise the single-device all-pairs search) and
    block against block at offsets ±n/4 (ring; the four steps of block 1
    merged bitwise its gather rows); block 1 held to the plain version
    exactly (lattice), both shapes timed with events."""
    from repro_torch.core.distributed_pipeline import merge_topk

    x = pos[:N_SHARD].contiguous()
    nl = NL_SHARD
    blk = [x[r * nl:(r + 1) * nl] for r in range(SHARDS)]
    gathered = [knn_ops.knn_topk(x, KNN_K, queries=blk[r], query_offset=r * nl)
                for r in range(SHARDS)]
    sd, si = knn_ops.knn_topk(x, KNN_K)
    check(torch.equal(torch.cat([g[1] for g in gathered]), si)
          and torch.equal(torch.cat([g[0] for g in gathered]), sd),
          "knn_topk@shard: the gather blocks are not the all-pairs rows")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wd, wi = knn_topk_ref(x, KNN_K, queries=blk[1], query_offset=nl)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(gathered[1][0], wd) and torch.equal(gathered[1][1], wi),
          "knn_topk@shard: block 1 against the pool differs from the plain version")
    bd = torch.zeros((nl, 0), device=x.device)
    bi = torch.zeros((nl, 0), dtype=torch.int32, device=x.device)
    for src in range(SHARDS):
        d, i = knn_ops.knn_topk(blk[src], KNN_K, queries=blk[1], query_offset=(1 - src) * nl)
        if src in (0, 2):  # offsets +n/4 and −n/4
            pd, pi = knn_topk_ref(blk[src], KNN_K, queries=blk[1], query_offset=(1 - src) * nl)
            check(torch.equal(d, pd) and torch.equal(i, pi),
                  f"knn_topk@shard: block 1 against block {src} differs from the plain version")
        bd, bi = merge_topk(bd, bi, d, torch.where(i >= 0, i + src * nl, -1), KNN_K)
    check(torch.equal(bi, gathered[1][1]) and torch.equal(bd, gathered[1][0]),
          "knn_topk@shard: the ring's merged rows are not the gather rows")
    xp = torch.nn.functional.pad(x, (0, 1)).contiguous()
    qp = xp[nl:2 * nl]
    ms = cuda_ms(lambda: knn_topk_cuda(qp, xp, KNN_K, query_offset=nl, d=3), iters=10)
    ring_ms = cuda_ms(lambda: knn_topk_cuda(qp, xp[:nl], KNN_K, query_offset=nl, d=3), iters=20)

    def library():  # cdist + topk, chunked
        out = []
        for s in range(0, nl, 8192):
            q = blk[1][s:s + 8192]
            d2 = torch.cdist(q, x) ** 2
            d2[torch.arange(q.shape[0], device=x.device),
               torch.arange(nl + s, nl + s + q.shape[0], device=x.device)] = math.inf
            out.append(torch.topk(d2, KNN_K, largest=False))
        return out

    library_ms = cuda_ms(library, iters=3)
    n_bytes = (N_SHARD + nl) * 3 * 4 + nl * KNN_K * 8
    t_ops, t_bytes = issue_ms(float(nl) * N_SHARD * 3), n_bytes / PEAK_HBM_BYTES * 1e3
    bms, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    log(f"[sharded] kernel knn_topk@shard (tol: lattice exact; gather blocks = all pairs, ring "
        f"merge = gather, bitwise): [{nl} × {N_SHARD} × 3] offset {nl}, k={KNN_K}: "
        f"kernel_ms={ms:.3f} (ring step [{nl} × {nl}] offset {nl}: {ring_ms:.3f}) "
        f"plain_ms={plain_ms:.1f} library_ms={library_ms:.2f} (cdist + topk) "
        f"bound_ms={bms:.4f} ({by}, fp32 issue slots)")
    return dict(name="knn_topk@shard", route="cuda", source="src/repro_torch/csrc/knn_topk.cu",
                replaces="src/repro/kernels/knn_topk/kernel.py:91", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                ring_step_ms=ring_ms, shape=f"[{nl} × {N_SHARD} × 3] offset {nl}, k={KNN_K}")


def kmeans_shard_record(emb, labels) -> dict:
    """``kmeans_iter`` on a 4-rank plan's shard: the first 35,635 rows of the
    first path's embedding and the centroids of its final labels (k = 500),
    held to the plain version (labels up to float64 near-ties) and timed."""
    x = emb.float().contiguous()
    c = tkm.update_centroids(x, labels, K_FULL, torch.zeros(K_FULL, x.shape[1], device=x.device))
    x = x[:NL_SHARD].contiguous()
    rows, gap, scale = hold_iter_near_ties(x, c, "@shard")
    _, gd, gs, _ = km_ops.kmeans_iter(x, c)
    _, wd, ws, _ = kmeans_iter_ref(x, c)
    err = max(float((gd - wd).abs().max()), float((gs - ws).abs().max()))
    cn = (c * c).sum(1)
    ms = cuda_ms(lambda: kmeans_iter_cuda(x, c, cn), iters=20)
    plain_ms = cuda_ms(lambda: kmeans_iter_ref(x, c), iters=3)
    library_ms = cuda_ms(lambda: kmeans_library(x, c), iters=3)
    n, d = x.shape
    bms, by = kmeans_bound(iter_bytes(n, K_FULL, d), n, K_FULL, d)
    log(f"[sharded] kernel kmeans_iter@shard (tol: labels up to float64 near-ties, dmin atol "
        f"1e-5·(‖x‖²+‖c‖²), counts and sums those of its labels): [{n} × {d}], k={K_FULL}: "
        f"{rows.numel()} labels differ (largest gap {gap:.3e}); kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} bound_ms={bms:.4f} ({by})")
    return dict(name="kmeans_iter@shard", route="cuda",
                source="src/repro_torch/csrc/kmeans_iter.cu",
                replaces="src/repro/kernels/kmeans_iter/kernel.py:98", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                shape=f"[{n} × {d}], k={K_FULL}")


def hash_shard_record(pos) -> dict:
    """``hash_codes`` on a 4-rank plan's ring block: the first 35,635 lattice
    points with the scalable path's planes (16 tables of 16 bits, seed 0),
    held with ``hold_hash``; device time cold."""
    dev = pos.device
    x = pos[:NL_SHARD].contiguous()
    planes = lsh_ops.make_planes(3, LSH_TABLES, LSH_BITS, 0).to(dev)
    near, differ, err = hold_hash(x, planes)
    copies = [(x.clone(),) for _ in range(8)]
    ms = device_ms(lambda a: hash_codes_cuda(a, planes), copies, iters=80)
    plain_ms = cuda_ms(lambda: hash_codes_ref(x, planes), iters=10)
    pows = 2 ** torch.arange(LSH_BITS, device=dev, dtype=torch.int32)

    def library(a):  # x @ P, then the pack
        proj = a @ planes
        return ((proj[..., :-1] >= 0).int() * pows).sum(-1), proj[..., -1]

    library_ms = device_ms(library, copies, iters=80)
    cols, n = LSH_BITS + 1, NL_SHARD
    bms, by = bound(n * 3 * 4 + LSH_TABLES * 3 * cols * 4 + LSH_TABLES * n * 8,
                    2.0 * n * LSH_TABLES * cols * 3)
    log(f"[sharded] kernel hash_codes@shard (tol: codes exact where every |proj| >= "
        f"{HASH_EPS:g}, tie rtol 1e-5): [{n} × 3] T={LSH_TABLES} bits={LSH_BITS}: {near} "
        f"pairs near 0, {differ} codes differ, max|Δtie|={err:.2e}; kernel_ms device "
        f"cold={ms:.4f} plain_ms={plain_ms:.4f} library_ms device cold={library_ms:.4f} "
        f"bound_ms={bms:.5f} ({by})")
    return dict(name="hash_codes@shard", route="cuda", source="src/repro_torch/csrc/hash_codes.cu",
                replaces="src/repro/kernels/lsh_candidates/kernel.py:48", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                shape=f"[{n} × 3], {LSH_TABLES} tables × {LSH_BITS} bits")


def run_example(*args) -> tuple:
    """One example as its own process: (exit code, stdout lines, seconds)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *map(str, args)], capture_output=True, text=True,
                          env=env, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for ln in lines:
        log(f"[example] {ln[:300]}")
    if proc.returncode:
        log(proc.stderr[-3000:])
    return proc.returncode, lines, wall


def examples_phase() -> dict:
    """Both examples on the card at their default sizes (exit 0), and
    ``dti_pointcloud_torch.py --device-stage1 --n 4000`` on the card and on
    the CPU: purities within 0.01."""
    ex = ROOT / "examples"
    out = {}
    for name, args in (("dti", ()), ("ann", ())):
        script = ex / ("dti_pointcloud_torch.py" if name == "dti" else "ann_retrieval_torch.py")
        rc, _, wall = run_example(script, *args)
        check(rc == 0, f"examples: {script.name} exited {rc}")
        out[name] = dict(wall_s=wall)
    pur = {}
    for dev in ("cuda", "cpu"):
        rc, lines, wall = run_example(ex / "dti_pointcloud_torch.py", "--device-stage1",
                                      "--n", "4000", "--device", dev)
        check(rc == 0, f"examples: dti_pointcloud_torch.py --device-stage1 on {dev} exited {rc}")
        pur[dev] = float([ln for ln in lines if "purity" in ln][-1].split()[-1])
        out[f"dti_stage1_{dev}"] = dict(wall_s=wall, purity=pur[dev])
    log(f"[examples] dti --device-stage1 --n 4000 purity: card {pur['cuda']:.3f}, CPU "
        f"{pur['cpu']:.3f}")
    check(abs(pur["cuda"] - pur["cpu"]) <= 0.01,
          "examples: the card's DTI purity is not within 0.01 of the CPU's")
    return out


def sharded_phase(pos, prof, region, first, scalable) -> tuple:
    """The sharded plan: the layout path; the mesh path on a world-size-1
    NCCL mesh (its process group made here, in this process, and destroyed
    at the end); card vs CPU; 4 gloo ranks sharing the card; the three
    @shard kernel rows; both examples.  Returns the kernel records
    (launches from the mesh path's runs) and the phase's record."""
    import shutil

    from torch.distributed.device_mesh import init_device_mesh

    rec = {}
    rec["layout"], w = layout_path(pos, prof, region, first)
    tmp = ROOT / "build" / "sharded"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        rec["mesh_operator"] = mesh_operator_path(w, region, first, mesh)
        del w
        rec["mesh"] = mesh_paths(pos, prof, region, mesh, first, scalable)
        rec["card_vs_cpu"], spec, card = card_vs_cpu_sharded(mesh, tmp)
    finally:
        dist.destroy_process_group()
    rec["ranks_on_one_card"] = ranks_on_one_card(spec, card, tmp)
    kernels = [knn_shard_record(pos), kmeans_shard_record(first[0].embedding, first[0].labels),
               hash_shard_record(pos)]
    # the launches are counted on the world-size-1 mesh runs, whose one rank
    # gives each kernel the whole problem, not the 4-rank shapes timed here
    launches = dict(
        knn_topk=(rec["mesh"]["gather"]["launches"]["knn_topk"],
                  f"[{N_FULL} × {N_FULL} × 3] (world-size-1 mesh run, gather)"),
        kmeans_iter=(rec["mesh"]["gather"]["launches"]["kmeans_iter"],
                     f"[{N_FULL} × {K_FULL}], k={K_FULL} (world-size-1 mesh run, gather)"),
        hash_codes=(rec["mesh"]["lsh-ring"]["launches"]["hash_codes"],
                    f"[{N_FULL} × 3] (world-size-1 mesh run, LSH ring)"))
    for kern in kernels:
        kern["launches"], kern["launches_at"] = launches[kern["name"].split("@")[0]]
    rec["examples"] = examples_phase()
    shutil.rmtree(tmp, ignore_errors=True)
    return kernels, rec


# ---------------------------------------------------------------------------
# phase 7: LM decode (the model zoo's serving path)
# ---------------------------------------------------------------------------

# (arch, --batch, --seq, --tokens): published widths and depths, bf16, nothing
# cut — a dense model, and the one MoE config whose padded vocab (49,155 →
# 49,184) and padded experts (40 → 48) are both live
DECODE_RUNS = (("qwen3-0.6b", 8, 2048, 64), ("granite-moe-3b-a800m", 8, 1024, 32))
LM_ARCHS = ("glm4-9b", "qwen2-7b", "qwen3-0.6b", "granite-moe-3b-a800m", "olmoe-1b-7b")
# decode step vs forward on the extended sequence, bf16, as a fraction of
# max|logit|: the two paths round to bf16 (2⁻⁹ relative) after differently
# ordered GEMMs, some ten times a layer, and the differences add over the
# layers, a random walk of ~28 · 10 steps — a few percent of the scale
DECODE_BF16_FRAC = 2.0 ** -4
# card vs CPU at SMOKE size, fp32 with TF32 off, as a fraction of max|logit|
# (two layers of fp32 GEMMs summed in another order: ~1e-6)
DECODE_F32_FRAC = 1e-5
PEAK_BF16_FLOPS = 989e12
DECODE_LINE = re.compile(r"decoded (\d+) tokens x batch (\d+): ([0-9.]+) tok/s "
                         r"\(([0-9.]+) ms/step\)")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


class MoESpy:
    """Wraps the transformer's ``moe_ffn``: keeps each call's token count,
    ``dropped_frac`` and the number of distinct experts routed, as device
    tensors (read after the run).  Its extra routing launches belong to no
    timed run."""

    def __enter__(self):
        self.calls = []
        self._orig = tfm.moe_ffn

        def spy(p, x, cfg):
            y, aux = self._orig(p, x, cfg)
            ids = tmoe.route(p, x, cfg)[3]
            hit = torch.zeros(p["w_gate"].shape[0], device=x.device).index_fill_(
                0, ids.reshape(-1), 1.0)
            self.calls.append((x.shape[0], aux["dropped_frac"], hit.sum()))
            return y, aux

        tfm.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        tfm.moe_ffn = self._orig

    def read(self, tokens: int):
        """(mean dropped_frac, mean distinct experts) over the calls on
        ``tokens`` tokens."""
        rows = [(float(d), float(h)) for t, d, h in self.calls if t == tokens]
        return float(np.mean([d for d, _ in rows])), float(np.mean([h for _, h in rows]))


def decode_bound(cfg, params, B: int, prompt: int, steps: int, slots: int,
                 experts_hit=None) -> dict:
    """The least time of one decode step on this run's data: each byte the
    step needs read once (every parameter but the embedding table, of which
    B rows; of the experts, the ones routed — ``experts_hit`` a layer, this
    run's mean; the KV cache's valid prefix, P + i + 1 rows at step i, the
    run's mean) and each output written once (the new KV rows, the logits),
    over 3.35 TB/s; against the operations (2 a weight a token in bf16, the
    attention's 4·len·dh a head in fp32).  Also the count with the whole
    cache read."""
    L, d = cfg.n_layers, cfg.d_model
    el = torch.finfo(cfg.dtype).bits // 8
    weights = tree_bytes(params) - params["embed"].numel() * el + B * d * el
    active = cfg.active_param_count() - cfg.vocab * d  # multiply-adds a token
    if cfg.moe is not None:
        m = params["layers"]["mlp"]
        expert = (m["w_gate"][0, 0].numel() + m["w_up"][0, 0].numel()
                  + m["w_down"][0, 0].numel()) * el
        E_pad = m["w_gate"].shape[1]
        weights -= L * (E_pad - experts_hit) * expert
    row = 2 * L * B * cfg.n_kv_heads * cfg.d_head * el  # one position of k and v
    mean_len = prompt + (steps + 1) / 2
    kv_read = row * mean_len
    out = row + B * cfg.vocab_padded * el
    n_bytes = weights + kv_read + out
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = max(2 * active * B / PEAK_BF16_FLOPS,
                4 * B * cfg.n_heads * L * mean_len * cfg.d_head / PEAK_FP32_FLOPS) * 1e3
    full_cache = (weights + row * slots + out) / PEAK_HBM_BYTES
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops
                else "operations", weight_gb=weights / 1e9, kv_gb=kv_read / 1e9,
                ops_ms=t_ops, full_cache_ms=full_cache * 1e3)


def step_vs_forward(params, prompt, cfg):
    """The reference's check (``tests/test_arch_smoke.py``) at full width:
    (decode step vs the forward on the prompt extended by the greedy token,
    prefill vs the forward's last prompt position — each as a fraction of
    max|logit| over the logical vocab —, argmax agreement of the step,
    max|logit|)."""
    last, cache, cl = launch_serve.prefill_cache(params, prompt, cfg, prompt.shape[1] + 1)
    tok = last.argmax(-1)
    step, _ = tfm.decode_step(params, cache, cl, tok, cfg)
    ext, _ = tfm.forward(params, torch.cat([prompt, tok[:, None]], 1), cfg)
    V = cfg.vocab  # the padded vocab's logits are −1e30 on both sides
    ext, step, last = ext[:, -2:, :V].float(), step[:, 0, :V].float(), last[:, :V].float()
    scale = float(ext.abs().max())
    return (float((step - ext[:, 1]).abs().max()) / scale,
            float((last - ext[:, 0]).abs().max()) / scale,
            float((step.argmax(-1) == ext[:, 1].argmax(-1)).float().mean()), scale)


def busy_record(fn, tag: str, table: str, rows: int = 8) -> dict:
    """``fn()`` under ``torch.profiler``: its wall, the device busy share of
    it, the device records, the ``rows`` kernels that take the most device
    time (logged under ``tag``; the full table to ``chiprun_out/<table>``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof_.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:rows]
    (ROOT / "chiprun_out" / table).write_text(
        events.table(sort_by="self_device_time_total", row_limit=40))
    for e in top:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")
    return dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall, events=events,
                records=sum(e.count for e in events if e.self_device_time_total > 0),
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])


def decode_busy(params, prompt, cfg, S: int, steps: int) -> dict:
    """The decode loop under ``torch.profiler``: device busy share of its
    wall and the kernels that take the most device time."""
    logits, cache, cl = launch_serve.prefill_cache(params, prompt, cfg, S)
    rec = busy_record(lambda: launch_serve.decode_loop(params, cache, cl, logits.argmax(-1),
                                                       cfg, steps),
                      "decode", f"profile_decode_{cfg.name}.txt")
    del rec["events"]
    log(f"[decode] {cfg.name} under the profiler: {steps} steps {rec['wall_s'] * 1e3:.1f} ms "
        f"wall, device busy {rec['device_busy_s'] * 1e3:.1f} ms "
        f"({100 * rec['busy_share']:.1f} %), {rec['records'] / steps:.0f} device records "
        f"(kernels, copies, fills) a step")
    rec["ops_per_step"] = rec["records"] / steps
    return rec


def decode_full(arch: str, B: int, S: int, steps: int, profile: bool) -> dict:
    """One arch at its published config through the launcher's decode mode
    (the counters zeroed just before and read just after: the path runs
    none of the repo's kernels), then, on the launcher's own parameters and
    prompt: the timed greedy decode (prefill ms, decode ms a step, tok/s,
    peak memory, the bound); the gates — every logit finite; a second decode
    bitwise equal to the first (tokens, prefill and step logits); no device
    → host copy inside the decode loop; one decode step = the forward on
    the prompt extended by that token, and the prefill = the forward's
    last prompt position, within ``DECODE_BF16_FRAC`` of max|logit| — for
    an MoE model at capacity factor E/K, where no slot is dropped (at its
    own capacity a token's output depends on which other tokens of the
    batch share its experts, so prefill, forward and decode drop different
    slots; those numbers are printed, not gated)."""
    dev = torch.device("cuda")
    cfg = ARCHS[arch].config
    P = S // 2
    for _, fn in COUNTERS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rc, lines, wall = run_launcher(["--mode", "decode", "--arch", arch, "--batch", str(B),
                                    "--seq", str(S), "--tokens", str(steps)])
    launcher_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in COUNTERS}
    check(rc == 0, f"decode {arch}: the launcher exited {rc}")
    hit = DECODE_LINE.fullmatch(lines[-1]) if lines else None
    check(hit is not None and (int(hit[1]), int(hit[2])) == (steps, B),
          f"decode {arch}: the launcher printed {lines[-1:]!r}")
    check(not any(launches.values()), f"decode {arch}: a pipeline kernel launched: {launches}")

    params, prompt = launch_serve.decode_inputs(cfg, B, P, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = launch_serve.greedy_decode(params, prompt, cfg, S, steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(out.logits).all() and torch.isfinite(out.prefill_logits).all()),
          f"decode {arch}: non-finite logits")
    check(bool((out.tokens < cfg.vocab).all()), f"decode {arch}: a token in the padded vocab")
    with MoESpy() as spy:
        again = launch_serve.greedy_decode(params, prompt, cfg, S, steps)
    same = (torch.equal(out.tokens, again.tokens) and torch.equal(out.logits, again.logits)
            and torch.equal(out.prefill_logits, again.prefill_logits))
    check(same, f"decode {arch}: a second decode differs (tokens or logits)")
    moe_rec = None
    if cfg.moe is not None:
        drop_prefill, _ = spy.read(B * P)
        drop_decode, experts_hit = spy.read(B)
        moe_rec = dict(dropped_frac_prefill=drop_prefill, dropped_frac_decode=drop_decode,
                       experts_hit=experts_hit)
    del again

    # no device → host copy inside the decode loop
    logits, cache, cl = launch_serve.prefill_cache(params, prompt, cfg, S)
    tok = logits.argmax(-1)
    d2h = d2h_copy_bytes(lambda: launch_serve.decode_loop(params, cache, cl, tok, cfg, 4))
    check(not d2h, f"decode {arch}: the decode loop copied {d2h} bytes to the host")
    del logits, cache

    # one decode step = the forward on the extended sequence; an MoE model
    # checked dropless, reported at its own capacity
    gate_cfg = cfg
    if cfg.moe is not None:
        gate_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    err_step, err_prefill, agree, scale = step_vs_forward(params, prompt, gate_cfg)
    check(err_step <= DECODE_BF16_FRAC and err_prefill <= DECODE_BF16_FRAC,
          f"decode {arch}: decode step vs extended forward {err_step:.3e}, prefill vs forward "
          f"{err_prefill:.3e} of max|logit| (gate {DECODE_BF16_FRAC:.3e})")
    if cfg.moe is not None:
        with MoESpy() as spy:
            moe_rec["at_capacity"] = dict(zip(("step_vs_forward", "prefill_vs_forward",
                                                "argmax_agreement"),
                                               step_vs_forward(params, prompt, cfg)[:3]))
        moe_rec["at_capacity"]["dropped_frac_forward"] = spy.read(B * (P + 1))[0]

    bound = decode_bound(cfg, params, B, P, steps, S,
                         moe_rec["experts_hit"] if moe_rec else None)
    ms_step = out.decode_s / steps * 1e3
    rec = dict(arch=arch, batch=B, seq=S, prompt=P, steps=steps, launcher_line=lines[-1],
               launcher_wall_s=wall, launcher_peak_gb=launcher_peak_gb, launches=launches,
               prefill_ms=out.prefill_s * 1e3, decode_ms_step=ms_step,
               tok_s=steps * B / out.decode_s, peak_gb=peak_gb, d2h_copies=len(d2h),
               step_vs_forward=err_step, prefill_vs_forward=err_prefill,
               argmax_agreement=agree, deterministic=same, moe=moe_rec, **bound)
    log(f"[decode] {arch} (published config, bf16) batch {B}, prompt {P}, cache {S}, {steps} "
        f"steps: prefill {rec['prefill_ms']:.2f} ms; decode {ms_step:.3f} ms/step, "
        f"{rec['tok_s']:.1f} tok/s; peak device memory {peak_gb:.2f} GB (launcher run "
        f"{launcher_peak_gb:.2f} GB); launcher: {lines[-1]!r}; kernel launches {launches}")
    log(f"[decode] {arch} bound a step {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
        f"weights {bound['weight_gb']:.3f} GB + KV prefix {bound['kv_gb']:.3f} GB over "
        f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s; operations {bound['ops_ms']:.4f} ms; with the "
        f"whole {S}-slot cache {bound['full_cache_ms']:.4f} ms) — {ms_step / bound['bound_ms']:.1f}"
        f"× the bound")
    log(f"[decode] {arch} gates: logits finite; second decode bitwise equal; device→host "
        f"copies in the loop {len(d2h)}; decode step vs extended forward {err_step:.3e}, prefill "
        f"vs forward {err_prefill:.3e} of max|logit| {scale:.3f} (gate {DECODE_BF16_FRAC:.4f}"
        + ("; dropless, capacity factor E/K" if moe_rec else "")
        + f"); argmax agreement {agree:.3f}")
    if moe_rec:
        cap = moe_rec["at_capacity"]
        log(f"[decode] {arch} dropped_frac prefill {moe_rec['dropped_frac_prefill']:.4f}, "
            f"decode {moe_rec['dropped_frac_decode']:.4f}, extended forward "
            f"{cap['dropped_frac_forward']:.4f}; experts routed a layer a step "
            f"{moe_rec['experts_hit']:.2f}; at capacity factor {cfg.moe.capacity_factor} "
            f"(not gated: a dropped slot depends on the other tokens of the batch) decode step "
            f"vs extended forward {cap['step_vs_forward']:.3e}, prefill vs forward "
            f"{cap['prefill_vs_forward']:.3e}, argmax agreement {cap['argmax_agreement']:.3f}")
    if profile:
        rec["profile"] = decode_busy(params, prompt, cfg, S, steps)
    return rec


def decode_card_vs_cpu(steps: int = 8) -> dict:
    """Each LM arch's SMOKE config in fp32 (TF32 off): one parameter tree
    made on the CPU from a seed and copied to the card, one prompt; the
    prefill's and ``steps`` decode steps' logits on the card within
    ``DECODE_F32_FRAC`` of max|logit| of the CPU's, and the greedy tokens
    equal."""
    out = {}
    for arch in LM_ARCHS:
        cfg = ARCHS[arch].smoke_config
        check(cfg.dtype == torch.float32, f"{arch}: SMOKE is not fp32")
        params = tfm.init_params(cfg, cpu_generator(0), device="cpu")
        prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (4, 24)))
        cpu = launch_serve.greedy_decode(params, prompt, cfg, 32, steps)
        card = launch_serve.greedy_decode(convert.transformer_params(params, device="cuda"),
                                          prompt.cuda(), cfg, 32, steps)
        V = cfg.vocab
        scale = max(float(cpu.logits[..., :V].abs().max()),
                    float(cpu.prefill_logits[..., :V].abs().max()))
        err = max(float((card.logits.cpu() - cpu.logits).abs().max()),
                  float((card.prefill_logits.cpu() - cpu.prefill_logits).abs().max())) / scale
        same = torch.equal(card.tokens.cpu(), cpu.tokens)
        out[arch] = dict(err=err, tokens_equal=same)
        check(same, f"decode card vs CPU ({arch} SMOKE): greedy tokens differ")
        check(err <= DECODE_F32_FRAC, f"decode card vs CPU ({arch} SMOKE): logits "
                                      f"{err:.3e} of max|logit| (gate {DECODE_F32_FRAC})")
    log("[decode] card vs CPU at SMOKE size (fp32, TF32 off), prefill + "
        f"{steps} steps: " + ", ".join(f"{a} {r['err']:.2e}" for a, r in out.items())
        + f" of max|logit| (gate {DECODE_F32_FRAC}); greedy tokens equal on all five")
    return out


def decode_phase(profile: bool) -> dict:
    """The model zoo's serving path: the full-width decode runs, then card
    vs CPU at SMOKE size."""
    rec = {arch: decode_full(arch, B, S, steps, profile) for arch, B, S, steps in DECODE_RUNS}
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = decode_card_vs_cpu()
    return rec


# ---------------------------------------------------------------------------
# phase 8: train — the LM training path and AutoInt (no kernel of the repo)
# ---------------------------------------------------------------------------

# qwen3-0.6b at its published widths and depth in bf16: 8 steps of batch 8 ×
# 1,024 tokens (LM_ACCUM = 2: microbatches of 4), remat "nothing", OPT_CFG
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "qwen3-0.6b", 8, 8, 1024
# remat variants of one step: the forward is the same operations, so the
# losses are bitwise equal; grad_norm within this relative difference (bf16
# gradients, the embedding's backward summing with atomics)
REMAT_GN_RTOL = 1e-2
# a resumed run against an uninterrupted one on the card, each leaf's max
# difference over its max|p| (atomics in the backward pass may reorder sums)
RESUME_RTOL = 1e-6
# card vs CPU at SMOKE size in fp32 (TF32 off), 3 steps: losses relative,
# parameters of max|p| over the tree.  Not of each leaf's own max: AdamW's
# step lr·m̂/(√v̂ + ε) is steep where a gradient is within rounding of ε —
# a key bias's gradient is zero but for rounding (softmax ignores a shift
# shared by all keys), and such elements differ by a good part of lr
TRAIN_F32_RTOL = 1e-5
TRAIN_CARD_VS_CPU_STEPS = 3
AUTOINT_STEPS, SERVE_CALLS, RETRIEVAL_CALLS, BULK_CALLS = 5, 100, 20, 3
# device records of a train step by kind (first match): fp32 GEMMs on the
# CUDA cores (the attention's products, TF32 off), tensor-core GEMMs (the
# bf16 projections, MLP and head), AdamW's multi-tensor passes, reductions,
# copies and fills, and the elementwise passes
TRAIN_KERNEL_KINDS = (("gemm fp32", r"f32f32|sgemm"), ("gemm bf16", r"nvjet|gemm|xmma|cutlass"),
                      ("foreach", r"multi_tensor"), ("reduce", r"reduce_kernel|softmax"),
                      ("copy/convert", r"Memcpy|Memset|copy"), ("elementwise", r"elementwise"))
STEP_LINE = re.compile(r"\[step +(\d+)\] loss=([0-9.]+) grad_norm=([0-9.]+) dt=([0-9.]+)s")


class StepClock:
    """Wraps ``launch.train.make_train_step``: each step of the launcher's
    run timed on the host clock between two synchronisations, with its peak
    memory and its metrics (device tensors, read after the run)."""

    def __enter__(self):
        self.ms, self.peak_gb, self.metrics = [], [], []
        self._orig = launch_train.make_train_step

        def make(*args, **kw):
            step = self._orig(*args, **kw)

            def timed(state, batch):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                self.peak_gb.append(torch.cuda.max_memory_allocated() / 1e9)
                self.metrics.append(metrics)
                return state, metrics

            return timed

        launch_train.make_train_step = make
        return self

    def __exit__(self, *exc):
        launch_train.make_train_step = self._orig


def run_train_launcher(argv) -> tuple:
    """``launch.train.main(argv)`` in process: (final state, its stdout
    lines, host seconds), the lines echoed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state = launch_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"[launcher] {ln[:400]}")
    return state, lines, wall


def lm_train_bound(cfg, params, tokens: int, seq: int, accum: int, remat: bool) -> dict:
    """The least time of one train step on this run's data: the products'
    operations — the layers' and the head's GEMMs in bf16 (2 a weight a
    token), the causal attention's two products in fp32 (2·B·H·S²·dh a
    layer: half the S×S scores are needed) — three forwards' worth for the
    forward and backward passes plus the layers' re-forward under remat, at
    the bf16 dense and fp32 peaks; plus AdamW's bytes at the HBM rate (p,
    the gradient — fp32 when accumulated —, m and v read once; p, m and v
    written once)."""
    layer = cfg.active_param_count() - 2 * cfg.vocab * cfg.d_model  # weights a token
    head = cfg.vocab * cfg.d_model
    attn = 2 * cfg.n_layers * (tokens // seq) * cfg.n_heads * seq * seq * cfg.d_head
    gemm = 3 * 2 * (layer + head) * tokens + (2 * layer * tokens if remat else 0)
    attn_ops = (3 + int(remat)) * attn
    ops_ms = (gemm / PEAK_BF16_FLOPS + attn_ops / PEAK_FP32_FLOPS) * 1e3
    opt_bytes = 0
    for p in _tree.leaves(params):
        el = p.element_size()
        opt_bytes += p.numel() * (2 * el + (4 if accum > 1 else el) + 4 * 4)
    bytes_ms = opt_bytes / PEAK_HBM_BYTES * 1e3
    return dict(bound_ms=ops_ms + bytes_ms, ops_ms=ops_ms, bytes_ms=bytes_ms,
                gemm_flop=gemm, attn_flop=attn_ops, opt_gb=opt_bytes / 1e9)


def _named_leaves(tree, prefix=""):
    """(path, leaf) in flatten order, through dicts and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def clone_state(state) -> TrainState:
    return _tree.map(torch.clone, state)


def remat_compare(state, batch, cfg, accum: int) -> dict:
    """One step each with remat off, ``"nothing"`` and ``"dots"`` from clones
    of ``state`` on ``batch``: loss, grad_norm, step ms and peak memory (the
    state and its clone included in every peak).  Remat off fits at this
    shape (61.2 GB on an 80 GB H100); a shape where it does not raises."""
    out = {}
    for tag, remat, policy in (("off", False, "nothing"), ("nothing", True, "nothing"),
                               ("dots", True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        step = make_train_step(functools.partial(tfm.train_loss, cfg=c), OPT_CFG,
                               accum_steps=accum)
        st = clone_state(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, m = step(st, batch)
        torch.cuda.synchronize()
        out[tag] = dict(loss=m["loss"].clone(), grad_norm=float(m["grad_norm"]),
                        ms=(time.perf_counter() - t0) * 1e3,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del st
        torch.cuda.empty_cache()
    return out


def train_busy(step, state, batch) -> dict:
    """One train step under ``torch.profiler``: device busy share of its
    wall, its device time by kernel kind, the kernels that take the most."""
    rec = busy_record(lambda: step(state, batch), "train", "profile_train.txt", rows=10)
    groups = {}
    for e in rec.pop("events"):
        if e.self_device_time_total > 0:
            kind = next((k for k, pat in TRAIN_KERNEL_KINDS if re.search(pat, e.key)), "other")
            groups[kind] = groups.get(kind, 0.0) + e.self_device_time_total / 1e3
    log(f"[train] one step under the profiler: {rec['wall_s'] * 1e3:.1f} ms wall, device busy "
        f"{rec['device_busy_s'] * 1e3:.1f} ms ({100 * rec['busy_share']:.1f} %), "
        f"{rec['records']} device records; by kind: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    rec["by_kind_ms"] = groups
    return rec


def train_checkpoint(state, step: int) -> dict:
    """``state`` saved through ``CheckpointManager`` under ``build/`` and
    restored onto the card: save s, restore s, MB; gate bitwise equal."""
    d = ROOT / "build" / "train_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    free_gb = shutil.disk_usage(ROOT).free / 1e9
    mgr = CheckpointManager(str(d), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(step, state, blocking=True)
    save_s = time.perf_counter() - t0
    mb = sum(f.stat().st_size for f in (d / f"step_{step:08d}").iterdir()) / 1e6
    t0 = time.perf_counter()
    got = mgr.restore(step, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
               for a, b in zip(_tree.leaves(got), _tree.leaves(state)))
    del got
    shutil.rmtree(d, ignore_errors=True)
    check(same, "train: the restored checkpoint differs from the saved state")
    log(f"[train] checkpoint of the step-{step} state: {mb:.1f} MB, save {save_s:.2f} s, "
        f"restore onto the card {restore_s:.2f} s, bitwise equal ({free_gb:.0f} GB free before)")
    return dict(mb=mb, save_s=save_s, restore_s=restore_s, bitwise=same)


def lm_train_full(profile: bool) -> dict:
    """qwen3-0.6b through ``launch.train.main`` (counters zeroed just before
    and read just after: the path runs none of the repo's kernels), every
    step timed; then on the final state: the full-width checkpoint, the
    remat comparison, no device → host copy inside a step."""
    dev = torch.device("cuda")
    cfg = ARCHS[TRAIN_ARCH].config
    accum = LM_ACCUM[cfg.name]
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ)]
    for _, fn in COUNTERS:
        fn.launches = 0
    with StepClock() as clock:
        state, lines, wall = run_train_launcher(argv)
    launches = {name: fn.launches for name, fn in COUNTERS}
    check(not any(launches.values()), f"train: a pipeline kernel launched: {launches}")
    hit = STEP_LINE.fullmatch(lines[-1]) if lines else None
    check(hit is not None and int(hit[1]) == TRAIN_STEPS, f"train: the launcher printed "
                                                          f"{lines[-1:]!r}")
    check(len(clock.ms) == TRAIN_STEPS and int(state.step) == TRAIN_STEPS,
          f"train: {len(clock.ms)} steps timed, state at step {int(state.step)}")
    losses = [float(m["loss"]) for m in clock.metrics]
    gnorms = [float(m["grad_norm"]) for m in clock.metrics]
    check(all(map(math.isfinite, losses + gnorms)), f"train: losses {losses}, grad_norm {gnorms}")
    # every drawn weight changed; the norm gains start at 1.0, where one
    # bf16 ulp (2⁻⁸ below, 2⁻⁷ above) is far more than 8 warmup steps move
    # them (Σ lr ≈ 1e-4; no master weights, as in the reference)
    init = _named_leaves(tfm.init_params(cfg, cpu_generator(0), device=dev))
    moved = {n: float((a != b).float().mean()) for (n, b), a in
             zip(init, _tree.leaves(state.params))}
    drawn = [n for n, b in init if bool(b.min() != b.max())]  # not a constant gain
    del init
    still = [n for n, f in moved.items() if f == 0.0]
    check(all(moved[n] > 0 for n in drawn), f"train: drawn weights did not change: {still}")
    ms = float(np.median(clock.ms[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound = lm_train_bound(cfg, state.params, tokens, TRAIN_SEQ, accum, cfg.remat)
    peak_gb = max(clock.peak_gb)
    log(f"[train] {TRAIN_ARCH} (published config, bf16) batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"accum {accum}, remat {cfg.remat_policy!r}: step ms (median of steps 2-{TRAIN_STEPS}) "
        f"{ms:.1f}, all {[round(x, 1) for x in clock.ms]}; {tokens / ms * 1e3:.0f} tokens/s; "
        f"peak device memory {peak_gb:.2f} GB; launcher wall {wall:.1f} s; losses "
        f"{[round(x, 4) for x in losses]}, grad_norm {[round(x, 3) for x in gnorms]}; "
        f"leaves unchanged in bf16 (gains at 1.0): {still}")
    log(f"[train] {TRAIN_ARCH} bound a step {bound['bound_ms']:.2f} ms: GEMMs "
        f"{bound['gemm_flop']:.3e} flop at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s + fp32 "
        f"attention {bound['attn_flop']:.3e} flop at {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{bound['ops_ms']:.2f} ms, AdamW {bound['opt_gb']:.2f} GB at "
        f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s = {bound['bytes_ms']:.2f} ms — "
        f"{ms / bound['bound_ms']:.1f}× the bound")
    ckpt_rec = train_checkpoint(state, TRAIN_STEPS)

    stream = MarkovTokenStream(cfg.vocab, seed=0)
    stream._step = TRAIN_STEPS
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.next_batch(TRAIN_BATCH, TRAIN_SEQ).items()}
    remat = remat_compare(state, batch, cfg, accum)
    base = remat["nothing"]
    for t, r in remat.items():
        check(torch.equal(r["loss"], base["loss"]),
              f"train: remat {t} loss {float(r['loss'])!r} != {float(base['loss'])!r}")
        check(abs(r["grad_norm"] - base["grad_norm"]) <= REMAT_GN_RTOL * base["grad_norm"],
              f"train: remat {t} grad_norm {r['grad_norm']} vs {base['grad_norm']}")
    for r in remat.values():
        r["loss"] = float(r["loss"])
    check(all(base["peak_gb"] <= r["peak_gb"] for r in remat.values()),
          f"train: remat 'nothing' is not the lowest peak: "
          f"{ {t: r['peak_gb'] for t, r in remat.items()} }")
    log("[train] remat, one step each from one state and batch: " + "; ".join(
        f"{t}: peak {r['peak_gb']:.2f} GB, {r['ms']:.1f} ms, loss {r['loss']:.6f}, grad_norm "
        f"{r['grad_norm']:.5f}" for t, r in remat.items())
        + " (losses bitwise equal; 'nothing' the lowest)")

    step = make_train_step(functools.partial(tfm.train_loss, cfg=cfg), OPT_CFG,
                           accum_steps=accum)
    step(state, batch)  # warm: the profiler's window holds one steady step
    d2h = d2h_copy_bytes(lambda: step(state, batch))
    check(not d2h, f"train: a step copied {d2h} bytes to the host")
    rec = dict(arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ, accum=accum,
               launcher_lines=lines, launcher_wall_s=wall, launches=launches, step_ms=clock.ms,
               step_ms_median=ms, tokens_s=tokens / ms * 1e3, peak_gb=peak_gb,
               peak_gb_steps=clock.peak_gb, losses=losses, grad_norm=gnorms, d2h_copies=len(d2h),
               changed_frac=moved,
               checkpoint=ckpt_rec, remat=remat, **bound)
    if profile:
        rec["profile"] = train_busy(step, state, batch)
    del state, step
    torch.cuda.empty_cache()
    return rec


def train_resume() -> dict:
    """The launcher at ``--smoke`` on the card: 6 steps with a checkpoint
    dir, then 10 resumed from it, against 10 uninterrupted; each leaf within
    ``RESUME_RTOL`` of its max|p|, and whether bitwise."""
    d = ROOT / "build" / "train_resume"
    shutil.rmtree(d, ignore_errors=True)
    run_train_launcher(["--smoke", "--steps", "6", "--ckpt-dir", str(d)])
    resumed, lines, _ = run_train_launcher(["--smoke", "--steps", "10", "--ckpt-dir", str(d)])
    check("[resume] restored checkpoint at step 6" in lines, f"train: no resume line: {lines}")
    whole, _, _ = run_train_launcher(["--smoke", "--steps", "10"])
    pairs = list(zip(_tree.leaves(resumed), _tree.leaves(whole)))
    err = max(float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                1e-30) for a, b in pairs)
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    shutil.rmtree(d, ignore_errors=True)
    check(err <= RESUME_RTOL, f"train: resumed vs uninterrupted {err:.3e} of max|p|")
    log(f"[train] resume through the launcher (--smoke, 6 then 10 steps vs 10): max "
        f"{err:.3e} of a leaf's max|p| (gate {RESUME_RTOL}); bitwise equal: {bitwise}")
    return dict(err=err, bitwise=bitwise)


def autoint_batch(cfg, n: int, seed: int, dev) -> dict:
    """Numpy-seeded single-hot ids, multi-hot bags and labels, on ``dev``."""
    rng = np.random.default_rng(seed)
    b = {"ids": rng.integers(0, cfg.rows_per_table, (n, cfg.n_fields - cfg.n_multihot)),
         "bag_ids": rng.integers(0, cfg.rows_per_table, (n, cfg.n_multihot, cfg.hot_per_field)),
         "labels": rng.integers(0, 2, (n,))}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def autoint_flop(cfg, n: int) -> float:
    """The forward's products for ``n`` rows: the four projections a layer
    and the two attention products a head, the logit."""
    F, H, da = cfg.n_fields, cfg.n_heads, cfg.d_attn
    flop, d_in = 0, cfg.embed_dim
    for _ in range(cfg.n_attn_layers):
        flop += 4 * 2 * F * d_in * H * da + 2 * 2 * H * F * F * da
        d_in = H * da
    return n * (flop + 2 * F * d_in)


def host_ms(fn, calls: int) -> list:
    """Host-clock ms of each of ``calls`` calls, each ended by a
    synchronisation (one warm call first)."""
    fn()
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def autoint_full() -> dict:
    """AutoInt at its published config (39 × 1,000,000 × 16 fp32 tables) at
    the reference's ``RECSYS_SHAPES``: train steps, serving latency, bulk
    scoring and retrieval, with bounds and peak memory."""
    dev = torch.device("cuda")
    arch = ARCHS["autoint"]
    cfg, shapes = arch.config, {k: v.dims for k, v in arch.shapes.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = trs.init_params(cfg, cpu_generator(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _tree.leaves(params))
    state = init_state(params)
    B = shapes["train_batch"]["batch"]
    batch = autoint_batch(cfg, B, 0, dev)
    step = make_train_step(functools.partial(trs.train_loss, cfg=cfg), OPT_CFG)
    ms, losses = [], []
    for _ in range(AUTOINT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(map(math.isfinite, losses)), f"autoint: losses {losses}")
    check(losses[-1] != losses[0], f"autoint: the loss did not change: {losses}")
    gathered = B * (cfg.n_fields - cfg.n_multihot + cfg.n_multihot * cfg.hot_per_field)
    # AdamW: p, g, m, v read and p, m, v written (fp32); the dense table
    # gradient zeroed; the gathered rows read and their gradient scattered
    t_bytes = (28 * n_params + 4 * params["tables"].numel()
               + 2 * 4 * gathered * cfg.embed_dim) / PEAK_HBM_BYTES * 1e3
    t_ops = 3 * autoint_flop(cfg, B) / PEAK_FP32_FLOPS * 1e3
    train_ms = float(np.median(ms[1:]))

    def serve_rec(n, calls, seed):
        b = autoint_batch(cfg, n, seed, dev)
        with torch.no_grad():
            times = host_ms(lambda: trs.forward_logits(state.params, b, cfg), calls)
            logits = trs.forward_logits(state.params, b, cfg)
        check(logits.shape == (n,) and bool(torch.isfinite(logits).all()),
              f"autoint: serving logits at {n} rows")
        rows = n * (cfg.n_fields - cfg.n_multihot + cfg.n_multihot * cfg.hot_per_field)
        b_ms = (rows * cfg.embed_dim * 4 + 4 * sum(p.numel() for p in _tree.leaves(
            state.params["layers"])) + 8 * n) / PEAK_HBM_BYTES * 1e3
        o_ms = autoint_flop(cfg, n) / PEAK_FP32_FLOPS * 1e3
        return dict(batch=n, p50_ms=float(np.percentile(times, 50)),
                    p99_ms=float(np.percentile(times, 99)), ms=times,
                    bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations")

    torch.cuda.reset_peak_memory_stats()
    serve = serve_rec(shapes["serve_p99"]["batch"], SERVE_CALLS, 1)
    bulk = serve_rec(shapes["serve_bulk"]["batch"], BULK_CALLS, 2)
    n_cand = shapes["retrieval_cand"]["n_candidates"]
    cand = _random.Stream.from_generator(cpu_generator(3)).normal((n_cand, 64), dev)
    qb = autoint_batch(cfg, shapes["retrieval_cand"]["batch"], 4, dev)
    with torch.no_grad():
        def retrieve():
            return trs.retrieval_scores(trs.query_embedding(state.params, qb, cfg), cand)
        r_ms = host_ms(retrieve, RETRIEVAL_CALLS)
        scores = retrieve()
    check(scores.shape == (1, n_cand) and bool(torch.isfinite(scores).all()),
          "autoint: retrieval scores")
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    retr = dict(n_candidates=n_cand, ms_median=float(np.median(r_ms)), ms=r_ms,
                bound_ms=n_cand * 64 * 4 * 2 / PEAK_HBM_BYTES * 1e3, bound_by="bytes")
    rec = dict(n_params=n_params, init_s=init_s, train_batch=B, step_ms=ms,
               step_ms_median=train_ms, rows_s=B / train_ms * 1e3, losses=losses,
               train_bound_ms=t_bytes + t_ops, train_bytes_ms=t_bytes, train_ops_ms=t_ops,
               train_peak_gb=train_peak, serve_p99=serve, serve_bulk=bulk, retrieval=retr,
               serve_peak_gb=serve_peak)
    log(f"[train] autoint (published config: {n_params / 1e6:.1f} M parameters, "
        f"{params['tables'].numel() * 4 / 1e9:.2f} GB of tables) drawn on the card in "
        f"{init_s:.2f} s; train batch {B}: step ms (median of 2-{AUTOINT_STEPS}) {train_ms:.2f}, "
        f"all {[round(x, 2) for x in ms]}, {B / train_ms * 1e3:.0f} rows/s; bound "
        f"{t_bytes + t_ops:.2f} ms (bytes {t_bytes:.2f} + fp32 operations {t_ops:.2f}) — "
        f"{train_ms / (t_bytes + t_ops):.1f}× the bound; losses {[round(x, 6) for x in losses]}; "
        f"peak {train_peak:.2f} GB")
    log(f"[train] autoint serve_p99 (batch {serve['batch']}, {SERVE_CALLS} calls): p50 "
        f"{serve['p50_ms']:.3f} ms, p99 {serve['p99_ms']:.3f} ms (bound {serve['bound_ms']:.4f} "
        f"ms, {serve['bound_by']}); serve_bulk (batch {bulk['batch']}): p50 {bulk['p50_ms']:.2f} "
        f"ms (bound {bulk['bound_ms']:.3f} ms, {bulk['bound_by']}); retrieval_cand (query "
        f"embedding + {n_cand} × 64 scores): {retr['ms_median']:.3f} ms (bound "
        f"{retr['bound_ms']:.4f} ms, bytes); peak {serve_peak:.2f} GB")
    del state, params, cand
    torch.cuda.empty_cache()
    return rec


def train_card_vs_cpu(steps: int = TRAIN_CARD_VS_CPU_STEPS) -> dict:
    """Each LM arch's SMOKE config and AutoInt's in fp32 (TF32 off): weights
    made on the CPU from a seed and carried to the card by ``convert``,
    ``steps`` steps of ``make_train_step(train_loss, OPT_CFG)`` on both; the
    losses within ``TRAIN_F32_RTOL`` relative and the parameters within
    ``TRAIN_F32_RTOL`` of max|p| over the tree (each leaf's error over its
    own max printed)."""
    out = {}
    for arch in LM_ARCHS + ("autoint",):
        cfg = ARCHS[arch].smoke_config
        check(cfg.dtype == torch.float32, f"{arch}: SMOKE is not fp32")
        if arch == "autoint":
            params = trs.init_params(cfg, cpu_generator(0), device="cpu")
            card_params = convert.autoint_params(params, device="cuda")
            loss_fn = functools.partial(trs.train_loss, cfg=cfg)
            batches = [autoint_batch(cfg, 64, 10 + i, "cpu") for i in range(steps)]
        else:
            params = tfm.init_params(cfg, cpu_generator(0), device="cpu")
            card_params = convert.transformer_params(params, device="cuda")
            loss_fn = functools.partial(tfm.train_loss, cfg=cfg)
            batches = []
            for i in range(steps):
                toks = torch.from_numpy(np.random.default_rng(10 + i).integers(0, cfg.vocab,
                                                                               (4, 32)))
                batches.append({"tokens": toks, "labels": toks})
        step = make_train_step(loss_fn, OPT_CFG)
        cpu, card = init_state(params), init_state(card_params)
        loss_err = 0.0
        for b in batches:
            cpu, cm_ = step(cpu, b)
            card, gm = step(card, {k: v.cuda() for k, v in b.items()})
            loss_err = max(loss_err, abs(float(gm["loss"]) - float(cm_["loss"]))
                           / abs(float(cm_["loss"])))
        diff = [(float((a.cpu() - b).abs().max()), float(b.abs().max()))
                for a, b in zip(_tree.leaves(card.params), _tree.leaves(cpu.params))]
        p_err = max(d for d, _ in diff) / max(m for _, m in diff)
        leaf_err = max(d / max(m, 1e-30) for d, m in diff)
        out[arch] = dict(loss=loss_err, params=p_err, worst_leaf=leaf_err)
        check(loss_err <= TRAIN_F32_RTOL and p_err <= TRAIN_F32_RTOL,
              f"train card vs CPU ({arch} SMOKE): losses {loss_err:.3e}, params {p_err:.3e}")
    log(f"[train] card vs CPU at SMOKE size (fp32, TF32 off), {steps} steps: "
        + ", ".join(f"{a} loss {r['loss']:.2e} params {r['params']:.2e} (worst leaf "
                    f"{r['worst_leaf']:.2e} of its own max)" for a, r in out.items())
        + f"; gate {TRAIN_F32_RTOL} of the loss, and of max|p| over the tree")
    return out


def train_phase(profile: bool) -> dict:
    """The training path: qwen3-0.6b through the launcher at full width,
    the launcher's resume on the card, AutoInt at its published config, and
    card vs CPU at SMOKE size."""
    rec = dict(lm=lm_train_full(profile), resume=train_resume(), autoint=autoint_full())
    rec["card_vs_cpu"] = train_card_vs_cpu()
    return rec


# ---------------------------------------------------------------------------
# phase 9: gnn — the GNN family's training (no kernel of the repo)
# ---------------------------------------------------------------------------

# (run, arch, shape): published configs at full width and depth through
# gnn_shape_config and make_train_step(loss, OPT_CFG), synthetic batches
# drawn from a seed on the card.  G5 is cut: nequip at ogb_products would be
# ~59 edge chunks × 5 layers of tensor products, each run 3 times (forward,
# remat re-forward, the chunked backward's re-forward), a minute or more a
# step; 4,200,000 edges (5 chunks, the last ragged) over 166,000 nodes keep
# products' mean degree (≈ 25.3) and run sum_over_chunks on the card.
GNN_RUNS = (("G1", "gcn-cora", "full_graph_sm"), ("G2", "gcn-cora", "ogb_products"),
            ("G3", "pna", "minibatch_lg"), ("G4", "nequip", "molecule"),
            ("G5", "nequip", "ogb_products"), ("G6", "equiformer-v2", "molecule"))
GNN_STEPS = {"G5": 2, "G5-gate": 2}  # steps a run (the first a warmup); 3 unless named
G5_NODES, G5_EDGES = 166_000, 4_200_000
# G5's memory gate: the chunked step against the unchunked step of one graph.
# Unchunked at 4.2 M edges would hold the per-edge radial weights ([E, 15, 32]
# f32, 8.1 GB, twice), the 15 paths' messages (51 rows of 32 f32 an edge,
# 27 GB) and the gathered features (4.8 GB) of a layer at once: too near an
# 80 GB card's capacity.  So the gate runs on 2.5 chunks' worth of edges (3
# chunks, the last half full) at the same mean degree, ~40 GB unchunked.
G5_GATE_EDGES = 5 * (1 << 20) // 2
EQUIV_RTOL = 5e-5  # rotation + translation, tests/test_e3.py's gate


def gnn_graph(run: str, arch: str, shape: str, cfg, dev, seed: int, csr=None) -> tuple:
    """The run's batch on ``dev`` (synthetic, from ``seed``) and (nodes,
    edges, the sampler's host ms or None).  Sizes are GNN_SHAPES padded by
    ``_pad_div``; padding nodes and edges are masked out."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.cells import _pad_div
    from repro_torch.data.sampler import NeighborSampler, subgraph_capacities
    from repro_torch.models.gnn.graph import GraphBatch

    d = GNN_SHAPES[shape].dims
    g = torch.Generator(device=dev).manual_seed(seed)
    geometric = arch in ("nequip", "equiformer-v2")
    sample_ms = None

    def randint(hi, n):
        return torch.randint(0, hi, (n,), generator=g, device=dev, dtype=torch.int32)

    if shape == "molecule":
        G_, n1, e1 = d["batch"], d["n_nodes"], d["n_edges"]
        N, E = _pad_div(G_ * n1), _pad_div(G_ * e1)
        check((N, E) == (G_ * n1, G_ * e1), "gnn: the molecule batch would need padding")
        base = torch.arange(G_, device=dev, dtype=torch.int32).repeat_interleave(e1) * n1
        src, dst = base + randint(n1, G_ * e1), base + randint(n1, G_ * e1)
        gid = torch.arange(G_, device=dev, dtype=torch.int32).repeat_interleave(n1)
        labels = torch.randn(G_, generator=g, device=dev)
        batch = GraphBatch(
            node_feat=torch.zeros((N, 1), device=dev), edge_src=src, edge_dst=dst,
            edge_mask=torch.ones(E, device=dev), labels=labels,
            label_mask=torch.ones(G_, device=dev),
            positions=torch.randn((N, 3), generator=g, device=dev) * 2,
            species=randint(cfg.n_species, N), graph_id=gid, n_graphs=G_)
        return batch, N, E, sample_ms
    if shape == "minibatch_lg":
        indptr, indices, feat, node_labels = csr
        sampler = NeighborSampler(indptr, indices, seed=seed)
        t0 = time.perf_counter()
        seeds = np.random.default_rng(seed).choice(len(indptr) - 1, d["batch_nodes"],
                                                   replace=False)
        sub = sampler.sample(seeds, (d["fanout0"], d["fanout1"]))
        sample_ms = (time.perf_counter() - t0) * 1e3
        N, E = subgraph_capacities(d["batch_nodes"], (d["fanout0"], d["fanout1"]))
        ids = torch.from_numpy(sub.node_ids).to(dev)
        lmask = torch.zeros(N, device=dev)
        lmask[:sub.seed_count] = 1.0
        batch = GraphBatch(
            node_feat=feat.index_select(0, ids), edge_src=torch.from_numpy(sub.edge_src).to(dev),
            edge_dst=torch.from_numpy(sub.edge_dst).to(dev),
            edge_mask=torch.from_numpy(sub.edge_mask).to(dev),
            labels=node_labels.index_select(0, ids), label_mask=lmask)
        return batch, N, E, sample_ms
    n_real, e_real = (G5_NODES, G5_EDGES) if run == "G5" else (d["n_nodes"], d["n_edges"])
    if run == "G5-gate":
        n_real, e_real = round(G5_GATE_EDGES * G5_NODES / G5_EDGES), G5_GATE_EDGES
    N, E = _pad_div(n_real), _pad_div(e_real)
    emask = torch.zeros(E, device=dev)
    emask[:e_real] = 1.0
    lmask = torch.zeros(N, device=dev)
    lmask[:n_real] = 1.0
    src, dst = randint(n_real, E), randint(n_real, E)
    batch = GraphBatch(
        node_feat=(torch.zeros((N, 1), device=dev) if geometric
                   else torch.randn((N, d["d_feat"]), generator=g, device=dev)),
        edge_src=src, edge_dst=dst, edge_mask=emask,
        labels=randint(d["n_classes"], N), label_mask=lmask,
        positions=torch.randn((N, 3), generator=g, device=dev) * 2 if geometric else None,
        species=randint(cfg.n_species, N) if geometric else None)
    return batch, N, E, sample_ms


def reddit_csr(dev) -> tuple:
    """A synthetic CSR of Reddit's size (232,965 nodes, 114,615,892 edges:
    degree ≈ 492, neighbours uniform) on the host, int32 indices (458 MB),
    and a [232,965, 602] feature table and labels on the card; host
    seconds to build."""
    from repro_torch.configs.base import GNN_SHAPES

    d = GNN_SHAPES["minibatch_lg"].dims
    n, e = d["n_nodes"], d["n_edges"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    indptr = np.arange(n + 1, dtype=np.int64) * e // n
    indices = rng.integers(0, n, e, dtype=np.int32)
    build_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(1)
    feat = torch.randn((n, d["d_feat"]), generator=g, device=dev)
    labels = torch.randint(0, d["n_classes"], (n,), generator=g, device=dev, dtype=torch.int32)
    return (indptr, indices, feat, labels), build_s


def _gnn_layer_cost(arch: str, cfg, N: int, E: int) -> tuple:
    """(bytes, flops) of one forward pass on this graph: each gather, scatter
    and node tensor read or written once (node tensors at their storage
    dtype, edge tensors fp32, 4-byte indices), the dense products' flops."""
    if arch == "gcn-cora":
        dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        nb = eb = fl = 0
        for a, b in zip(dims[:-1], dims[1:]):
            nb += N * (a + b) * 4  # h in, h out
            eb += E * (2 * b * 4 + 12)  # the gather and the scatter, src/dst/weight
            fl += 2 * N * a * b
        return nb + eb, fl
    if arch == "pna":
        d = cfg.d_hidden
        nb = N * (cfg.d_in + d) * 4 + N * (d + cfg.n_classes) * 4
        fl = 2 * N * cfg.d_in * d + 2 * N * d * cfg.n_classes
        for _ in range(cfg.n_layers):
            nb += N * (13 * d + d) * 4  # [h, 12 aggregates] in, h out
            nb += E * (2 * d + 4 * d) * 4 + E * 12  # 2 gathers, 4 scatters, indices+mask
            fl += 2 * E * (2 * d * d + d * d) + 2 * N * 13 * d * d
        return nb, fl
    if arch == "nequip":
        from repro_torch.models.gnn.nequip import _paths

        C, dim, P = cfg.channels, (cfg.l_max + 1) ** 2, len(_paths(cfg.l_max))
        # a path: CG against Y (a·b·c an edge), then [c, a] × [a, C] an edge
        tp = sum((2 * a + 1) * (2 * c + 1) * ((2 * b + 1) + C) for a, b, c in _paths(cfg.l_max))
        layer_b = N * dim * C * 4 * 4 + E * (2 * dim * C * 4 + 24)  # h ×4, gather, scatter
        layer_f = (2 * 2 * N * dim * C * C + 2 * N * C * (cfg.l_max + 1) * C
                   + 2 * E * (cfg.n_rbf * 64 + 64 * P * C) + 2 * E * tp)
        return cfg.n_layers * layer_b, cfg.n_layers * layer_f
    C, dim, L = cfg.channels, (cfg.l_max + 1) ** 2, cfg.l_max
    el = torch.finfo(cfg.dtype).bits // 8
    rows = sum((2 * l + 1) ** 2 for l in range(L + 1))
    so2 = 2 * E * (L + 1) * 2 * C * (L + 1) * C + sum(
        4 * 2 * E * (L + 1 - m) * 2 * C * (L + 1 - m) * C for m in range(1, cfg.m_max + 1))
    layer_f = (6 * E * rows * C + so2 + 2 * E * (cfg.n_rbf * 64 + 64 * C + 2 * C * C)
               + 2 * 2 * N * dim * C * C + 2 * N * C * (2 * C + 2 * C + (L + 1) * C))
    layer_b = N * dim * C * (4 * el + 4 * 4) + E * (3 * dim * C * 4 + 24)
    return cfg.n_layers * layer_b, cfg.n_layers * layer_f


def gnn_bound(arch: str, cfg, params, N: int, E: int) -> dict:
    """The least time of one train step on this graph: the forward pass's
    bytes and flops (``_gnn_layer_cost``) three times over for the forward
    and backward passes (the backward of a gather is a scatter of its size,
    of a product two products), once more for remat's re-forward and once
    more for the chunked backward's re-forward; plus AdamW's bytes (p, g,
    m, v read, p, m, v written).  Flops at the fp32 peak (equiformer's bf16
    weights meet fp32 features, and TF32 is off), bytes at 3.35 TB/s."""
    n_bytes, flops = _gnn_layer_cost(arch, cfg, N, E)
    chunk = getattr(cfg, "edge_chunk", None)
    passes = 3 + int(getattr(cfg, "remat", False)) + int(bool(chunk) and E > chunk)
    opt = sum(p.numel() * (3 * p.element_size() + 4 * 4) for p in _tree.leaves(params))
    bytes_ms = (passes * n_bytes + opt) / PEAK_HBM_BYTES * 1e3
    ops_ms = passes * flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms
                else "operations", bytes_ms=bytes_ms, ops_ms=ops_ms, passes=passes,
                gb=passes * n_bytes / 1e9, gflop=passes * flops / 1e9)


def gnn_run(run: str, arch: str, shape: str, profile: bool, csr=None, cfg_over=None) -> dict:
    """One run: the published config through ``gnn_shape_config``, ``steps``
    train steps (the first a warmup), each timed on the host clock between
    two synchronisations with its peak memory; gates: every loss and
    grad_norm finite, every parameter leaf the loss reaches changed (in
    bf16, every drawn leaf: one bf16 ulp of a gain at 1.0 is far more than
    a few warmup steps move it)."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.cells import _gnn_model, gnn_shape_config

    dev = torch.device("cuda")
    arch_def = ARCHS[arch]
    mod = _gnn_model(arch_def)
    cfg = gnn_shape_config(arch_def, GNN_SHAPES[shape])
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    steps = GNN_STEPS.get(run, 3)
    torch.cuda.empty_cache()
    params = mod.init_params(cfg, cpu_generator(0), device=dev)
    init = [p.clone() for p in _tree.leaves(params)]
    state = init_state(params)
    step = make_train_step(lambda p, b: mod.loss(p, b, cfg), OPT_CFG)
    ms, peaks, metrics, sample_ms = [], [], [], []
    for i in range(steps):
        batch, N, E, smp = gnn_graph(run, arch, shape, cfg, dev, seed=100 + i, csr=csr)
        if smp is not None:
            sample_ms.append(smp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        metrics.append(m)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    check(all(map(math.isfinite, losses + gnorms)),
          f"gnn {run}: losses {losses}, grad_norm {gnorms}")
    names = [n for n, _ in _named_leaves(state.params)]
    # the leaves the loss reaches: a nonzero gradient on a small graph under
    # this config (the last layer's gates of l > 0 features, and a node
    # classifier's graph readout, are not read by the loss)
    small = smoke_graph(arch in ("nequip", "equiformer-v2"), cfg.task, n=64, e=256,
                        d_in=getattr(cfg, "d_in", 32), n_classes=cfg.n_classes,
                        n_species=cfg.n_species if hasattr(cfg, "n_species") else 5)
    _, g_small = _grads_of(lambda p, b: mod.loss(p, b, cfg),
                           _tree.unflatten(state.params, init),
                           convert.graph_batch(small, device=dev))
    reached = {n for n, g in zip(names, g_small) if bool(g.abs().max() > 0)}
    del g_small
    moved = {n: float((a != b).float().mean()) for n, a, b in
             zip(names, _tree.leaves(state.params), init)}
    # every reached leaf got a gradient (its fp32 first moment is nonzero)
    # and, in fp32, changed; a bf16 leaf may keep its value through a few
    # warmup steps (Σ lr ≈ 2e-5 is below half an ulp of most of its
    # elements; no master weights, as in the reference)
    no_grad = [n for n, m in zip(names, _tree.leaves(state.opt["m"]))
               if n in reached and not bool(m.abs().max() > 0)]
    still = [n for n, p in zip(names, init) if n in reached and moved[n] == 0.0
             and p.dtype == torch.float32]
    check(not no_grad and not still, f"gnn {run}: parameter leaves with no gradient "
                                     f"{no_grad}, unchanged {still}")
    t = float(np.median(ms[1:]))
    bound = gnn_bound(arch, cfg, state.params, N, E)
    rec = dict(arch=arch, shape=shape, nodes=N, edges=E, steps=steps, ms=ms, ms_median=t,
               nodes_per_s=N / t * 1e3, edges_per_s=E / t * 1e3, peak_gb=max(peaks[1:]),
               peak_gb_all=peaks, losses=losses, grad_norm=gnorms, bound=bound,
               x_bound=t / bound["bound_ms"], dtype=str(cfg.dtype).replace("torch.", ""),
               edge_chunk=getattr(cfg, "edge_chunk", None), sample_ms=sample_ms,
               unreached=sorted(set(names) - reached),
               unchanged=[n for n, f in moved.items() if f == 0.0])
    log(f"[gnn] {run} {arch}/{shape} ({rec['dtype']}, {N:,} nodes, {E:,} edges"
        + (f", edge_chunk {cfg.edge_chunk:,}" if rec["edge_chunk"] else "") + f"): step ms "
        f"(median of steps 2-{steps}) {t:.2f}, all {[round(x, 2) for x in ms]}; "
        f"{rec['nodes_per_s']:.3e} nodes/s, {rec['edges_per_s']:.3e} edges/s; peak "
        f"{rec['peak_gb']:.2f} GB; bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}: "
        f"{bound['gb']:.2f} GB in {bound['passes']} passes → {bound['bytes_ms']:.3f} ms, "
        f"{bound['gflop']:.1f} GFLOP fp32 → {bound['ops_ms']:.3f} ms), {rec['x_bound']:.1f}× "
        f"the bound; losses {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 3) for x in gnorms]}; leaves not reached by the loss "
        f"{rec['unreached']}, unchanged {rec['unchanged']}"
        + (f"; sampler host ms {[round(x, 1) for x in sample_ms]}" if sample_ms else ""))
    if profile:
        b = gnn_graph(run, arch, shape, cfg, dev, seed=99, csr=csr)[0]
        busy = busy_record(lambda: step(state, b), f"gnn {run}", f"profile_gnn_{run}.txt", rows=6)
        del busy["events"]
        log(f"[gnn] {run} one step under the profiler: {busy['wall_s'] * 1e3:.1f} ms wall, "
            f"device busy {busy['device_busy_s'] * 1e3:.1f} ms ({100 * busy['busy_share']:.1f} %)"
            f", {busy['records']} device records")
        rec["profile"] = busy
    del state, params, init, metrics
    torch.cuda.empty_cache()
    return rec


def g5_memory_gate() -> dict:
    """nequip's chunked step against its unchunked step on one graph of
    ``G5_GATE_EDGES`` edges (3 chunks of 2²⁰): the chunked step's peak must
    stay below the unchunked one's — a ``sum_over_chunks`` that kept every
    chunk's working set would not."""
    out = {}
    for tag, chunk in (("chunked", 1 << 20), ("unchunked", None)):
        r = gnn_run("G5-gate", "nequip", "ogb_products", False,
                    cfg_over={"edge_chunk": chunk})
        out[tag] = dict(peak_gb=r["peak_gb"], ms=r["ms_median"], edges=r["edges"],
                        nodes=r["nodes"], losses=r["losses"])
    check(out["chunked"]["peak_gb"] < out["unchunked"]["peak_gb"],
          f"gnn G5: chunked peak {out['chunked']['peak_gb']:.2f} GB not below unchunked "
          f"{out['unchunked']['peak_gb']:.2f} GB")
    log(f"[gnn] G5 memory gate on {out['chunked']['edges']:,} edges (3 chunks): chunked peak "
        f"{out['chunked']['peak_gb']:.2f} GB ({out['chunked']['ms']:.1f} ms a step) < unchunked "
        f"{out['unchunked']['peak_gb']:.2f} GB ({out['unchunked']['ms']:.1f} ms)")
    return out


def smoke_graph(geometric: bool, task: str, n=40, e=120, seed=0, d_in=32, n_classes=4,
                n_species=5):
    """tests/test_arch_smoke.py's tiny graph (node_class) or 4 molecules of
    n/4 nodes and e/4 edges (graph_reg), numpy-seeded, on the CPU."""
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
        labels, lmask = torch.from_numpy(rng.integers(0, n_classes, n)), torch.ones(n)
    return GraphBatch(
        node_feat=torch.from_numpy(rng.normal(size=(n, d_in)).astype(np.float32)),
        edge_src=torch.from_numpy(src), edge_dst=torch.from_numpy(dst), edge_mask=torch.ones(e),
        labels=labels, label_mask=lmask,
        positions=torch.from_numpy((rng.normal(size=(n, 3)) * 2).astype(np.float32))
        if geometric else None,
        species=torch.from_numpy(rng.integers(0, n_species, n)) if geometric else None,
        graph_id=gid, n_graphs=g)


def gnn_card_vs_cpu(steps: int = TRAIN_CARD_VS_CPU_STEPS) -> dict:
    """Each GNN's SMOKE config (fp32, TF32 off) on the tiny graph
    (node_class) and on the molecule layout (graph_reg): weights made on the
    CPU and carried to the card by ``convert``, ``steps`` steps on the CPU
    and twice on the card; losses within ``TRAIN_F32_RTOL`` relative and
    parameters within ``TRAIN_F32_RTOL`` of max|p| over the tree; the spread
    of the two card runs printed (``index_add`` sums with atomics)."""
    from repro_torch.configs.cells import _gnn_model

    out = {}
    for arch in ("gcn-cora", "pna", "nequip", "equiformer-v2"):
        geometric = arch in ("nequip", "equiformer-v2")
        mod = _gnn_model(ARCHS[arch])
        for task in ("node_class", "graph_reg"):
            cfg = dataclasses.replace(ARCHS[arch].smoke_config, n_classes=4, task=task,
                                      **({} if geometric else {"d_in": 32}))
            check(cfg.dtype == torch.float32, f"{arch}: SMOKE is not fp32")
            params = mod.init_params(cfg, cpu_generator(0), device="cpu")
            batch = smoke_graph(geometric, task)
            card_batch = convert.graph_batch(batch, device="cuda")
            step = make_train_step(lambda p, b: mod.loss(p, b, cfg), OPT_CFG)
            cpu = init_state(params)
            cards = [init_state(convert.gnn_params(params, device="cuda")) for _ in range(2)]
            loss_err, spread_loss = 0.0, 0.0
            for _ in range(steps):
                cpu, cm = step(cpu, batch)
                gl = []
                for i in range(2):
                    cards[i], gm = step(cards[i], card_batch)
                    gl.append(float(gm["loss"]))
                loss_err = max(loss_err, abs(gl[0] - float(cm["loss"])) / abs(float(cm["loss"])))
                spread_loss = max(spread_loss, abs(gl[0] - gl[1]) / abs(float(cm["loss"])))
            want = _tree.leaves(cpu.params)
            scale = max(float(p.abs().max()) for p in want)
            p_err = max(float((a.cpu() - b).abs().max()) for a, b in
                        zip(_tree.leaves(cards[0].params), want)) / scale
            spread = max(float((a - b).abs().max()) for a, b in
                         zip(_tree.leaves(cards[0].params), _tree.leaves(cards[1].params))) / scale
            out[f"{arch}/{task}"] = dict(loss=loss_err, params=p_err, spread_loss=spread_loss,
                                         spread_params=spread)
            check(loss_err <= TRAIN_F32_RTOL and p_err <= TRAIN_F32_RTOL,
                  f"gnn card vs CPU ({arch} {task}): losses {loss_err:.3e}, params {p_err:.3e}")
    log(f"[gnn] card vs CPU at SMOKE (fp32, TF32 off), {steps} steps: "
        + ", ".join(f"{k} loss {r['loss']:.1e} params {r['params']:.1e} (two card runs: "
                    f"{r['spread_loss']:.1e}, {r['spread_params']:.1e})" for k, r in out.items())
        + f"; gate {TRAIN_F32_RTOL} of the loss, and of max|p| over the tree")
    return out


def _rotmat(a, b, c) -> np.ndarray:
    def rz(t):
        return np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1]])

    def ry(t):
        return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]])

    return rz(a) @ ry(b) @ rz(c)


def gnn_equivariance() -> dict:
    """Rotation + translation of the positions on the card: the loss of
    ``tests/test_e3.py``'s two configs moves by less than ``EQUIV_RTOL``
    relative (the reference's own gate); at full width in fp32 on the
    molecule layout, the figure printed."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.cells import _gnn_model, gnn_shape_config
    from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config
    from repro_torch.models.gnn.graph import GraphBatch
    from repro_torch.models.gnn.nequip import NequIPConfig

    dev = torch.device("cuda")
    R = torch.from_numpy(_rotmat(0.5, 0.9, 1.3).astype(np.float32)).to(dev)
    out = {}

    def moved(mod, cfg, batch):
        params = mod.init_params(cfg, cpu_generator(0), device=dev)
        with torch.no_grad():
            l1 = float(mod.loss(params, batch, cfg))
            l2 = float(mod.loss(params, dataclasses.replace(
                batch, positions=batch.positions @ R.T + 5.0), cfg))
        return abs(l1 - l2) / max(abs(l1), 1.0)

    rng = np.random.default_rng(0)
    n, e = 24, 60
    small = GraphBatch(
        node_feat=torch.zeros((n, 1), device=dev),
        edge_src=torch.from_numpy(rng.integers(0, n, e)).to(dev),
        edge_dst=torch.from_numpy(rng.integers(0, n, e)).to(dev),
        edge_mask=torch.ones(e, device=dev), labels=torch.zeros(1, device=dev),
        label_mask=torch.ones(1, device=dev),
        positions=torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 2).to(dev),
        species=torch.from_numpy(rng.integers(0, 5, n)).to(dev),
        graph_id=torch.zeros(n, dtype=torch.int64, device=dev), n_graphs=1)
    for arch, cfg in (("nequip", NequIPConfig(n_layers=2, channels=8, n_species=5)),
                      ("equiformer-v2", EquiformerV2Config(n_layers=2, channels=16, l_max=3,
                                                           m_max=2, n_heads=4, n_species=5))):
        out[arch] = moved(_gnn_model(ARCHS[arch]), cfg, small)
        check(out[arch] < EQUIV_RTOL, f"gnn equivariance ({arch}): {out[arch]:.3e}")
        cfg = dataclasses.replace(gnn_shape_config(ARCHS[arch], GNN_SHAPES["molecule"]),
                                  dtype=torch.float32)
        batch = gnn_graph("equiv", arch, "molecule", cfg, dev, seed=7)[0]
        out[f"{arch}/full"] = moved(_gnn_model(ARCHS[arch]), cfg, batch)
    log(f"[gnn] equivariance on the card (rotation + translation, loss moved relative): "
        f"test_e3 configs nequip {out['nequip']:.2e}, equiformer-v2 {out['equiformer-v2']:.2e} "
        f"(gate {EQUIV_RTOL}); full width fp32 at molecule nequip {out['nequip/full']:.2e}, "
        f"equiformer-v2 {out['equiformer-v2/full']:.2e} (printed)")
    return out


def gnn_phase(profile: bool) -> dict:
    """The GNN family's training on the card: G1–G6 (``GNN_RUNS``), G5's
    memory gate, card vs CPU at SMOKE, equivariance."""
    t0 = time.perf_counter()
    runs = {}
    for run, arch, shape in GNN_RUNS:
        csr = None
        if shape == "minibatch_lg":
            csr, build_s = reddit_csr(torch.device("cuda"))
            log(f"[gnn] G3 synthetic Reddit-size CSR: {len(csr[0]) - 1:,} nodes, "
                f"{len(csr[1]):,} edges, built on the host in {build_s:.2f} s")
        runs[run] = gnn_run(run, arch, shape, profile, csr=csr)
        del csr
    rec = dict(runs=runs, g5_gate=g5_memory_gate(), card_vs_cpu=gnn_card_vs_cpu(),
               equivariance=gnn_equivariance())
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[gnn] phase wall {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 10: mesh — the launcher's DeviceMesh path (no kernel of the repo)
# ---------------------------------------------------------------------------

MESH_STEPS = 3
# granite-moe at its published widths (48 padded experts × 3 × 1,536 × 512 a
# layer: 113 M expert weights a layer, 3.6 B at 32 layers), depth cut so
# that bf16 weights, fp32 moments, fp32 accumulated gradients and AdamW's
# fp32 temporaries fit one 80 GB card
MESH_MOE_LAYERS = 12
MESH_MOE_BATCH, MESH_MOE_SEQ = 8, 1024
# the mesh launcher against the one-device path (bitwise expected at world
# size 1), of max|p| over the tree
MESH_RTOL = 1e-6
# moe_ffn_shard_map against moe_ffn_gspmd at the dropless capacity factor
# E/K: bf16 outputs, the expert GEMMs on buffers of other capacities (T and
# T rounded up to 32), so two bf16 ulps of max|y|
MOE_PATH_RTOL = 2.0 ** -7
# the one-device launcher's steps and peak on an H100 before the launcher built
# a mesh (PERF.md §6), printed beside M1's
ONE_DEVICE_STEP_MS, ONE_DEVICE_PEAK_GB = (759, 792), 22.38
DRYRUN_CELLS = ("qwen3-0.6b/decode_32k", "gcn-cora/full_graph_sm", "autoint/serve_p99",
                "spectral/dti", "equiformer-v2/molecule")


def mesh_argv(arch: str, steps: int, batch: int, seq: int, *extra) -> list:
    return ["--arch", arch, "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--data-parallel", "1", "--model-parallel", "1", *extra]


def one_device_state(cfg, steps: int, batch: int, seq: int, accum: int, dev) -> TrainState:
    """The path the launcher took before it built a mesh: the same seed's
    weights and token stream, plain tensors, ``make_train_step``."""
    state = init_state(tfm.init_params(cfg, cpu_generator(0), device=dev))
    step = make_train_step(functools.partial(tfm.train_loss, cfg=cfg), OPT_CFG,
                           accum_steps=accum)
    stream = MarkovTokenStream(cfg.vocab, seed=0)
    for i in range(steps):
        stream._step = i
        b = {k: torch.from_numpy(v).to(dev) for k, v in stream.next_batch(batch, seq).items()}
        state, _ = step(state, b)
    return state


def tree_diff(got, want) -> tuple:
    """(max |got − want| over the tree / max|want| over the tree, bitwise)."""
    pairs = list(zip(_tree.leaves(got), _tree.leaves(want)))
    d = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    m = max(float(b.float().abs().max()) for _, b in pairs)
    return d / max(m, 1e-30), all(torch.equal(a, b) for a, b in pairs)


def mesh_step_record(argv, tag: str) -> dict:
    """One step of the launcher's mesh run outside its loop (``prepare``,
    then the step under the mesh's rules): the device → host copies it
    makes, and its device busy share under the profiler."""
    args = launch_train.parse_args(argv)
    with launch_train.process_group("nccl"):
        run = launch_train.prepare(args)
        with run.context():
            batch = run.batches(0)
            run.step(run.state, batch)  # warm
            d2h = d2h_copy_bytes(lambda: run.step(run.state, batch))
            busy = busy_record(lambda: run.step(run.state, batch), tag, f"profile_{tag}.txt")
        del run, batch
    busy.pop("events")
    torch.cuda.empty_cache()
    return dict(d2h=d2h, **busy)


def mesh_lm() -> dict:
    """M1: qwen3-0.6b through ``launch.train.main`` on a world-size-1 NCCL
    DeviceMesh, against the one-device path; M3: the same run checkpointed
    at step 2 and resumed with ``--elastic``."""
    dev = torch.device("cuda")
    cfg = ARCHS[TRAIN_ARCH].config
    accum = LM_ACCUM[cfg.name]
    argv = mesh_argv(TRAIN_ARCH, MESH_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    with StepClock() as clock:
        state, lines, wall = run_train_launcher(argv)
    check(bool(lines) and lines[0].startswith("mesh {'data': 1, 'model': 1}"),
          f"mesh M1: the launcher printed {lines[:1]!r}")
    losses = [float(m["loss"]) for m in clock.metrics]
    check(len(losses) == MESH_STEPS and all(map(math.isfinite, losses)),
          f"mesh M1: losses {losses}")
    plain = one_device_state(cfg, MESH_STEPS, TRAIN_BATCH, TRAIN_SEQ, accum, dev)
    err, bitwise = tree_diff(state, plain)
    del plain
    torch.cuda.empty_cache()
    check(bitwise or err <= MESH_RTOL,
          f"mesh M1: the mesh launcher's state differs from the one-device path by {err:.3e}")
    ms = float(np.median(clock.ms[1:]))
    peak = max(clock.peak_gb)
    log(f"[mesh] M1 {TRAIN_ARCH} (published config, bf16) on a (1, 1) NCCL mesh, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, accum {accum}: step ms (median of steps 2-{MESH_STEPS}) "
        f"{ms:.1f}, all {[round(x, 1) for x in clock.ms]}; peak {peak:.2f} GB (the one-device "
        f"launcher before the mesh: {ONE_DEVICE_STEP_MS[0]}-{ONE_DEVICE_STEP_MS[1]} ms, "
        f"{ONE_DEVICE_PEAK_GB} GB); "
        f"losses {[round(x, 4) for x in losses]}; vs the one-device path {err:.3e} of max|p|, "
        f"bitwise {bitwise}")

    d = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    run_train_launcher(mesh_argv(TRAIN_ARCH, MESH_STEPS - 1, TRAIN_BATCH, TRAIN_SEQ,
                                 "--ckpt-dir", str(d)))
    resumed, rlines, _ = run_train_launcher(mesh_argv(TRAIN_ARCH, MESH_STEPS, TRAIN_BATCH,
                                                      TRAIN_SEQ, "--ckpt-dir", str(d),
                                                      "--elastic"))
    shutil.rmtree(d, ignore_errors=True)
    check(f"[resume] restored checkpoint at step {MESH_STEPS - 1}" in rlines,
          f"mesh M3: no resume line: {rlines}")
    r_err, r_bitwise = tree_diff(resumed, state)
    check(r_bitwise or r_err <= RESUME_RTOL,
          f"mesh M3: resumed vs uninterrupted {r_err:.3e} of max|p|")
    log(f"[mesh] M3 --elastic: step-{MESH_STEPS - 1} checkpoint under build/ resumed onto the "
        f"re-planned (1, 1) mesh to step {MESH_STEPS}: vs M1's state {r_err:.3e} of max|p|, "
        f"bitwise {r_bitwise}")
    del resumed, state
    torch.cuda.empty_cache()
    step_rec = mesh_step_record(argv, "mesh_m1")
    check(not step_rec["d2h"], f"mesh M1: a step copied {step_rec['d2h']} bytes to the host")
    log(f"[mesh] M1 one step under the profiler: {step_rec['wall_s'] * 1e3:.1f} ms wall, device "
        f"busy {step_rec['device_busy_s'] * 1e3:.1f} ms ({100 * step_rec['busy_share']:.1f} %); "
        f"no device → host copy")
    return dict(m1=dict(lines=lines, wall_s=wall, step_ms=clock.ms, step_ms_median=ms,
                        peak_gb=peak, losses=losses, err=err, bitwise=bitwise, step=step_rec),
                m3=dict(lines=rlines, err=r_err, bitwise=r_bitwise))


def moe_paths(p, cfg, dev) -> dict:
    """One layer's ``moe_ffn_shard_map`` (on a (1, 1) NCCL mesh) against
    ``moe_ffn_gspmd`` at the dropless capacity factor E/K on 4,096 seeded
    bf16 tokens."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_smoke_mesh, rules_for_mesh

    mc = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(4096, cfg.d_model)).astype(
        np.float32)).to(dev, cfg.dtype)
    y_g, aux_g = tmoe.moe_ffn_gspmd(p, x, mc)
    with launch_train.process_group("nccl"):
        mesh = make_smoke_mesh(1, 1, "cuda")
        with shd.axis_rules(rules_for_mesh(mesh), mesh):
            y_s, aux_s = tmoe.moe_ffn_shard_map(p, x, mc, mesh)
        y_s = y_s.to_local()
        lb_s, rz_s = float(aux_s["load_balance"].to_local()), float(aux_s["router_z"].to_local())
    scale = float(y_g.float().abs().max())
    err = float((y_s.float() - y_g.float()).abs().max()) / scale
    lb_g, rz_g = float(aux_g["load_balance"]), float(aux_g["router_z"])
    return dict(err=err, max_y=scale, dropped_gspmd=float(aux_g["dropped_frac"]),
                load_balance=(lb_s, lb_g), router_z=(rz_s, rz_g))


def mesh_moe() -> dict:
    """M2: granite-moe-3b-a800m at its published widths (depth cut to
    ``MESH_MOE_LAYERS``) through the launcher on the (1, 1) mesh: every MoE
    layer takes ``moe_ffn_shard_map``."""
    dev = torch.device("cuda")
    name = "granite-moe-3b-a800m"
    full = ARCHS[name]
    cut = dataclasses.replace(full, config=dataclasses.replace(full.config,
                                                               n_layers=MESH_MOE_LAYERS))
    cfg = cut.config
    calls = {"shard_map": 0, "gspmd": 0}
    saved = tmoe.moe_ffn_shard_map, tmoe.moe_ffn_gspmd

    def counted(kind, fn):
        def run(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return run

    ARCHS[name] = cut
    tmoe.moe_ffn_shard_map = counted("shard_map", saved[0])
    tmoe.moe_ffn_gspmd = counted("gspmd", saved[1])
    try:
        with StepClock() as clock:
            state, lines, wall = run_train_launcher(mesh_argv(name, MESH_STEPS, MESH_MOE_BATCH,
                                                              MESH_MOE_SEQ))
    finally:
        ARCHS[name] = full
        tmoe.moe_ffn_shard_map, tmoe.moe_ffn_gspmd = saved
    accum = LM_ACCUM[name]
    losses = [float(m["loss"]) for m in clock.metrics]
    check(len(losses) == MESH_STEPS and all(map(math.isfinite, losses)),
          f"mesh M2: losses {losses}")
    check(calls["gspmd"] == 0 and calls["shard_map"] > 0,
          f"mesh M2: MoE layers by path {calls}")
    init = _named_leaves(tfm.init_params(cfg, cpu_generator(0), device=dev))
    moved = {n: bool((a != b).any()) for (n, b), a in zip(init, _tree.leaves(state.params))}
    drawn = [n for n, b in init if bool(b.min() != b.max())]
    del init
    check(all(moved[n] for n in drawn),
          f"mesh M2: drawn weights did not change: {[n for n in drawn if not moved[n]]}")
    paths = moe_paths({k: v[0] for k, v in state.params["layers"]["mlp"].items()}, cfg, dev)
    check(paths["err"] <= MOE_PATH_RTOL,
          f"mesh M2: moe_ffn_shard_map vs moe_ffn_gspmd at cf E/K: {paths['err']:.3e} of max|y|")
    ms = float(np.median(clock.ms[1:]))
    peak = max(clock.peak_gb)
    n_params = sum(p.numel() for p in _tree.leaves(state.params))
    log(f"[mesh] M2 {name} at published widths, {MESH_MOE_LAYERS} of 32 layers "
        f"({n_params / 1e9:.2f} B parameters), bf16, batch {MESH_MOE_BATCH} x {MESH_MOE_SEQ}, "
        f"accum {accum}: step ms (median of steps 2-{MESH_STEPS}) {ms:.1f}, all "
        f"{[round(x, 1) for x in clock.ms]}; peak {peak:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}; MoE calls {calls}; one layer shard_map vs gspmd at "
        f"cf E/K: {paths['err']:.3e} of max|y| {paths['max_y']:.3f} (gate {MOE_PATH_RTOL:.3e}), "
        f"aux shard_map/gspmd lb {paths['load_balance']}, rz {paths['router_z']}")
    del state
    torch.cuda.empty_cache()
    return dict(lines=lines, wall_s=wall, layers=MESH_MOE_LAYERS, params=n_params,
                step_ms=clock.ms, step_ms_median=ms, peak_gb=peak, losses=losses,
                moe_calls=calls, paths=paths)


def mesh_dryrun() -> dict:
    """The dry-run of five cells — the paper's `spectral/dti` among them — on
    the (16, 16) fake mesh on the host (no card), one subprocess a cell, all
    at once: their roofline terms and memory a rank.  A failing cell fails
    the phase."""
    out = ROOT / "build" / "dryrun_chip"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    procs = {}
    try:
        for cell in DRYRUN_CELLS:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell", cell, "--mesh",
                    "single", "--out", str(out)]
            procs[cell] = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True, env=env)
        logs = {cell: p.communicate(timeout=600)[0] for cell, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    (ROOT / "chiprun_out" / "dryrun_chip.log").write_text("".join(logs.values()))
    for cell, p in procs.items():
        check(p.returncode == 0, f"mesh: the dry-run of {cell} exited {p.returncode}: "
                                 f"{logs[cell][-1500:]}")
    rows = {}
    for cell in DRYRUN_CELLS:
        r = json.loads((out / "single" / (cell.replace("/", "__") + ".json")).read_text())
        rows[cell] = {k: r[k] for k in ("compute_s", "memory_s", "collective_s", "bottleneck",
                                        "useful_ratio", "memory_per_device_gb",
                                        "coll_bytes_dev")}
        log(f"[mesh] dry-run {cell} @ (16, 16) fake ranks (host only): compute "
            f"{r['compute_s']:.6f} s, memory {r['memory_s']:.6f} s, collective "
            f"{r['collective_s']:.6f} s, {r['bottleneck']}-bound, useful "
            f"{r['useful_ratio']:.3f}, {r['memory_per_device_gb']:.2f} GB a rank, "
            f"{r['compile_s']:.1f} s on the host")
    log(f"[mesh] dry-run of {len(DRYRUN_CELLS)} cells: {wall:.1f} s on the host")
    return dict(cells=rows, wall_s=wall)


def mesh_phase() -> dict:
    """M1–M3 and the dry-run figures (PERF.md §4)."""
    t0 = time.perf_counter()
    rec = dict(lm=mesh_lm(), moe=mesh_moe(), dryrun=mesh_dryrun())
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[mesh] phase wall {rec['phase_s']:.1f} s")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script needs a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
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
    random_rec = random_phase()
    guard_rec = guard_phase(prof)
    blockell_rec = blockell_phase(pos, prof)
    knn_rec, exact = knn_phase()
    kernels = [knn_rec, kmeans_phase(), ell_phase(pos, prof)]
    spipe = scalable_pipeline(K_FULL)
    sstate = spipe.build_graph(prof, points=pos)
    sop = spipe.operator(sstate)
    kernels += [hash_phase(pos), spmv_phase(sstate, sop), cheb_step_phase(sstate, sop),
                assign_phase()]
    del sstate, sop
    t_main = time.perf_counter()
    first = main_path(pos, prof, region)
    t_scal = time.perf_counter()
    scalable = scalable_path(pos, prof, region, exact, first)
    t_red = time.perf_counter()
    reduced = dict(
        sparsify=reduced_path("sparsify", sparsify_pipeline(K_FULL), MAIN_KERNELS, pos, prof,
                              region, first),
        coarsen=reduced_path("coarsen", coarsen_pipeline(K_FULL), COARSEN_KERNELS, pos, prof,
                             region, scalable))
    resume_rec = resume_phase(pos, prof, first[0])
    t_shard = time.perf_counter()
    shard_kernels, shard_rec = sharded_phase(pos, prof, region, first, scalable)
    t_shard_done = time.perf_counter()
    main_rec, scal_rec = first[1], scalable[1]
    del first, scalable
    t_e2e = time.perf_counter()
    # eigenvalue gates, 1e-4 on both paths: Lanczos on both devices converges
    # to tol 1e-4 (card and CPU agree to ~1e-7 once the projected eigh is
    # float64); the Chebyshev Ritz values carry the filter's own error
    # (~1e-3 against the true eigenvalues), but card and CPU filter the same
    # draws through the same graph, so they differ only by rounding in 64
    # recurrence steps (2.4e-7 on an H100) — a hash bit flipped by a projection
    # within rounding of 0 would move LSH edges and show here
    e2e = {tag: end_to_end(make, f"e2e-{tag}", 1e-4) for tag, make in (
        ("main", main_pipeline), ("scalable", scalable_pipeline),
        ("sparsify", sparsify_pipeline), ("coarsen", coarsen_pipeline))}
    t_serve = time.perf_counter()
    serve_kernels, serve_rec = serve_phase()
    t_decode = time.perf_counter()
    decode_rec = decode_phase("--profile" in sys.argv[1:])
    t_train = time.perf_counter()
    for _, fn in COUNTERS:
        fn.launches = 0
    train_rec = train_phase("--profile" in sys.argv[1:])
    train_launches = {name: fn.launches for name, fn in COUNTERS}
    check(not any(train_launches.values()),
          f"train phase: a pipeline kernel launched: {train_launches}")
    t_gnn = time.perf_counter()
    for _, fn in COUNTERS:
        fn.launches = 0
    gnn_rec = gnn_phase("--profile" in sys.argv[1:])
    gnn_launches = {name: fn.launches for name, fn in COUNTERS}
    check(not any(gnn_launches.values()), f"gnn phase: a pipeline kernel launched: {gnn_launches}")
    t_mesh = time.perf_counter()
    for _, fn in COUNTERS:
        fn.launches = 0
    mesh_rec = mesh_phase()
    mesh_launches = {name: fn.launches for name, fn in COUNTERS}
    check(not any(mesh_launches.values()),
          f"mesh phase: a pipeline kernel launched: {mesh_launches}")
    t_done = time.perf_counter()
    profiled = None
    if "--profile" in sys.argv[1:]:
        profiled = {tag: profile_path(make(K_FULL), pos, prof, tag) for tag, make in (
            ("main", main_pipeline), ("scalable", scalable_pipeline),
            ("sparsify", sparsify_pipeline), ("coarsen", coarsen_pipeline))}
    for kern in kernels:  # each kernel's launches on its own path
        rec = main_rec if kern["name"] in MAIN_KERNELS else scal_rec
        kern["launches"] = rec["launches"][kern["name"]]
    kernels += serve_kernels  # launches from the serving path's run
    kernels += shard_kernels  # launches from the sharded plan's mesh runs
    summary = dict(device=smi, torch=torch.__version__, cuda=torch.version.cuda,
                   build_s=build_s, random=random_rec, guard=guard_rec, blockell=blockell_rec,
                   kernels=kernels, main=main_rec, scalable=scal_rec, reduced=reduced,
                   resume=resume_rec, sharded=shard_rec, e2e=e2e, serve=serve_rec,
                   decode=decode_rec, train=train_rec, gnn=gnn_rec, mesh=mesh_rec,
                   profile=profiled,
                   phase_s=dict(kernels=t_main - t_start, main=t_scal - t_main,
                                scalable=t_red - t_scal, reduced_and_resume=t_shard - t_red,
                                sharded=t_shard_done - t_shard, e2e=t_serve - t_e2e,
                                serve=t_decode - t_serve, decode=t_train - t_decode,
                                train=t_gnn - t_train, gnn=t_mesh - t_gnn,
                                mesh=t_done - t_mesh,
                                total=time.perf_counter() - t_start))
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    log(f"[done] {summary['phase_s']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("shape", "launches_at")  # the @shard rows: the timed shape, the counted run's
    print(json.dumps({"kernels": [{k: kern[k] for k in keys + extra if k in kern}
                                  for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
