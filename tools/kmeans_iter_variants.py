"""The accumulation epilogue of the fused k-means iteration
(``src/repro_torch/csrc/kmeans_iter.cu``), measured against the schemes it
was chosen over, in turns on one card.

    python3 tools/kmeans_iter_variants.py

Builds the kernel as committed (one 16-byte ``red.global.add.v4.f32`` per
run of equal labels, rows in their own order) and three variants made from
its source:

* ``direct`` — one scalar atomic add (RED) per (row, column) straight from
  the block's labels, the scheme of the SIMT kernel the tensor-core one
  replaced: no runs;
* ``scalar`` — the committed runs, but four scalar REDs in place of each
  16-byte one;
* ``sorted`` — the block's rows ranked by label in shared memory first, so
  that each label makes one run.

On two inputs at n = 142,541, k = d = 500 — tie-free blobs in random label
order, and the first DTI path's final spectral embedding with the centroids
of its final labels (voxel order: neighbouring rows often share a label) —
each variant is held to the plain version (labels, counts, sums) and timed
with CUDA events in turns with the assignment kernel ``kmeans_assign``,
which runs the same argmin tile without the epilogue: the iteration's time
minus the assignment's and the accumulator's zero fill is the epilogue's
exposed time.  Also prints the mean number of distinct labels and of runs
of equal labels in a 128-row block (the REDs per column group that the
sorted and the committed epilogue emit).  Needs a GPU and nvcc.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._util import round_up  # noqa: E402
from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_cuda  # noqa: E402
from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref  # noqa: E402

N, K, D = 142541, 500, 500
BM = 128  # rows per block of the tile

CALL = "  accumulate_rows<VEC>(x, d, row0, min(BM, n - row0), lab, acc, ldacc);"
DIRECT_CALL = "  accumulate_direct(x, d, row0, min(BM, n - row0), lab, acc, ldacc);"
DIRECT_FN = '''__device__ __forceinline__ void accumulate_direct(const float* __restrict__ x, int d,
                                                  int row0, int rows, const int* lab,
                                                  float* __restrict__ acc, int ldacc) {
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, j = e % d;
    atomicAdd(&acc[(long long)lab[r] * ldacc + j], x[(long long)(row0 + r) * d + j]);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads)
    atomicAdd(&acc[(long long)lab[r] * ldacc + d], 1.f);
}

template <int VEC>
__global__'''
V4_RED = "    atomicAdd(reinterpret_cast<float4*>(p), v);  // result unused: one RED.128"
SCALAR_RED = ("    atomicAdd(p, v.x);\n    atomicAdd(p + 1, v.y);\n    atomicAdd(p + 2, v.z);\n"
              "    atomicAdd(p + 3, v.w);")
# the sorted walk: rows ranked by (label, row) in shared memory after the labels
UNITS = "  const int units = (d + VEC - 1) / VEC + 1;"
RANK = '''  int* order = const_cast<int*>(lab) + BM;
  if ((int)threadIdx.x < rows) {
    const int mine = lab[threadIdx.x];
    int rank = 0;
    for (int j = 0; j < rows; ++j) {
      const int o = lab[j];
      rank += o < mine || (o == mine && j < (int)threadIdx.x);
    }
    order[rank] = threadIdx.x;
  }
  __syncthreads();
''' + UNITS
SORTED = (("    int cur = lab[beg];", "    int cur = lab[order[beg]];"),
          ("        const int r = min(p0 + i, end - 1);",
           "        const int r = order[min(p0 + i, end - 1)];"),
          (UNITS, RANK))


def substitute(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"kmeans_iter.cu no longer holds the text this variant replaces:\n"
                             f"{old[:200]}")
        src = src.replace(old, new)
    return src


def build(name: str, src: str):
    out = ROOT / "build" / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "kmeans_tile.cuh").write_text((_build.CSRC / "kmeans_tile.cuh").read_text())
    cu, so = out / "kmeans_iter.cu", out / "kmeans_iter.so"
    cu.write_text(src)
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if log.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{log.stdout}{log.stderr}")
    regs = [ln.split("info    : ")[-1] for ln in (log.stdout + log.stderr).splitlines()
            if "registers" in ln]
    fn = ctypes.CDLL(str(so)).kmeans_iter_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, regs


def first_path_embedding():
    """The first DTI path's final embedding and the centroids of its final
    labels (``chip_smoke.py``'s configuration, seed 0)."""
    from repro_torch.core import kmeans as tkm
    from repro_torch.core.spectral import (EigConfig, GraphConfig, KMeansConfig,
                                           SpectralPipeline)
    from repro_torch.data.pointcloud import dti_like_pointcloud

    pos, prof, _, _ = dti_like_pointcloud(N, 90, 250, eps=1.8, seed=0, neighbors="none")
    pipe = SpectralPipeline(n_clusters=K,
                            graph=GraphConfig(knn_k=16, measure="cross_correlation"),
                            eig=EigConfig(tol=1e-4, block_size=4, representation="blockell"),
                            kmeans=KMeansConfig(iter="fused"))
    res = pipe.run_state(prof, torch.Generator().manual_seed(0), points=pos).result
    x = res.embedding.float().contiguous()
    c = tkm.update_centroids(x, res.labels, K, torch.zeros(K, x.shape[1], device=x.device))
    return x, c.contiguous()


def blobs():
    gen = torch.Generator().manual_seed(8)
    c = torch.randn(K, D, generator=gen)
    x = c[torch.randint(K, (N,), generator=gen)] + 0.02 * torch.randn(N, D, generator=gen)
    return x.cuda(), c.cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("kmeans_iter_variants: this script needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    src = (_build.CSRC / "kmeans_iter.cu").read_text()
    variants = {
        "kernel": src,
        "direct": substitute(src, (CALL, DIRECT_CALL),
                             ("template <int VEC>\n__global__", DIRECT_FN)),
        "scalar": substitute(src, (V4_RED, SCALAR_RED)),
        "sorted": substitute(src, *SORTED),
    }
    fns = {}
    for name, text in variants.items():
        fns[name], regs = build(f"kmeans_iter_{name}", text)
        print(f"[build] {name}: " + " | ".join(regs))

    for tag, (x, c) in (("blobs", blobs()), ("first-path embedding", first_path_embedding())):
        n, d = x.shape
        k = c.shape[0]
        cn = (c * c).sum(1)
        want_l, want_d, _, _ = kmeans_iter_ref(x, c)
        gate = 1e-5 * float((x * x).sum(1).max() + (c * c).sum(1).max())
        lab = want_l.long()
        blocks = torch.arange(n, device=x.device) // BM
        n_blocks = int(blocks[-1]) + 1
        distinct = torch.unique(blocks * k + lab).numel() / n_blocks
        starts = torch.ones_like(lab, dtype=torch.bool)
        starts[1:] = (lab[1:] != lab[:-1]) | (blocks[1:] != blocks[:-1])
        print(f"[input] {tag} [{n} × {d}], k = {k}: a 128-row block holds {distinct:.2f} "
              f"labels in {int(starts.sum()) / n_blocks:.2f} runs")
        mn = torch.empty(n, device="cuda")
        ix = torch.empty(n, dtype=torch.int32, device="cuda")
        ld = round_up(d + 1, 4)
        acc = torch.zeros(k, ld, device="cuda")

        def run(name):
            if name == "assign":
                kmeans_assign_cuda(x, c, cn)
                return
            acc.zero_()
            err = fns[name](x.data_ptr(), c.data_ptr(), cn.data_ptr(), n, k, d, mn.data_ptr(),
                            ix.data_ptr(), acc.data_ptr(), ld,
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: launch failed with cudaError_t {err}")

        for name in fns:
            run(name)
            torch.cuda.synchronize()
            got_d = torch.clamp(mn + (x * x).sum(1), min=0.0)
            own = ix.long()
            sums = torch.zeros(k, d, device="cuda").index_add_(0, own, x)
            counts = torch.bincount(own, minlength=k).float()
            print(f"[check] {tag} {name}: {int((ix != want_l).sum())} labels differ from the "
                  f"plain version; counts of its own labels equal: "
                  f"{bool(torch.equal(acc[:, d], counts))}; max|Δsums| against its own labels "
                  f"{float((acc[:, :d] - sums).abs().max()):.3e}; max|Δdmin| "
                  f"{float((got_d - want_d).abs().max()):.3e} (gate {gate:.3e})")
        order = list(fns) + ["assign"]
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            run(name)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run(name)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / 20)
        # the accumulator's zero fill, inside every iteration variant's time
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            acc.zero_()
        end.record()
        end.synchronize()
        zero_ms = start.elapsed_time(end) / 20
        mean = {name: sum(ts) / len(ts) for name, ts in times.items()}
        for name, ts in times.items():
            extra = ("" if name == "assign" else
                     f"; exposed epilogue (this − assign − zero fill) "
                     f"{mean[name] - mean['assign'] - zero_ms:.4f} ms")
            print(f"[time] {tag} {name}: " + " / ".join(f"{t:.4f}" for t in ts) + " ms" + extra)
        print(f"[time] {tag} zero fill of the [{k} × {ld}] accumulator: {zero_ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
