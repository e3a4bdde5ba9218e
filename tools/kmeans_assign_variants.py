"""The design choices of the tensor-core k-means assignment
(``src/repro_torch/csrc/kmeans_assign.cu``), measured against the forms they
replaced, in turns on one card.

    python3 tools/kmeans_assign_variants.py

Builds the kernel as committed and two variants made from its source:

* ``direct`` — the mma products accumulate straight into the running sums
  (no fresh partial per 32-deep slice), 8-deep fragments, two blocks per SM:
  the fastest form, whose error grows as d² (the tensor cores truncate as
  they accumulate);
* ``cvt`` — the operands split with ``cvt.rna.tf32.f32`` in place of the
  integer add and mask.

Each is held to the plain version at n = 142,541, k = d = 500 on tie-free
blobs (labels, max |Δdmin| against the gate 1e-5·(‖x‖²+‖c‖²)) and timed
with CUDA events in turns (kernel, direct, cvt, cvt, direct, kernel).
Needs a GPU and nvcc.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref  # noqa: E402

N, K, D = 142541, 500, 500

SLICE_PARTIAL = '''    // the whole slice's fragments of the warp's centroids, split once
    uint32_t bh[KS][NT][2], bl[KS][NT][2];
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = cs + (j * 8 + g) * LDS + 8 * s + t;
        split_tf32(p[0], bh[s][j][0], bl[s][j][0]);
        split_tf32(p[4], bh[s][j][1], bl[s][j][1]);
      }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ah[KS][4], al[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const float* p = xs + (i * 16 + g) * LDS + 8 * s + t;
        split_tf32(p[0], ah[s][0], al[s][0]);
        split_tf32(p[8 * LDS], ah[s][1], al[s][1]);
        split_tf32(p[4], ah[s][2], al[s][2]);
        split_tf32(p[8 * LDS + 4], ah[s][3], al[s][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // the slice's fresh partial
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          mma_tf32(part, al[s], bh[s][j]);
          mma_tf32(part, ah[s], bl[s][j]);
          mma_tf32(part, ah[s], bh[s][j]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
      }
    }'''
DIRECT = '''#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = cs + (j * 8 + g) * LDS + kk + t;
        split_tf32(p[0], bh[j][0], bl[j][0]);
        split_tf32(p[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = xs + (i * 16 + g) * LDS + kk + t;
        uint32_t ah[4], al[4];
        split_tf32(p[0], ah[0], al[0]);
        split_tf32(p[8 * LDS], ah[1], al[1]);
        split_tf32(p[4], ah[2], al[2]);
        split_tf32(p[8 * LDS + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_tf32(acc[i][j], al, bh[j]);
          mma_tf32(acc[i][j], ah, bl[j]);
          mma_tf32(acc[i][j], ah, bh[j]);
        }
      }
    }'''
INT_SPLIT = '''  const uint32_t h = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  const float r = a - __uint_as_float(h);
  hi = h;
  lo = (__float_as_uint(r) + 0x1000u) & 0xffffe000u;'''
CVT_SPLIT = '''  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(a));
  h &= 0xffffe000u;
  const float r = a - __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(r));
  hi = h;
  lo = l & 0xffffe000u;'''


def substitute(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"kmeans_assign.cu no longer holds the text this variant replaces:\n"
                             f"{old[:200]}")
        src = src.replace(old, new)
    return src


def build(name: str, src: str):
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if log.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{log.stdout}{log.stderr}")
    regs = [ln.split("info    : ")[-1] for ln in (log.stdout + log.stderr).splitlines()
            if "registers" in ln]
    fn = ctypes.CDLL(str(so)).kmeans_assign_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("kmeans_assign_variants: this script needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    src = (ROOT / "src/repro_torch/csrc/kmeans_assign.cu").read_text()
    variants = {
        "kernel": src,
        "direct": substitute(src, (SLICE_PARTIAL, DIRECT),
                             ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")),
        "cvt": substitute(src, (INT_SPLIT, CVT_SPLIT)),
    }
    fns = {}
    for name, text in variants.items():
        fns[name], regs = build(f"kmeans_assign_{name}", text)
        print(f"[build] {name}: " + " | ".join(regs))

    gen = torch.Generator().manual_seed(8)
    c = torch.randn(K, D, generator=gen)
    x = (c[torch.randint(K, (N,), generator=gen)] + 0.02 * torch.randn(N, D, generator=gen)).cuda()
    c = c.cuda()
    cn = (c * c).sum(1)
    want_l, want_d = kmeans_assign_ref(x, c)
    gate = 1e-5 * float((x * x).sum(1).max() + (c * c).sum(1).max())
    mn = torch.empty(N, device="cuda")
    ix = torch.empty(N, dtype=torch.int32, device="cuda")

    def run(name):
        err = fns[name](x.data_ptr(), c.data_ptr(), cn.data_ptr(), N, K, D, mn.data_ptr(),
                        ix.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{name}: launch failed with cudaError_t {err}")

    for name in fns:
        run(name)
        got_d = torch.clamp(mn + (x * x).sum(1), min=0.0)
        print(f"[check] {name}: {int((ix != want_l).sum())} labels differ, max|Δdmin| "
              f"{float((got_d - want_d).abs().max()):.3e} (gate {gate:.3e})")
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        run(name)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            run(name)
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / 20)
    for name, ts in times.items():
        print(f"[time] {name}: " + " / ".join(f"{t:.4f}" for t in ts) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
