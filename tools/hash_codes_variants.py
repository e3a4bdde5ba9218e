"""The LSH hashing kernel (``src/repro_torch/csrc/hash_codes.cu``) against
the kernel it replaced, against variants of its own mapping and against the
kernel of another tree, in turns on one card.

    python3 tools/hash_codes_variants.py [OTHER_SRC_DIR]

The replaced kernel — one thread per (point, table), d and n_bits runtime
values, the planes read with ``__ldg`` for every multiply-add — lives only
here (``PARENT_SOURCE``, built under ``build/variants/``); the card-only
tests import :func:`parent_hash_codes` from this file to hold the kernel
bitwise equal to it.

The variants are text edits of the committed source (``VARIANTS``): the
tables a block takes (``kTablesABlock``: 8 committed; 16, one thread for
all of a point's tables; 4, 2 and 1, more and shorter threads in flight)
and the threads a block (64, 256; 128 committed).  On the scalable path's
shape (the 142,541-voxel DTI lattice, d = 3, 16 tables of 16 bits + 1 tie
column, ``make_planes(3, 16, 16, 0)``) and on a grid of random shapes,
every build's codes and tie-breaks are compared with the replaced kernel's
bit for bit; then all are timed in
turns (the list, then the list reversed) as ``torch.profiler`` device
time, cold (rotating over 8 copies of x and of the outputs, 160 MB, so no
launch finds its operands in the 50 MB L2), and as CUDA events around 50
back-to-back warm launches.

Given ``OTHER_SRC_DIR`` (another tree's ``src``, e.g. the parent commit
unpacked with ``git archive`` under the gitignored ``build/``), that tree's
``hash_codes.cu`` is built as it is and held bitwise to this tree's kernel
(codes and tie-break bits) at the shapes the paths give it — the lattice,
a serving batch ([256 × 16], and d = 9, 12), the serving pool ([160,000 ×
16]) and a 4-rank plan's block (the lattice's first 35,635 points) — and
the two are timed in turns (other, this, this, other) as profiler device
time, cold.  Needs a GPU and nvcc.
"""
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

PARENT_SOURCE = r'''
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hash_codes_kernel(const float* __restrict__ x, const float* __restrict__ planes, int n,
                  int d, int n_bits, int* __restrict__ codes, float* __restrict__ tie) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int t = blockIdx.y;
  if (i >= n) return;
  const int cols = n_bits + 1;
  const float* xi = x + (long long)i * d;
  const float* pt = planes + (long long)t * d * cols;
  int code = 0;
  for (int b = 0; b < n_bits; ++b) {
    float p = 0.f;
    for (int j = 0; j < d; ++j) p = fmaf(xi[j], __ldg(pt + j * cols + b), p);
    code |= (p >= 0.f ? 1 : 0) << b;
  }
  float p = 0.f;
  for (int j = 0; j < d; ++j) p = fmaf(xi[j], __ldg(pt + j * cols + n_bits), p);
  codes[(long long)t * n + i] = code;
  tie[(long long)t * n + i] = p;
}

}  // namespace

extern "C" int hash_codes_f32(const float* x, const float* planes, int n, int d,
                              int n_tables, int n_bits, int* codes, float* tie,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)n_tables);
  hash_codes_kernel<<<grid, kThreads, 0, st>>>(x, planes, n, d, n_bits, codes, tie);
  return (int)cudaGetLastError();
}
'''

VARIANTS = {f"{g} tables a block": [("constexpr int kTablesABlock = 8;",
                                      f"constexpr int kTablesABlock = {g};")]
            for g in (16, 4, 2, 1)}
VARIANTS.update({f"{t} threads a block": [("constexpr int kThreads = 128;",
                                           f"constexpr int kThreads = {t};")]
                 for t in (64, 256)})

_PARENT = []


def build(name: str, source: str):
    """``hash_codes_f32`` of ``source``, built under ``build/variants/``."""
    out = ROOT / "build" / "variants" / f"hash_codes_{name.replace(' ', '_')}"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "hash_codes.cu", out / "hash_codes.so"
    cu.write_text(source)
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed for hash_codes ({name}):\n{log.stdout}{log.stderr}")
    fn = ctypes.CDLL(str(so)).hash_codes_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _parent_fn():
    if not _PARENT:
        _PARENT.append(build("parent", PARENT_SOURCE))
    return _PARENT[0]


def parent_hash_codes(x: torch.Tensor, planes: torch.Tensor, codes=None, tie=None):
    """The replaced kernel on contiguous fp32 CUDA tensors ``x [n, d]``,
    ``planes [T, d, n_bits + 1]``: ``(codes [T, n] int32, tie [T, n] f32)``,
    into ``codes``/``tie`` when given."""
    n, d = x.shape
    n_tables, _, cols = planes.shape
    if codes is None:
        codes = torch.empty((n_tables, n), dtype=torch.int32, device=x.device)
        tie = torch.empty((n_tables, n), dtype=torch.float32, device=x.device)
    err = _parent_fn()(x.data_ptr(), planes.data_ptr(), n, d, n_tables, cols - 1,
                       codes.data_ptr(), tie.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "parent hash_codes")
    return codes, tie


def device_cold(fn, copies, iters: int = 80) -> float:
    """``torch.profiler`` device milliseconds a launch of ``fn(*copy)``, the
    copies taken in rotation so that no launch finds its operands in L2."""
    from torch.profiler import ProfilerActivity, profile

    it = itertools.cycle(copies)
    for _ in range(len(copies)):
        fn(*next(it))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*next(it))
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    if total <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    return total / 1e3 / iters


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("hash_codes_variants: this script needs a GPU", file=sys.stderr)
        return 1
    from repro_torch.data.pointcloud import dti_like_pointcloud
    from repro_torch.kernels.lsh_candidates.kernel import _lib, hash_codes_cuda
    from repro_torch.kernels.lsh_candidates.ops import make_planes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    gen = torch.Generator().manual_seed(16)
    shapes = [(1000, d, t, b) for d in (1, 3, 8, 9, 12, 16, 17, 90) for t in (1, 16)
              for b in (1, 16, 24)]
    shapes += [(1, 3, 16, 16), (129, 3, 2, 16), (256, 16, 16, 16), (37, 16, 3, 16)]
    for n, d, t, b in shapes:
        x = (torch.rand(n, d, generator=gen) * 50 - 10).cuda()
        planes = torch.randn(t, d, b + 1, generator=gen).cuda()
        got, want = hash_codes_cuda(x, planes), parent_hash_codes(x, planes)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                            want[1].view(torch.int32))):
            raise SystemExit(f"hash_codes differs from the parent kernel at n={n} d={d} "
                             f"T={t} bits={b}")
    print(f"[check] {len(shapes)} random shapes: codes and tie-breaks bitwise equal")
    pos, _, _, _ = dti_like_pointcloud(142541, 1, 1, neighbors="none", seed=0)
    planes = make_planes(3, 16, 16, 0).cuda()
    got, want = hash_codes_cuda(pos, planes), parent_hash_codes(pos, planes)
    equal = torch.equal(got[0], want[0]) and torch.equal(got[1].view(torch.int32),
                                                         want[1].view(torch.int32))
    print(f"[check] path shape n=142541 d=3 T=16 bits=16: bitwise equal {equal}")
    if not equal:
        return 1

    source = (_build.CSRC / "hash_codes.cu").read_text()
    fns = {"kernel": _lib(), "parent": _parent_fn()}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"hash_codes.cu no longer holds {old!r}")
            text = text.replace(old, new)
        fns[name] = build(name, text)
    stream = torch.cuda.current_stream().cuda_stream
    copies = [(pos.clone(), torch.empty_like(got[0]), torch.empty_like(got[1]))
              for _ in range(8)]

    def launcher(fn):
        def run(x, c, t):
            _build.check(fn(x.data_ptr(), planes.data_ptr(), x.shape[0], 3, 16, 16,
                            c.data_ptr(), t.data_ptr(), stream), "hash_codes variant")
        return run

    runs = {name: launcher(fn) for name, fn in fns.items()}
    for name, run in runs.items():
        x, c, t = copies[0]
        run(x, c, t)
        if not (torch.equal(c, want[0]) and torch.equal(t.view(torch.int32),
                                                        want[1].view(torch.int32))):
            raise SystemExit(f"{name}: differs from the replaced kernel at the path shape")
    print(f"[check] {len(runs)} builds bitwise equal to the replaced kernel at the path shape")


    def events_warm(fn, iters=50):
        fn(*copies[0])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*copies[0])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append((device_cold(runs[name], copies), events_warm(runs[name])))
    for name, ts in times.items():
        print(f"[time] {name}: device cold " + " / ".join(f"{c:.4f}" for c, _ in ts)
              + " ms; events warm " + " / ".join(f"{w:.4f}" for _, w in ts) + " ms")
    if argv:
        against_other(Path(argv[0]), pos)
    return 0


def against_other(src: Path, pos) -> None:
    """This tree's kernel bitwise the other tree's at the paths' shapes,
    and both timed in turns (other, this, this, other) as profiler device
    time, cold (8 copies of x and of the outputs in rotation)."""
    from repro_torch.kernels.lsh_candidates.kernel import _lib
    from repro_torch.kernels.lsh_candidates.ops import make_planes

    fns = {"other": build("other tree", (src / "repro_torch" / "csrc" / "hash_codes.cu")
                          .read_text()), "this": _lib()}
    gen = np.random.default_rng(0)  # blobs like the serving pool (16 centres × 8.0, d = 16)
    centres = gen.normal(size=(16, 16)) * 8.0
    blobs = torch.from_numpy((centres[gen.integers(16, size=160_000)]
                              + gen.normal(size=(160_000, 16))).astype(np.float32)).cuda()
    shapes = {"lattice [142541 × 3]": pos, "serve [256 × 16]": blobs[:256].contiguous(),
              "serve [256 × 9]": blobs[:256, :9].contiguous(),
              "serve [256 × 12]": blobs[:256, :12].contiguous(),
              "pool [160000 × 16]": blobs, "shard [35635 × 3]": pos[:35635].contiguous()}
    stream = torch.cuda.current_stream().cuda_stream
    for name, x in shapes.items():
        n, d = x.shape
        planes = make_planes(d, 16, 16, 0).cuda()
        copies = [(x.clone(), torch.empty((16, n), dtype=torch.int32, device="cuda"),
                   torch.empty((16, n), device="cuda")) for _ in range(8)]

        def launcher(fn):
            def run(a, c, t):
                _build.check(fn(a.data_ptr(), planes.data_ptr(), n, d, 16, 16, c.data_ptr(),
                                t.data_ptr(), stream), "hash_codes")
            return run

        runs = {tree: launcher(fn) for tree, fn in fns.items()}
        outs = {}
        for tree, run in runs.items():
            c, t = torch.empty_like(copies[0][1]), torch.empty_like(copies[0][2])
            run(x, c, t)
            outs[tree] = (c, t.view(torch.int32))
        if not (torch.equal(outs["this"][0], outs["other"][0])
                and torch.equal(outs["this"][1], outs["other"][1])):
            raise SystemExit(f"{name}: codes or tie-breaks differ from the other tree's kernel")
        times = {"other": [], "this": []}
        for tree in ("other", "this", "this", "other"):
            times[tree].append(device_cold(runs[tree], copies))
        print(f"[other] {name}, 16 tables × 16 bits: codes and tie-breaks bitwise the other "
              f"tree's; device cold other " + " / ".join(f"{t:.5f}" for t in times["other"])
              + " ms, this " + " / ".join(f"{t:.5f}" for t in times["this"]) + " ms")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
