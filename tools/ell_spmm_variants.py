"""The two mappings of the BlockELL SpMM kernel (``src/repro_torch/csrc/
ell_spmm.cu``) against each other at the widths the paths use, and the
device launches of one ``ell_spmm`` call, on one card.

    python3 tools/ell_spmm_variants.py [OTHER_SRC_DIR ...]

On the first DTI path's normalized kNN graph in its BlockELL layout (R =
142,544 rows, W = 40, 142,541 voxels, seed 0) and for b = 4, 8, 16, 32, 64
and 508 right-hand sides: each mapping (``stream``, the streamed slot pass;
``rows``, a thread per row and column group; each built from the source
with the cut-over ``kStreamMaxB`` set so that the C entry always takes it)
is held to the plain version
(rtol 1e-5, atol 1e-6) and timed in turns (stream, rows, rows, stream),
warm (one copy of the slots, back to back) and cold (rotating over three
copies, 137 MB, so that no launch finds its slots in the 50 MB L2), as
device time from ``torch.profiler``'s kernel records: with CUDA events a
launch of a few tens of µs measures the host's launch rate instead.  The cut-over the C entry uses (``kStreamMaxB``) is read
from these times.

Then the device kernels (and memsets) that one ``ell_spmm(m, x)`` call
launches at b = 4, counted with ``torch.profiler``, for this tree and for
the ``repro_torch`` package of each ``OTHER_SRC_DIR`` (each in its own
process).  Needs a GPU.
"""
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
N = 142541
WIDTHS = (4, 8, 16, 32, 64, 508)
CUT = "constexpr int kStreamMaxB = 8; "
MAPPINGS = {"stream": "constexpr int kStreamMaxB = 1 << 30; ", "rows": "constexpr int kStreamMaxB = 0; "}


def build(name: str, src: str):
    """``ell_spmm_f32`` of ``src`` built into its own library."""
    from repro_torch.kernels import _build

    out = ROOT / "build" / "variants" / f"ell_spmm_{name}"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "ell_spmm.cu", out / "ell_spmm.so"
    cu.write_text(src)
    log = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if log.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{log.stdout}{log.stderr}")
    fn = ctypes.CDLL(str(so)).ell_spmm_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def count_launches(src: str) -> None:
    """Device activities per ``ell_spmm`` call of the package under ``src``
    at b = 4, on a small graph with a COO tail."""
    sys.path.insert(0, src)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ell_spmm.ops import ell_spmm
    from repro_torch.sparse import formats as tf

    rng = np.random.default_rng(0)
    n = 1000
    r, c = rng.integers(0, n, 12 * n), rng.integers(0, n, 12 * n)
    v = rng.random(12 * n).astype(np.float32)
    m = tf.csr_to_blockell(tf.coo_to_csr(tf.coo_from_edges(r, c, v, (n, n), device="cuda")),
                           width=8)
    x = torch.randn(n, 4, device="cuda")
    ell_spmm(m, x)
    torch.cuda.synchronize()
    calls = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ell_spmm(m, x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    print(f"[launches] {src}: {len(names) / calls:g} device activities per ell_spmm call "
          f"(b = 4, {m.tail.nnz} tail entries): "
          + ", ".join(sorted({nm[:60] for nm in names})))


def main(argv) -> int:
    if argv[:1] == ["--count"]:
        count_launches(argv[1])
        return 0
    if not torch.cuda.is_available():
        print("ell_spmm_variants: this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.spectral import (EigConfig, GraphConfig, KMeansConfig,
                                           SpectralPipeline)
    from repro_torch.data.pointcloud import dti_like_pointcloud
    from repro_torch.kernels._build import CSRC
    from repro_torch.kernels.ell_spmm.ref import ell_spmm_ref

    src = (CSRC / "ell_spmm.cu").read_text()
    if src.count(CUT) != 1:
        raise SystemExit(f"ell_spmm.cu no longer holds {CUT!r}")
    fns = {name: build(name, src.replace(CUT, line)) for name, line in MAPPINGS.items()}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    pos, prof, _, _ = dti_like_pointcloud(N, 90, 250, eps=1.8, seed=0, neighbors="none")
    pipe = SpectralPipeline(n_clusters=500,
                            graph=GraphConfig(knn_k=16, measure="cross_correlation"),
                            eig=EigConfig(tol=1e-4, block_size=4, representation="blockell"),
                            kmeans=KMeansConfig(iter="fused"))
    m = pipe.operator(pipe.build_graph(prof, points=pos)).a
    nb, br, w = m.cols.shape
    cols, vals = m.cols.reshape(nb * br, w).contiguous(), m.vals.reshape(nb * br, w).contiguous()
    slots = [(cols.clone(), vals.clone()) for _ in range(3)]
    print(f"[graph] R = {nb * br}, W = {w}, slot bytes {cols.numel() * 8 / 1e6:.1f} MB")

    def ms(fn, iters):  # device time per call, from the profiler's kernel records
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as rec:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in rec.key_averages()) / 1e3 / iters

    for b in WIDTHS:
        x = torch.randn(N, b, device="cuda")
        y = torch.empty(nb * br, b, device="cuda")

        def run(mapping, c, v):
            err = fns[mapping](x.data_ptr(), c.data_ptr(), v.data_ptr(), N, nb * br, w, b,
                               y.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{mapping}: launch failed with cudaError_t {err}")

        want = ell_spmm_ref(x, cols, vals)
        for mapping in MAPPINGS:
            run(mapping, cols, vals)
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
        del want
        times = {f"{mp} {how}": [] for mp in MAPPINGS for how in ("warm", "cold")}
        iters = 100 if b <= 64 else 10
        for mapping in ("stream", "rows", "rows", "stream"):
            times[f"{mapping} warm"].append(ms(lambda: run(mapping, cols, vals), iters))
            it = itertools.cycle(slots)
            times[f"{mapping} cold"].append(ms(lambda: run(mapping, *next(it)), iters - iters % 3))
        print(f"[time] b = {b}: " + "; ".join(
            f"{key} " + " / ".join(f"{t:.4f}" for t in ts) for key, ts in times.items()) + " ms")
    del slots
    for src in [str(ROOT / "src"), *argv]:
        subprocess.run([sys.executable, __file__, "--count", src], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
