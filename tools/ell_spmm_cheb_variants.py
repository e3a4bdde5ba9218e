"""The fused Chebyshev step of ``src/repro_torch/csrc/ell_spmm.cu`` (the
row-band × column-slab pass) at each band and slab size, against the
kernel of another tree, in turns on one card.

    python3 tools/ell_spmm_cheb_variants.py [OTHER_SRC_DIR]

On the scalable DTI path's BlockELL graph (LSH kNN graph of the 142,541
voxels, cross-correlation weights, seed 0) and on a copy of it with rows and
columns permuted at random (the same matrix in an order with no locality of
ids), at the filter's width b = 508: builds the step from this tree's
source for each band B ∈ {64, 128, 256} rows and slab s ∈ {16, 32, 64}
columns (a lane a column group), with registers for one or two
1024-thread blocks an SM (m; ``kBandRows``, ``kBandLanes`` = s / 4,
``kBandBlocks``, rewritten; B is rounded up to a whole number of the
block's row passes), and, given
``OTHER_SRC_DIR`` (e.g. the parent tree unpacked with ``git archive``), that
tree's ``ell_spmm.cu`` as it is.  Each is held to the plain step (rtol 1e-5,
atol 1e-5) and to the other tree's output (bit equality reported), then
timed with CUDA events in turns (the list, then the list reversed).  Prints
the distinct (band, column) pairs of each graph for each B and for single
rows (the neighbour rows a band gathers, against the slots) and how many
distinct columns a band names.  Needs a GPU and
nvcc.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.operator import BlockEllOperator  # noqa: E402
from repro_torch.core.spectral import (EigConfig, GraphConfig, KMeansConfig,  # noqa: E402
                                       SpectralPipeline)
from repro_torch.data.pointcloud import dti_like_pointcloud  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ell_spmm.ref import ell_spmm_cheb_ref  # noqa: E402
from repro_torch.sparse.formats import COO, coo_to_csr, csr_to_blockell  # noqa: E402

N, B = 142541, 508
# name: (rows a band, lanes a row — a slab of 4 · lanes columns — and blocks
# an SM the registers must allow); 1024 threads a block
SHAPES = {f"B={b} s={4 * lanes} m={m}": (b, lanes, m)
          for b in (64, 128, 256) for lanes in (4, 8, 16) for m in (1, 2)}
SIZES = (r"constexpr int kBandRows = \d+, kBandLanes = \d+, kBandThreads = \d+, "
         r"kBandBlocks = \d+,\s+kSlotUnroll = \d+;")

def build_all(sources: dict) -> dict:
    """Each ``name: source`` compiled into its own library, all nvcc started
    together; returns each library's ``ell_spmm_cheb_f32``."""
    jobs = {}
    for name, src in sources.items():
        out = ROOT / "build" / "variants" / "ell_spmm_cheb" / re.sub(r"\W+", "_", name)
        out.mkdir(parents=True, exist_ok=True)
        (out / "ell_spmm.cu").write_text(src)
        jobs[name] = (out / "ell_spmm.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / "ell_spmm.so"),
             str(out / "ell_spmm.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        print(f"[build] {name}: " + " | ".join(ptxas_summary(log, "ell_spmm_band")))
        fn = ctypes.CDLL(str(so)).ell_spmm_cheb_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def ptxas_summary(log: str, kernel: str) -> list:
    """``-Xptxas -v``'s registers and spills of each entry function whose
    (mangled) name holds ``kernel``."""
    out, fn = [], ""
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
        elif kernel in fn and ("registers" in ln or "spill" in ln):
            out.append(f"{fn[fn.index(kernel):][:30]}: {ln.split(':', 1)[-1].strip()}")
    return out


def permuted(adj: COO, seed: int) -> COO:
    """P A Pᵀ for a random permutation P: the same graph, ids shuffled, its
    entries sorted by (row, column) as the graph builder leaves them."""
    perm = torch.randperm(adj.shape[0], generator=torch.Generator().manual_seed(seed))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel())
    inv = inv.to(adj.row.device)
    row, col = inv[adj.row.long()], inv[adj.col.long()]
    order = torch.argsort(row * adj.shape[1] + col)
    return COO(row[order].to(adj.row.dtype), col[order].to(adj.col.dtype), adj.val[order],
               adj.shape)


def distinct_pairs(cols: torch.Tensor, vals: torch.Tensor, band: int) -> int:
    """Distinct (row // band, column) pairs over the real slots (padding
    slots hold value 0)."""
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None].expand_as(cols)
    real = vals != 0
    key = (rows[real] // band).long() * N + cols[real].long()
    return int(torch.unique(key).numel())


def band_columns(cols: torch.Tensor, band: int) -> torch.Tensor:
    """Distinct column ids (padding slots' column 0 included) in each band."""
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None].expand_as(cols)
    key = torch.unique((rows // band).long() * N + cols.long())
    return torch.bincount(key // N)


def events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ell_spmm_cheb_variants: this script needs a GPU", file=sys.stderr)
        return 1
    src = (_build.CSRC / "ell_spmm.cu").read_text()
    if len(re.findall(SIZES, src)) != 1:
        raise SystemExit("ell_spmm.cu no longer holds one declaration of kBandRows, "
                         "kBandLanes, kBandThreads, kBandBlocks and kSlotUnroll")
    sources = {name: re.sub(
        SIZES, f"constexpr int kBandRows = {b}, kBandLanes = {lanes}, kBandThreads = 1024, "
               f"kBandBlocks = {m}, kSlotUnroll = 8;", src)
        for name, (b, lanes, m) in SHAPES.items()}
    if argv:
        sources["other tree"] = (Path(argv[0]) / "repro_torch" / "csrc" / "ell_spmm.cu").read_text()
    fns = build_all(sources)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())

    pos, prof, _, _ = dti_like_pointcloud(N, 90, 250, eps=1.8, seed=0, neighbors="none")
    pipe = SpectralPipeline(
        n_clusters=500,
        graph=GraphConfig(knn_k=16, measure="cross_correlation", method="lsh"),
        eig=EigConfig(tol=1e-4, solver="chebyshev", representation="blockell"),
        kmeans=KMeansConfig(iter="two_pass"))
    state = pipe.build_graph(prof, points=pos)
    graphs = {"scalable": pipe.operator(state).a,
              "permuted": BlockEllOperator(csr_to_blockell(coo_to_csr(permuted(state.adj, 1)))).a}
    del state
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(N, B, generator=gen).cuda()
    prev = torch.randn(N, B, generator=gen).cuda()
    coef = torch.tensor([1.98, -0.02], device="cuda")
    for tag, m in graphs.items():
        nb, br, w = m.cols.shape
        cols = m.cols.reshape(nb * br, w).contiguous()
        vals = m.vals.reshape(nb * br, w).float().contiguous()
        real = int((vals != 0).sum())
        pairs = {band: distinct_pairs(cols, vals, band) for band in (1, 64, 128, 256)}
        print(f"[graph] {tag}: R = {nb * br}, W = {w}, {real} real slots, tail {m.tail.nnz}; "
              f"distinct (band, column) pairs: " + ", ".join(
                  f"B={band} {p} ({p * B * 4 / 1e9:.2f} GB of gathered rows at b = {B})"
                  for band, p in pairs.items()))
        for band in (64, 128, 256):  # padding slots' column 0 included
            per = band_columns(cols, band).float()
            q = torch.quantile(per, torch.tensor([0.5, 0.9, 0.99], device=per.device))
            print(f"[graph] {tag}: distinct columns a band of {band} rows: mean "
                  f"{float(per.mean()):.1f}, median {float(q[0]):.0f}, p90 {float(q[1]):.0f}, "
                  f"p99 {float(q[2]):.0f}, max {int(per.max())}")
        want = ell_spmm_cheb_ref(x, cols, vals, prev, coef[0], coef[1])
        outs = {}

        def run(name):
            y = torch.empty(N, B, device="cuda")
            err = fns[name](x.data_ptr(), cols.data_ptr(), vals.data_ptr(), prev.data_ptr(),
                            coef.data_ptr(), N, N, w, B, y.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: launch failed with cudaError_t {err}")
            return y

        for name in fns:
            y = run(name)
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
            outs[name] = y
        del want
        ref_name = "other tree" if "other tree" in outs else next(iter(outs))
        for name, y in outs.items():
            same = torch.equal(y, outs[ref_name])
            print(f"[check] {tag} {name}: within rtol 1e-5 of the plain step; "
                  + ("bitwise equal to " if same else
                     f"max |Δ| {float((y - outs[ref_name]).abs().max()):.3e} against ") + ref_name)
        del outs
        names = list(fns)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(events_ms(lambda: run(name), iters=20))
        for name, ts in times.items():
            print(f"[time] {tag} {name}: " + " / ".join(f"{t:.4f}" for t in ts)
                  + f" ms (mean {sum(ts) / len(ts):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
