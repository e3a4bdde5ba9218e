"""The kNN top-k kernel (``src/repro_torch/csrc/knn_topk.cu``) against the
kernel of another tree, bit for bit and in turns on one card.

    python3 tools/knn_topk_variants.py [OTHER_SRC_DIR] [--sweep]

``OTHER_SRC_DIR`` is another tree's ``src`` (e.g. the parent commit
unpacked with ``git archive`` under the gitignored ``build/``); its
``repro_torch/csrc/knn_topk.cu`` is built as it is, whichever C interface
it has (with or without the candidate split).  The shapes, each the one a
path gives the kernel:

* ``lattice`` — the 142,541-voxel DTI lattice, all pairs, d = 3, k = 16
  (the first path's Stage 1);
* ``random`` — as many uniform random points in the same box;
* ``serve`` — a batch of 256 held-out queries against ``launch/serve.py``'s
  blob pool (n = 160,000, 16 centres, d = 16), k = 10, query_offset = n
  (``serve/oos.py``), query 5 with a NaN coordinate (the launcher's
  injected fault);
* ``pool`` — that pool all pairs, k = 10 (the serving cell's training);
* ``shard`` — a 4-rank plan's block: rows 35,635–71,269 of the lattice's
  first 142,540 points against all of them, offset 35,635, k = 16.

At each shape this tree's kernel at the slice count the binding picks
(``choose_splits``) and at S = 1, 2 and 7 is held bitwise (distance bits
and ids) to the other tree's kernel, or to its own S = 1 without one; then
both are timed with CUDA events in turns (other, this, this, other).
``--sweep`` also times this tree's kernel at a range of S on the serving
and shard shapes.  Variants of this tree's source, each a text edit of one
choice (``VARIANTS``: the candidates a hot-loop step takes, 8 against 16;
the 16-slot list for k <= 12 instead of 12 slots; a 16 KB tile against
48 KB; the group's insertions taken as one branch a candidate instead of
one a candidate each lane keeps), are held
bitwise too and timed in turns at the lattice, serving and shard shapes.
The build prints ``-Xptxas -v``'s registers and spills of the kernels the
shapes run.  Needs a GPU and nvcc.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data.pointcloud import dti_like_pointcloud  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.knn_topk.kernel import choose_splits  # noqa: E402

N_LATTICE, K_LATTICE = 142541, 16
N_POOL, D_POOL, CENTRES, B_SERVE, K_SERVE = 160_000, 16, 16, 256, 10
SHARDS = 4
SWEEP = {"serve": (1, 2, 4, 8, 16, 32, 52, 66, 104, 132, 209),
         "shard": (1, 2, 3, 4, 8)}
# text edits of this tree's source, each varying one choice of the design
GROUP = "constexpr int kGroup = 16;"
TILE = "constexpr int kSmemFloats = 12288;"
PICK = ("      while (keep) {  // the list may have moved since the mask: test again\n"
        "        const int u = __ffs(keep) - 1;\n        keep &= keep - 1;\n",
        "#pragma unroll\n      for (int u = 0; u < G; ++u) if (keep >> u & 1) {\n")
RUNG = ("  if (k <= 12) return KNN_KP(12);\n", "")
VARIANTS = {"kGroup 8": [(GROUP, GROUP.replace("16", "8"))],
            "no 12-slot list": [RUNG],
            "tile 16 KB": [(TILE, TILE.replace("12288", "4096"))],
            "a branch a candidate": [PICK]}
VARIANT_SHAPES = ("lattice", "serve", "shard")


def build_all(sources: dict) -> dict:
    """Each ``name: source text`` compiled into ``build/variants/knn_topk/``,
    all nvcc started together; returns ``name: library``, printing
    ``-Xptxas -v``'s lines of the kernels the shapes run."""
    jobs = {}
    for name, text in sources.items():
        out = ROOT / "build" / "variants" / "knn_topk" / re.sub(r"\W+", "_", name)
        out.mkdir(parents=True, exist_ok=True)
        (out / "knn_topk.cu").write_text(text)
        jobs[name] = (out / "knn_topk.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / "knn_topk.so"),
             str(out / "knn_topk.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        print(f"[build] {name}: " + " | ".join(ptxas_summary(log)))
        libs[name] = ctypes.CDLL(str(so))
    return libs


def ptxas_summary(log: str) -> list:
    """Registers and spills of the KP = 12/16 kernels (k = 10, 16)."""
    out, fn = [], ""
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
        elif re.search(r"ILi(12|16)E", fn) and ("registers" in ln or "spill" in ln):
            out.append(f"{fn[:40]}: {ln.split(':', 1)[-1].strip()}")
    return out


def entry(lib, split: bool):
    """A call of ``knn_topk_f32`` on padded CUDA inputs: ``run(xq, xc, k, off,
    d, splits)``; ``splits`` None is the binding's choice (ignored by a
    kernel without the split)."""
    fn = lib.knn_topk_f32
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
                   + ([ctypes.c_int] + [ctypes.c_void_p] * 2 if split else [])
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(xq, xc, k, off, d, splits=None):
        nq, dp = xq.shape
        dist = torch.empty(nq, k, device="cuda")
        idx = torch.empty(nq, k, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        head = (xq.data_ptr(), xc.data_ptr(), nq, xc.shape[0], dp, d, k, off)
        if split:
            s = choose_splits(nq, xc.shape[0], dp, sms) if splits is None else splits
            part = [torch.empty((s, k, nq), dtype=torch.int32, device="cuda")
                    for _ in range(2)] if s > 1 else [None, None]
            err = fn(*head, s, *(None if p is None else p.data_ptr() for p in part),
                     dist.data_ptr(), idx.data_ptr(), stream)
        else:
            err = fn(*head, dist.data_ptr(), idx.data_ptr(), stream)
        if err:
            raise SystemExit(f"launch failed with cudaError_t {err}")
        return dist, idx
    return run


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


def same_bits(a, b) -> bool:
    return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])


def serve_data():
    """``launch/serve.py``'s pool (its rng, its draws), then 256 held-out
    queries from the same centres."""
    rng = np.random.default_rng(0)
    centres = rng.normal(size=(CENTRES, D_POOL)) * 8.0
    pool = np.concatenate([centres[i] + rng.normal(size=(N_POOL // CENTRES, D_POOL))
                           for i in range(CENTRES)]).astype(np.float32)
    tru = rng.integers(CENTRES, size=B_SERVE)
    q = (centres[tru] + rng.normal(size=(B_SERVE, D_POOL))).astype(np.float32)
    q[5, 3] = np.nan
    return torch.from_numpy(pool).cuda(), torch.from_numpy(q).cuda()


def shapes():
    """name: (queries, candidates, k, query_offset, d, timed iterations), the
    rows padded to a multiple of 4 as the wrapper pads them."""
    pos, _, _, _ = dti_like_pointcloud(N_LATTICE, 1, 1, neighbors="none", seed=0)
    lat = torch.nn.functional.pad(pos.cuda(), (0, 1)).contiguous()
    rnd = torch.rand(N_LATTICE, 3, generator=torch.Generator().manual_seed(0)).cuda() * 52
    rnd = torch.nn.functional.pad(rnd, (0, 1)).contiguous()
    pool, q = serve_data()
    n_shard = N_LATTICE - N_LATTICE % SHARDS
    nl = n_shard // SHARDS
    xs = lat[:n_shard].contiguous()
    return {"lattice": (lat, lat, K_LATTICE, 0, 3, 5),
            "random": (rnd, rnd, K_LATTICE, 0, 3, 5),
            "serve": (q, pool, K_SERVE, N_POOL, D_POOL, 20),
            "pool": (pool, pool, K_SERVE, 0, D_POOL, 3),
            "shard": (xs[nl:2 * nl].contiguous(), xs, K_LATTICE, nl, 3, 10)}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("knn_topk_variants: this script needs a GPU", file=sys.stderr)
        return 1
    sweep = "--sweep" in argv
    argv = [a for a in argv if a != "--sweep"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    text = (_build.CSRC / "knn_topk.cu").read_text()
    sources = {"this": text}
    for name, edits in VARIANTS.items():
        sources[name] = text
        for old, new in edits:
            if sources[name].count(old) != 1:
                raise SystemExit(f"knn_topk.cu no longer holds {old!r} once")
            sources[name] = sources[name].replace(old, new)
    if argv:
        sources["other"] = (Path(argv[0]) / "repro_torch" / "csrc" / "knn_topk.cu").read_text()
    libs = build_all(sources)
    runs = {name: entry(lib, "int splits" in sources[name]) for name, lib in libs.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (xq, xc, k, off, d, iters) in shapes().items():
        chosen = choose_splits(xq.shape[0], xc.shape[0], xq.shape[1], sms)
        ref_name = "other" if "other" in runs else "this"
        want = runs[ref_name](xq, xc, k, off, d, 1)
        for s in sorted({chosen, 1, 2, 7}):
            if not same_bits(runs["this"](xq, xc, k, off, d, s), want):
                raise SystemExit(f"{name}: S = {s} differs from the {ref_name} tree's kernel")
        print(f"[check] {name} [{xq.shape[0]} × {xc.shape[0]} × {d}] k={k} offset={off}: "
              f"S = 1, 2, 7 and the chosen {chosen} bitwise the {ref_name} tree's kernel "
              f"({int(torch.isnan(want[0]).any(1).sum())} rows with NaN distances)")
        order = ["other", "this", "this", "other"] if "other" in runs else ["this", "this"]
        times = {r: [] for r in order}
        for r in order:
            times[r].append(events_ms(lambda: runs[r](xq, xc, k, off, d), iters))
        if name in VARIANT_SHAPES:  # the variants at this tree's S, in turns
            names = list(VARIANTS)
            vt = {v: [] for v in names}
            for v in names + names[::-1]:
                if len(vt[v]) == 0 and not same_bits(runs[v](xq, xc, k, off, d), want):
                    raise SystemExit(f"{name}: variant {v} differs")
                vt[v].append(events_ms(lambda: runs[v](xq, xc, k, off, d, chosen), iters))
            print(f"[variants] {name} at S = {chosen}: " + "; ".join(
                f"{v} " + " / ".join(f"{t:.4f}" for t in ts) for v, ts in vt.items()) + " ms")
        print(f"[time] {name}: " + "; ".join(
            f"{r} " + " / ".join(f"{t:.4f}" for t in ts) + f" ms (mean {np.mean(ts):.4f})"
            for r, ts in times.items()) + " (events, warm, in turns "
            + "/".join(order) + ")")
        if name == "serve":  # the sweep and the merge apart, profiler device time
            from torch.profiler import ProfilerActivity, profile
            runs["this"](xq, xc, k, off, d)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    runs["this"](xq, xc, k, off, d)
                torch.cuda.synchronize()
            parts = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                     if "knn" in e.key}
            print(f"[parts] serve at S = {chosen}, device ms a call: " + "; ".join(
                f"{'merge' if 'merge' in key else 'sweep'} {t:.4f}" for key, t in parts.items()))
        if sweep and name in SWEEP:
            got = {s: events_ms(lambda: runs["this"](xq, xc, k, off, d, s), iters)
                   for s in SWEEP[name]}
            print(f"[sweep] {name} (chosen S = {chosen}): "
                  + ", ".join(f"S={s} {t:.4f}" for s, t in got.items()) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
