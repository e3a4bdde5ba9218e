"""The kNN top-k kernel (``src/repro_torch/csrc/knn_topk.cu``) against the
steps of its redesign and the kernel of another tree, in turns on one card.

    python3 tools/knn_topk_variants.py [OTHER_SRC_DIR]

Builds the kernel from this tree's source, each step of the redesign
undone by a text edit of the source (the start tile, the dispatch on d, the
``kGroup`` constant):

* ``old order`` — ascending tiles (the start tile set to 0, so the outward
  sweep only ever steps right), all 4 padded coordinates, one branch for
  each lane's group of 4 candidates (the sweep of the kernel before the
  redesign, with its (distance, id) insertion rule);
* ``near-first`` — a block starts at its own queries' tile and goes outward;
* ``+ real d`` — only the 3 real coordinates computed;
* ``committed`` — + one branch for 8 candidates;
* ``one candidate a step`` — one branch a candidate;
* ``+ warp vote`` — the group's branch taken by the whole warp or none
  (``__any_sync``);

and, given ``OTHER_SRC_DIR`` (e.g. the parent tree unpacked with ``git
archive``), that tree's ``knn_topk.cu`` as it is.  On the 142,541-voxel DTI
lattice (k = 16, d = 3, voxel ids in raster order) and on as many uniform
random points in the same box, each is held to the plain version (lattice:
ids and distances equal; random: distances rtol 1e-5, ids equal up to
float64 near-ties) and timed with CUDA events in turns (the list, then the
list reversed).  Then an instrumented build of the old order, of
near-first and of the committed switches (an atomic count at the insertion
site, made here and not in the package) gives the insertions a query makes:
mean and maximum over the queries.  A diagnostic build whose lists start
full (no candidate ever enters) times the sweep alone, and the SM clock is
sampled during a sustained run.  Needs a GPU and nvcc.
"""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data.pointcloud import dti_like_pointcloud  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.knn_topk.ref import knn_topk_ref  # noqa: E402

N, K = 142541, 16
# text edits of the source, each undoing or varying one step of the redesign
ASCENDING = ("  const int t0 = (int)min(max(first / tc, 0ll), (long long)nt - 1);",
             "  const int t0 = 0;")
ALL_D = ("  else if (d == 3)\n", "  else if (false)\n")  # the 4-coordinate kernel for d = 3


def group(g: int):
    return ("constexpr int kGroup = 8;", f"constexpr int kGroup = {g};")


# the warp-vote variant: the group's branch taken by the whole warp or none
VOTE = ("      if (!near) continue;",
        "      if (!__any_sync(0xffffffffu, near)) continue;")
# each variant: its edits, applied in order (none: the committed source)
VARIANTS = {
    "old order": [ASCENDING, ALL_D, group(4)],
    "near-first": [ALL_D, group(4)],
    "+ real d": [group(4)],
    "committed": [],
    "one candidate a step": [group(1)],
    "+ warp vote": [VOTE],
}
# a diagnostic, not a kernel: every list starts full at distance −1, so no
# candidate ever enters — the sweep's own cost, without insertions
SWEEP_ONLY = ("    bd[s] = CUDART_INF_F;", "    bd[s] = -1.f;")
INSERT = "insert(bd, bi, acc, cid);"
COUNT = "{ insert(bd, bi, acc, cid); atomicAdd(g_insertions + min(q0, nq - 1), 1u); }"
COUNTER = '''
__device__ unsigned int* g_insertions;
extern "C" int set_insertion_counter(unsigned int* p) {
  return (int)cudaMemcpyToSymbol(g_insertions, &p, sizeof(p));
}
'''


def edited(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"knn_topk.cu no longer holds {old!r} once")
        src = src.replace(old, new)
    return src


def instrumented(src: str) -> str:
    if src.count(INSERT) != 1:
        raise SystemExit(f"knn_topk.cu no longer holds {INSERT!r}")
    src = src.replace(INSERT, COUNT)
    # the counter's declaration goes before the kernels, inside nothing
    head, sep, tail = src.partition("namespace {")
    return head + COUNTER + sep + tail


def build_all(sources: dict) -> dict:
    """Each ``name: source`` compiled into its own library, all nvcc started
    together; returns the loaded libraries."""
    jobs = {}
    for name, src in sources.items():
        out = ROOT / "build" / "variants" / "knn_topk" / re.sub(r"\W+", "_", name)
        out.mkdir(parents=True, exist_ok=True)
        (out / "knn_topk.cu").write_text(src)
        jobs[name] = (out / "knn_topk.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / "knn_topk.so"),
             str(out / "knn_topk.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        print(f"[build] {name}: " + " | ".join(ptxas_summary(log, "knn_topk_kernelILi16E")))
        libs[name] = ctypes.CDLL(str(so))
    return libs


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


def entry(lib, with_d: bool):
    fn = lib.knn_topk_f32
    ints = 5 if with_d else 4
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * ints + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    def run(xp, d):
        dist = torch.empty(N, K, device="cuda")
        idx = torch.empty(N, K, dtype=torch.int32, device="cuda")
        args = (N, N, 4, d) if with_d else (N, N, 4)
        err = fn(xp.data_ptr(), xp.data_ptr(), *args, K, 0, dist.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
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


def near_ties_only(x, gi, wi, wd) -> int:
    diff = gi != wi
    rows = torch.nonzero(diff)[:, 0]
    x64 = x.double()
    d_got = ((x64[rows] - x64[gi[diff].long()]) ** 2).sum(1)
    want = wd[diff].double()
    if not bool(((d_got - want).abs() <= 1e-5 * want + 1e-6).all()):
        raise SystemExit("a differing id is not a near-tie")
    return int(diff.sum())


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("knn_topk_variants: this script needs a GPU", file=sys.stderr)
        return 1
    src = (_build.CSRC / "knn_topk.cu").read_text()
    sources = {name: edited(src, edits) for name, edits in VARIANTS.items()}
    sources["sweep only (diagnostic)"] = edited(src, [SWEEP_ONLY])
    counted = ("old order", "near-first", "committed")
    for name in counted:
        sources[f"count {name}"] = instrumented(sources[name])
    if argv:
        sources["other tree"] = (Path(argv[0]) / "repro_torch" / "csrc" / "knn_topk.cu").read_text()
    libs = build_all(sources)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())

    pos, _, _, _ = dti_like_pointcloud(N, 1, 1, neighbors="none", seed=0)
    rnd = torch.rand(N, 3, generator=torch.Generator().manual_seed(0)).cuda() * 52
    inputs = {"lattice": pos, "random": rnd}
    runs = {name: entry(libs[name], "int dp, int d," in sources[name])
            for name in sources if not name.startswith("count ")}
    for data, x in inputs.items():
        xp = torch.nn.functional.pad(x, (0, 1)).contiguous()
        wd, wi = knn_topk_ref(x, K)
        for name, run in runs.items():
            if name.endswith("(diagnostic)"):
                continue
            gd, gi = run(xp, 3)
            if data == "lattice":
                if not (torch.equal(gd, wd) and torch.equal(gi, wi)):
                    raise SystemExit(f"{name}: lattice neighbours differ from the plain version")
                note = "ids and distances equal"
            else:
                torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-6)
                note = f"{near_ties_only(x, gi, wi, wd)} ids swapped at near-ties"
            print(f"[check] {data} {name}: {note}")
        del wd, wi
        names = list(runs)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(events_ms(lambda: runs[name](xp, 3), iters=5))
        for name, ts in times.items():
            print(f"[time] {data} {name}: " + " / ".join(f"{t:.3f}" for t in ts)
                  + f" ms (mean {sum(ts) / len(ts):.3f})")
        if data == "lattice":  # the SM clock under a sustained run of the committed kernel
            smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                    "--format=csv,noheader", "-lms", "200"],
                                   stdout=subprocess.PIPE, text=True)
            events_ms(lambda: runs["committed"](xp, 3), iters=150)
            smi.terminate()
            print("[clock] clocks.sm, power.draw during 150 runs: "
                  + " | ".join(smi.communicate()[0].split("\n")[2:-2]))
        for name in counted:
            lib = libs[f"count {name}"]
            counts = torch.zeros(N, dtype=torch.int32, device="cuda")
            if lib.set_insertion_counter(ctypes.c_void_p(counts.data_ptr())):
                raise SystemExit("could not set the insertion counter")
            entry(lib, True)(xp, 3)
            torch.cuda.synchronize()
            c = counts.double()
            print(f"[insertions] {data} {name}: mean {float(c.mean()):.1f}, max {int(c.max())} "
                  f"a query")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
