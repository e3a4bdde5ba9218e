"""Run one cell of the port's benchmark once and print its result line.

    python specbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the result's metrics are
the cell's end-to-end ones, with ``--trace 1`` its per-layer ones, read from
a ``torch.profiler`` trace of the window.  The last line of standard output
is the result (JSON); the numbers the check compared, each beside its
limit, are the last lines of standard error and the result's last key.
Exits with 2, printing no result, without a CUDA device; with 3 if a module
of JAX or of the JAX package was loaded.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "specbench"


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from specbench import harness, runner

    man = harness.manifest(ROOT)
    chips = harness.cell(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"specbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = runner.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                          device="cuda", t_start=T0)
    out.pop("run")
    out["device"]["power_limit"] = _power_limit()
    found = harness.foreign_modules()
    if found:
        print(f"specbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in out["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(harness.result_line(**out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
