"""The control of the check: the plain reference in the program's place,
computed in TF32 (the nearest precision below the configurations' float32),
at a configuration's own size, judged by the same comparison as a run.  The
check must come out false on every seed; each number's readings set the
upper end of its limit.  With ``--fault`` the reference is broken instead
(:func:`specbench.reference.pipeline.run`), for the faults' readings.

    python3 specbench/control.py --config dti-exact --seeds 11 12 13 [--precision tf32]
        [--fault drop_pair]

prints one JSON line a seed (the data are dataset 0 of a run of that seed,
and the reference draws from it too): the numbers, the verdict and the
seconds.  It imports nothing of the program.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from specbench import harness
    from specbench.reference import judge, pipeline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default="tf32", choices=("fp32", "tf32"))
    ap.add_argument("--fault", choices=pipeline.FAULTS)
    args = ap.parse_args(argv)
    import torch

    # by its file, so a configuration no cell uses yet can be read too
    cfg = json.loads((ROOT / "specbench" / "configs"
                      / f"{harness.check_name(args.config)}.json").read_text())
    maker = harness.load_module(harness.part_path(ROOT, "datasets", cfg["data"]["maker"]))
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        d = maker.make(cfg["data"], harness.data_seed(seed, 0))
        pos, feats = d["points"].to(dev), d["features"].to(dev)
        out = pipeline.run(pos, feats, cfg, args.precision, seed=seed, fault=args.fault)
        t1 = time.perf_counter()
        nums = judge.judge(out, pos, feats, cfg["pipeline"])
        ok, shown = judge.verdict(nums, cfg["check"]["limits"])
        print(json.dumps({"config": args.config, "seed": seed, "precision": args.precision,
                          "fault": args.fault, "correct": ok, "check": shown,
                          "numbers": nums, "pipeline_s": t1 - t0,
                          "judge_s": time.perf_counter() - t1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
