"""Training launcher (mirrors :mod:`repro.launch.train` on one device).

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 1000 \\
        --ckpt-dir /ckpt/run1
    python -m repro_torch.launch.train --smoke --device cpu

Features exercised:
  * microbatch accumulation + remat (per-arch accumulation from
    ``configs.cells.LM_ACCUM``; the config's remat policy),
  * checkpoint/auto-resume (``repro_torch.train.loop``), async saves,
  * deterministic data: step ``i`` trains on the token stream's batch ``i``.

Runs on the card unless ``--device cpu`` is given.  The reference's mesh
flags (``--data-parallel``, ``--model-parallel``), ``--elastic`` and
``--grad-compress`` are accepted and refused unless left at their defaults:
the mesh, the elastic restart and the compressed all-reduce come with the
sharding slice (ROADMAP A14e), and a flag is never ignored silently.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.cells import LM_ACCUM, OPT_CFG
from repro_torch.data.tokens import MarkovTokenStream
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.state import TrainState, init_state, make_train_step

# the flags of the reference that need a mesh, and their defaults
_MESH_FLAGS = {"data_parallel": 0, "model_parallel": 1, "elastic": False,
               "grad_compress": False}


def main(argv=None) -> TrainState:
    """Parse ``argv``, train, and return the final state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-parallel", type=int, default=0, help="0 = auto")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--elastic", action="store_true",
                    help="re-plan mesh from live device count (restart path)")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless cpu is asked for)")
    args = ap.parse_args(argv)

    set_flags = [f"--{k.replace('_', '-')}" for k, default in _MESH_FLAGS.items()
                 if getattr(args, k) != default]
    if set_flags:
        raise SystemExit(f"{', '.join(set_flags)}: the mesh, the elastic restart and the "
                         "compressed all-reduce are not ported yet (ROADMAP A14e); this "
                         "launcher trains on one device")
    from repro_torch._device import cpu_generator, resolve_device

    dev = resolve_device(args.device)
    arch = ARCHS[args.arch]
    if arch.family != "lm":
        raise SystemExit("train.py drives the LM family; see examples/ for others")
    cfg = arch.smoke_config if args.smoke else arch.config

    # one device: the reference's mesh degenerates to 1 × 1
    print(f"mesh {dict(data=1, model=1)}  arch {cfg.name}  params ~{cfg.param_count()/1e6:.0f}M")

    from repro_torch.models import transformer as tfm

    params = tfm.init_params(cfg, cpu_generator(0), device=dev)
    state = init_state(params)
    accum = LM_ACCUM.get(cfg.name, 1) if not args.smoke else 1
    step = make_train_step(lambda p, b: tfm.train_loss(p, b, cfg), OPT_CFG,
                           accum_steps=accum)

    stream = MarkovTokenStream(cfg.vocab, seed=0)

    def batches(i):
        stream._step = i
        b = stream.next_batch(args.batch, args.seq)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    return run_training(step, state, batches,
                        TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                        ckpt_every=max(args.steps // 5, 1)))


if __name__ == "__main__":
    main()
