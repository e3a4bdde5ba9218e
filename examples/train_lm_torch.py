"""Training-substrate example on the PyTorch/CUDA port: train a small LM with
the full runtime stack (AdamW, schedules, remat, checkpoint/auto-resume,
deterministic data).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300

The port's counterpart of ``examples/train_lm.py``, with the same presets,
flags and printed lines, plus ``--device`` (the card unless ``cpu`` is
given).  Interrupt it and re-run — it resumes from the newest checkpoint.
"""
import argparse
import os
import tempfile

import torch

from repro_torch._device import cpu_generator, resolve_device
from repro_torch.data.tokens import MarkovTokenStream
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.state import init_state, make_train_step

PRESETS = {
    # ~5M params: CPU-friendly demo
    "tiny": tfm.TransformerConfig(
        name="tiny", n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_head=64,
        d_ff=1024, vocab=4096, dtype=torch.float32, attn_chunk=128,
    ),
    # ~100M params: the example scale (minutes on the card)
    "100m": tfm.TransformerConfig(
        name="100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
        d_ff=2048, vocab=32768, dtype=torch.float32, attn_chunk=256,
    ),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless cpu is asked for)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = PRESETS[args.preset]
    print(f"model {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params")
    params = tfm.init_params(cfg, cpu_generator(0), device=dev)
    state = init_state(params)

    opt = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(lambda p, b: tfm.train_loss(p, b, cfg), opt)

    stream = MarkovTokenStream(cfg.vocab, seed=0)

    def batches(step):
        stream._step = step  # deterministic per step => restart-reproducible
        b = stream.next_batch(args.batch, args.seq)
        return {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                "labels": torch.from_numpy(b["labels"]).to(dev)}

    run_training(step_fn, state, batches,
                 TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                 ckpt_every=50, log_every=10))


if __name__ == "__main__":
    main()
