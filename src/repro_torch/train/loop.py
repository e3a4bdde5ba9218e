"""Fault-tolerant training loop (mirrors :mod:`repro.train.loop`).

* auto-resume from the newest intact checkpoint (crash at any point →
  restart loses at most ``ckpt_every`` steps),
* async checkpointing off the step path,
* deterministic data (stream state derives from the step counter, so a
  resumed run sees exactly the tokens it would have seen),
* straggler knob: ``step_timeout_s`` — a step over it is logged (a
  multi-host deployment would restart elastically there, the launcher's
  ``--elastic``).

The loss is read back to the host only on log steps, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    ckpt_keep: int = 3
    log_every: int = 10
    step_timeout_s: float = 3600.0


def run_training(
    step_fn: Callable,
    state: TrainState,
    batches: Callable[[int], Dict[str, Any]],
    cfg: TrainLoopConfig,
    *,
    log: Callable[[str], None] = print,
) -> TrainState:
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep) if cfg.ckpt_dir else None
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest(state)
        if restored is not None:
            start, state = restored[0], restored[1]
            log(f"[resume] restored checkpoint at step {start}")

    losses = []
    for step in range(start, cfg.total_steps):
        t0 = time.monotonic()
        state, metrics = step_fn(state, batches(step))
        if (step + 1) % cfg.log_every == 0 or step + 1 == cfg.total_steps:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.monotonic() - t0
            log(f"[step {step+1:6d}] loss={loss:.4f} grad_norm={float(metrics['grad_norm']):.3f} dt={dt:.3f}s")
            if dt > cfg.step_timeout_s:
                log(f"[straggler] step time {dt:.1f}s exceeded {cfg.step_timeout_s}s — "
                    "multi-host deployment would trigger elastic restart here")
        if mgr is not None and (step + 1) % cfg.ckpt_every == 0:
            mgr.save(step + 1, state, blocking=False)
    if mgr is not None:
        mgr.save(cfg.total_steps, state, blocking=True)
        mgr.wait()
    return state
