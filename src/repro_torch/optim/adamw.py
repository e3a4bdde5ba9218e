"""AdamW with decoupled weight decay, global-norm clipping and schedules
(mirrors :mod:`repro.optim.adamw`).

Optimizer state mirrors the parameter tree: m and v in fp32 whatever the
parameter's dtype, no master weights — the reference's layout.  The
schedule and the bias corrections are fp32 tensors on the step's device,
computed from the step tensor as the reference computes them, so the step
reads nothing back to the host.  The update runs in place on the
parameters and moments (the reference donates them) with
``torch._foreach_*`` over the tree's leaves, in the reference's order of
operations.  ``torch.optim.AdamW`` is not used: it keeps bf16 moments for
bf16 parameters and orders the weight decay and ε differently.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch import _tree

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr (fp32, on ``step``'s
    device)."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(params) -> Dict[str, Any]:
    """fp32 zero moments shaped like ``params``, and an int32 step 0, on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    dev = _tree.leaves(params)[0].device
    return {"m": _tree.map(zeros, params), "v": _tree.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> Tensor:
    """√(Σ over leaves of Σ x²), each leaf's sum in fp32."""
    sums = [torch.sum(torch.square(x.float())) for x in _tree.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One clipped AdamW step.  Returns (params, opt_state, metrics): the
    parameter leaves and the moments are updated in place (each parameter
    rounded back to its dtype), the step is a new tensor; metrics
    ``grad_norm`` (before clipping) and ``lr`` are device tensors."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)

    ps = _tree.leaves(params)
    ms, vs = _tree.leaves(opt_state["m"]), _tree.leaves(opt_state["v"])
    g = torch._foreach_mul([x.float() for x in _tree.leaves(grads)], scale)
    torch._foreach_mul_(ms, b1)  # m = b1·m + (1 − b1)·g
    torch._foreach_add_(ms, torch._foreach_mul(g, 1 - b1))
    gg = torch._foreach_mul(g, 1 - b2)  # v = b2·v + (1 − b2)·g·g
    torch._foreach_mul_(gg, g)
    del g
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, gg)
    del gg
    upd = torch._foreach_div(ms, [bc1] * len(ms))  # m̂ / (√v̂ + ε) + wd·p
    den = torch._foreach_div(vs, [bc2] * len(vs))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    torch._foreach_div_(upd, den)
    del den
    pf = [p.float() for p in ps]
    torch._foreach_add_(upd, torch._foreach_mul(pf, cfg.weight_decay))
    torch._foreach_mul_(upd, lr)
    new = torch._foreach_sub(pf, upd)
    del upd, pf
    for p, x in zip(ps, new):
        p.copy_(x)  # back to the parameter's dtype (round to nearest even)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
