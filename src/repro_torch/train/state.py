"""Train state and ``make_train_step``: loss → gradients → clip → AdamW
(mirrors :mod:`repro.train.state`).

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``.
Gradients come from ``torch.autograd`` on detached aliases of the parameter
leaves; the update then runs in place on the parameters and the moments
(the analogue of the reference's donated state), so the state passed in is
the state returned, advanced.  Optional microbatch accumulation
(``accum_steps``) splits the batch's leading dim evenly, sums the losses and
the gradients (into fp32 zeros) and divides both by ``accum_steps``, as
the reference's scan does.  The metrics (``loss``, ``grad_norm``, ``lr``)
stay device tensors: a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch import _tree
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Dict[str, Any]
    step: Tensor


def init_state(params) -> TrainState:
    dev = _tree.leaves(params)[0].device
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _grads_of(loss_fn, params, batch):
    """(loss, gradient leaves in flatten order, each in its parameter's
    dtype; a leaf the loss does not use gets zeros, as ``jax.grad`` gives)."""
    ps = _tree.leaves(params)
    xs = [p.detach().requires_grad_() for p in ps]
    with torch.enable_grad():
        loss = loss_fn(_tree.unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]


def make_train_step(
    loss_fn: Callable[[Any, Dict[str, Tensor]], Tensor],
    opt_cfg: AdamWConfig,
    *,
    accum_steps: int = 1,
    accum_unroll: bool = False,
):
    """loss_fn(params, batch) -> scalar.  Returns step(state, batch).

    ``accum_unroll`` is the reference's scan-unrolling knob for its dry-run
    cost pass; the microbatch loop here is a Python loop, unrolled either
    way, so it changes nothing."""
    del accum_unroll

    def step(state: TrainState, batch: Dict[str, Tensor]):
        if accum_steps == 1:
            loss, grads = _grads_of(loss_fn, state.params, batch)
        else:
            n = _tree.leaves(batch)[0].shape[0]
            if n % accum_steps:
                raise ValueError(f"a batch of {n} rows does not split into {accum_steps} "
                                 "equal microbatches")
            mb = n // accum_steps
            # fp32 zeros laid out like each parameter (a DTensor's placements)
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in _tree.leaves(state.params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for i in range(accum_steps):
                micro = _tree.map(lambda x: x[i * mb:(i + 1) * mb], batch)
                l, g = _grads_of(loss_fn, state.params, micro)
                loss = loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
            loss = loss / accum_steps
            torch._foreach_div_(grads, accum_steps)
        params, opt, om = adamw_update(state.params, _tree.unflatten(state.params, grads),
                                       state.opt, opt_cfg)
        metrics = {"loss": loss, **om}
        return TrainState(params=params, opt=opt, step=state.step + 1), metrics

    return step
