"""Mixture-of-Experts FFN with capacity-based top-k token-choice routing
(mirrors :mod:`repro.models.moe`).

The GShard/Switch dispatch family, expressed scatter-style: tokens are
scattered into an ``[E, C, d]`` expert buffer by (expert_id,
position-in-expert), the position computed with a masked cumulative sum in
integers.  Dropped tokens (capacity overflow) contribute zero and keep their
residual path.  The router runs in fp32; aux losses follow Switch
(load-balance) + z-loss.

This module has the single-device formulation only (the reference's
``moe_ffn_gspmd``); the expert-parallel ``shard_map`` path and the logical
specs belong to the sharding slice (ROADMAP A14e).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import _random
from repro_torch.models.common import normal_init

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    load_balance_coef: float = 0.01
    router_z_coef: float = 1e-3


def _mask_padded_experts(logits: Tensor, n_logical: int) -> Tensor:
    if logits.shape[-1] == n_logical:
        return logits
    valid = torch.arange(logits.shape[-1], device=logits.device) < n_logical
    return logits.masked_fill(~valid, -1e30)


def n_experts_padded(cfg: MoEConfig) -> int:
    """Expert count padded to a multiple of 16 (the reference's max TP
    degree); the router only ever routes to the logical n_experts — padded
    experts see zero traffic."""
    return ((cfg.n_experts + 15) // 16) * 16


def init_moe_params(stream: _random.Stream, d_model: int, cfg: MoEConfig, n_layers: int,
                    dtype, *, device) -> Dict[str, Tensor]:
    E, ffe = n_experts_padded(cfg), cfg.d_ff_expert
    shape_in = (n_layers, E, d_model, ffe)
    shape_out = (n_layers, E, ffe, d_model)
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(ffe)
    return {
        "router": normal_init(stream, (n_layers, d_model, E), torch.float32, 0.02, device),
        "w_gate": normal_init(stream, shape_in, dtype, s_in, device),
        "w_up": normal_init(stream, shape_in, dtype, s_in, device),
        "w_down": normal_init(stream, shape_out, dtype, s_out, device),
    }


def route(p: Dict[str, Tensor], x: Tensor, cfg: MoEConfig):
    """The router on tokens ``x`` [T, d]: (logits [T, E_pad] fp32 with padded
    experts at −1e30, probs, gate [T, K] renormalized, ids [T, K]).

    Top-k by a stable descending sort, so equal probabilities keep the lower
    expert first, as ``lax.top_k`` does (``torch.topk`` promises no order
    for ties)."""
    logits = x.float() @ p["router"].float()  # [T, E_pad]
    logits = _mask_padded_experts(logits, cfg.n_experts)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :cfg.top_k], ids[:, :cfg.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, ids


def moe_ffn(p: Dict[str, Tensor], x: Tensor, cfg: MoEConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: [T, d] tokens (caller flattens batch×seq).  Returns (y, aux).

    Always the single-device scatter formulation (the reference's
    ``moe_ffn_gspmd``; its expert-parallel path waits for ROADMAP A14e).
    """
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    E_pad = p["w_gate"].shape[0]
    # capacity per expert, padded to a multiple of 32 as the reference pads
    # it for its data-parallel shards (the same C keeps the same drops)
    C = max(int(T * K * cfg.capacity_factor / E), 1)
    C = ((C + 31) // 32) * 32

    logits, probs, gate, ids = route(p, x, cfg)
    sid = ids.reshape(-1)  # [T*K] expert per slot
    sgate = gate.reshape(-1)
    onehot = (sid[:, None] == torch.arange(E_pad, device=x.device)).long()  # [T*K, E_pad]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)  # rank within expert
    keep = (pos < C).to(x.dtype)
    pos_c = torch.clamp(pos, max=C - 1)

    x_exp = torch.repeat_interleave(x, K, dim=0) * keep[:, None]  # [T*K, d]
    # kept (expert, slot) pairs are unique and every dropped slot adds exact
    # zeros at C − 1, so the accumulation's order cannot change a sum: the
    # buffer is the same on every run and device
    buf = torch.zeros((E_pad, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((sid, pos_c), x_exp, accumulate=True)

    # expert SwiGLU, batched over E
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", buf, p["w_up"])
    y_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"])

    y_slots = y_buf[sid, pos_c] * (keep * sgate.to(x.dtype))[:, None]
    y = y_slots.reshape(T, K, d).sum(dim=1)

    # aux losses (Switch load-balance + router z-loss)
    first = (ids[:, 0][:, None] == torch.arange(E_pad, device=x.device)).float()
    frac_tokens = first.mean(dim=0)
    mean_probs = probs.mean(dim=0)
    aux = {
        "load_balance": E * torch.sum(frac_tokens * mean_probs) * cfg.load_balance_coef,
        "router_z": cfg.router_z_coef * torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return y, aux
