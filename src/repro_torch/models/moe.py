"""Mixture-of-Experts FFN with capacity-based top-k token-choice routing
(mirrors :mod:`repro.models.moe`).

The GShard/Switch dispatch family, expressed scatter-style: tokens are
scattered into an ``[E, C, d]`` expert buffer by (expert_id,
position-in-expert), the position computed with a masked cumulative sum in
integers.  Dropped tokens (capacity overflow) contribute zero and keep their
residual path.  The router runs in fp32; aux losses follow Switch
(load-balance) + z-loss.

``moe_ffn`` dispatches as the reference's does: to the expert-parallel
``moe_ffn_shard_map`` when a mesh with a ``model`` axis is installed
(:func:`repro_torch.launch.sharding.axis_rules`), else to the single-device
/ GSPMD formulation ``moe_ffn_gspmd``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

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


def moe_logical_specs() -> Dict[str, Any]:
    from repro_torch.launch.sharding import logical_spec as L

    return {
        "router": L((None, None, None)),
        # experts over the model axis (EP); ffn dim stays local per expert
        "w_gate": L((None, "experts", None, None)),
        "w_up": L((None, "experts", None, None)),
        "w_down": L((None, "experts", None, None)),
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

    Dispatches to the expert-parallel implementation when a mesh with a
    ``model`` axis is installed (the launcher's path, on a (1, 1) mesh
    too), else the single-device / GSPMD scatter formulation.
    """
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.sharding import current_mesh

    mesh = current_mesh()
    if (mesh is not None and "model" in mesh.mesh_dim_names
            and n_experts_padded(cfg) % mesh_shape(mesh)["model"] == 0):
        return moe_ffn_shard_map(p, x, cfg, mesh)
    return moe_ffn_gspmd(p, x, cfg)


def moe_ffn_gspmd(p: Dict[str, Tensor], x: Tensor, cfg: MoEConfig
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: [T, d] tokens (caller flattens batch×seq).  Returns (y, aux)."""
    from repro_torch.launch.sharding import constrain

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
    x_exp = constrain(x_exp, "batch", None)
    # kept (expert, slot) pairs are unique and every dropped slot adds exact
    # zeros at C − 1, so the accumulation's order cannot change a sum: the
    # buffer is the same on every run and device
    buf = torch.zeros((E_pad, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((sid, pos_c), x_exp, accumulate=True)
    buf = constrain(buf, "experts", "batch", None)  # EP × capacity-DP

    # expert SwiGLU, batched over E
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", buf, p["w_up"])
    y_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"])
    y_buf = constrain(y_buf, "experts", "batch", None)

    y_slots = y_buf[sid, pos_c] * (keep * sgate.to(x.dtype))[:, None]
    y_slots = constrain(y_slots, "batch", None)
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


# ---------------------------------------------------------------------------
# production path: replicated-dispatch expert parallelism (the reference's
# shard_map)
# ---------------------------------------------------------------------------

def _group_all_reduce(t: Tensor, group) -> Tensor:
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.sparse.distributed import COLLECTIVES

    COLLECTIVES.add("psum", t.numel() * t.element_size())
    return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))


class _SumOverModel(torch.autograd.Function):
    """The sum of each model rank's expert outputs.  Backward: the identity
    — the output is replicated over ``model``, so every rank holds the whole
    cotangent, and it is each summand's."""

    @staticmethod
    def forward(ctx, y, group):
        return _group_all_reduce(y, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverData(torch.autograd.Function):
    """The mean of the data ranks' values (``pmean`` over the data axes).
    The result is replicated over every mesh dim, and every rank computes
    it from the same row values its model peers do, so each of the
    ``n_ranks`` copies takes ``1 / n_ranks`` of the cotangent: summed over
    the ranks (the gradients' partial sums), each data row's value gets
    ``1 / n_data``, its share of the mean."""

    @staticmethod
    def forward(ctx, v, groups, n_data, n_ranks):
        ctx.n_ranks = n_ranks
        for g in groups:
            v = _group_all_reduce(v, g)
        return v / n_data

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_ranks, None, None, None


def _local(t: Tensor, mesh, spec, grad_spec) -> Tensor:
    """This rank's block of ``t`` laid out by ``spec`` on ``mesh`` (a plain
    tensor is taken as replicated); its gradient is laid out by
    ``grad_spec``, a list of placements."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.sharding import placements

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, placements(spec, mesh, t.ndim)).to_local(
        grad_placements=grad_spec)


def moe_ffn_shard_map(p, x: Tensor, cfg: MoEConfig, mesh) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Expert parallelism exploiting the TP layout directly.

    Activations are replicated along ``model``, so every rank of a mesh row
    already has all of its row's tokens.  Each rank therefore routes its
    local tokens, gathers the slots destined for its own E/TP experts into
    a small local capacity buffer, runs its expert GEMMs, and one
    all-reduce over ``model`` recombines the outputs.  The aux losses are
    averaged over the data ranks.

    Capacity is per rank: C_loc = T_loc·K·cf/E (overflow drops per row, the
    standard local-capacity semantics); ``dropped_frac`` is reported as 0,
    as the reference reports it.  Returns y as a DTensor sharded over the
    data axes and replicated over ``model``, and the aux losses replicated.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.sharding import P

    E, K = cfg.n_experts, cfg.top_k
    E_pad = p["w_gate"].shape[0]
    names = list(mesh.mesh_dim_names)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    shape = mesh_shape(mesh)
    tp = shape["model"]
    e_loc = E_pad // tp
    m_idx = names.index("model")

    def grad_pl(sharded_dim=None, on=()):
        # gradient placements: Shard(sharded_dim) on the mesh dims in
        # ``on``, partial sums on every other mesh dim
        return [Shard(sharded_dim) if n in on else Partial() for n in names]

    router = _local(p["router"], mesh, P(), grad_pl())
    wg = _local(p["w_gate"], mesh, P("model"), grad_pl(0, ("model",)))
    wu = _local(p["w_up"], mesh, P("model"), grad_pl(0, ("model",)))
    wd = _local(p["w_down"], mesh, P("model"), grad_pl(0, ("model",)))
    x_loc = _local(x, mesh, P(data_axes or None), grad_pl(0, data_axes))

    T_loc, d = x_loc.shape
    dev = x_loc.device
    C = max(int(T_loc * K * cfg.capacity_factor / E), 1)
    logits, probs, gate, ids = route({"router": router}, x_loc, cfg)

    sid = ids.reshape(-1)
    sgate = gate.reshape(-1).to(x_loc.dtype)
    first = mesh.get_local_rank(m_idx) * e_loc
    lid = sid - first
    mine = (lid >= 0) & (lid < e_loc)
    lid_c = torch.clamp(lid, 0, e_loc - 1)
    onehot = (lid_c[:, None] == torch.arange(e_loc, device=dev)).long() * mine[:, None].long()
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = (mine & (pos < C)).to(x_loc.dtype)
    pos_c = torch.clamp(pos, max=C - 1)

    x_exp = torch.repeat_interleave(x_loc, K, dim=0) * keep[:, None]
    buf = torch.zeros((e_loc, C, d), dtype=x_loc.dtype, device=dev)
    buf.index_put_((lid_c, pos_c), x_exp, accumulate=True)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) * torch.einsum("ecd,edf->ecf", buf, wu)
    y_buf = torch.einsum("ecf,efd->ecd", h, wd)
    y_slots = y_buf[lid_c, pos_c] * (keep * sgate)[:, None]
    y = y_slots.reshape(T_loc, K, d).sum(dim=1)
    y = _SumOverModel.apply(y, mesh.get_group("model"))

    frac = (ids[:, 0][:, None] == torch.arange(E_pad, device=dev)).float().mean(dim=0)
    lb = E * torch.sum(frac * probs.mean(0)) * cfg.load_balance_coef
    rz = cfg.router_z_coef * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    n_data = math.prod(shape[a] for a in data_axes)
    aux_vec = _MeanOverData.apply(torch.stack([lb, rz]),
                                  [mesh.get_group(a) for a in data_axes], n_data,
                                  math.prod(shape.values()))

    y_pl = [Shard(0) if n in data_axes else Replicate() for n in names]
    y = DTensor.from_local(y, mesh, y_pl, run_check=False)
    rep = [Replicate()] * mesh.ndim
    aux = {"load_balance": DTensor.from_local(aux_vec[0], mesh, rep, run_check=False),
           "router_z": DTensor.from_local(aux_vec[1], mesh, rep, run_check=False),
           "dropped_frac": torch.zeros((), device=dev)}
    return y, aux
