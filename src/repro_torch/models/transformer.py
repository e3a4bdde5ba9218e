"""Decoder-only LM transformer: RoPE, GQA, optional qk-norm / QKV bias / MoE
(mirrors :mod:`repro.models.transformer`).

Covers the five LM architectures (glm4-9b, qwen2-7b, qwen3-0.6b,
granite-moe-3b-a800m, olmoe-1b-7b) from one config.  Layers are stacked on a
leading ``L`` axis, as in the reference, and applied by a Python loop over
``l``: each stacked tensor is unbound once a pass (``torch.unbind``), so a
layer's parameters are views whose backward is one ``stack`` — not a
select per layer, each of which would materialize a zero tensor the size
of the whole stack in the backward pass.

Entry points:
  ``forward`` / ``train_loss`` — full-sequence logits / next-token CE + the
                                 MoE aux loss; with gradients on, each layer
                                 is rematerialized as ``cfg.remat`` and
                                 ``cfg.remat_policy`` say,
  ``prefill``                  — run a prompt, return last-position logits
                                 + KV cache,
  ``decode_step``              — one token against a KV cache, updated in
                                 place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from repro_torch import _random, _tree
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import common as cm
from repro_torch.launch.sharding import constrain, logical_spec as L
from repro_torch.models.moe import MoEConfig, init_moe_params, moe_ffn, moe_logical_specs

Tensor = torch.Tensor
Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config field for field; ``dtype`` is a torch dtype.

    ``remat`` rematerializes each layer in the backward pass (when gradients
    are on): ``remat_policy="nothing"`` saves nothing inside a layer,
    ``"dots"`` saves the outputs of the products with no batch dims
    (``aten.mm``/``addmm``: the projections and the MLP) and recomputes the
    rest, the attention's batched products included — the reference's
    ``nothing_saveable`` and ``dots_with_no_batch_dims_saveable``.
    ``scan_unroll`` is the reference's compile knob, kept so the configs
    compare field for field; the layer loop here is a Python loop."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    dtype: Any = torch.bfloat16
    attn_chunk: int = 1024
    remat: bool = True
    remat_policy: str = "nothing"
    scan_unroll: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def vocab_padded(self) -> int:
        """Embedding/logits rows padded to a multiple of 32 (the logical
        vocab stays exact; padded logits are masked to -1e30)."""
        return ((self.vocab + 31) // 32) * 32

    def param_count(self) -> int:
        c = self.vocab * self.d_model * 2  # embed + head
        per = self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model
        if self.moe:
            per += self.d_model * self.moe.n_experts + 3 * self.moe.n_experts * self.d_model * self.moe.d_ff_expert
        else:
            per += 3 * self.d_model * self.d_ff
        return c + self.n_layers * per

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        per_active = (
            self.d_model * (self.q_dim + 2 * self.kv_dim)
            + self.q_dim * self.d_model
            + self.d_model * self.moe.n_experts
            + 3 * self.moe.top_k * self.d_model * self.moe.d_ff_expert
        )
        return self.vocab * self.d_model * 2 + self.n_layers * per_active


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, gen: torch.Generator, *,
                device: DeviceLike = None) -> Params:
    """The reference's parameter tree (layers stacked on a leading ``L``
    axis, the same keys), drawn on ``device`` — the card unless the caller
    asks for the CPU — from the counter-based stream keyed by one draw of
    ``gen``: the same bits on every device, and no parameter is drawn on
    the host."""
    dev = resolve_device(device)
    stream = _random.Stream.from_generator(gen)
    Ln, d, dt = cfg.n_layers, cfg.d_model, cfg.dtype

    def nrm(*shape, scale):
        return cm.normal_init(stream, shape, dt, scale, dev)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dt, device=dev)

    attn = {
        "wq": nrm(Ln, d, cfg.q_dim, scale=d ** -0.5),
        "wk": nrm(Ln, d, cfg.kv_dim, scale=d ** -0.5),
        "wv": nrm(Ln, d, cfg.kv_dim, scale=d ** -0.5),
        "wo": nrm(Ln, cfg.q_dim, d, scale=cfg.q_dim ** -0.5),
    }
    if cfg.qkv_bias:
        attn["bq"] = const(0.0, Ln, cfg.q_dim)
        attn["bk"] = const(0.0, Ln, cfg.kv_dim)
        attn["bv"] = const(0.0, Ln, cfg.kv_dim)
    if cfg.qk_norm:
        attn["q_norm"] = const(1.0, Ln, cfg.d_head)
        attn["k_norm"] = const(1.0, Ln, cfg.d_head)

    if cfg.moe is not None:
        mlp = init_moe_params(stream, d, cfg.moe, Ln, dt, device=dev)
    else:
        mlp = {
            "w_gate": nrm(Ln, d, cfg.d_ff, scale=d ** -0.5),
            "w_up": nrm(Ln, d, cfg.d_ff, scale=d ** -0.5),
            "w_down": nrm(Ln, cfg.d_ff, d, scale=cfg.d_ff ** -0.5),
        }

    return {
        "embed": cm.embed_init(stream, cfg.vocab_padded, d, dt, device=dev),
        "layers": {
            "attn": attn,
            "mlp": mlp,
            "ln1": const(1.0, Ln, d),
            "ln2": const(1.0, Ln, d),
        },
        "final_norm": const(1.0, d),
        "lm_head": cm.dense_init(stream, d, cfg.vocab_padded, dt, device=dev),
    }


def _mask_padded_logits(logits: Tensor, cfg: TransformerConfig) -> Tensor:
    if cfg.vocab_padded == cfg.vocab:
        return logits
    valid = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
    return logits.masked_fill(~valid, -1e30)


def logical_specs(cfg: TransformerConfig) -> Params:
    """Logical-axis tags matching ``init_params`` output leaf for leaf, the
    stacked layer axis first (Megatron TP layout; KV replicated under GQA)."""
    attn = {
        "wq": L((None, None, "heads")),
        "wk": L((None, None, "kv_heads")),
        "wv": L((None, None, "kv_heads")),
        "wo": L((None, "heads", None)),
    }
    if cfg.qkv_bias:
        attn |= {"bq": L((None, "heads")), "bk": L((None, "kv_heads")), "bv": L((None, "kv_heads"))}
    if cfg.qk_norm:
        attn |= {"q_norm": L((None, None)), "k_norm": L((None, None))}
    if cfg.moe is not None:
        mlp = moe_logical_specs()
    else:
        mlp = {
            "w_gate": L((None, None, "mlp")),
            "w_up": L((None, None, "mlp")),
            "w_down": L((None, "mlp", None)),
        }
    return {
        "embed": L(("vocab", None)),
        "layers": {"attn": attn, "mlp": mlp, "ln1": L((None, None)), "ln2": L((None, None))},
        "final_norm": L((None,)),
        "lm_head": L((None, "vocab")),
    }


def cache_logical_specs():
    return {"k": L((None, "batch", "kv_seq", "kv_heads", None)),
            "v": L((None, "batch", "kv_seq", "kv_heads", None))}


def _per_layer(tree, n_layers: int):
    """Each layer's parameters, from one ``torch.unbind`` of every stacked
    ``[L, ...]`` tensor: views, and in the backward pass one ``stack`` a
    tensor."""
    if isinstance(tree, dict):
        per = {k: _per_layer(v, n_layers) for k, v in tree.items()}
        return [{k: v[l] for k, v in per.items()} for l in range(n_layers)]
    return torch.unbind(tree, 0)


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of the products with no
    batch dims, recompute everything else."""
    if op in _SAVED_BY_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: TransformerConfig, tensors):
    """``fn`` (a layer) rematerialized as the config asks when a gradient
    will be taken (grad mode on and one of ``tensors`` requires grad); else
    ``fn`` itself."""
    if not (cfg.remat and torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return fn
    kw = {}  # any policy but "dots" saves nothing, as in the reference
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _dots_policy)
    return functools.partial(ckpt.checkpoint, _on_mesh(fn), use_reentrant=False, **kw)


def _on_mesh(fn):
    """``fn`` run under the mesh's rules and DTensor's implicit replication
    when they are installed: the recompute of a checkpointed layer runs in
    the backward pass, on the autograd engine's thread."""
    from repro_torch.launch.sharding import axis_rules, current_mesh, current_rules

    rules, mesh = current_rules(), current_mesh()
    if rules is None:
        return fn
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def run(*args, **kwargs):
        with contextlib.ExitStack() as stack:
            stack.enter_context(axis_rules(rules, mesh))
            # entered only where it is off: leaving it switches it off,
            # whatever it was before
            if not DTensor._op_dispatcher._allow_implicit_replication:
                stack.enter_context(implicit_replication())
            return fn(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# layer
# ---------------------------------------------------------------------------

def _project_qkv(lp, x, cfg: TransformerConfig, positions):
    B, S, _ = x.shape
    a = lp["attn"]
    q = x @ a["wq"]
    k = x @ a["wk"]
    v = x @ a["wv"]
    if cfg.qkv_bias:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q = cm.split_last(q, cfg.n_heads, cfg.d_head)
    k = cm.split_last(k, cfg.n_kv_heads, cfg.d_head)
    v = cm.split_last(v, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = cm.rmsnorm(q, a["q_norm"])
        k = cm.rmsnorm(k, a["k_norm"])
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    v = constrain(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def _mlp(lp, x, cfg: TransformerConfig):
    B, S, d = x.shape
    if cfg.moe is not None:
        y, aux = moe_ffn(lp["mlp"], x.reshape(B * S, d), cfg.moe)
        return y.reshape(B, S, d), aux["load_balance"] + aux["router_z"]
    m = lp["mlp"]
    h = F.silu(x @ m["w_gate"]) * (x @ m["w_up"])
    h = constrain(h, "batch", "seq", "mlp")
    return h @ m["w_down"], torch.zeros((), dtype=torch.float32, device=x.device)


def layer_forward(lp, x, cfg: TransformerConfig, positions, q_offset=0):
    """Full-sequence layer (train / prefill). Returns (x, aux, k, v)."""
    h = cm.rmsnorm(x, lp["ln1"])
    q, k, v = _project_qkv(lp, h, cfg, positions)
    o = cm.flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk, q_offset=q_offset)
    o = o.reshape(*x.shape[:2], cfg.q_dim) @ lp["attn"]["wo"]
    x = x + constrain(o, "batch", "seq", None)
    h = cm.rmsnorm(x, lp["ln2"])
    m, aux = _mlp(lp, h, cfg)
    x = constrain(x + m, "batch", "seq", None)
    return x, aux, k, v


def _write_rows(cache: Tensor, pos: Tensor, val: Tensor) -> None:
    """``cache[b, pos[b]] = val[b]`` for every batch row ``b``, in place.

    On a DTensor cache (batch and sequence sharded on a mesh) each rank
    writes its own block: the rows it holds, at the positions that fall in
    its slice of the sequence (elsewhere it writes back what is there)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = val
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, pl = cache.device_mesh, cache.placements

    def like(p, drop_seq):  # the placement of a tensor without the seq dim
        if not isinstance(p, Shard) or p.dim == 1 or (drop_seq and p.dim > 0):
            return Replicate()
        return Shard(p.dim - 1 if p.dim > 1 else 0)

    if not isinstance(pos, DTensor):
        pos = DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pos_l = pos.redistribute(mesh, [like(p, True) for p in pl]).to_local().long()
    val_l = val.redistribute(mesh, [like(p, False) for p in pl]).to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    loc = cache.to_local()
    rel = pos_l - offset[1]
    mine = (rel >= 0) & (rel < shape[1])
    rows = torch.arange(shape[0], device=loc.device)
    at = torch.clamp(rel, 0, max(shape[1] - 1, 0))
    keep = mine.reshape(-1, *([1] * (val_l.ndim - 1)))
    loc[rows, at] = torch.where(keep, val_l.to(loc.dtype), loc[rows, at])


def layer_decode(lp, x, k_cache, v_cache, cache_len, cfg: TransformerConfig):
    """Single-token layer against a cache. x: [B, 1, d].  Writes the new KV
    row at each batch row's ``cache_len`` into ``k_cache``/``v_cache`` in
    place (``cache_len`` < the cache's length)."""
    B = x.shape[0]
    h = cm.rmsnorm(x, lp["ln1"])
    q, k, v = _project_qkv(lp, h, cfg, cache_len[:, None])
    _write_rows(k_cache, cache_len, k[:, 0])
    _write_rows(v_cache, cache_len, v[:, 0])
    o = cm.decode_attention(q, k_cache, v_cache, cache_len + 1)
    o = o.reshape(B, 1, cfg.q_dim) @ lp["attn"]["wo"]
    x = x + o
    h = cm.rmsnorm(x, lp["ln2"])
    m, _ = _mlp(lp, h, cfg)
    return x + m, k_cache, v_cache


# ---------------------------------------------------------------------------
# model entry points (a loop over the stacked layers)
# ---------------------------------------------------------------------------

def _layers(params, x, cfg: TransformerConfig, positions, collect_kv: bool):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    per_layer = _per_layer(params["layers"], cfg.n_layers)
    layer = _remat(layer_forward, cfg, [x, *_tree.leaves(params["layers"])])
    for lp in per_layer:
        x, a, k, v = layer(lp, x, cfg, positions)
        aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def _embed(params, tokens: Tensor, cfg: TransformerConfig) -> Tensor:
    """The tokens' embedding rows: a gather whose backward sums each row's
    gradient in a fixed order (``embedding``'s sorted segments, not the
    racing adds of an indexing backward), so a step is reproducible bit for
    bit on one device."""
    x = cm.embedding_rows(tokens, params["embed"]).to(cfg.dtype)
    # on a mesh the gather from the vocab-sharded table is a partial sum:
    # reduce it here, to the activations' layout
    return constrain(x, "batch", "seq", None)


def _positions(B: int, S: int, device) -> Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(params: Params, tokens: Tensor, cfg: TransformerConfig) -> Tuple[Tensor, Tensor]:
    """tokens [B, S] -> logits [B, S, vocab_padded], aux loss."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    x, aux, _ = _layers(params, x, cfg, _positions(B, S, x.device), collect_kv=False)
    x = cm.rmsnorm(x, params["final_norm"])
    logits = _mask_padded_logits(x @ params["lm_head"], cfg)
    return constrain(logits, "batch", "seq", "vocab"), aux


def train_loss(params: Params, batch: Dict[str, Tensor], cfg: TransformerConfig) -> Tensor:
    """Next-token cross-entropy + the MoE aux loss."""
    logits, aux = forward(params, batch["tokens"], cfg)
    return cm.cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:]) + aux


def prefill(params: Params, tokens: Tensor, cfg: TransformerConfig):
    """Prompt pass. Returns (last-position logits [B, 1, vocab_padded], kv
    cache ``{"k", "v"}`` stacked [L, B, S, Hkv, dh])."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    x, _, (k_cache, v_cache) = _layers(params, x, cfg, _positions(B, S, x.device),
                                       collect_kv=True)
    x = cm.rmsnorm(x[:, -1:], params["final_norm"])
    logits = _mask_padded_logits(x @ params["lm_head"], cfg)
    return logits, {"k": k_cache, "v": v_cache}


def decode_step(params: Params, cache: Dict[str, Tensor], cache_len: Tensor, token: Tensor,
                cfg: TransformerConfig):
    """One decode step. token [B], cache_len [B] (each < the cache's length).
    Returns (logits [B, 1, vocab_padded], cache): ``cache`` is updated in
    place — the new KV rows written at ``cache_len`` — and returned, the
    contract of the reference's launcher, which donates the cache."""
    x = _embed(params, token[:, None], cfg)
    for l, lp in enumerate(_per_layer(params["layers"], cfg.n_layers)):
        x, _, _ = layer_decode(lp, x, cache["k"][l], cache["v"][l], cache_len, cfg)
    x = cm.rmsnorm(x, params["final_norm"])
    return _mask_padded_logits(x @ params["lm_head"], cfg), cache


def make_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, *,
               device: DeviceLike = None) -> Dict[str, Tensor]:
    dt = dtype or cfg.dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}
