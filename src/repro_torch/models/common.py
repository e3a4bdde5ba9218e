"""Shared model-layer substrate: norms, rotary embeddings, attention (mirrors
:mod:`repro.models.common`).

Pure functions over nested-dict param trees of torch tensors.  Initializers
draw from a :class:`repro_torch._random.Stream` on the device the tensor
lives on; ``apply`` functions never allocate parameters.  Attention ships
two execution paths, both plain PyTorch (no library attention kernel: these
are the functions held against the reference):

* :func:`flash_attention` — blockwise online-softmax attention (a loop over
  KV chunks, fp32 running max/denominator/accumulator); the S×S score
  matrix is never materialized.
* :func:`decode_attention` — single-query attention against a KV cache.

Both support GQA (n_kv_heads < n_heads) natively via head grouping.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import constrain

from repro_torch import _random

Tensor = torch.Tensor
Params = Dict[str, Any]

# values a normal draw makes at once: bounds the Philox pass's int64
# temporaries (~30 bytes a value) whatever the parameter's size
_DRAW_CHUNK = 1 << 23


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def normal_init(stream: _random.Stream, shape: Sequence[int], dtype, scale: float,
                device) -> Tensor:
    """``scale`` × standard normals of ``shape`` in ``dtype``, drawn on
    ``device`` as one draw of ``stream`` (rows = the leading axes, flattened)
    in chunks of rows; the chunks reproduce one large draw."""
    shape = tuple(int(s) for s in shape)
    cols = shape[-1]
    rows = math.prod(shape[:-1])
    draw = stream.take()
    if torch.device(device).type == "meta":  # shapes only (the dry-run's cells)
        return torch.empty(shape, dtype=dtype, device=device)
    out = torch.empty((rows, cols), dtype=dtype, device=device)
    step = max(1, _DRAW_CHUNK // max(cols, 1))
    for r0 in range(0, rows, step):
        r = min(step, rows - r0)
        z = _random.normal(stream.key, draw, (r, cols), device, row0=r0)
        out[r0:r0 + r] = (z * scale).to(dtype)
    return out.reshape(shape)


def dense_init(stream: _random.Stream, d_in: int, d_out: int, dtype=torch.float32,
               scale: Optional[float] = None, *, device) -> Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal_init(stream, (d_in, d_out), dtype, s, device)


def embed_init(stream: _random.Stream, vocab: int, d: int, dtype=torch.float32, *,
               device) -> Tensor:
    return normal_init(stream, (vocab, d), dtype, 0.02, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, g: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm in fp32, rounded to ``x.dtype`` before the multiply by ``g``
    (the reference's order; it matters in bf16)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def layernorm(x: Tensor, g: Tensor, b: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * g + b


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float = 10000.0, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x: [..., seq, n_heads, d_head]; positions: [..., seq] integers.  In
    fp32; rotates the two halves of ``d_head`` (not interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # [d_head/2]
    angles = positions[..., None].float() * freqs  # [..., seq, d/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_attention(
    q: Tensor,  # [B, Sq, H, dh]
    k: Tensor,  # [B, Sk, Hkv, dh]
    v: Tensor,  # [B, Sk, Hkv, dh]
    *,
    causal: bool = True,
    chunk: int = 1024,
    q_offset: int = 0,
) -> Tensor:
    """Blockwise online-softmax attention, a plain loop over KV chunks.

    GQA in grouped form ``[B, Hkv, G, Sq, dh]``: KV heads are never repeated
    to the query-head count.  fp32 running (max, denominator, accumulator);
    keys padded to a chunk multiple with the padding masked; fully masked
    rows give zeros.  ``q_offset`` shifts query positions for chunked
    prefill against an existing cache.
    """
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    # on a mesh: the grouped view below splits the heads dim into
    # [Hkv, G]; lay the heads out as the kv heads are first
    q = constrain(q, "batch", "seq", "kv_heads", None)
    dev = q.device
    scale = 1.0 / math.sqrt(dh)
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, dh).permute(0, 2, 3, 1, 4)

    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:  # pad keys to a chunk multiple; padded positions masked below
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = (Sk + pad) // chunk
    q_pos = torch.arange(Sq, device=dev) + q_offset

    m = torch.full((B, Hkv, G, Sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, dh), dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        kc = k[:, idx * chunk:(idx + 1) * chunk].float()  # [B, c, Hkv, dh]
        vc = v[:, idx * chunk:(idx + 1) * chunk].float()
        s = torch.einsum("bkgqd,bckd->bkgqc", qf, kc)
        k_pos = idx * chunk + torch.arange(chunk, device=dev)
        valid = (k_pos < Sk)[None, :]
        mask = (q_pos[:, None] >= k_pos[None, :]) & valid if causal else valid.expand(Sq, chunk)
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # [B, Hkv, G, Sq, dh]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)


def decode_attention(
    q: Tensor,  # [B, 1, H, dh]
    k_cache: Tensor,  # [B, S, Hkv, dh]
    v_cache: Tensor,  # [B, S, Hkv, dh]
    cache_len: Tensor,  # [B] valid prefix lengths
) -> Tensor:
    """Single-token attention against a (possibly partially filled) cache.

    Grouped GQA: the cache stays at its native head count and dtype (each
    layer's slice is widened to fp32 for the product — exact — as the
    reference's in-dot convert is); the [B, Hkv, G, S] scores are fp32 and
    positions ``≥ cache_len`` of each row are masked.
    """
    B, S, Hkv, dh = k_cache.shape
    H = q.shape[2]
    G = H // Hkv
    q = constrain(q, "batch", None, "kv_heads", None)  # see flash_attention
    qf = (q.float() * (1.0 / math.sqrt(dh))).reshape(B, Hkv, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    mask = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]  # [B, S]
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def split_last(t: Tensor, *sizes: int) -> Tensor:
    """``t`` with its last dim split into ``sizes`` (a reshape).  On a mesh
    whose shards of the last dim would not split evenly into the leading
    size (28 heads over 16 ranks; 7 irrep rows over 16) that dim is gathered
    first: a view cannot split an uneven shard."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(t, DTensor):
        last = t.ndim - 1
        on = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == last]
        if sizes[0] % math.prod(t.device_mesh.size(i) for i in on):
            t = t.redistribute(t.device_mesh, [Replicate() if i in on else p
                                               for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:-1], *sizes)


def embedding_rows(ids: Tensor, table: Tensor, fields: Optional[Tensor] = None) -> Tensor:
    """``table[ids]`` (``F.embedding``: its backward sums each row's
    gradient in a fixed order); with ``fields``, ``table`` is a stack of
    tables [F, R, d] and ``ids`` index each field's own table (``fields``
    broadcasts against ``ids``).

    On a DTensor table whose rows are sharded (a vocab-parallel embedding)
    each rank gathers the ids in its own rows, zeros elsewhere, and the
    result is a partial sum over those mesh dims; the table's local
    gradient is a partial sum over the mesh dims the ids are sharded on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    row_dim = 0 if fields is None else 1
    if not isinstance(table, DTensor) or not any(
            isinstance(p, Shard) and p.dim == row_dim for p in table.placements):
        if fields is None:
            return F.embedding(ids, table)
        return F.embedding(fields * table.shape[1] + ids, table.reshape(-1, table.shape[2]))
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    rows = [isinstance(p, Shard) and p.dim == row_dim for p in table.placements]
    ids = ids.redistribute(mesh, [Replicate() if r else p for r, p in zip(rows, ids.placements)])
    shape, offset = compute_local_shape_and_global_offset(table.shape, mesh, table.placements)
    rel = ids.to_local().long() - offset[row_dim]
    mine = (rel >= 0) & (rel < shape[row_dim])
    grad_pl = [p if r else (Partial() if isinstance(q, Shard) else Replicate())
               for r, p, q in zip(rows, table.placements, ids.placements)]
    local = table.to_local(grad_placements=grad_pl)
    at = torch.clamp(rel, 0, max(shape[row_dim] - 1, 0))
    if fields is not None:
        f = fields.to_local() if isinstance(fields, DTensor) else fields
        at = f * shape[1] + at
        local = local.reshape(-1, local.shape[-1])
    got = F.embedding(at, local)
    out = torch.where(mine[..., None], got, torch.zeros((), dtype=got.dtype, device=got.device))
    out_pl = [Partial() if r else q for r, q in zip(rows, ids.placements)]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def take_last(x: Tensor, idx: Tensor) -> Tensor:
    """``x[..., idx]`` elementwise over the leading dims.  On a DTensor
    whose last dim is sharded (vocab-parallel logits) each rank gathers
    from its own slice of the last dim, zero where the index lies outside
    it, and the result is a partial sum over those mesh dims — the
    vocab-parallel gather of Megatron's cross-entropy."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    last = x.ndim - 1
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and p.dim == last for p in x.placements):
        return torch.take_along_dim(x, idx[..., None].long(), dim=-1)[..., 0]
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = x.device_mesh
    lead = [Replicate() if isinstance(p, Shard) and p.dim == last else p for p in x.placements]
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim, run_check=False)
    idx = idx.redistribute(mesh, lead).to_local().long()
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, x.placements)
    lo, width = offset[last], shape[last]
    x_loc = x.to_local()
    rel = idx - lo
    mine = (rel >= 0) & (rel < width)
    got = torch.take_along_dim(x_loc, rel.clamp(0, max(width - 1, 0))[..., None], dim=-1)[..., 0]
    out = torch.where(mine, got, torch.zeros((), dtype=got.dtype, device=got.device))
    out_pl = [Partial() if isinstance(p, Shard) and p.dim == last else p for p in x.placements]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def cross_entropy_loss(logits: Tensor, labels: Tensor, *, z_loss: float = 0.0) -> Tensor:
    """Mean token cross-entropy with optional z-loss, fp32 log-softmax."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = take_last(lf, labels)
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss
