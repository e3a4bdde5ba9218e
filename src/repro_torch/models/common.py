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


def cross_entropy_loss(logits: Tensor, labels: Tensor, *, z_loss: float = 0.0) -> Tensor:
    """Mean token cross-entropy with optional z-loss, fp32 log-softmax."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss
