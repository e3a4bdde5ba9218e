"""int8 error-feedback gradient compression (mirrors
:mod:`repro.optim.compress`).

Symmetric per-tensor quantization to int8 with an fp32 scale, and error
feedback (Seide et al. 2014; Karimireddy et al. 2019): the residual stays
local and is added to the next step's gradient.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the codes equal the reference's
bit for bit.

``compressed_psum_mean`` is the building block of a compressed cross-pod
data-parallel all-reduce: quantize locally → integer sum over a process
group → dequantize (the scales are max-reduced first, so every rank
dequantizes identically).
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def compress_int8(x: Tensor) -> Tuple[Tensor, Tensor]:
    """x → (int8 codes, fp32 scale). Symmetric per-tensor quantization."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: Tensor, scale: Tensor, dtype=torch.float32) -> Tensor:
    return (q.float() * scale).to(dtype)


def ef_compress(grad: Tensor, residual: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Error-feedback compression: returns (codes, scale, new_residual)."""
    corrected = grad.float() + residual
    q, s = compress_int8(corrected)
    new_residual = corrected - decompress_int8(q, s)
    return q, s, new_residual


def compressed_psum_mean(grad: Tensor, residual: Tensor, group=None):
    """int8-compressed mean-all-reduce over ``group`` (the default group
    when None): every rank of the group calls it.

    Integer codes are summed exactly (no overflow: int8 × ranks ≤ int32);
    the per-rank scales are shared via max so all ranks dequantize
    identically.  Returns (mean_grad fp32, new_residual).
    """
    import torch.distributed as dist

    from repro_torch.sparse.distributed import COLLECTIVES

    corrected = grad.float() + residual
    scale = torch.clamp(torch.max(torch.abs(corrected)), min=1e-30) / 127.0
    COLLECTIVES.add("psum", scale.element_size())  # an all-reduce (max)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)  # common scale
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int32)
    # the product exact and one rounding: the reference's multiply-subtract
    # is fused (an FMA) where the compiler can fuse it
    new_residual = (corrected.double() - q.double() * scale.double()).float()
    COLLECTIVES.add("psum", q.numel() * q.element_size())
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    mean = q.float() * scale / float(n)
    return mean, new_residual
