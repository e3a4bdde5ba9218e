"""int8 error-feedback gradient compression (mirrors
:mod:`repro.optim.compress`).

Symmetric per-tensor quantization to int8 with an fp32 scale, and error
feedback (Seide et al. 2014; Karimireddy et al. 2019): the residual stays
local and is added to the next step's gradient.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the codes equal the reference's
bit for bit.  The compressed all-reduce (``compressed_psum_mean``, the
launcher's ``--grad-compress``) comes with the sharding slice (ROADMAP
A14e).
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
