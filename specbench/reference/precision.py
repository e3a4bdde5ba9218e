"""The precisions the reference computes in.

``"fp64"`` and ``"fp32"`` are the dtypes.  ``"tf32"`` is float32 storage
whose products take TF32 operands: each operand's mantissa rounded to 10
bits (to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) before an
fp32-accumulated product.  It is emulated with integer ops, so it reads the
same on the CPU as on the card, and it covers the sparse products too, which
the card's TF32 switch does not reach.  TF32 is off for every true fp32
product (the reference sets the switches itself).
"""
from __future__ import annotations

import torch

PRECISIONS = ("fp64", "fp32", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "fp64" else torch.float32


def no_tf32() -> None:
    """Every fp32 matrix product in full fp32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` with its mantissa rounded to TF32's 10 bits (non-finite
    values kept)."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000  # half of the 13 dropped bits
    out = ((mag & ~0x1FFF) | (bits & ~0x7FFFFFFF)).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as an operand of a product in ``precision``."""
    x = x.to(dtype_of(precision))
    return round_tf32(x) if precision == "tf32" else x


def sparse_operand(a: torch.Tensor, precision: str) -> torch.Tensor:
    """A sparse CSR matrix as an operand of products in ``precision``."""
    return torch.sparse_csr_tensor(a.crow_indices(), a.col_indices(),
                                   operand(a.values(), precision), a.shape,
                                   check_invariants=False)


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in ``precision``; a sparse ``a`` must already be an operand
    (:func:`sparse_operand`)."""
    if a.layout == torch.sparse_csr:
        return a @ operand(b, precision)
    return operand(a, precision) @ operand(b, precision)
