"""Plain PyTorch version of the LSH hashing kernel (mirrors
:mod:`repro.kernels.lsh_candidates.ref`).

Per table, project every point onto ``n_bits`` random hyperplanes through
the origin, pack the sign pattern into an integer bucket code, and emit one
extra *tie-break* projection.  The tie-break orders points inside a bucket
for the candidate windows of :func:`~repro_torch.kernels.lsh_candidates.ops
.lsh_candidates` (the reference measured recall 0.39 → 0.99 from it at
n = 4k, DESIGN.md §12).
"""
from __future__ import annotations

import torch


def hash_codes_ref(x: torch.Tensor, planes: torch.Tensor):
    """(codes [T, n] int32, tie [T, n] f32) from points [n, d] and hyperplane
    normals ``planes`` [T, d, n_bits + 1]: bit j of a code is 1 iff
    x·planes[t, :, j] ≥ 0 (packed little-endian); column ``n_bits`` is the
    tie-break projection."""
    proj = torch.einsum("nd,tdb->tnb", x.float(), planes.float())  # [T, n, n_bits+1]
    bits = (proj[..., :-1] >= 0).to(torch.int32)
    pows = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32),
        torch.arange(bits.shape[-1], dtype=torch.int32)).to(x.device)
    return (bits * pows).sum(-1, dtype=torch.int32), proj[..., -1].contiguous()
