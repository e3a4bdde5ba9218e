"""Plain PyTorch versions of the BlockELL multi-vector SpMM kernel and of the
fused Chebyshev step.  The SpMM is the ELL body's gather of
:func:`repro_torch.sparse.ops.spmm_blockell`,
``Y[r, :] = Σ_w vals[r, w] · x[cols[r, w], :]`` (padding slots carry val = 0)."""
from __future__ import annotations

import torch

from repro_torch.sparse.ops import ell_body_spmm as ell_spmm_ref


def ell_spmm_cheb_ref(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                      prev: torch.Tensor, ca, cb) -> torch.Tensor:
    """Fused-step oracle over the first ``n_out = prev.shape[0]`` rows of
    the ELL body: ``ca·(A_ell x) + cb·x[:n_out] − prev``."""
    n = prev.shape[0]
    ax = ell_spmm_ref(x, cols[:n], vals[:n])
    return ca * ax + cb * x[:n].float() - prev.float()
