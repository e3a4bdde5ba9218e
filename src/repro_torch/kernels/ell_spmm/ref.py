"""Plain PyTorch version of the BlockELL multi-vector SpMM kernel."""
from __future__ import annotations

import torch

_TILE_ELEMS = 1 << 26  # bound on the live [rows, w, b] gather tile


def ell_spmm_ref(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Y[r, :] = Σ_w vals[r, w] · x[cols[r, w], :]  (padding slots carry val = 0).
    Chunked over rows so it runs at main-path shapes on the card."""
    n_rows, w = cols.shape
    b = x.shape[1]
    xf = x.float()
    step = max(1, _TILE_ELEMS // max(1, w * b))
    out = [(vals[s:s + step].float()[..., None] * xf[cols[s:s + step].long()]).sum(dim=1)
           for s in range(0, n_rows, step)]
    return torch.cat(out) if out else torch.zeros((0, b), device=x.device)
