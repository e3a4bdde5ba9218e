"""Public wrapper: BlockELL(+tail) multi-vector SpMM (mirrors
:mod:`repro.kernels.ell_spmm.ops`).

``ell_spmm(m: BlockELL, x)`` with ``x: [n, b]`` — the matmat of the block
eigensolver.  A CUDA input launches the kernel in ``csrc/ell_spmm.cu`` for
the ELL body (or raises); a CPU input runs the plain version in :mod:`.ref`.
The COO overflow tail goes through the plain index-add product either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._util import pad_to, round_up
from repro_torch.kernels.ell_spmm.kernel import ell_spmm_cuda
from repro_torch.kernels.ell_spmm.ref import ell_spmm_ref
from repro_torch.sparse.formats import BlockELL
from repro_torch.sparse.ops import spmm_coo


def ell_spmm(m: BlockELL, x: torch.Tensor) -> torch.Tensor:
    if x.ndim != 2:
        raise ValueError(f"ell_spmm wants [n, b] multi-vectors, got {tuple(x.shape)}")
    nb, br, w = m.cols.shape
    cols2d = m.cols.reshape(nb * br, w)
    vals2d = m.vals.reshape(nb * br, w)
    if x.device.type == "cuda":
        # the kernel gathers float4 rows of x: make the [n, b] block contiguous
        # (a Krylov block sliced from the basis arrives transposed) and pad it
        # with zero columns to a multiple of 4
        b = x.shape[1]
        xc = pad_to(x.float(), round_up(b, 4), 1).contiguous()
        if xc.data_ptr() % 16:  # a view at an odd offset: float4 gathers need 16 B
            xc = xc.clone()
        body = ell_spmm_cuda(xc, cols2d.contiguous(), vals2d.float().contiguous())[:, :b]
        ell_spmm.launches += 1
    elif x.device.type == "cpu":
        body = ell_spmm_ref(x, cols2d, vals2d)
    else:
        raise ValueError(f"ell_spmm: unsupported device {x.device}")
    y = body[: m.shape[0]] + spmm_coo(m.tail, x).float()
    return y.to(x.dtype)


ell_spmm.launches = 0  # kernel launches (CUDA path only)
