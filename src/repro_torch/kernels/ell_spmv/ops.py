"""Public wrapper: BlockELL(+tail) SpMV (mirrors :mod:`repro.kernels.ell_spmv.ops`).

``ell_spmv(m: BlockELL, x)`` with ``x: [n]`` — the matvec behind
:meth:`repro_torch.core.operator.BlockEllOperator.mv`.  A CUDA input
launches the kernel in ``csrc/ell_spmv.cu`` for the ELL body (or raises); a
CPU input runs the plain version in :mod:`.ref`.  The COO overflow tail goes
through the plain index-add product either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ell_spmv.kernel import ell_spmv_cuda
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref
from repro_torch.sparse.formats import BlockELL
from repro_torch.sparse.ops import spmv_coo


def ell_spmv(m: BlockELL, x: torch.Tensor) -> torch.Tensor:
    if x.ndim != 1:
        raise ValueError(f"ell_spmv wants an [n] vector, got {tuple(x.shape)}")
    nb, br, w = m.cols.shape
    cols2d = m.cols.reshape(nb * br, w)
    vals2d = m.vals.reshape(nb * br, w)
    if x.device.type == "cuda":
        body = ell_spmv_cuda(x.float().contiguous(), cols2d.contiguous(),
                             vals2d.float().contiguous())
        ell_spmv.launches += 1
    elif x.device.type == "cpu":
        body = ell_spmv_ref(x, cols2d, vals2d)
    else:
        raise ValueError(f"ell_spmv: unsupported device {x.device}")
    y = body[: m.shape[0]] + spmv_coo(m.tail, x).float()
    return y.to(x.dtype)


ell_spmv.launches = 0  # kernel launches (CUDA path only)
