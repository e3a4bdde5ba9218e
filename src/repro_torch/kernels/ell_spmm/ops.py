"""Public wrappers: BlockELL(+tail) multi-vector SpMM and the fused
Chebyshev step (mirrors :mod:`repro.kernels.ell_spmm.ops`).

``ell_spmm(m: BlockELL, x)`` with ``x: [n, b]`` — the matmat of the block
eigensolver; ``ell_spmm_cheb_step(m, x, prev, ca, cb)`` — one three-term
step ``ca·(A x) + cb·x − prev`` of the Chebyshev filter.  A CUDA input
launches the kernel in ``csrc/ell_spmm.cu`` for the ELL body (or raises); a
CPU input runs the plain version in :mod:`.ref`.  The COO overflow tail is
index-added into the body's rows either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._util import pad_to, round_up
from repro_torch.kernels.ell_spmm.kernel import ell_spmm_cheb_cuda, ell_spmm_cuda
from repro_torch.kernels.ell_spmm.ref import ell_spmm_cheb_ref, ell_spmm_ref
from repro_torch.sparse.formats import BlockELL


def _float4_ready(a: torch.Tensor) -> torch.Tensor:
    """``a`` as a contiguous fp32 [n, b'] block the float4 kernels take:
    zero columns up to a multiple of 4 (they add exactly 0 to every output
    column kept), 16-byte aligned."""
    ac = pad_to(a.float(), round_up(a.shape[1], 4), 1).contiguous()
    return ac.clone() if ac.data_ptr() % 16 else ac  # a view at an odd offset


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
        body = ell_spmm_cuda(_float4_ready(x), cols2d.contiguous(),
                             vals2d.float().contiguous())[:, :b]
        ell_spmm.launches += 1
    elif x.device.type == "cpu":
        body = ell_spmm_ref(x, cols2d, vals2d)
    else:
        raise ValueError(f"ell_spmm: unsupported device {x.device}")
    # the tail touches few rows: add val·x[col] into them in place rather
    # than adding a dense [n, b] tail product to the body
    y = body[: m.shape[0]]
    t = m.tail
    y.index_add_(0, t.row, x[t.col].float() * t.val.float()[:, None])
    return y.to(x.dtype)


ell_spmm.launches = 0  # kernel launches (CUDA path only)


def ell_spmm_cheb_step(m: BlockELL, x: torch.Tensor, prev: torch.Tensor, ca, cb) -> torch.Tensor:
    """One fused Chebyshev three-term step ``ca·(A x) + cb·x − prev``.

    ``(ca, cb)`` may be 0-d tensors on the device of ``x``: the kernel reads
    them there, so a filter loop never reads them back to the host.  The
    kernel computes only the first n rows of the ELL body, so unlike the
    reference the iterates are not padded to the layout's row count on
    every step (the function is the same: padded rows are sliced off).
    The COO tail contributes ``ca·(A_tail x)`` outside the kernel.
    """
    if x.ndim != 2 or prev.shape != x.shape:
        raise ValueError(f"ell_spmm_cheb_step wants [n, b] iterates of one shape, got "
                         f"{tuple(x.shape)} and {tuple(prev.shape)}")
    nb, br, w = m.cols.shape
    cols2d = m.cols.reshape(nb * br, w)
    vals2d = m.vals.reshape(nb * br, w)
    f32 = torch.float32
    ca = torch.as_tensor(ca, dtype=f32, device=x.device)
    cb = torch.as_tensor(cb, dtype=f32, device=x.device)
    if x.device.type == "cuda":
        b = x.shape[1]
        body = ell_spmm_cheb_cuda(_float4_ready(x), cols2d.contiguous(),
                                  vals2d.float().contiguous(), _float4_ready(prev),
                                  torch.stack([ca, cb]))[:, :b]
        ell_spmm_cheb_step.launches += 1
    elif x.device.type == "cpu":
        body = ell_spmm_cheb_ref(x, cols2d, vals2d, prev, ca, cb)
    else:
        raise ValueError(f"ell_spmm_cheb_step: unsupported device {x.device}")
    # the tail touches few rows: add ca·val·x[col] into them in place
    # rather than materializing a dense [n, b] tail product
    t = m.tail
    body.index_add_(0, t.row, x[t.col].float() * (ca * t.val.float())[:, None])
    return body.to(x.dtype)


ell_spmm_cheb_step.launches = 0  # kernel launches (CUDA path only)
