"""Public wrapper for the fused k-means iteration (mirrors
:mod:`repro.kernels.kmeans_iter.ops`).

One call = one Lloyd iteration's statistics ``(labels, dmin, sums,
counts)`` from one pass over ``x``, through the custom operator
``torch.ops.repro_torch.kmeans_iter``:

* CUDA: the kernel in ``csrc/kmeans_iter.cu`` — for any k and d, with no
  shared-memory budget to fall back from; it launches or raises;
* CPU: the chunked plain version in :mod:`.ref`;
* ``meta`` (the dry-run): the operator's fake, which gives the outputs'
  shapes and dtypes and computes nothing.

The operator returns the sums and counts as one ``[k, d+1]`` block (an
operator's outputs may not share storage); the wrapper splits it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._util import KMEANS_BLOCK_Q
from repro_torch.kernels.kmeans_iter.kernel import kmeans_iter_cuda
from repro_torch.kernels.kmeans_iter.ref import kmeans_iter_ref

OP_NAME = "repro_torch::kmeans_iter"


@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cpu",
                         schema="(Tensor x, Tensor c, Tensor? x_norm, int block_q) "
                                "-> (Tensor, Tensor, Tensor)")
def _kmeans_iter_op(x, c, x_norm, block_q):
    """``(labels [n] int32, dmin [n] f32, acc [k, d+1] f32)``, ``acc`` the
    sums beside the counts; on the CPU, the plain version."""
    labels, dmin, sums, counts = kmeans_iter_ref(x, c, x_norm, block_q=block_q)
    return labels, dmin, torch.cat([sums, counts[:, None]], 1)


@_kmeans_iter_op.register_kernel("cuda")
def _kmeans_iter_kernel(x, c, x_norm, block_q):
    cf = c.float().contiguous()
    cn = (cf * cf).sum(1)
    tile_min, labels, acc = kmeans_iter_cuda(x.float().contiguous(), cf, cn)
    kmeans_iter.launches += 1
    xn = (x.float() ** 2).sum(1) if x_norm is None else x_norm.float()
    return labels, torch.clamp(tile_min + xn, min=0.0), acc


@_kmeans_iter_op.register_fake
def _kmeans_iter_fake(x, c, x_norm, block_q):
    n, d = x.shape
    k = c.shape[0]
    return (x.new_empty((n,), dtype=torch.int32), x.new_empty((n,), dtype=torch.float32),
            x.new_empty((k, d + 1), dtype=torch.float32))


def kmeans_iter(x: torch.Tensor, c: torch.Tensor, *,
                x_norm: Optional[torch.Tensor] = None,
                block_q: int = KMEANS_BLOCK_Q):
    """labels[i], dist²[i], per-cluster sums [k, d] and counts [k] — one
    Lloyd iteration.  Empty-cluster policy is the caller's (counts == 0 rows
    carry zero sums).  ``block_q`` is the plain version's row chunk."""
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"kmeans_iter: unsupported device {x.device}")
    labels, dmin, acc = _kmeans_iter_op(x, c, x_norm, block_q)
    d = x.shape[1]
    return labels, dmin, acc[:, :d], acc[:, d]


kmeans_iter.launches = 0  # kernel launches (CUDA path only)
