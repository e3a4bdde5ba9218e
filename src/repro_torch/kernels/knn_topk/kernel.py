"""ctypes binding of the CUDA kNN top-k kernel (``csrc/knn_topk.cu``), which
replaces the TPU kernel ``knn_topk_pallas`` in
``src/repro/kernels/knn_topk/kernel.py``.  The design note is in the source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_K = 128


def _lib():
    fn = _build.load("knn_topk").knn_topk_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def knn_topk_cuda(xq: torch.Tensor, xc: torch.Tensor, k: int, *,
                  query_offset: int = 0):
    """Raw kernel entry on padded inputs: ``xq [nq, dp]``, ``xc [nc, dp]``
    fp32, contiguous, on one CUDA device, ``dp % 4 == 0``.  Returns
    ``(dist [nq, k] fp32, idx [nq, k] int32)``; launches on the current
    stream and does not synchronise."""
    for name, t in (("xq", xq), ("xc", xc)):
        if t.device.type != "cuda":
            raise ValueError(f"knn_topk_cuda: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"knn_topk_cuda: {name} must be float32, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"knn_topk_cuda: {name} must be a contiguous 2-D tensor")
    if xq.device != xc.device:
        raise ValueError("knn_topk_cuda: xq and xc must be on the same device")
    nq, dp = xq.shape
    nc = xc.shape[0]
    if xc.shape[1] != dp or dp % 4:
        raise ValueError(f"knn_topk_cuda: widths must agree and be a multiple of 4, "
                         f"got {xq.shape} and {xc.shape}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_topk_cuda supports 1 <= k <= {MAX_K}, got k={k}")
    if max(nq, nc) >= 2**31:
        raise ValueError("knn_topk_cuda: row counts must fit in int32")
    dist = torch.empty((nq, k), dtype=torch.float32, device=xq.device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=xq.device)
    if nq == 0:
        return dist, idx
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(xq.data_ptr(), xc.data_ptr(), nq, nc, dp, k, int(query_offset),
                     dist.data_ptr(), idx.data_ptr(), stream)
    _build.check(err, "knn_topk")
    return dist, idx
