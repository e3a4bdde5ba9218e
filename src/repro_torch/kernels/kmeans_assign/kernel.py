"""ctypes binding of the CUDA fused k-means assignment
(``csrc/kmeans_assign.cu``), which replaces the TPU kernel
``kmeans_assign_pallas`` in ``src/repro/kernels/kmeans_assign/kernel.py``.
The design note is in the source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def _lib():
    fn = _build.load("kmeans_assign").kmeans_assign_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kmeans_assign_cuda(x: torch.Tensor, c: torch.Tensor, c_norm: torch.Tensor):
    """Raw kernel entry: ``x [n, d]``, ``c [k, d]``, ``c_norm [k]`` fp32,
    contiguous, on one CUDA device.  Returns ``(min [n] without the ‖x‖²
    term, idx [n] int32)``.  Launches on the current stream, no
    synchronisation."""
    for name, t, nd in (("x", x, 2), ("c", c, 2), ("c_norm", c_norm, 1)):
        if t.device.type != "cuda":
            raise ValueError(f"kmeans_assign_cuda: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"kmeans_assign_cuda: {name} must be float32, got {t.dtype}")
        if t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"kmeans_assign_cuda: {name} must be a contiguous {nd}-D tensor")
        if t.device != x.device:
            raise ValueError("kmeans_assign_cuda: all operands must be on one device")
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d or c_norm.shape[0] != k:
        raise ValueError(f"kmeans_assign_cuda: shapes disagree: x {tuple(x.shape)}, "
                         f"c {tuple(c.shape)}, c_norm {tuple(c_norm.shape)}")
    if k < 1 or d < 1:
        raise ValueError("kmeans_assign_cuda needs k >= 1 centroids of width d >= 1")
    if n * d >= 2**31 or k * d >= 2**31:
        raise ValueError("kmeans_assign_cuda: n·d and k·d must fit in int32")
    tile_min = torch.empty(n, dtype=torch.float32, device=x.device)
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return tile_min, idx
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), c.data_ptr(), c_norm.data_ptr(), n, k, d,
                     tile_min.data_ptr(), idx.data_ptr(), stream)
    _build.check(err, "kmeans_assign")
    return tile_min, idx
