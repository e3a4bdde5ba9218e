"""ctypes binding of the CUDA BlockELL SpMV kernel (``csrc/ell_spmv.cu``),
which replaces the TPU kernel ``ell_spmv_pallas`` in
``src/repro/kernels/ell_spmv/kernel.py``.  The design note is in the source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_W = 8192  # four rows of products, 128 KB of shared memory


def _lib():
    fn = _build.load("ell_spmv").ell_spmv_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ell_spmv_cuda(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Raw kernel entry: ``x [n]`` fp32, ``cols [R, W]`` int32 (every id in
    ``[0, n)``), ``vals [R, W]`` fp32, all contiguous on one CUDA device,
    ``cols`` and ``vals`` 16-byte aligned, ``W <= MAX_W``.
    Returns ``y [R]`` fp32 for the ELL body; launches on the current stream
    and does not synchronise."""
    for name, t, dt, nd in (("x", x, torch.float32, 1), ("cols", cols, torch.int32, 2),
                            ("vals", vals, torch.float32, 2)):
        if t.device.type != "cuda":
            raise ValueError(f"ell_spmv_cuda: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"ell_spmv_cuda: {name} must be {dt}, got {t.dtype}")
        if t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"ell_spmv_cuda: {name} must be a contiguous {nd}-D tensor")
        if t.device != x.device:
            raise ValueError("ell_spmv_cuda: all operands must be on one device")
    if cols.shape != vals.shape:
        raise ValueError(f"ell_spmv_cuda: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must match")
    n_rows, w = cols.shape
    if n_rows * w >= 2**31:
        raise ValueError("ell_spmv_cuda: rows·W must fit in int32")
    if w > MAX_W:
        raise ValueError(f"ell_spmv_cuda: W = {w} slots a row; the kernel keeps four rows' "
                         f"products in shared memory and takes W <= {MAX_W}")
    if cols.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("ell_spmv_cuda: cols and vals must start 16-byte aligned "
                         "(the kernel streams them as int4 / float4)")
    if w == 0:
        return torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.shape[0], n_rows, w,
                     y.data_ptr(), stream)
    _build.check(err, "ell_spmv")
    return y
