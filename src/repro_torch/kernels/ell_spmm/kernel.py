"""ctypes binding of the CUDA BlockELL SpMM kernel (``csrc/ell_spmm.cu``),
which replaces the TPU kernel ``ell_spmm_pallas`` in
``src/repro/kernels/ell_spmm/kernel.py``.  The design note is in the source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def _lib():
    fn = _build.load("ell_spmm").ell_spmm_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ell_spmm_cuda(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Raw kernel entry: ``x [n, b]`` fp32 with ``b % 4 == 0``, ``cols [R, W]`` int32 (every id
    in ``[0, n)``), ``vals [R, W]`` fp32, all contiguous on one CUDA device.
    Returns ``y [R, b]`` fp32 for the ELL body; launches on the current
    stream and does not synchronise."""
    for name, t, dt in (("x", x, torch.float32), ("cols", cols, torch.int32),
                        ("vals", vals, torch.float32)):
        if t.device.type != "cuda":
            raise ValueError(f"ell_spmm_cuda: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"ell_spmm_cuda: {name} must be {dt}, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"ell_spmm_cuda: {name} must be a contiguous 2-D tensor")
        if t.device != x.device:
            raise ValueError("ell_spmm_cuda: all operands must be on one device")
    if cols.shape != vals.shape:
        raise ValueError(f"ell_spmm_cuda: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must match")
    n, b = x.shape
    n_rows, w = cols.shape
    if b % 4 or x.data_ptr() % 16:
        raise ValueError(f"ell_spmm_cuda: x must have a multiple of 4 columns (got {b}) and "
                         f"be 16-byte aligned for float4 gathers")
    y = torch.empty((n_rows, b), dtype=torch.float32, device=x.device)
    if n_rows == 0 or b == 0:
        return y
    if n_rows * b >= 2**31:
        raise ValueError("ell_spmm_cuda: rows·b must fit in int32")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), cols.data_ptr(), vals.data_ptr(), n, n_rows, w, b,
                     y.data_ptr(), stream)
    _build.check(err, "ell_spmm")
    return y
