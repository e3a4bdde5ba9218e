"""ctypes bindings of the CUDA BlockELL SpMM kernel and of the fused
Chebyshev step (``csrc/ell_spmm.cu``), which replace the TPU kernels
``ell_spmm_pallas`` and ``ell_spmm_cheb_pallas`` in
``src/repro/kernels/ell_spmm/kernel.py``.  The design notes are in the
source.
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


def _cheb_lib():
    fn = _build.load("ell_spmm").ell_spmm_cheb_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def _check_operands(what, operands, cols, vals):
    x = operands[0][1]
    for name, t, dt in (*operands, ("cols", cols, torch.int32), ("vals", vals, torch.float32)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt}, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 2-D tensor")
        if t.device != x.device:
            raise ValueError(f"{what}: all operands must be on one device")
    if cols.shape != vals.shape:
        raise ValueError(f"{what}: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must match")
    b = x.shape[1]
    if b % 4 or any(t.data_ptr() % 16 for _, t, _ in operands):
        raise ValueError(f"{what}: the iterates must have a multiple of 4 columns (got {b}) "
                         f"and be 16-byte aligned for float4 loads")


def ell_spmm_cuda(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Raw kernel entry: ``x [n, b]`` fp32 with ``b % 4 == 0``, ``cols [R, W]`` int32 (every id
    in ``[0, n)``), ``vals [R, W]`` fp32, all contiguous on one CUDA device,
    ``cols`` and ``vals`` 16-byte aligned (the streamed slot pass reads them
    as int4 / float4).  Returns ``y [R, b]`` fp32 for the ELL body; launches
    on the current stream and does not synchronise."""
    _check_operands("ell_spmm_cuda", (("x", x, torch.float32),), cols, vals)
    if cols.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("ell_spmm_cuda: cols and vals must start 16-byte aligned "
                         "(the kernel streams them as int4 / float4)")
    n, b = x.shape
    n_rows, w = cols.shape
    if n_rows * max(b, w) >= 2**31:
        raise ValueError("ell_spmm_cuda: rows·b and rows·W must fit in int32")
    y = torch.empty((n_rows, b), dtype=torch.float32, device=x.device)
    if n_rows == 0 or b == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), cols.data_ptr(), vals.data_ptr(), n, n_rows, w, b,
                     y.data_ptr(), stream)
    _build.check(err, "ell_spmm")
    return y


def ell_spmm_cheb_cuda(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                       prev: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Raw fused-step entry: ``x [n, b]`` and ``prev [n_out, b]`` fp32 with
    ``b % 4 == 0`` and n_out ≤ n, ``cols/vals [R, W]`` (R ≥ n_out, every id
    in ``[0, n)``), ``coef [2]`` fp32 = ``(ca, cb)`` on the device.  Returns
    ``y [n_out, b] = ca·(A_ell x) + cb·x[:n_out] − prev`` for the first
    n_out rows of the ELL body; launches on the current stream and does not
    synchronise."""
    _check_operands("ell_spmm_cheb_cuda", (("x", x, torch.float32),
                                           ("prev", prev, torch.float32)), cols, vals)
    if prev.shape[1] != x.shape[1] or prev.shape[0] > x.shape[0]:
        raise ValueError(f"ell_spmm_cheb_cuda: prev {tuple(prev.shape)} must have x's "
                         f"columns and at most its rows {tuple(x.shape)}")
    if coef.device != x.device or coef.dtype != torch.float32 or coef.shape != (2,) \
            or not coef.is_contiguous():
        raise ValueError("ell_spmm_cheb_cuda: coef must be a contiguous float32 [2] "
                         "tensor (ca, cb) on the iterates' device")
    n, b = x.shape
    n_out = prev.shape[0]
    n_rows, w = cols.shape
    if n_out > n_rows:
        raise ValueError(f"ell_spmm_cheb_cuda: {n_out} output rows but only {n_rows} ELL rows")
    if n_rows * b >= 2**31:
        raise ValueError("ell_spmm_cheb_cuda: rows·b must fit in int32")
    y = torch.empty((n_out, b), dtype=torch.float32, device=x.device)
    if n_out == 0 or b == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _cheb_lib()(x.data_ptr(), cols.data_ptr(), vals.data_ptr(), prev.data_ptr(),
                          coef.data_ptr(), n, n_out, w, b, y.data_ptr(), stream)
    _build.check(err, "ell_spmm_cheb")
    return y
