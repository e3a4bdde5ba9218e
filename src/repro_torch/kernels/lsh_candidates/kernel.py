"""ctypes binding of the CUDA LSH hashing kernel (``csrc/hash_codes.cu``),
which replaces the TPU kernel ``hash_codes_pallas`` in
``src/repro/kernels/lsh_candidates/kernel.py``.  The design note is in the
source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_TABLE_BYTES = 232448  # shared memory one block may use on the H100


def _lib():
    fn = _build.load("hash_codes").hash_codes_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def hash_codes_cuda(x: torch.Tensor, planes: torch.Tensor):
    """Raw kernel entry: ``x [n, d]`` and ``planes [T, d, n_bits + 1]`` fp32,
    contiguous, on one CUDA device, 1 ≤ n_bits ≤ 24, one table's planes
    padded to a multiple of 4 columns within ``MAX_TABLE_BYTES``.  Returns ``(codes
    [T, n] int32, tie [T, n] f32)``; launches on the current stream and
    does not synchronise."""
    for name, t, nd in (("x", x, 2), ("planes", planes, 3)):
        if t.device.type != "cuda":
            raise ValueError(f"hash_codes_cuda: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"hash_codes_cuda: {name} must be float32, got {t.dtype}")
        if t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"hash_codes_cuda: {name} must be a contiguous {nd}-D tensor")
        if t.device != x.device:
            raise ValueError("hash_codes_cuda: all operands must be on one device")
    n, d = x.shape
    n_tables, dp, cols = planes.shape
    n_bits = cols - 1
    if dp != d or not 1 <= n_bits <= 24:
        raise ValueError(f"hash_codes_cuda: planes {tuple(planes.shape)} must be "
                         f"[T, {d}, n_bits + 1] with 1 <= n_bits <= 24")
    if n * d >= 2**31 or n * n_tables >= 2**31:
        raise ValueError("hash_codes_cuda: n·d and n·T must fit in int32")
    if d * 4 * ((cols + 3) // 4) * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"hash_codes_cuda: one table's planes (d={d}, n_bits={n_bits}, "
                         f"padded to 4 columns) exceed the {MAX_TABLE_BYTES} bytes of shared "
                         f"memory a block can stage")
    codes = torch.empty((n_tables, n), dtype=torch.int32, device=x.device)
    tie = torch.empty((n_tables, n), dtype=torch.float32, device=x.device)
    if n == 0 or n_tables == 0:
        return codes, tie
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), planes.data_ptr(), n, d, n_tables, n_bits,
                     codes.data_ptr(), tie.data_ptr(), stream)
    _build.check(err, "hash_codes")
    return codes, tie
