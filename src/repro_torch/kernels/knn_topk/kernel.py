"""ctypes binding of the CUDA kNN top-k kernel (``csrc/knn_topk.cu``), which
replaces the TPU kernel ``knn_topk_pallas`` in
``src/repro/kernels/knn_topk/kernel.py``.  The design note is in the source.

:func:`choose_splits` is pure Python: it decides from the shapes and the
card's SM count how many slices of the candidate axis the grid takes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_K = 128
THREADS = 128  # queries a block (kThreads)
SMEM_FLOATS = 12288  # floats of candidate tile a block stages (kSmemFloats)
MAX_TILE = 1024  # most candidates a tile holds (kTile)
BLOCKS_AN_SM = 4  # the grid the split aims at: this many blocks for every SM
MAX_SPLITS = 65535  # gridDim.y


def tile_rows(dp: int) -> int:
    """Candidates a tile holds at row width ``dp`` (the kernel's ``tc``)."""
    return max(1, min(MAX_TILE, SMEM_FLOATS // dp))


def choose_splits(nq: int, nc: int, dp: int, sms: int) -> int:
    """Slices S of the candidate axis for ``nq`` queries against ``nc``
    candidates of width ``dp`` on a card of ``sms`` SMs: 1 when the query
    blocks alone make ``BLOCKS_AN_SM`` blocks an SM, else the fewest that
    do, and never more slices than tiles (each slice at least one tile)."""
    q_blocks = -(-nq // THREADS)
    tiles = -(-nc // tile_rows(dp))
    want = BLOCKS_AN_SM * sms
    if q_blocks >= want or tiles <= 1:
        return 1
    return min(tiles, -(-want // max(1, q_blocks)))


def _lib():
    fn = _build.load("knn_topk").knn_topk_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def knn_topk_cuda(xq: torch.Tensor, xc: torch.Tensor, k: int, *,
                  query_offset: int = 0, d: Optional[int] = None,
                  splits: Optional[int] = None):
    """Raw kernel entry on padded inputs: ``xq [nq, dp]``, ``xc [nc, dp]``
    fp32, contiguous, 16-byte aligned, on one CUDA device, ``dp % 4 == 0``,
    the columns past the first ``d`` (default ``dp``) zero.  ``splits``
    slices of the candidate axis (default :func:`choose_splits`'s); every
    value gives the same bits.  Returns ``(dist [nq, k] fp32, idx [nq, k]
    int32)``; launches on the current stream and does not synchronise."""
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
    d = dp if d is None else d
    if not 1 <= d <= dp:
        raise ValueError(f"knn_topk_cuda: d must be in [1, {dp}], got {d}")
    if xq.data_ptr() % 16 or xc.data_ptr() % 16:
        raise ValueError("knn_topk_cuda: xq and xc must be 16-byte aligned (the kernel "
                         "loads rows as float4)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_topk_cuda supports 1 <= k <= {MAX_K}, got k={k}")
    if max(nq, nc) >= 2**31:
        raise ValueError("knn_topk_cuda: row counts must fit in int32")
    if splits is None:
        splits = choose_splits(nq, nc, dp,
                               torch.cuda.get_device_properties(xq.device).multi_processor_count)
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"knn_topk_cuda: splits must be in [1, {MAX_SPLITS}], got {splits}")
    dist = torch.empty((nq, k), dtype=torch.float32, device=xq.device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=xq.device)
    if nq == 0:
        return dist, idx
    # each slice's first k (key, id) pairs, [S, k, nq], for the merge
    part_k = part_i = None
    if splits > 1:
        part_k = torch.empty((splits, k, nq), dtype=torch.int32, device=xq.device)
        part_i = torch.empty((splits, k, nq), dtype=torch.int32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(xq.data_ptr(), xc.data_ptr(), nq, nc, dp, d, k, int(query_offset), splits,
                     None if part_k is None else part_k.data_ptr(),
                     None if part_i is None else part_i.data_ptr(),
                     dist.data_ptr(), idx.data_ptr(), stream)
    _build.check(err, "knn_topk")
    return dist, idx
