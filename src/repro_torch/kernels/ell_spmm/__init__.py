"""Multi-vector Blocked-ELL SpMM (block-Lanczos hot op) and the fused
Chebyshev step: ``kernel.py`` (ctypes bindings of ``csrc/ell_spmm.cu``),
``ops.py`` (wrappers + tail), ``ref.py`` (plain versions)."""
from repro_torch.kernels.ell_spmm.ops import ell_spmm, ell_spmm_cheb_step  # noqa: F401
