"""Blocked-ELL SpMV (the Chebyshev bounds estimator's operator application):
``kernel.py`` (ctypes binding of ``csrc/ell_spmv.cu``), ``ops.py`` (wrapper
+ tail), ``ref.py`` (plain version)."""
from repro_torch.kernels.ell_spmv.ops import ell_spmv  # noqa: F401
