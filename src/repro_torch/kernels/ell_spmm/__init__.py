"""Multi-vector Blocked-ELL SpMM (block-Lanczos hot op): ``kernel.py``
(ctypes binding of ``csrc/ell_spmm.cu``), ``ops.py`` (wrapper + tail),
``ref.py`` (plain version)."""
from repro_torch.kernels.ell_spmm.ops import ell_spmm  # noqa: F401
