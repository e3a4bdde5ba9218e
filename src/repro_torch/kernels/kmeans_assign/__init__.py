"""Fused k-means assignment (the two-pass Lloyd iteration's first pass):
``kernel.py`` (ctypes binding of ``csrc/kmeans_assign.cu``), ``ops.py``
(wrapper), ``ref.py`` (plain version)."""
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign  # noqa: F401
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref  # noqa: F401
