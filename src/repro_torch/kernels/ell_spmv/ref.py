"""Plain PyTorch version of the BlockELL SpMV kernel: the ELL body's gather
of :func:`repro_torch.sparse.ops.spmv_blockell`,
``y[r] = Σ_w vals[r, w] · x[cols[r, w]]`` (padding slots carry val = 0)."""
from repro_torch.sparse.ops import ell_body_spmv as ell_spmv_ref  # noqa: F401
