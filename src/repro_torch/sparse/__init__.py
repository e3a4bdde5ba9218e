"""Sparse formats and ops on torch tensors (mirrors :mod:`repro.sparse`).

* :mod:`repro_torch.sparse.formats` — COO / CSR / BlockELL containers and
  their conversions (from edges, COO → CSR → BlockELL) on the input's device.
* :mod:`repro_torch.sparse.ops` — SpMV / SpMM, degree vectors, Laplacian
  normalizations.
* :mod:`repro_torch.sparse.distributed` — the row-block layout and the
  counted collectives of the sharded plan.
"""

from repro_torch.sparse.formats import (  # noqa: F401
    COO, CSR, BlockELL, coo_from_edges, coo_to_csr, csr_to_blockell)
from repro_torch.sparse.ops import (  # noqa: F401
    spmv_coo,
    spmm_coo,
    spmv_blockell,
    spmm_blockell,
    degrees,
    normalize_sym,
    normalize_rw,
    symmetrize_coo,
    sort_coo_rows,
)
