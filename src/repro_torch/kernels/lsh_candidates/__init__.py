"""Random-hyperplane LSH candidate generation (approximate Stage 1):
``kernel.py`` (ctypes binding of ``csrc/hash_codes.cu``), ``ops.py``
(hashing wrapper, candidate windows, persisted tables), ``ref.py`` (plain
hashing)."""
from repro_torch.kernels.lsh_candidates.ops import (  # noqa: F401
    LshTables,
    default_candidates,
    hash_codes,
    lsh_candidates,
    make_planes,
    routed_candidates,
    sorted_tables,
)
from repro_torch.kernels.lsh_candidates.ref import hash_codes_ref  # noqa: F401
