"""The three stages of the pipeline on torch tensors (mirrors :mod:`repro.core`).

Stage 1   :mod:`repro_torch.core.similarity` — sparse similarity graphs.
Stage 2   :mod:`repro_torch.core.laplacian`, :mod:`repro_torch.core.lanczos`,
          :mod:`repro_torch.core.chebyshev` — normalized Laplacian + eigensolvers.
Stage 3   :mod:`repro_torch.core.kmeans` — k-means++ / fused Lloyd.
End to end :mod:`repro_torch.core.spectral` (+ ``distributed_pipeline``).

NOTE: ``repro_torch.core.kmeans`` (module) contains ``kmeans`` (function) —
not re-exported here, so the function does not shadow the submodule.
"""

from repro_torch.core.spectral import (  # noqa: F401
    DEFAULT_STAGES,
    EigConfig,
    EmbedState,
    GraphConfig,
    GraphState,
    KMeansConfig,
    Plan,
    PipelineState,
    SpectralPipeline,
    SpectralResult,
)
from repro_torch.core.reduce import (  # noqa: F401  (Stage 1.5 — graph reduction)
    CoarsenConfig,
    ReduceInfo,
    ReductionState,
    SparsifyConfig,
)
from repro_torch.core.operator import (  # noqa: F401
    BlockEllOperator,
    CallableOperator,
    CooOperator,
    LinearOperator,
    ShardedCooOperator,
)
from repro_torch.core.pipeline import (  # noqa: F401  (deprecated shims)
    SpectralClusteringConfig,
    spectral_cluster,
    spectral_cluster_from_points,
)
from repro_torch.core.lanczos import eigsh, lanczos_topk  # noqa: F401
from repro_torch.core.kmeans import kmeanspp_init  # noqa: F401
