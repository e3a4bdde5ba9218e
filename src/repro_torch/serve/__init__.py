"""Online serving over the spectral pipeline — embed once, serve many (mirrors
:mod:`repro.serve`).

* :mod:`repro_torch.serve.oos` — out-of-sample extension: label unseen
  points by kernel-weighted interpolation of cached embedding rows + the
  nearest cached centroid (:func:`~repro_torch.serve.oos.serve_fn`);
* :mod:`repro_torch.serve.batcher` — fixed-size padded micro-batches with a
  max-wait flush (:class:`~repro_torch.serve.batcher.MicroBatcher`);
* :mod:`repro_torch.serve.stream` — mini-batch k-means centroid refresh
  from served traffic + drift detection;
* :mod:`repro_torch.serve.registry` — versioned index snapshots with
  read-back health gating and an atomic ACTIVE pointer.

``python -m repro_torch.launch.serve --mode serve`` is the CLI over all four.
"""
from repro_torch.serve.batcher import BatchConfig, BatcherStats, MicroBatcher
from repro_torch.serve.metrics import adjusted_rand_index
from repro_torch.serve.oos import (
    OOSConfig,
    OOSResult,
    ServingIndex,
    build_index,
    index_problems,
    oos_embed,
    oos_labels,
    serve_fn,
)
from repro_torch.serve.registry import EmbeddingRegistry, RegistryGateError
from repro_torch.serve.stream import (
    StreamConfig,
    StreamState,
    drift,
    needs_refresh,
    rebase,
    stream_from_index,
    stream_init,
    stream_update,
)

__all__ = [
    "BatchConfig", "BatcherStats", "MicroBatcher", "adjusted_rand_index",
    "OOSConfig", "OOSResult", "ServingIndex", "build_index",
    "index_problems", "oos_embed", "oos_labels", "serve_fn",
    "EmbeddingRegistry", "RegistryGateError",
    "StreamConfig", "StreamState", "drift", "needs_refresh", "rebase",
    "stream_from_index", "stream_init", "stream_update",
]
