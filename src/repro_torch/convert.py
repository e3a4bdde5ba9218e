"""Carry the reference's state across into this package's objects.

The system has no weights: its state is the graph, the embedding and the
centroids.  Each function takes the reference's arrays — anything
``numpy.asarray`` accepts, such as the fields of a ``repro`` container —
and returns the port's counterpart on ``device`` (the card unless the
caller asks for the CPU).  Nothing here imports the reference: containers
are read by field name.
"""
from __future__ import annotations

import json
from typing import Any, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.reduce import ReduceInfo, ReductionState
from repro_torch.core.spectral import EmbedState, GraphState, SpectralPipeline
from repro_torch.kernels.lsh_candidates.ops import LshTables
from repro_torch.serve.oos import OOSConfig, ServingIndex
from repro_torch.sparse.distributed import ShardedCOO
from repro_torch.sparse.formats import COO, CSR, BlockELL


def _t(a, dev: torch.device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.array(a), device=dev)  # a writable copy
    return t if dtype is None else t.to(dtype)


def coo(m: Any, *, device: DeviceLike = None) -> COO:
    """A reference ``COO`` (row, col, val, shape, sorted_rows)."""
    dev = resolve_device(device)
    return COO(_t(m.row, dev, torch.int64), _t(m.col, dev, torch.int64),
               _t(m.val, dev), tuple(int(s) for s in m.shape),
               sorted_rows=bool(getattr(m, "sorted_rows", True)))


def csr(m: Any, *, device: DeviceLike = None) -> CSR:
    """A reference ``CSR`` (indptr, indices, data, row, shape)."""
    dev = resolve_device(device)
    return CSR(_t(m.indptr, dev, torch.int64), _t(m.indices, dev, torch.int64),
               _t(m.data, dev), _t(m.row, dev, torch.int64),
               tuple(int(s) for s in m.shape))


def sharded_coo(m: Any, *, device: DeviceLike = None) -> ShardedCOO:
    """A reference ``ShardedCOO`` (row_local, col, val, shape,
    rows_per_shard, num_shards, edges_per_shard)."""
    dev = resolve_device(device)
    return ShardedCOO(_t(m.row_local, dev, torch.int64), _t(m.col, dev, torch.int64),
                      _t(m.val, dev), tuple(int(s) for s in m.shape),
                      int(m.rows_per_shard), int(m.num_shards), int(m.edges_per_shard))


def blockell(m: Any, *, device: DeviceLike = None) -> BlockELL:
    """A reference ``BlockELL`` (cols, vals, tail, shape, block_rows, width)."""
    dev = resolve_device(device)
    return BlockELL(_t(m.cols, dev, torch.int32), _t(m.vals, dev),
                    coo(m.tail, device=dev), tuple(int(s) for s in m.shape),
                    int(m.block_rows), int(m.width))


def graph_state(g: Any, *, device: DeviceLike = None) -> GraphState:
    """A reference single-device ``GraphState`` (adj, deg, inv_sqrt_deg)."""
    dev = resolve_device(device)
    return GraphState(adj=coo(g.adj, device=dev), deg=_t(g.deg, dev),
                      inv_sqrt_deg=_t(g.inv_sqrt_deg, dev))


def reduce_info(i: Any) -> ReduceInfo:
    """A reference ``ReduceInfo`` (kind, n_before, n_after, nnz_before,
    nnz_after)."""
    return ReduceInfo(kind=str(i.kind), n_before=int(i.n_before), n_after=int(i.n_after),
                      nnz_before=int(i.nnz_before), nnz_after=int(i.nnz_after))


def reduction_state(r: Any, *, device: DeviceLike = None) -> ReductionState:
    """A reference ``ReductionState`` (fine_graph, prolong, info): the coarsen
    stage's hand-off to refine."""
    dev = resolve_device(device)
    prolong = None if r.prolong is None else _t(r.prolong, dev, torch.int64)
    return ReductionState(fine_graph=graph_state(r.fine_graph, device=dev), prolong=prolong,
                          info=reduce_info(r.info))


def embed_state(e: Any, *, device: DeviceLike = None) -> EmbedState:
    """A reference ``EmbedState`` (embedding, eigenvalues, residuals,
    restarts, converged)."""
    dev = resolve_device(device)
    return EmbedState(embedding=_t(e.embedding, dev), eigenvalues=_t(e.eigenvalues, dev),
                      residuals=_t(e.residuals, dev), restarts=int(np.asarray(e.restarts)),
                      converged=bool(np.asarray(e.converged).all()))


def centroids(c: Any, *, device: DeviceLike = None) -> torch.Tensor:
    """Reference centroids ``[k, d]`` (e.g. for ``kmeans(init_centroids=)``)."""
    return _t(c, resolve_device(device), torch.float32)


def pipeline(config: Union[str, dict]) -> SpectralPipeline:
    """A ``SpectralPipeline`` from the reference's ``to_dict()`` (a dict or
    its JSON text)."""
    return SpectralPipeline.from_dict(json.loads(config) if isinstance(config, str) else config)


def lsh_tables(t: Any, *, device: DeviceLike = None) -> LshTables:
    """Reference ``LshTables`` (order, codes, ties): a pool's persisted LSH
    tables."""
    dev = resolve_device(device)
    return LshTables(order=_t(t.order, dev, torch.int32), codes=_t(t.codes, dev, torch.int32),
                     ties=_t(t.ties, dev, torch.float32))


def serving_index(i: Any, *, device: DeviceLike = None) -> ServingIndex:
    """A reference ``ServingIndex`` (points, embedding, centroids, labels,
    config, lsh_tables)."""
    dev = resolve_device(device)
    tables = None if i.lsh_tables is None else lsh_tables(i.lsh_tables, device=dev)
    return ServingIndex(points=_t(i.points, dev, torch.float32),
                        embedding=_t(i.embedding, dev, torch.float32),
                        centroids=_t(i.centroids, dev, torch.float32),
                        labels=_t(i.labels, dev, torch.int32),
                        config=OOSConfig(**i.config.to_dict()), lsh_tables=tables)
