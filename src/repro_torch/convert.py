"""Carry the reference's state across into this package's objects.

The pipeline has no weights: its state is the graph, the embedding and the
centroids; the model zoo's models have parameter trees, and training has a
``TrainState``.  Each function takes the reference's arrays — anything
``numpy.asarray`` accepts, such as the fields of a ``repro`` container —
and returns the port's counterpart on ``device`` (the card unless the
caller asks for the CPU).  Nothing here imports the reference: containers
are read by field name.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.reduce import ReduceInfo, ReductionState
from repro_torch.core.spectral import EmbedState, GraphState, SpectralPipeline
from repro_torch.kernels.lsh_candidates.ops import LshTables
from repro_torch.models.gnn.graph import GraphBatch
from repro_torch.serve.oos import OOSConfig, ServingIndex
from repro_torch.sparse.distributed import ShardedCOO
from repro_torch.sparse.formats import COO, CSR, BlockELL
from repro_torch.train.state import TrainState


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


def _leaf(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read:
        # widened to float32 and narrowed back, both exact
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=dev)


def transformer_params(tree: Any, *, device: DeviceLike = None) -> Any:
    """A reference transformer parameter tree (nested dicts of arrays,
    ``repro.models.transformer.init_params``'s layout, MoE included) — or a
    KV cache ``{"k", "v"}`` — as the same tree of tensors, each leaf's dtype
    kept (bfloat16 included)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: transformer_params(v, device=dev) for k, v in tree.items()}
    return _leaf(tree, dev)


def _tensors(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, dev) for v in tree]
    return _leaf(tree, dev)


def autoint_params(tree: Any, *, device: DeviceLike = None) -> Any:
    """A reference AutoInt parameter tree (``repro.models.recsys.init_params``'s
    layout: a dict whose ``layers`` is a list of dicts) as the same tree of
    tensors."""
    return _tensors(tree, resolve_device(device))


def gnn_params(tree: Any, *, device: DeviceLike = None) -> Any:
    """A reference GNN parameter tree (gcn, pna, nequip or equiformer-v2:
    dicts and lists of arrays) as the same tree of tensors, each leaf's
    dtype kept (bfloat16 included)."""
    return _tensors(tree, resolve_device(device))


def graph_batch(b: Any, *, device: DeviceLike = None) -> GraphBatch:
    """A reference ``GraphBatch`` (node_feat, edge_src, edge_dst, edge_mask,
    labels, label_mask, positions, species, graph_id, n_graphs), each array
    as a tensor of its dtype and ``n_graphs`` an int."""
    dev = resolve_device(device)
    fields = {f.name: getattr(b, f.name) for f in dataclasses.fields(GraphBatch)}
    return GraphBatch(**{k: int(v) if k == "n_graphs" else None if v is None else _leaf(v, dev)
                         for k, v in fields.items()})


def train_state(state: Any, *, device: DeviceLike = None) -> TrainState:
    """A reference ``TrainState`` (params, opt ``{m, v, step}``, step) — of an
    LM, of AutoInt or of a GNN — as the port's, each leaf's dtype kept."""
    dev = resolve_device(device)
    opt = state.opt
    return TrainState(params=_tensors(state.params, dev),
                      opt={"m": _tensors(opt["m"], dev), "v": _tensors(opt["v"], dev),
                           "step": _leaf(opt["step"], dev)},
                      step=_leaf(state.step, dev))
