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
from repro_torch.core.spectral import EmbedState, GraphState, SpectralPipeline
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
