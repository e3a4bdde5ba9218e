"""Pipeline-state checkpoints (mirrors :mod:`repro.core.state_io`): a
crashed stage must not redo the ones before it::

    try:
        out = pipe.run(x, gen, checkpoint_dir="ckpt/run1")
    except PipelineError as e:
        ...fix the config...
        out = pipe.run(resume_from="ckpt/run1")   # skips completed stages

The codec flattens a :class:`~repro_torch.core.spectral.PipelineState` into
the reference's flat name → array dict (dotted names: ``graph.adj.row`` …)
plus one uint8 ``__meta__`` leaf holding a JSON blob (provenance,
reductions, reports, COO shapes, the pipeline config), written by
:class:`repro_torch.ckpt.CheckpointManager` in the reference's disk format.
Either package restores the other's data slots.

The port's per-stage random state is two CPU ``torch.Generator``s; their
``get_state()`` bytes are the uint8 leaves ``gen_embed`` and
``gen_cluster``, which the reference ignores.  A checkpoint the reference
wrote holds its PRNG keys ``key_embed``/``key_cluster`` (two uint32 words)
instead; each becomes a generator seeded with ``word0 · 2³² + word1``.  The
port's random stream is not JAX's, so stages resumed from such a checkpoint
draw the port's numbers, not the reference's.

A :class:`~repro_torch.sparse.distributed.ShardedCOO` slot is the
reference's ``"sharded"`` kind: its (row_local, col, val) buckets plus
``rows_per_shard`` / ``num_shards`` / ``edges_per_shard`` in the meta.  The
layout is pure data; the mesh is a runtime resource of the plan.

Under a mesh of more than one rank the embeddings (``EmbedState`` and
``SpectralResult``) are each rank's row block: :func:`save_state`, given the
pipeline, gathers each once so the checkpoint holds them whole, as the
reference's does (every rank must call it, as every rank of the plan runs
the stages), and :func:`load_state`, given a pipeline with such a mesh,
hands each rank its rows again (the blocks of
:meth:`~repro_torch.sparse.distributed.RowBlock.padded` when the rows do not
divide by the ranks).
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, cpu_generator, resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core.health import StageReport
from repro_torch.core.reduce import ReduceInfo, ReductionState
from repro_torch.sparse.distributed import RowBlock, ShardedCOO, gather_rows, mesh_axis
from repro_torch.sparse.formats import COO

_META_KEY = "__meta__"
STATE_STEP = 0  # one checkpoint per directory: the latest prefix wins
_GENERATORS = (("gen_embed", "key_embed"), ("gen_cluster", "key_cluster"))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)  # a writable copy


def _put_coo(tree: Dict[str, np.ndarray], meta: dict, name: str, coo) -> None:
    if isinstance(coo, ShardedCOO):
        tree[f"{name}.row_local"] = _np(coo.row_local)
        tree[f"{name}.col"] = _np(coo.col)
        tree[f"{name}.val"] = _np(coo.val)
        meta[name] = {"kind": "sharded", "shape": list(coo.shape),
                      "rows_per_shard": int(coo.rows_per_shard),
                      "num_shards": int(coo.num_shards),
                      "edges_per_shard": int(coo.edges_per_shard)}
        return
    tree[f"{name}.row"] = _np(coo.row)
    tree[f"{name}.col"] = _np(coo.col)
    tree[f"{name}.val"] = _np(coo.val)
    meta[name] = {"kind": "coo", "shape": list(coo.shape), "sorted_rows": bool(coo.sorted_rows)}


def _get_coo(tree, meta: dict, name: str, dev):
    m = meta[name]
    if m.get("kind", "coo") == "sharded":
        return ShardedCOO(row_local=_t(tree[f"{name}.row_local"], dev).long(),
                          col=_t(tree[f"{name}.col"], dev).long(),
                          val=_t(tree[f"{name}.val"], dev), shape=tuple(m["shape"]),
                          rows_per_shard=m["rows_per_shard"], num_shards=m["num_shards"],
                          edges_per_shard=m["edges_per_shard"])
    return COO(row=_t(tree[f"{name}.row"], dev).long(), col=_t(tree[f"{name}.col"], dev).long(),
               val=_t(tree[f"{name}.val"], dev), shape=tuple(m["shape"]),
               sorted_rows=m["sorted_rows"])


def _put_graph(tree, meta, name, g) -> None:
    _put_coo(tree, meta, f"{name}.adj", g.adj)
    tree[f"{name}.deg"] = _np(g.deg)
    tree[f"{name}.inv_sqrt_deg"] = _np(g.inv_sqrt_deg)


def _get_graph(tree, meta, name, dev):
    from repro_torch.core.spectral import GraphState

    return GraphState(adj=_get_coo(tree, meta, f"{name}.adj", dev),
                      deg=_t(tree[f"{name}.deg"], dev),
                      inv_sqrt_deg=_t(tree[f"{name}.inv_sqrt_deg"], dev))


def _split_axis(pipeline):
    """The mesh axis over which ``pipeline``'s embeddings are row blocks (a
    mesh of more than one rank), else None."""
    plan = getattr(pipeline, "plan", None)
    if plan is None or plan.mesh is None:
        return None
    ax = mesh_axis(plan.mesh, plan.axis)
    return ax if ax.size > 1 else None


def state_to_tree(state, pipeline=None) -> Dict[str, np.ndarray]:
    """Flatten a :class:`PipelineState` to the flat dict the checkpoint
    manager stores.  ``pipeline`` (optional) embeds its ``to_dict()`` so
    resume can warn on a config mismatch; under its mesh the embeddings are
    gathered whole (one all-gather each)."""
    tree: Dict[str, np.ndarray] = {}
    meta: dict = {
        "provenance": list(state.provenance),
        "reductions": [i._asdict() for i in state.reductions],
        "reports": [r.to_dict() for r in state.reports],
        "pipeline": pipeline.to_dict() if pipeline is not None else None,
    }
    if state.operator_override is not None:
        warnings.warn(
            "PipelineState.operator_override is a runtime resource and is not "
            "checkpointed — re-pass operator= after resume if the override mattered",
            RuntimeWarning, stacklevel=2)
    for name in ("points", "search_points"):
        v = getattr(state, name)
        if v is not None:
            tree[name] = _np(v)
    for name, _ in _GENERATORS:
        gen = getattr(state, name)
        if gen is not None:
            tree[name] = _np(gen.get_state())
    if state.input_graph is not None:
        _put_coo(tree, meta, "input_graph", state.input_graph)
    if state.graph is not None:
        _put_graph(tree, meta, "graph", state.graph)
    ax = _split_axis(pipeline)

    def whole(h, n_rows=None):
        if ax is not None and n_rows is None:
            n_rows = h.shape[0] * ax.size
        return _np(gather_rows(h, ax, n_rows))

    if state.embedding is not None:
        e = state.embedding
        tree["embedding.embedding"] = whole(e.embedding, e.n_rows)
        tree["embedding.eigenvalues"] = _np(e.eigenvalues)
        tree["embedding.residuals"] = _np(e.residuals)
        tree["embedding.restarts"] = np.asarray(e.restarts)
        tree["embedding.converged"] = np.asarray(e.converged)
    if state.result is not None:
        r = state.result
        for f in ("labels", "eigenvalues", "eig_residuals", "kmeans_inertia",
                  "lanczos_restarts", "kmeans_iterations"):
            tree[f"result.{f}"] = _np(getattr(r, f))
        tree["result.embedding"] = whole(r.embedding, r.labels.shape[0])
        meta["result_reports"] = [rep.to_dict() for rep in r.reports]
    if state.reduction is not None:
        red = state.reduction
        _put_graph(tree, meta, "reduction.fine", red.fine_graph)
        if red.prolong is not None:
            tree["reduction.prolong"] = _np(red.prolong)
        meta["reduction_info"] = red.info._asdict()
    blob = json.dumps(meta).encode("utf-8")
    tree[_META_KEY] = np.frombuffer(blob, np.uint8).copy()
    return tree


def _reports_from_meta(items) -> Tuple[StageReport, ...]:
    return tuple(
        StageReport(stage=d["stage"], escalations=tuple(d["escalations"]),
                    attempts=d["attempts"], converged=d["converged"],
                    residual_max=d["residual_max"], wall_s=d["wall_s"])
        for d in items)


def _generator(tree, name: str, key_name: str) -> Optional[torch.Generator]:
    """The port's saved generator, else one seeded from the reference's key
    words (``word0 · 2³² + word1``), else None."""
    if name in tree:
        gen = torch.Generator(device="cpu")
        gen.set_state(torch.from_numpy(np.array(tree[name], np.uint8)))
        return gen
    if key_name in tree:
        w0, w1 = (int(w) for w in np.asarray(tree[key_name], np.uint32).reshape(-1)[:2])
        return cpu_generator((w0 << 32) | w1)
    return None


def state_from_tree(tree: Dict[str, np.ndarray], *, device: DeviceLike = None):
    """Rebuild the :class:`PipelineState` (inverse of :func:`state_to_tree`),
    its tensors on ``device`` (the card unless the caller names another, as
    for every entry point of the port).  Returns
    ``(state, pipeline_dict_or_None)``."""
    from repro_torch.core.spectral import EmbedState, PipelineState, SpectralResult

    dev = resolve_device(device)
    meta = json.loads(bytes(np.asarray(tree[_META_KEY])).decode("utf-8"))
    kw: Dict[str, Any] = {
        "provenance": tuple(meta["provenance"]),
        "reductions": tuple(ReduceInfo(**i) for i in meta["reductions"]),
        "reports": _reports_from_meta(meta["reports"]),
        "device": dev,
    }
    for name in ("points", "search_points"):
        if name in tree:
            kw[name] = _t(tree[name], dev)
    for name, key_name in _GENERATORS:
        kw[name] = _generator(tree, name, key_name)
    if "input_graph" in meta:
        kw["input_graph"] = _get_coo(tree, meta, "input_graph", dev)
    if "graph.deg" in tree:
        kw["graph"] = _get_graph(tree, meta, "graph", dev)
    if "embedding.embedding" in tree:
        kw["embedding"] = EmbedState(
            embedding=_t(tree["embedding.embedding"], dev),
            eigenvalues=_t(tree["embedding.eigenvalues"], dev),
            residuals=_t(tree["embedding.residuals"], dev),
            restarts=int(np.asarray(tree["embedding.restarts"])),
            converged=bool(np.asarray(tree["embedding.converged"]).all()))
    if "result.labels" in tree:
        kw["result"] = SpectralResult(
            labels=_t(tree["result.labels"], dev),
            embedding=_t(tree["result.embedding"], dev),
            eigenvalues=_t(tree["result.eigenvalues"], dev),
            eig_residuals=_t(tree["result.eig_residuals"], dev),
            kmeans_inertia=_t(tree["result.kmeans_inertia"], dev),
            lanczos_restarts=int(np.asarray(tree["result.lanczos_restarts"])),
            kmeans_iterations=int(np.asarray(tree["result.kmeans_iterations"])),
            reports=_reports_from_meta(meta.get("result_reports", [])))
    if "reduction.fine.deg" in tree:
        prolong = (_t(tree["reduction.prolong"], dev).long()
                   if "reduction.prolong" in tree else None)
        kw["reduction"] = ReductionState(
            fine_graph=_get_graph(tree, meta, "reduction.fine", dev),
            prolong=prolong, info=ReduceInfo(**meta["reduction_info"]))
    return PipelineState(**kw), meta.get("pipeline")


def save_state(directory: str, state, pipeline=None) -> str:
    """Persist the state prefix (crash-consistent: tmp + fsync + rename).  One
    slot per directory — a later save replaces the earlier one.  Returns the
    directory."""
    mgr = CheckpointManager(directory, keep=1)
    mgr.save(STATE_STEP, state_to_tree(state, pipeline), blocking=True)
    return directory


def load_state(directory: str, pipeline=None, *, device: DeviceLike = None):
    """``(state, pipeline_dict)`` from :func:`save_state`'s slot, tensors on
    ``device`` (the card unless the caller names another).  With ``pipeline`` given, warns if its config differs from
    the one the state was produced under (resume still proceeds), and under
    its mesh each rank keeps its own rows of the embeddings."""
    mgr = CheckpointManager(directory, keep=1)
    if not mgr._complete(STATE_STEP):
        raise FileNotFoundError(f"no intact pipeline-state checkpoint in {directory!r}")
    state, pipe_dict = state_from_tree(mgr.restore_dict(STATE_STEP), device=device)
    ax = _split_axis(pipeline)
    if ax is not None:  # each rank its own rows of the embeddings
        def rows(h):
            return RowBlock.padded(ax, h.shape[0]).take(h)

        if state.embedding is not None:
            h = state.embedding.embedding
            state = dataclasses.replace(state, embedding=state.embedding._replace(
                embedding=rows(h), n_rows=RowBlock.padded(ax, h.shape[0]).live))
        if state.result is not None:
            state = dataclasses.replace(state, result=state.result._replace(
                embedding=rows(state.result.embedding)))
    if pipeline is not None and pipe_dict is not None and pipeline.to_dict() != pipe_dict:
        warnings.warn(
            "resuming a pipeline-state checkpoint under a different pipeline config "
            "than the one that produced it — completed stages keep their old-config "
            "outputs", RuntimeWarning, stacklevel=2)
    return state, pipe_dict
