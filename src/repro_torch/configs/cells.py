"""Cell builders: (arch × shape) → a dry-run cell (mirrors
:mod:`repro.configs.cells`), and the launcher's per-arch knobs.

A :class:`Cell` carries the step function, its arguments as ``meta``
tensors (shapes and dtypes, no storage) and the spec trees that shard them
on the production mesh.  ``launch/dryrun.py`` distributes the arguments by
the specs over a fake process group and runs the function once.

Per-family step semantics:
  lm/train_4k      train_step (loss+AdamW), microbatched per LM_ACCUM
  lm/prefill_32k   prefill (chunked flash attention, returns cache)
  lm/decode_*      decode_step (1 token vs KV cache); long_500k skipped for
                   the five full-attention archs (assignment rule)
  gnn/*            full-batch / sampled-subgraph / batched-molecule train
  recsys/*         train, serve logits, bulk scoring, retrieval scoring
  spectral/*       the paper's pipeline on its four datasets (fixed-cost
                   Lanczos restarts + k-means iterations)
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.launch import sharding as shd
from repro_torch.launch.sharding import P
from repro_torch.optim.adamw import AdamWConfig


@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable
    args: Tuple[Any, ...]  # trees of meta tensors
    in_specs: Tuple[Any, ...]  # PartitionSpec trees (same structure)
    donate: Tuple[int, ...] = ()
    skip: Optional[str] = None
    meta: dict = dataclasses.field(default_factory=dict)


def _sds(shape, dtype):
    """A shape-and-dtype stand-in: a ``meta`` tensor (no storage)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def zero1_opt_specs(param_specs, param_shapes, rules):
    """ZeRO-1: shard fp32 optimizer moments over the data axis too.

    For each param leaf, the first axis that is unsharded in the param spec
    and divisible by the full data-parallel degree (32 covers both meshes)
    additionally gets the 'batch' mesh axes.  Params stay replicated over
    data (plain DP); only m/v shard — the AdamW update then computes a
    shard of the step and the new params are all-gathered (ZeRO-1).
    """
    data_axes = shd.resolve(("batch",), rules)
    axes = data_axes[0] if len(data_axes) else None
    if axes is None:
        return param_specs

    def one(spec, shape):
        spec = spec if spec is not None else P()
        entries = list(spec) + [None] * (len(shape.shape) - len(spec))
        for i, (e, dim) in enumerate(zip(entries, shape.shape)):
            if e is None and dim % 32 == 0:
                entries[i] = axes
                return P(*entries)
        return spec

    return shd.spec_map(one, param_specs, param_shapes)


def _skip(name, reason):
    return Cell(name=name, fn=None, args=(), in_specs=(), skip=reason)

# microbatch accumulation per LM arch (activation-memory fit)
LM_ACCUM = {
    "glm4-9b": 8,
    "qwen2-7b": 8,
    "qwen3-0.6b": 2,
    "granite-moe-3b-a800m": 4,
    "olmoe-1b-7b": 4,
}

OPT_CFG = AdamWConfig(lr=3e-4)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _train_state_of(init):
    """The train state of ``init()``'s parameters (drawn on ``meta``): the
    port's ``jax.eval_shape`` of ``init_state(init_params(...))``."""
    from repro_torch.train.state import init_state

    return init_state(init())


def _lm_cell(arch, sspec, rules, *, accum_unroll: bool = False) -> Cell:
    from repro_torch._device import cpu_generator
    from repro_torch.models import transformer as tfm
    from repro_torch.train.state import TrainState, make_train_step

    cfg = arch.config
    name = f"{arch.name}/{sspec.name}"
    B = sspec.dims["global_batch"]
    S = sspec.dims["seq_len"]
    if sspec.name == "long_500k" and not arch.sub_quadratic:
        return _skip(name, "SKIP(full-attn): long_500k is defined for "
                           "sub-quadratic archs only (assignment rule)")

    pspec = shd.to_partition_specs(tfm.logical_specs(cfg), rules)
    init = lambda: tfm.init_params(cfg, cpu_generator(0), device="meta")  # noqa: E731
    params_shape = init()
    bspec = shd.resolve(("batch", None), rules)

    if sspec.kind == "train":
        state_shape = _train_state_of(init)
        ospec = zero1_opt_specs(pspec, params_shape, rules)
        state_spec = TrainState(
            params=pspec, opt={"m": ospec, "v": ospec, "step": P()}, step=P()
        )
        accum = LM_ACCUM.get(arch.name, 1)
        step = make_train_step(
            lambda p, b: tfm.train_loss(p, b, cfg), OPT_CFG, accum_steps=accum,
            accum_unroll=accum_unroll,
        )
        batch = {"tokens": _sds((B, S), torch.int32), "labels": _sds((B, S), torch.int32)}
        bspecs = {"tokens": bspec, "labels": bspec}
        return Cell(name, step, (state_shape, batch), (state_spec, bspecs), donate=(0,),
                    meta={"accum": accum})

    if sspec.kind == "prefill":
        fn = partial(tfm.prefill, cfg=cfg)
        toks = _sds((B, S), torch.int32)
        return Cell(name, fn, (params_shape, toks), (pspec, bspec))

    # decode
    fn = partial(tfm.decode_step, cfg=cfg)
    cache_shape = tfm.make_cache(cfg, B, S, device="meta")
    cache_spec = shd.to_partition_specs(tfm.cache_logical_specs(), rules)
    cl = _sds((B,), torch.int32)
    tok = _sds((B,), torch.int32)
    blk = shd.resolve(("batch",), rules)
    return Cell(
        name, fn,
        (params_shape, cache_shape, cl, tok),
        (pspec, cache_spec, blk, blk),
        donate=(1,),
    )


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _gnn_model(arch):
    if arch.name == "gcn-cora":
        from repro_torch.models.gnn import gcn as mod
    elif arch.name == "pna":
        from repro_torch.models.gnn import pna as mod
    elif arch.name == "nequip":
        from repro_torch.models.gnn import nequip as mod
    else:
        from repro_torch.models.gnn import equiformer_v2 as mod
    return mod


def gnn_shape_config(arch, sspec):
    """Adapt the arch config to a cell: io dims + task come from the shape."""
    cfg = arch.config
    d = sspec.dims
    geometric = arch.name in ("nequip", "equiformer-v2")
    if sspec.name == "molecule":
        task = "graph_reg"
        n_classes = 1
        d_in = 16
    else:
        task = "node_class"
        n_classes = d["n_classes"]
        d_in = d.get("d_feat", 16)
    if geometric:
        return dataclasses.replace(cfg, n_classes=n_classes, task=task)
    return dataclasses.replace(cfg, d_in=d_in, n_classes=n_classes, task=task)


def _pad_div(x: int, mult: int = 32) -> int:
    """Pad a sharded dim to the mesh-divisibility multiple (pod·data = 32
    covers both production meshes); padding rows/edges are mask-zeroed by
    the data pipeline, exactly like sampler padding."""
    return ((x + mult - 1) // mult) * mult


def gnn_batch_shapes(arch, sspec, rules):
    """(GraphBatch of meta tensors, GraphBatch of specs) for a cell."""
    from repro_torch.data.sampler import subgraph_capacities
    from repro_torch.models.gnn.graph import GraphBatch

    d = sspec.dims
    geometric = arch.name in ("nequip", "equiformer-v2")
    f32, i32 = torch.float32, torch.int32
    if sspec.name == "molecule":
        G = d["batch"]
        N = d["n_nodes"] * G
        E = d["n_edges"] * G
        n_graphs, graph_id = G, _sds((N,), i32)
        labels, lmask = _sds((G,), f32), _sds((G,), f32)
        d_in = 16
    elif sspec.name == "minibatch_lg":
        N, E = subgraph_capacities(d["batch_nodes"], (d["fanout0"], d["fanout1"]))
        n_graphs, graph_id = 1, None
        labels, lmask = _sds((N,), i32), _sds((N,), f32)
        d_in = d["d_feat"]
    else:
        N, E = d["n_nodes"], d["n_edges"]
        n_graphs, graph_id = 1, None
        d_in = d["d_feat"]
        N, E = _pad_div(N), _pad_div(E)
        labels, lmask = _sds((N,), i32), _sds((N,), f32)

    N, E = _pad_div(N), _pad_div(E)
    nodes = shd.resolve(("nodes",), rules)
    nodes2 = shd.resolve(("nodes", None), rules)
    edges = shd.resolve(("edges",), rules)

    batch = GraphBatch(
        node_feat=_sds((N, 1 if geometric else d_in), f32),
        edge_src=_sds((E,), i32),
        edge_dst=_sds((E,), i32),
        edge_mask=_sds((E,), f32),
        labels=labels,
        label_mask=lmask,
        positions=_sds((N, 3), f32) if geometric else None,
        species=_sds((N,), i32) if geometric else None,
        graph_id=graph_id,
        n_graphs=n_graphs,
    )
    lspec = nodes if sspec.name != "molecule" else P()
    specs = GraphBatch(
        node_feat=nodes2,
        edge_src=edges,
        edge_dst=edges,
        edge_mask=edges,
        labels=lspec,
        label_mask=lspec,
        positions=nodes2 if geometric else None,
        species=nodes if geometric else None,
        graph_id=nodes if graph_id is not None else None,
        n_graphs=n_graphs,
    )
    return batch, specs


def _gnn_cell(arch, sspec, rules) -> Cell:
    from repro_torch._device import cpu_generator
    from repro_torch.train.state import TrainState, make_train_step

    mod = _gnn_model(arch)
    name = f"{arch.name}/{sspec.name}"
    cfg = gnn_shape_config(arch, sspec)
    pspec = shd.to_partition_specs(mod.logical_specs(cfg), rules)
    state_shape = _train_state_of(lambda: mod.init_params(cfg, cpu_generator(0), device="meta"))
    state_spec = TrainState(params=pspec, opt={"m": pspec, "v": pspec, "step": P()}, step=P())
    step = make_train_step(lambda p, b: mod.loss(p, b, cfg), OPT_CFG)
    batch, bspecs = gnn_batch_shapes(arch, sspec, rules)
    return Cell(name, step, (state_shape, batch), (state_spec, bspecs), donate=(0,))


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------

def _recsys_batch(cfg, B, rules, with_labels):
    ids = _sds((B, cfg.n_fields - cfg.n_multihot), torch.int32)
    bags = _sds((B, cfg.n_multihot, cfg.hot_per_field), torch.int32)
    b = {"ids": ids, "bag_ids": bags}
    shardable = B % 32 == 0  # retrieval_cand has B=1 — replicate it
    bs = shd.resolve(("batch", None), rules) if shardable else P()
    bs3 = shd.resolve(("batch", None, None), rules) if shardable else P()
    specs = {"ids": bs, "bag_ids": bs3}
    if with_labels:
        b["labels"] = _sds((B,), torch.int32)
        specs["labels"] = shd.resolve(("batch",), rules) if shardable else P()
    return b, specs


def _recsys_cell(arch, sspec, rules) -> Cell:
    from repro_torch._device import cpu_generator
    from repro_torch.models import recsys as rs
    from repro_torch.train.state import TrainState, make_train_step

    cfg = arch.config
    name = f"{arch.name}/{sspec.name}"
    pspec = shd.to_partition_specs(rs.logical_specs(cfg), rules)
    init = lambda: rs.init_params(cfg, cpu_generator(0), device="meta")  # noqa: E731
    params_shape = init()

    if sspec.kind == "train":
        state_shape = _train_state_of(init)
        state_spec = TrainState(params=pspec, opt={"m": pspec, "v": pspec, "step": P()}, step=P())
        step = make_train_step(lambda p, b: rs.train_loss(p, b, cfg), OPT_CFG)
        batch, bspecs = _recsys_batch(cfg, sspec.dims["batch"], rules, True)
        return Cell(name, step, (state_shape, batch), (state_spec, bspecs), donate=(0,))

    if sspec.kind == "serve":
        fn = partial(rs.forward_logits, cfg=cfg)
        batch, bspecs = _recsys_batch(cfg, sspec.dims["batch"], rules, False)
        return Cell(name, fn, (params_shape, batch), (pspec, bspecs))

    # retrieval: 1 query vs n_candidates
    NC = sspec.dims["n_candidates"]

    def retrieve(params, batch, candidates):
        q = rs.query_embedding(params, batch, cfg)
        return rs.retrieval_scores(q, candidates)

    batch, bspecs = _recsys_batch(cfg, sspec.dims["batch"], rules, False)
    cands = _sds((NC, 64), torch.float32)
    cspec = shd.resolve(("candidates", None), rules)
    return Cell(name, retrieve, (params_shape, batch, cands), (pspec, bspecs, cspec))


# ---------------------------------------------------------------------------
# spectral (the paper's own architecture)
# ---------------------------------------------------------------------------

def _num_shards(mesh) -> int:
    if mesh is None:
        return 16
    from repro_torch.launch.mesh import mesh_shape

    return math.prod(v for a, v in mesh_shape(mesh).items() if a != "model")


def _sharded_coo_shapes(n_raw, nnz, num_shards, rules):
    from repro_torch.sparse.distributed import ShardedCOO

    rps = math.ceil(n_raw / num_shards)
    eps_ = math.ceil(nnz * 1.05 / num_shards)
    n = rps * num_shards
    sm = ShardedCOO(
        row_local=_sds((num_shards * eps_,), torch.int32),
        col=_sds((num_shards * eps_,), torch.int32),
        val=_sds((num_shards * eps_,), torch.float32),
        shape=(n, n), rows_per_shard=rps, num_shards=num_shards, edges_per_shard=eps_,
    )
    espec = shd.resolve(("edges",), rules)
    return sm, ShardedCOO(espec, espec, espec, sm.shape, rps, num_shards, eps_)


def _local(t):
    """A DTensor's shard on this rank (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _own_bucket(sm):
    """The ShardedCOO this rank's plan holds: its own bucket of the edges
    (the local shards of the edge arrays, sharded over the data axes as the
    reference's specs shard them), the whole layout off a mesh."""
    return dataclasses.replace(sm, row_local=_local(sm.row_local), col=_local(sm.col),
                               val=_local(sm.val))


def spectral_cell(arch, sspec, rules, *, mesh=None, variant: str = "gspmd",
                  gather_dtype=None, data_axes=("pod", "data")) -> Cell:
    """The paper's pipeline on a row-sharded graph of the shape's size; the
    port's ``Plan(device="sharded", mesh=mesh)`` runs it, each rank on its
    own edge bucket and its own row block of the dense Stage-2 and Stage-3
    state (the Krylov basis, the embedding), as the reference's specs shard
    them.  The PRNG key argument stands for the run's seed: the port draws
    from a CPU generator seeded 0."""
    from repro_torch._device import cpu_generator
    from repro_torch.core.pipeline import SpectralClusteringConfig
    from repro_torch.core.spectral import Plan

    name = f"{arch.name}/{sspec.name}" + ("" if variant == "gspmd" else f"[{variant}]")
    d = sspec.dims
    n, nnz, k = d["n_nodes"], d["n_edges"], d["k"]
    sm, sm_spec = _sharded_coo_shapes(n, nnz, _num_shards(mesh), rules)

    scfg = SpectralClusteringConfig(
        n_clusters=k,
        lanczos_m=2 * k,
        fixed_restarts=arch.config.fixed_restarts,
        fixed_kmeans_iters=arch.config.fixed_kmeans_iters,
        kmeans_assign="ref",
    )
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    axis = tuple(a for a in data_axes if mesh is None or a in names)
    axis = axis[0] if len(axis) == 1 else axis
    pipe = scfg.to_pipeline(plan=Plan(device="sharded", mesh=mesh, axis=axis,
                                      variant=variant, gather_dtype=gather_dtype))

    def fn(sm_in, key):
        del key
        sm_in = _own_bucket(sm_in)
        out = pipe.run(sm_in, cpu_generator(0), device=sm_in.val.device)
        return out.labels, out.eigenvalues, out.kmeans_inertia

    key = _sds((2,), torch.uint32)
    return Cell(name, fn, (sm, key), (sm_spec, P()), meta={"k": k, "n": n, "nnz": nnz,
                                                           "variant": variant})


# ---------------------------------------------------------------------------
# cost variants
# ---------------------------------------------------------------------------
# The reference lowers unrolled / component variants because XLA's cost
# analysis counts a loop body once.  The port's dry-run runs each op, so
# its counts are exact for any lowering; the variants are kept so the two
# dry-runs report the same cells:
#   lm        two runs at n_layers ∈ {2, 4}; linear fit
#             total(L) = const + L·per_layer recovers the full-depth cost
#   gnn       edge chunking off, layers unscanned
#   recsys    loop-free already
#   spectral  per-stage component cells (Lanczos step / restart / k-means
#             iteration / k-means++ step) combined with the known trip counts


def lm_cost_cells(arch, shape_name: str, rules):
    """[(n_layers, Cell)] for the linear cost fit."""
    sspec = arch.shapes[shape_name]
    out = []
    for L in (2, 4):
        cfg = dataclasses.replace(
            arch.config, n_layers=L, scan_unroll=True,
            attn_chunk=sspec.dims["seq_len"],
        )
        a = dataclasses.replace(arch, config=cfg)
        cell = _lm_cell(a, sspec, rules, accum_unroll=True)
        cell.name = f"{arch.name}/{shape_name}[cost L={L}]"
        out.append((L, cell))
    return out


def gnn_cost_cell(arch, shape_name: str, rules) -> Optional[Cell]:
    """Loop-free variant: edge chunking off, layer scan unrolled."""
    cfg = arch.config
    sspec = arch.shapes[shape_name]
    replace = {}
    chunk = getattr(cfg, "edge_chunk", None)
    if chunk:
        batch, _ = gnn_batch_shapes(arch, sspec, rules)
        if batch.edge_src.shape[0] > chunk:
            replace["edge_chunk"] = None
    if getattr(cfg, "scan_layers", False) and cfg.n_layers > 1:
        replace["scan_layers"] = False
    if not replace:
        return None  # the production run is already loop-free
    a = dataclasses.replace(arch, config=dataclasses.replace(cfg, **replace))
    cell = _gnn_cell(a, sspec, rules)
    cell.name = f"{arch.name}/{shape_name}[cost {','.join(replace)}]"
    return cell


def spectral_component_cells(arch, shape_name: str, rules, *, mesh=None,
                             variant: str = "gspmd", gather_dtype=None,
                             data_axes=("pod", "data")):
    """Per-stage cells + trip counts: [(label, Cell, trip_count)].

    Each computes as the port's plan does, on the reference's specs: a
    rank's own edge bucket, and its own rows of the Krylov basis V (spec
    (None, "nodes")), of the Lanczos vector v ("nodes") and of the
    embedding h ("nodes", None); a contraction over the nodes all-reduces
    its small result.  Stage 3's iteration is the fused ``kmeans_iter``
    (B2) with the packed all-reduce of ``kmeans_sharded``; a k-means++ step
    scores the rank's rows against its own columns of the Gumbel row, takes
    the global argmax from the ranks' best pairs (one all-gather of [1, 2])
    and fetches the drawn row with one all-reduce of [1, k]."""
    from repro_torch.core.distributed_pipeline import fetch_rows, global_argmax
    from repro_torch.core.kmeans import centroids_from_sums
    from repro_torch.core.operator import ShardedCooOperator
    from repro_torch.kernels.kmeans_iter.ops import kmeans_iter
    from repro_torch.sparse.distributed import RowBlock, mesh_axis

    sspec = arch.shapes[shape_name]
    d = sspec.dims
    n_raw, nnz, k = d["n_nodes"], d["n_edges"], d["k"]
    m = 2 * k
    sm, sm_spec = _sharded_coo_shapes(n_raw, nnz, _num_shards(mesh), rules)
    n = sm.shape[0]
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    axis = tuple(a for a in data_axes if mesh is None or a in names)
    axis = axis[0] if len(axis) == 1 else axis

    vspec = shd.resolve(("nodes",), rules)
    Vspec = shd.resolve((None, "nodes"), rules)
    hspec = shd.resolve(("nodes", None), rules)

    def operator_of(sm_in):
        return ShardedCooOperator(_own_bucket(sm_in), variant=variant, mesh=mesh, axis=axis,
                                  gather_dtype=gather_dtype)

    def rows():
        return RowBlock.whole(n) if mesh is None else RowBlock.of(mesh_axis(mesh, axis), n)

    # (a) one Lanczos step: operator application + coefficient + two-pass reorth
    def lanczos_step(sm_in, V, v):
        V, v, r = _local(V), _local(v), rows()
        w = operator_of(sm_in).mv(v)
        c = r.psum(V @ w)
        w = w - V.T @ c
        c2 = r.psum(V @ w)
        w = w - V.T @ c2
        return w, c

    V = _sds((m + 1, n), torch.float32)
    v = _sds((n,), torch.float32)
    step_cell = Cell(f"{arch.name}/{shape_name}[lanczos_step]", lanczos_step,
                     (sm, V, v), (sm_spec, Vspec, vspec))

    # (b) restart: projected eigh + thick-restart basis rotation
    l_keep = min(m - 1, k + max(1, (m - k) // 2))

    def restart(T, V):
        theta, S = torch.linalg.eigh(_local(T))
        Y = S[:, m - l_keep:].T @ _local(V)[:m]
        return theta, Y

    T = _sds((m, m), torch.float32)
    restart_cell = Cell(f"{arch.name}/{shape_name}[restart]", restart, (T, V), (P(), Vspec))

    # (c) one k-means (Lloyd) iteration on the n×k embedding: the fused B2
    # on a rank's rows, its [Σx | counts] all-reduced
    def km_iter(h, C):
        h, C = _local(h), _local(C)
        labels, dmin, sums, counts = kmeans_iter(h, C)
        packed = rows().psum(torch.cat([sums.float(), counts.float()[:, None]], 1))
        return labels, centroids_from_sums(packed[:, :k], packed[:, k], C), dmin.sum()

    h = _sds((n, k), torch.float32)
    C = _sds((k, k), torch.float32)
    km_cell = Cell(f"{arch.name}/{shape_name}[kmeans_iter]", km_iter, (h, C), (hspec, P()))

    # (d) one k-means++ seeding step over a rank's rows
    def kmpp_step(h, c, dist2, g):
        h, c, dist2, g = (_local(t) for t in (h, c, dist2, g))
        r = rows()
        d2 = torch.clamp((h * h).sum(1) - 2.0 * (h @ c) + (c * c).sum(), min=0.0)
        dist2 = torch.minimum(dist2, d2)
        idx = global_argmax(torch.log(torch.clamp(dist2, min=1e-30)) + g, r)
        return dist2, fetch_rows(h, idx.view(1), r)[0]

    kmpp_cell = Cell(f"{arch.name}/{shape_name}[kmeanspp_step]", kmpp_step,
                     (h, _sds((k,), torch.float32), _sds((n,), torch.float32),
                      _sds((n,), torch.float32)),
                     (hspec, P(), vspec, vspec))

    restarts = arch.config.fixed_restarts
    km_iters = arch.config.fixed_kmeans_iters
    n_steps = m + restarts * (m - l_keep)
    return [
        ("lanczos_step", step_cell, n_steps),
        ("restart", restart_cell, restarts + 1),
        ("kmeans_iter", km_cell, km_iters),
        ("kmeanspp_step", kmpp_cell, k),
    ]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def build_cell(arch, shape_name: str, rules, *, mesh=None, **kw) -> Cell:
    sspec = arch.shapes[shape_name]
    if arch.family == "lm":
        return _lm_cell(arch, sspec, rules)
    if arch.family == "gnn":
        return _gnn_cell(arch, sspec, rules)
    if arch.family == "recsys":
        return _recsys_cell(arch, sspec, rules)
    if arch.family == "spectral":
        return spectral_cell(arch, sspec, rules, mesh=mesh, **kw)
    raise ValueError(arch.family)


def all_cells(archs) -> list:
    out = []
    for a in archs:
        for s in a.shapes:
            out.append((a, s))
    return out
