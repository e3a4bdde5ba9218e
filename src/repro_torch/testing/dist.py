"""Run a function on S ranks of a ``torch.distributed`` group, and the rank
bodies of the sharded plan's checks.

    from repro_torch.testing.dist import run_ranks, knn_rank
    outs = run_ranks(knn_rank, 4, spec, tmpdir="/tmp/x")   # one result a rank

Each rank is a process started with the ``spawn`` method.  The rendezvous is
a ``FileStore`` in ``tmpdir`` (no TCP port, so concurrent runs never
collide), ``init_process_group`` gets ``timeout``, and the parent waits at
most ``join_timeout`` for all ranks, then kills every one still alive and
raises.  A rank returns its result through a file in ``tmpdir``; a rank that
fails writes its traceback there, and the parent raises with it (or, for a
rank killed by a signal, with the end of its standard error, which goes to
``rank<r>.log`` in ``tmpdir``).

The rank bodies below take ``(rank, world, spec)``: ``spec`` is a dict of
numpy arrays and plain values, ``spec["mesh"]`` the mesh's shape and
dimension names, ``spec["device"]`` ``"cpu"`` or ``"cuda"``.  Every rank
gets the same inputs, as every rank of the sharded plan does.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
import traceback
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, tmpdir: str, backend: str, timeout: float) -> None:
    with open(os.path.join(tmpdir, f"rank{rank}.log"), "w") as log:
        os.dup2(log.fileno(), 2)  # native aborts write here, not over the parent's output
    torch.set_num_threads(1)  # S ranks share the host's cores
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        fn, args = torch.load(os.path.join(tmpdir, "call.pt"), weights_only=False)
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmpdir, "store"), world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmpdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, *args, tmpdir: str, backend: str = "gloo",
              timeout: float = 60.0, join_timeout: float = 120.0) -> List:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its own
    process of one process group.  ``fn`` and ``args`` must pickle (``fn``
    by import path).  Raises ``TimeoutError`` after ``join_timeout``
    seconds with every rank killed, ``RuntimeError`` with the first failed
    rank's traceback."""
    os.makedirs(tmpdir, exist_ok=True)
    # the call goes through a file: a start-up message larger than a pipe's
    # buffer would make each start wait for the previous rank's imports
    torch.save((fn, args), os.path.join(tmpdir, "call.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, tmpdir, backend, timeout),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in alive:
            p.join(10.0)
    if alive:
        raise TimeoutError(f"{len(alive)} of {world} ranks still running after "
                           f"{join_timeout:g} s; killed")
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            err = os.path.join(tmpdir, f"rank{r}.err")
            if os.path.exists(err):
                text = open(err).read()
            else:
                with open(os.path.join(tmpdir, f"rank{r}.log")) as f:
                    text = "(no traceback written; its standard error ends)\n" + f.read()[-2000:]
            raise RuntimeError(f"rank {r} of {world} exited with {p.exitcode}:\n{text}")
    return [torch.load(os.path.join(tmpdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

def _mesh(spec: dict):
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = spec.get("mesh", ((dist.get_world_size(),), ("data",)))
    return init_device_mesh(spec.get("mesh_device", "cpu"), tuple(shape),
                            mesh_dim_names=tuple(names))


def _device(spec: dict) -> torch.device:
    from repro_torch._device import resolve_device

    name = spec.get("device", "cpu")
    return resolve_device(None if name == "cuda" else name)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _counts() -> dict:
    from repro_torch.sparse.distributed import COLLECTIVES, collective_bytes

    return {"calls": dict(COLLECTIVES.calls), "bytes": collective_bytes()}


def tasks_rank(rank: int, world: int, tasks: list) -> list:
    """Several rank bodies in one process group: ``tasks`` is a list of
    ``(body name, spec)``; one result each, in order."""
    return [globals()[name](rank, world, spec) for name, spec in tasks]


def knn_rank(rank: int, world: int, spec: dict) -> dict:
    """``make_knn_rowblock(**spec["knn"])`` on this rank's block of
    ``spec["x"]``: its (dist², ids) rows and the collectives it made.  With
    ``spec["planes"]`` the LSH hyperplanes are those, not ``make_planes``'s
    (how parity tests put the reference's planes in)."""
    from repro_torch.core import distributed_pipeline as tdp
    from repro_torch.core.distributed_pipeline import make_knn_rowblock
    from repro_torch.kernels.lsh_candidates import ops as lsh_ops
    from repro_torch.sparse.distributed import COLLECTIVES, mesh_axis, shard_vector

    mesh, dev = _mesh(spec), _device(spec)
    axis = spec["knn"].get("axis", "data")
    x = shard_vector(mesh, torch.as_tensor(spec["x"], device=dev), axis)
    knn = make_knn_rowblock(mesh, **spec["knn"])
    saved = lsh_ops.make_planes, tdp.make_planes
    if "planes" in spec:
        planes = torch.as_tensor(spec["planes"])
        lsh_ops.make_planes = tdp.make_planes = lambda *a, **kw: planes
    try:
        COLLECTIVES.reset()
        d, i = knn(x)
    finally:
        lsh_ops.make_planes, tdp.make_planes = saved
    return {"dist": _np(d), "idx": _np(i), "coord": mesh_axis(mesh, axis).rank, **_counts()}


def kmeans_rank(rank: int, world: int, spec: dict) -> dict:
    """``kmeans_sharded`` of this rank's rows of ``spec["x"]`` under
    ``KMeansConfig(**spec["cfg"])`` (from ``spec["init"]`` when given, else
    seeded from ``spec["seed"]``), with the k-means kernels' launches on
    the card (``launches``)."""
    from repro_torch._device import cpu_generator
    from repro_torch.core.distributed_pipeline import kmeans_sharded
    from repro_torch.core.kmeans import KMeansConfig
    from repro_torch.sparse.distributed import COLLECTIVES, shard_vector

    mesh, dev = _mesh(spec), _device(spec)
    axis = spec.get("axis", "data")
    x = shard_vector(mesh, torch.as_tensor(spec["x"], device=dev), axis)
    init = spec.get("init")
    kernels = _kmeans_wrappers()
    for fn in kernels:
        fn.launches = 0
    COLLECTIVES.reset()
    res = kmeans_sharded(x, KMeansConfig(**spec["cfg"]), cpu_generator(spec.get("seed", 0)),
                         mesh=mesh, axis=axis,
                         init_centroids=None if init is None else torch.as_tensor(init, device=dev))
    return {"labels": _np(res.labels), "centroids": _np(res.centroids),
            "inertia": float(res.inertia), "iterations": res.iterations,
            "launches": {fn.__name__: fn.launches for fn in kernels}, **_counts()}


def _kmeans_wrappers() -> tuple:
    """The k-means kernels' wrappers, whose ``launches`` count their
    launches on the card."""
    from repro_torch.kernels.kmeans_assign.ops import kmeans_assign
    from repro_torch.kernels.kmeans_iter.ops import kmeans_iter

    return kmeans_assign, kmeans_iter


def operator_rank(rank: int, world: int, spec: dict) -> dict:
    """``ShardedCooOperator(mesh=...)`` products ``mv`` and ``mm`` of this
    rank's rows of ``spec["x"]`` over the COO ``spec["graph"]`` (row, col,
    val, n) partitioned onto the mesh axis, and ``make_sharded_spmm`` given
    only this rank's bucket (``shard_edges``), and ``mm`` of a column-major
    block: the collectives of the first two products, each product's rows
    (``*_rows``) and, gathered after the count, the whole products."""
    from repro_torch.core.operator import ShardedCooOperator
    from repro_torch.sparse.distributed import (COLLECTIVES, all_gather, make_sharded_spmm,
                                                mesh_axis, partition_coo_by_rows, shard_edges,
                                                shard_vector)
    from repro_torch.sparse.formats import COO

    mesh, dev = _mesh(spec), _device(spec)
    ax = mesh_axis(mesh)
    g = spec["graph"]
    w = COO(torch.as_tensor(g["row"], device=dev).long(), torch.as_tensor(g["col"], device=dev).long(),
            torch.as_tensor(g["val"], device=dev), (g["n"], g["n"]))
    sm = partition_coo_by_rows(w, ax.size)
    op = ShardedCooOperator(sm, variant="shard_map", mesh=mesh,
                            gather_dtype=spec.get("gather_dtype"))
    x = shard_vector(mesh, torch.as_tensor(spec["x"], device=dev))
    COLLECTIVES.reset()
    mv, mm = op.mv(x[:, 0]), op.mm(x)
    out = _counts()
    bucket = make_sharded_spmm(mesh, sm)(*shard_edges(mesh, sm), x)
    by_cols = op.mm(x.T.contiguous().T)  # a column-major block, as Lanczos slices one
    for name, y in (("mv", mv), ("mm", mm), ("mm_bucket", bucket), ("mm_colmajor", by_cols)):
        out[f"{name}_rows"] = tuple(y.shape)
        out[name] = _np(all_gather(y, ax))
    return out


def ell_operator_rank(rank: int, world: int, spec: dict) -> dict:
    """``SpectralPipeline.operator`` under ``representation="blockell"``
    and ``Plan(gather_dtype=spec.get("gather_dtype"))`` on the mesh, of the
    COO ``spec["graph"]`` (row, col, val, n), applied to this rank's rows
    of ``spec["x"]`` [n, b]: ``mv`` of its first column, ``mm``, ``mm`` of a
    column-major block and the fused ``cheb_step`` with ``spec["prev"]``'s
    rows and (ca, cb) = (0.5, −0.25).  The operator's class, the
    collectives of ``mv`` and ``mm``, each product's rows (``*_rows``) and,
    gathered after the count, the whole products; and the class of the
    operator the same plan gives the graph partitioned onto the mesh axis
    (``operator_sharded``), with its ``mv`` and ``mm`` (``*_sharded``)."""
    from repro_torch.core.spectral import EigConfig, GraphState, Plan, SpectralPipeline
    from repro_torch.sparse.distributed import (COLLECTIVES, all_gather, mesh_axis,
                                                partition_coo_by_rows, shard_vector)
    from repro_torch.sparse.formats import COO

    mesh, dev = _mesh(spec), _device(spec)
    ax = mesh_axis(mesh)
    g = spec["graph"]
    w = COO(torch.as_tensor(g["row"], device=dev).long(), torch.as_tensor(g["col"], device=dev).long(),
            torch.as_tensor(g["val"], device=dev), (g["n"], g["n"]))
    pipe = SpectralPipeline(n_clusters=2, eig=EigConfig(representation="blockell"),
                            plan=Plan(device="sharded", variant="shard_map", mesh=mesh,
                                      gather_dtype=spec.get("gather_dtype")))
    x = shard_vector(mesh, torch.as_tensor(spec["x"], device=dev))
    prev = shard_vector(mesh, torch.as_tensor(spec["prev"], device=dev))
    op = pipe.operator(GraphState(w, None, None))
    out = {"operator": type(op).__name__}
    COLLECTIVES.reset()
    mv, mm = op.mv(x[:, 0]), op.mm(x)
    out.update(_counts())
    products = (("mv", mv), ("mm", mm), ("mm_colmajor", op.mm(x.T.contiguous().T)),
                ("cheb", op.cheb_step(x, prev, 0.5, -0.25)))
    sharded = pipe.operator(GraphState(partition_coo_by_rows(w, ax.size), None, None))
    out["operator_sharded"] = type(sharded).__name__
    products += (("mv_sharded", sharded.mv(x[:, 0])), ("mm_sharded", sharded.mm(x)))
    for name, y in products:
        out[f"{name}_rows"] = tuple(y.shape)
        out[name] = _np(all_gather(y, ax))
    return out


def eigsh_rank(rank: int, world: int, spec: dict) -> dict:
    """``lanczos.eigsh`` under ``LanczosConfig(**spec["cfg"])`` of the mesh
    operator over the COO ``spec["graph"]`` (row, col, val, n) partitioned
    onto the mesh axis (its padding rows marked, as the pipeline marks
    them, when n does not divide by the ranks): the eigenvalues, this
    rank's rows of the eigenvectors and how many random directions the
    careful path drew."""
    import repro_torch.core.lanczos as lz
    from repro_torch._device import cpu_generator
    from repro_torch.core.operator import ShardedCooOperator
    from repro_torch.sparse.distributed import mesh_axis, partition_coo_by_rows
    from repro_torch.sparse.formats import COO

    mesh, dev = _mesh(spec), _device(spec)
    g = spec["graph"]
    w = COO(torch.as_tensor(g["row"], device=dev).long(), torch.as_tensor(g["col"], device=dev).long(),
            torch.as_tensor(g["val"], device=dev), (g["n"], g["n"]))
    op = ShardedCooOperator(partition_coo_by_rows(w, mesh_axis(mesh).size), mesh=mesh,
                            live_rows=g["n"])
    with _refills() as refills:
        res = lz.eigsh(op, lz.LanczosConfig(**spec["cfg"]),
                       generator=cpu_generator(spec.get("seed", 0)))
    return {"eigenvalues": _np(res.eigenvalues), "eigenvectors": _np(res.eigenvectors),
            "refills": len(refills)}


def qr_rank(rank: int, world: int, spec: dict) -> dict:
    """``RowBlock.qr`` of this rank's rows of ``spec["w"]`` [n, b] over the
    mesh axis: its rows of Q and the whole R."""
    from repro_torch.sparse.distributed import RowBlock, mesh_axis

    mesh, dev = _mesh(spec), _device(spec)
    w = torch.as_tensor(spec["w"], device=dev)
    rows = RowBlock.of(mesh_axis(mesh), w.shape[0])
    q, r = rows.qr(rows.take(w))
    return {"q": _np(q), "r": _np(r)}


def pipeline_rank(rank: int, world: int, spec: dict) -> dict:
    """``SpectralPipeline.from_dict(spec["pipeline"], mesh=...).run_state``
    on ``spec["x"]`` (points, with ``spec["points"]`` as the search
    coordinates when given) or on ``spec["graph"]`` (a COO's row, col, val,
    n) partitioned onto the mesh axis — with ``spec["own_bucket"]`` each
    rank is handed only its own bucket of it, with ``spec["as_coo"]`` the
    graph is handed over as the COO itself; the labels, this rank's rows
    of the embedding, the eigenvalues, the stage trail, the collectives the
    run made, the row counts of the vectors and blocks the eigensolver
    applied the operator to (``basis_rows``), the operators' classes
    (``operators``), the real rows of those that pad the graph's
    (``live_rows``), the BlockELL kernels' launches on the card
    (``launches``), and how many random directions Lanczos' careful path
    drew (``refills``).  With ``spec["draws"]`` the
    Chebyshev solver's three draws are those arrays, not ``draw_signals``'s
    (how parity tests put the reference's draws in).  ``stage3`` holds
    Stage 3's collectives and, with ``spec["gathered"]``, ``kmeans`` run
    once more on the embedding gathered whole from the same generator
    (``gathered_labels``)."""
    import repro_torch.core.chebyshev as cheb
    from repro_torch._device import cpu_generator
    from repro_torch.core.spectral import SpectralPipeline
    from repro_torch.sparse.distributed import COLLECTIVES, mesh_axis, partition_coo_by_rows
    from repro_torch.sparse.formats import COO

    mesh, dev = _mesh(spec), _device(spec)
    pipe = SpectralPipeline.from_dict(spec["pipeline"], mesh=mesh)
    gen = cpu_generator(spec.get("seed", 0))
    draw_signals = cheb.draw_signals
    if "draws" in spec:
        cheb.draw_signals = lambda gen, n, n_probes, r, device: tuple(
            torch.as_tensor(a, device=device) for a in spec["draws"])
    COLLECTIVES.reset()
    kernels = _ell_wrappers()
    for fn in kernels:
        fn.launches = 0
    with _basis_rows() as products, _refills() as refills, _stage3() as stage3:
        if "graph" in spec:
            g = spec["graph"]
            w = COO(torch.as_tensor(g["row"], device=dev).long(),
                    torch.as_tensor(g["col"], device=dev).long(),
                    torch.as_tensor(g["val"], device=dev), (g["n"], g["n"]))
            ax = mesh_axis(mesh, pipe.plan.axis)
            if spec.get("as_coo"):
                graph = w
            else:
                graph = partition_coo_by_rows(w, ax.size)
                if spec.get("own_bucket"):  # the rank is handed only its own edges
                    rl, c, v = graph.bucket(ax.rank)
                    graph = dataclasses.replace(graph, row_local=rl, col=c, val=v)
            st = pipe.run_state(graph, gen, device=dev)
        else:
            st = pipe.run_state(spec["x"], gen, points=spec.get("points"), device=dev)
    cheb.draw_signals = draw_signals
    res = st.result
    out = {"labels": _np(res.labels), "embedding": _np(res.embedding),
           "eigenvalues": _np(res.eigenvalues), "kmeans_iterations": res.kmeans_iterations,
           "provenance": st.provenance, "basis_rows": sorted(set(products.rows)),
           "operators": sorted(products.kinds), "live_rows": sorted(products.live),
           "refills": len(refills),
           "launches": {fn.__name__: fn.launches for fn in kernels}, **_counts(),
           "stage3": stage3.counts}
    if spec.get("gathered"):  # the route that gathers the embedding, from the same seeds
        from repro_torch.core import kmeans as km
        from repro_torch.sparse.distributed import gather_rows

        ax = pipe._split_axis()
        h = gather_rows(st.embedding.embedding, ax, pipe._embedding_rows(st.embedding))
        gen3 = torch.Generator()
        gen3.set_state(stage3.generator_state)
        out["gathered_labels"] = _np(km.kmeans(h, stage3.kcfg, gen3).labels)
    return out


def _ell_wrappers() -> tuple:
    """The BlockELL kernels' wrappers, whose ``launches`` count their
    launches on the card."""
    from repro_torch.kernels.ell_spmm.ops import ell_spmm, ell_spmm_cheb_step
    from repro_torch.kernels.ell_spmv.ops import ell_spmv

    return ell_spmv, ell_spmm, ell_spmm_cheb_step


def checkpoint_rank(rank: int, world: int, spec: dict) -> dict:
    """``pipeline_rank``'s run of ``spec["graph"]``, its state saved with
    ``state_io.save_state`` (this rank's directory under ``spec["dir"]``)
    and loaded back with the pipeline: the saved embeddings' shapes, this
    rank's rows, and whether the loaded rows are the run's."""
    from repro_torch._device import cpu_generator
    from repro_torch.core import state_io
    from repro_torch.core.spectral import SpectralPipeline
    from repro_torch.sparse.distributed import mesh_axis, partition_coo_by_rows
    from repro_torch.sparse.formats import COO

    mesh, dev = _mesh(spec), _device(spec)
    pipe = SpectralPipeline.from_dict(spec["pipeline"], mesh=mesh)
    g = spec["graph"]
    w = COO(torch.as_tensor(g["row"], device=dev).long(), torch.as_tensor(g["col"], device=dev).long(),
            torch.as_tensor(g["val"], device=dev), (g["n"], g["n"]))
    sm = partition_coo_by_rows(w, mesh_axis(mesh, pipe.plan.axis).size)
    st = pipe.run_state(sm, cpu_generator(0), device=dev)
    tree = state_io.state_to_tree(st, pipe)
    directory = state_io.save_state(os.path.join(spec["dir"], f"rank{rank}"), st, pipe)
    back, _ = state_io.load_state(directory, pipe, device=dev)
    return {"saved": {k: tree[k].shape for k in ("embedding.embedding", "result.embedding")},
            "rows": _np(st.result.embedding), "whole": tree["result.embedding"],
            "loaded_equal": bool(torch.equal(back.result.embedding, st.result.embedding)
                                 and torch.equal(back.embedding.embedding,
                                                 st.embedding.embedding))}


class _basis_rows:
    """Records the row count of every vector block the eigensolvers run on
    (each row-distributed operator product's input: ``rows``), the
    operators' classes (``kinds``) and their real rows when they pad the
    graph's (``live``) while it is entered."""

    def _products(self):
        from repro_torch.core.operator import RowBlockEllOperator, ShardedCooOperator

        return [(ShardedCooOperator, "mv"), (ShardedCooOperator, "mm"),
                (RowBlockEllOperator, "mv"), (RowBlockEllOperator, "mm"),
                (RowBlockEllOperator, "cheb_step")]

    def __enter__(self) -> "_basis_rows":
        self.rows, self.kinds, self.live = [], set(), set()
        self.saved = [getattr(c, name) for c, name in self._products()]

        def spy(fn):
            def product(op, x, *a):
                self.rows.append(int(x.shape[0]))
                self.kinds.add(type(op).__name__)
                if op.rows.live is not None:
                    self.live.add(op.rows.live)
                return fn(op, x, *a)
            return product

        for (c, name), fn in zip(self._products(), self.saved):
            setattr(c, name, spy(fn))
        return self

    def __exit__(self, *exc):
        for (c, name), fn in zip(self._products(), self.saved):
            setattr(c, name, fn)


class _stage3:
    """Records Stage 3's collectives (``counts``), its config and the state
    of the generator it was handed while it is entered."""

    def __enter__(self) -> "_stage3":
        from repro_torch.core.spectral import SpectralPipeline
        from repro_torch.sparse.distributed import COLLECTIVES

        self.saved, self.counts = SpectralPipeline._run_kmeans, None

        def run_kmeans(pipe, h, n, kcfg, generator):
            self.kcfg, self.generator_state = kcfg, generator.get_state()
            calls, sent = dict(COLLECTIVES.calls), dict(COLLECTIVES.bytes)
            res = self.saved(pipe, h, n, kcfg, generator)
            self.counts = {"calls": {k: COLLECTIVES.calls[k] - calls[k] for k in calls},
                           "bytes": {k: COLLECTIVES.bytes[k] - sent[k] for k in sent}}
            return res

        SpectralPipeline._run_kmeans = run_kmeans
        return self

    def __exit__(self, *exc):
        from repro_torch.core.spectral import SpectralPipeline

        SpectralPipeline._run_kmeans = self.saved


class _refills:
    """Records each random direction Lanczos' careful path draws while it
    is entered."""

    NAMES = ("_orthonormal_against", "_orthonormal_block_against")

    def __enter__(self) -> list:
        import repro_torch.core.lanczos as lz

        self.calls, self.saved = [], [getattr(lz, name) for name in self.NAMES]
        for name, fn in zip(self.NAMES, self.saved):
            def drawn(*a, _fn=fn, **kw):
                self.calls.append(1)
                return _fn(*a, **kw)
            setattr(lz, name, drawn)
        return self.calls

    def __exit__(self, *exc):
        import repro_torch.core.lanczos as lz

        for name, fn in zip(self.NAMES, self.saved):
            setattr(lz, name, fn)


def launch_rank(rank: int, world: int, spec: dict) -> dict:
    """``launch.train.main(spec["argv"])`` on this rank, its initial
    parameters ``spec["init"]`` when given (a flat ``{"/"-joined key path:
    array}`` dict, the tree ``init_params`` would draw — how parity tests
    put the reference's initial weights in); rank 0's printed lines."""
    import contextlib
    import io

    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tfm

    init = spec.get("init")
    drawn = tfm.init_params
    if init is not None:
        def given(cfg, gen, *, device=None):
            tree: dict = {}
            for path, a in init.items():
                *outer, last = path.split("/")
                node = tree
                for k in outer:
                    node = node.setdefault(k, {})
                node[last] = torch.tensor(a, device=device)
            return tree

        tfm.init_params = given
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            launch_train.main(spec["argv"])
    finally:
        tfm.init_params = drawn
    return {"lines": out.getvalue().splitlines()}


def moe_rank(rank: int, world: int, spec: dict) -> dict:
    """``moe_ffn_shard_map`` of ``spec["x"]`` [T, d] under ``spec["p"]``
    (one layer's router and experts) and ``MoEConfig(**spec["cfg"])`` on the
    mesh, with the gradients of ``Σ y² + aux`` taken: y whole, the aux
    losses and the parameters' and x's gradients whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import rules_for_mesh
    from repro_torch.models.moe import MoEConfig, moe_ffn_shard_map

    mesh = _mesh(spec)
    cfg = MoEConfig(**spec["cfg"])
    p = {k: torch.as_tensor(v).requires_grad_() for k, v in spec["p"].items()}
    x = torch.as_tensor(spec["x"]).requires_grad_()
    with shd.axis_rules(rules_for_mesh(mesh), mesh):
        y, aux = moe_ffn_shard_map(p, x, cfg, mesh)
        loss = (y * y).sum() + aux["load_balance"] + aux["router_z"]
        loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
        loss.backward()
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa: E731
    return {"y": _np(whole(y)), "load_balance": float(whole(aux["load_balance"])),
            "router_z": float(whole(aux["router_z"])),
            "grads": {k: _np(v.grad) for k, v in p.items()}, "x_grad": _np(x.grad)}


def compress_rank(rank: int, world: int, spec: dict) -> dict:
    """``compressed_psum_mean`` of this rank's ``spec["grad"][rank]`` and
    ``spec["residual"][rank]`` over the default group."""
    from repro_torch.optim.compress import compressed_psum_mean

    mean, res = compressed_psum_mean(torch.as_tensor(spec["grad"][rank]),
                                     torch.as_tensor(spec["residual"][rank]))
    return {"mean": _np(mean), "residual": _np(res)}


def reshard_rank(rank: int, world: int, spec: dict) -> dict:
    """``reshard_tree`` of ``spec["tree"]`` (flat name → array) by
    ``spec["logical"]`` (name → logical axes) under the mesh's rules, then
    each leaf gathered back whole: placements and whole leaves."""
    from repro_torch.ckpt.elastic import reshard_tree
    from repro_torch.launch.mesh import rules_for_mesh
    from repro_torch.launch.sharding import logical_spec

    mesh = _mesh(spec)
    tree = {k: torch.as_tensor(v) for k, v in spec["tree"].items()}
    logical = {k: logical_spec(v) for k, v in spec["logical"].items()}
    out = reshard_tree(tree, logical, rules_for_mesh(mesh), mesh)
    return {k: {"placements": [repr(p) for p in v.placements],
                "local_shape": tuple(v.to_local().shape), "whole": _np(v.full_tensor())}
            for k, v in out.items()}


def elastic_rank(rank: int, world: int, spec: dict) -> dict:
    """``plan_elastic_mesh(world, spec["model"])`` and then the launcher
    with ``--elastic`` on ``spec["argv"]``: this rank's coordinate in the
    planned mesh (None when left out) and whether the launcher returned a
    state."""
    from repro_torch.ckpt.elastic import plan_elastic_mesh
    from repro_torch.launch import train as launch_train

    mesh = plan_elastic_mesh(world, spec["model"], device_type="cpu")
    state = launch_train.main(spec["argv"] + ["--elastic", "--model-parallel",
                                              str(spec["model"])])
    coord = mesh.get_coordinate()
    return {"coordinate": None if coord is None else list(coord),
            "trained": state is not None}
