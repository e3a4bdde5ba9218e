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
    """``kmeans_sharded`` of ``spec["x"]`` under ``KMeansConfig(**spec["cfg"])``
    (from ``spec["init"]`` when given, else seeded from ``spec["seed"]``)."""
    from repro_torch._device import cpu_generator
    from repro_torch.core.distributed_pipeline import kmeans_sharded
    from repro_torch.core.kmeans import KMeansConfig
    from repro_torch.sparse.distributed import COLLECTIVES

    mesh, dev = _mesh(spec), _device(spec)
    x = torch.as_tensor(spec["x"], device=dev)
    init = spec.get("init")
    COLLECTIVES.reset()
    res = kmeans_sharded(x, KMeansConfig(**spec["cfg"]), cpu_generator(spec.get("seed", 0)),
                         mesh=mesh, axis=spec.get("axis", "data"),
                         init_centroids=None if init is None else torch.as_tensor(init, device=dev))
    return {"labels": _np(res.labels), "centroids": _np(res.centroids),
            "inertia": float(res.inertia), "iterations": res.iterations, **_counts()}


def operator_rank(rank: int, world: int, spec: dict) -> dict:
    """``ShardedCooOperator(mesh=...)`` products ``mv`` and ``mm`` of
    ``spec["x"]`` over the COO ``spec["graph"]`` (row, col, val, n)
    partitioned onto the mesh axis, and ``make_sharded_spmm`` given only
    this rank's bucket (``shard_edges``)."""
    from repro_torch.core.operator import ShardedCooOperator
    from repro_torch.sparse.distributed import (COLLECTIVES, make_sharded_spmm, mesh_axis,
                                                partition_coo_by_rows, shard_edges)
    from repro_torch.sparse.formats import COO

    mesh, dev = _mesh(spec), _device(spec)
    g = spec["graph"]
    w = COO(torch.as_tensor(g["row"], device=dev).long(), torch.as_tensor(g["col"], device=dev).long(),
            torch.as_tensor(g["val"], device=dev), (g["n"], g["n"]))
    sm = partition_coo_by_rows(w, mesh_axis(mesh).size)
    op = ShardedCooOperator(sm, variant="shard_map", mesh=mesh,
                            gather_dtype=spec.get("gather_dtype"))
    x = torch.as_tensor(spec["x"], device=dev)
    COLLECTIVES.reset()
    out = {"mv": _np(op.mv(x[:, 0])), "mm": _np(op.mm(x)), **_counts()}
    out["mm_bucket"] = _np(make_sharded_spmm(mesh, sm)(*shard_edges(mesh, sm), x))
    return out


def pipeline_rank(rank: int, world: int, spec: dict) -> dict:
    """``SpectralPipeline.from_dict(spec["pipeline"], mesh=...).run_state``
    on ``spec["x"]`` (points, with ``spec["points"]`` as the search
    coordinates when given) or on ``spec["graph"]`` (a COO's row, col, val,
    n) partitioned onto the mesh axis — with ``spec["own_bucket"]`` each
    rank is handed only its own bucket of it; the labels, embedding, eigenvalues,
    the stage trail and the collectives the run made.  With
    ``spec["flip_off_home"]`` the eigensolver of every rank but coordinate
    0 returns its last eigenvector negated, as the card's rounding can flip
    an eigenvector's sign on one rank and not on another."""
    import repro_torch.core.lanczos as lz
    from repro_torch._device import cpu_generator
    from repro_torch.core.spectral import SpectralPipeline
    from repro_torch.sparse.distributed import COLLECTIVES, mesh_axis, partition_coo_by_rows
    from repro_torch.sparse.formats import COO

    mesh, dev = _mesh(spec), _device(spec)
    pipe = SpectralPipeline.from_dict(spec["pipeline"], mesh=mesh)
    gen = cpu_generator(spec.get("seed", 0))
    eigsh = lz.eigsh
    if spec.get("flip_off_home") and mesh_axis(mesh, pipe.plan.axis).rank:
        def flipped(*a, **kw):
            res = eigsh(*a, **kw)
            vecs = res.eigenvectors.clone()
            vecs[:, -1] = -vecs[:, -1]
            return res._replace(eigenvectors=vecs)

        lz.eigsh = flipped
    COLLECTIVES.reset()
    try:
        if "graph" in spec:
            g = spec["graph"]
            w = COO(torch.as_tensor(g["row"], device=dev).long(),
                    torch.as_tensor(g["col"], device=dev).long(),
                    torch.as_tensor(g["val"], device=dev), (g["n"], g["n"]))
            ax = mesh_axis(mesh, pipe.plan.axis)
            sm = partition_coo_by_rows(w, ax.size)
            if spec.get("own_bucket"):  # the rank is handed only its own edges
                rl, c, v = sm.bucket(ax.rank)
                sm = dataclasses.replace(sm, row_local=rl, col=c, val=v)
            st = pipe.run_state(sm, gen, device=dev)
        else:
            st = pipe.run_state(spec["x"], gen, points=spec.get("points"), device=dev)
    finally:
        lz.eigsh = eigsh
    res = st.result
    return {"labels": _np(res.labels), "embedding": _np(res.embedding),
            "eigenvalues": _np(res.eigenvalues), "kmeans_iterations": res.kmeans_iterations,
            "provenance": st.provenance, **_counts()}


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
