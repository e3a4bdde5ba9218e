"""Row-partitioned graph layout and the collectives of the sharded plan
(mirrors :mod:`repro.sparse.distributed`).

The layout is the reference's: a :class:`ShardedCOO` is pure data, the
edges re-bucketed so shard ``s`` holds every edge whose row lies in
``[s·rows_per_shard, (s+1)·rows_per_shard)``, its rows stored locally and
each bucket padded to ``edges_per_shard`` with (0, 0, 0) null edges.

Two execution paths share it, as in the reference:

``spmv_gspmd`` / ``spmm_gspmd`` — the single-process layout path: one
    index-add over :func:`global_rows`, on one device.
``make_sharded_spmv`` / ``make_sharded_spmm`` — the mesh path over
    ``torch.distributed``: each rank index-adds its own bucket into its row
    block of ``A·x`` and all-gathers the product, one collective a product.
    The reference gathers ``x`` before the product instead; here the dense
    state stays whole on every rank (``core/distributed_pipeline.py`` says
    why), so it is the output that travels.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (NCCL on cards,
gloo on the CPU) and an axis one of its dimension names; the collectives
run over that dimension's process group through the wrappers below, which
count each call and the bytes it moves by the reference's model
(``collective_bytes``): an all-gather (S−1)·operand bytes, a ring shift
(``ppermute``) and an all-reduce (``psum``) operand bytes.  That counter
takes the place of the reference's jaxpr walk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.sparse.formats import COO


@dataclasses.dataclass(frozen=True)
class ShardedCOO:
    """COO re-bucketed so shard ``i`` holds the edges of rows ``[i·rows_per_shard,
    (i+1)·rows_per_shard)``, rows stored locally (0-based within the block),
    every bucket padded to ``edges_per_shard`` with (0, 0, 0) null edges.
    Leading axes are ``num_shards · edges_per_shard``."""

    row_local: torch.Tensor  # [S·E] int64, in-block row ids
    col: torch.Tensor  # [S·E] int64, global column ids
    val: torch.Tensor  # [S·E] float
    shape: Tuple[int, int]  # padded global shape (n_pad, n_pad)
    rows_per_shard: int
    num_shards: int
    edges_per_shard: int

    @property
    def device(self) -> torch.device:
        return self.val.device

    def to(self, device) -> "ShardedCOO":
        return dataclasses.replace(self, row_local=self.row_local.to(device),
                                   col=self.col.to(device), val=self.val.to(device))

    def bucket(self, shard: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(row_local, col, val) of one shard's bucket."""
        s = slice(shard * self.edges_per_shard, (shard + 1) * self.edges_per_shard)
        return self.row_local[s], self.col[s], self.val[s]


def padded_rows(n: int, num_shards: int) -> int:
    return ((n + num_shards - 1) // num_shards) * num_shards


def global_rows(sm: ShardedCOO, ax: "Axis | None" = None) -> torch.Tensor:
    """Per-edge global row ids recovered from the (shard, local-row) layout.
    A rank that holds only its own [E] bucket passes its mesh axis, whose
    coordinate is the bucket's shard, as in :func:`_local_bucket`."""
    if sm.row_local.shape[0] != sm.num_shards * sm.edges_per_shard:  # one bucket
        if ax is None:
            raise ValueError(
                f"the ShardedCOO holds one bucket of {sm.row_local.shape[0]} edges, not the "
                f"{sm.num_shards}·{sm.edges_per_shard} of the whole layout — pass the mesh "
                f"axis whose coordinate is its shard")
        return sm.row_local + ax.rank * sm.rows_per_shard
    shard = torch.arange(sm.num_shards, device=sm.device).repeat_interleave(sm.edges_per_shard)
    return sm.row_local + shard * sm.rows_per_shard


def normalize_sharded(sm: ShardedCOO, deg: torch.Tensor, ax: "Axis | None" = None) -> ShardedCOO:
    """val ← val · (d^{-1/2}[row] · d^{-1/2}[col]), as
    :func:`repro_torch.sparse.ops.normalize_sym` forms it (one product of
    the two scales, so an edge's two orientations keep one value).  ``deg``
    is whole; ``sm`` the whole layout, or a rank's own bucket with its mesh
    axis (:func:`global_rows`)."""
    d32 = deg.float()
    isd = torch.where(d32 > 0, torch.rsqrt(d32), torch.zeros_like(d32)).to(sm.val.dtype)
    grow = global_rows(sm, ax)
    return dataclasses.replace(sm, val=sm.val * (isd[grow] * isd[sm.col]))


def partition_coo_by_rows(m: COO, num_shards: int) -> ShardedCOO:
    """Re-bucket a COO onto ``num_shards`` row blocks on the COO's device:
    the reference's host layout bit for bit (each bucket keeps its edges in
    their order in ``m``).  Reads back one number, the fullest bucket's
    edge count, which sets the shape."""
    dev = m.device
    n = m.shape[0]
    n_pad = padded_rows(n, num_shards)
    rps = n_pad // num_shards
    row = m.row.long()
    owner = row // rps
    counts = torch.bincount(owner, minlength=num_shards)
    e_max = max(int(counts.max()) if counts.numel() else 0, 1)
    # each edge's slot: its owner's bucket, its rank among that owner's edges
    order = torch.argsort(owner, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.empty_like(owner)
    slot[order] = torch.arange(owner.numel(), device=dev) - starts[owner[order]]
    flat = owner * e_max + slot
    size = num_shards * e_max
    rl = torch.zeros(size, dtype=torch.int64, device=dev)
    cl = torch.zeros(size, dtype=torch.int64, device=dev)
    vl = torch.zeros(size, dtype=m.val.dtype, device=dev)
    rl[flat] = row - owner * rps
    cl[flat] = m.col.long()
    vl[flat] = m.val
    return ShardedCOO(row_local=rl, col=cl, val=vl, shape=(n_pad, n_pad),
                      rows_per_shard=rps, num_shards=num_shards, edges_per_shard=e_max)


# ---------------------------------------------------------------------------
# Path 1 — the single-process layout path
# ---------------------------------------------------------------------------

def spmv_gspmd(sm: ShardedCOO, x: torch.Tensor) -> torch.Tensor:
    """y = W @ x by one index-add over the global rows, accumulated in fp32."""
    contrib = sm.val.float() * x[sm.col].float()
    y = torch.zeros(sm.shape[0], dtype=torch.float32, device=x.device)
    y.index_add_(0, global_rows(sm), contrib)
    return y.to(x.dtype)


def spmm_gspmd(sm: ShardedCOO, x: torch.Tensor) -> torch.Tensor:
    """Y = W @ X for dense X [n_pad, b], as :func:`spmv_gspmd`."""
    contrib = sm.val.float()[:, None] * x[sm.col].float()
    y = torch.zeros((sm.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    y.index_add_(0, global_rows(sm), contrib)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Collectives over one mesh dimension, counted
# ---------------------------------------------------------------------------

class CollectiveCounter:
    """Calls and bytes of each collective, by the reference's model of bytes
    received per shard (``repro.sparse.distributed.collective_bytes``)."""

    NAMES = ("all_gather", "ppermute", "psum", "broadcast")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[str, int] = {k: 0 for k in self.NAMES}
        self.bytes: Dict[str, int] = {k: 0 for k in self.NAMES}

    def add(self, name: str, n_bytes: int) -> None:
        self.calls[name] += 1
        self.bytes[name] += int(n_bytes)


COLLECTIVES = CollectiveCounter()  # reset before a run, read after it


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh dimension: its process group, its size and this rank's
    coordinate along it."""

    group: "dist.ProcessGroup"
    size: int
    rank: int

    def global_rank(self, coord: int) -> int:
        return dist.get_global_rank(self.group, coord % self.size)


def mesh_axis(mesh, axis="data") -> Axis:
    """The :class:`Axis` of ``mesh`` (a ``DeviceMesh``) named ``axis``: a
    dimension name, or a tuple of names as the reference's plans carry —
    several dimensions are flattened into one, major first (the
    reference's ``("pod", "data")`` row order)."""
    names = tuple(mesh.mesh_dim_names or ())
    if not isinstance(axis, str):
        axis = tuple(axis)
        if len(axis) == 1:
            axis = axis[0]
        elif axis and all(a in names for a in axis):
            mesh = mesh[axis]._flatten()
            names = tuple(mesh.mesh_dim_names)
            axis = names[0]
    if axis not in names:
        raise ValueError(f"mesh has no dimension {axis!r} (its dimensions: {names})")
    return Axis(group=mesh.get_group(axis), size=mesh.size(names.index(axis)),
                rank=mesh.get_local_rank(axis))


def all_gather(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Tiled all-gather along dim 0: the axis' blocks in coordinate order."""
    t = t.contiguous()
    out = torch.empty((ax.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=ax.group)
    COLLECTIVES.add("all_gather", (ax.size - 1) * t.numel() * t.element_size())
    return out


def all_reduce(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """In-place sum over the axis (returns ``t``)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ax.group)
    COLLECTIVES.add("psum", t.numel() * t.element_size())
    return t


def broadcast(t: torch.Tensor, ax: Axis, src: int = 0) -> torch.Tensor:
    """In place: coordinate ``src``'s ``t`` on every rank of the axis."""
    dist.broadcast(t, src=ax.global_rank(src), group=ax.group)
    COLLECTIVES.add("broadcast", t.numel() * t.element_size())
    return t


def ring_perm(size: int):
    """The forward ring over a ``size``-shard axis: shard i sends to shard
    (i+1) % size.  After t steps, shard i holds the payload that started on
    shard (i − t) % size."""
    return [(i, (i + 1) % size) for i in range(size)]


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, tuple):
        parts = [_rebuild(sub, it) for sub in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return next(it)


def ring_shift(tree, ax: Axis):
    """One forward ring step of a tensor or a (nested, named) tuple of
    tensors: every leaf goes to coordinate rank+1 and comes from rank−1, all
    in one batch of sends and receives.  Each leaf counts its own bytes."""
    nxt, prv = ax.global_rank(ax.rank + 1), ax.global_rank(ax.rank - 1)
    ops, outs = [], []
    for a in _leaves(tree):
        a = a.contiguous()
        buf = torch.empty_like(a)
        ops += [dist.P2POp(dist.isend, a, nxt, group=ax.group),
                dist.P2POp(dist.irecv, buf, prv, group=ax.group)]
        outs.append(buf)
        COLLECTIVES.add("ppermute", a.numel() * a.element_size())
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _rebuild(tree, iter(outs))


# ---------------------------------------------------------------------------
# Path 2 — the mesh path: a rank's bucket, one all-gather a product
# ---------------------------------------------------------------------------

def _local_bucket(sm: ShardedCOO, row_local, col, val, ax: Axis):
    """This rank's bucket: sliced from the full [S·E] arrays, or taken as it
    is when the caller passed only its own [E]."""
    if row_local.shape[0] == sm.num_shards * sm.edges_per_shard:
        s = slice(ax.rank * sm.edges_per_shard, (ax.rank + 1) * sm.edges_per_shard)
        return row_local[s], col[s], val[s]
    return row_local, col, val


def _check_mesh(sm: ShardedCOO, ax: Axis) -> None:
    if ax.size != sm.num_shards:
        raise ValueError(
            f"the ShardedCOO has {sm.num_shards} shards but the mesh axis has "
            f"{ax.size} ranks — partition with partition_coo_by_rows(·, {ax.size})")


def make_sharded_spmv(mesh, sm: ShardedCOO, *, axis="data", gather_dtype=None):
    """``spmv(row_local, col, val, x) -> y``: ``x`` [n_pad] whole on every
    rank, the rank's row block of ``W x`` index-added from its bucket (fp32),
    cast to ``gather_dtype`` (optional: bf16 halves the bytes) and
    all-gathered into the whole ``y`` — one collective a product."""
    ax = mesh_axis(mesh, axis)
    _check_mesh(sm, ax)
    gdt = None if gather_dtype is None else getattr(torch, str(gather_dtype))

    def spmv(row_local, col, val, x):
        rl, c, v = _local_bucket(sm, row_local, col, val, ax)
        y = torch.zeros(sm.rows_per_shard, dtype=torch.float32, device=x.device)
        y.index_add_(0, rl, v.float() * x[c].float())
        return all_gather(y.to(gdt or x.dtype), ax).to(x.dtype)

    return spmv


def make_sharded_spmm(mesh, sm: ShardedCOO, *, axis="data", gather_dtype=None):
    """``spmm(row_local, col, val, x) -> y`` for X/Y of shape [n_pad, b]:
    one all-gather moves the whole [n_pad, b] product, so the collective
    cost a vector drops b× (the block eigensolver's amortization)."""
    ax = mesh_axis(mesh, axis)
    _check_mesh(sm, ax)
    gdt = None if gather_dtype is None else getattr(torch, str(gather_dtype))

    def spmm(row_local, col, val, x):
        rl, c, v = _local_bucket(sm, row_local, col, val, ax)
        y = torch.zeros((sm.rows_per_shard, x.shape[1]), dtype=torch.float32, device=x.device)
        y.index_add_(0, rl, v.float()[:, None] * x[c].float())
        return all_gather(y.to(gdt or x.dtype), ax).to(x.dtype)

    return spmm


def collective_bytes() -> dict:
    """``{name: bytes}`` of the collectives counted since the last
    ``COLLECTIVES.reset()``, plus ``"total"`` — the reference's
    ``collective_bytes`` return shape and byte model."""
    out = {k: v for k, v in COLLECTIVES.bytes.items() if COLLECTIVES.calls[k]}
    out["total"] = sum(out.values())
    return out


def shard_vector(mesh, x: torch.Tensor, axis="data") -> torch.Tensor:
    """This rank's row block of ``x``."""
    ax = mesh_axis(mesh, axis)
    nl = x.shape[0] // ax.size
    return x[ax.rank * nl:(ax.rank + 1) * nl]


def shard_edges(mesh, sm: ShardedCOO, axis="data") -> Tuple[torch.Tensor, ...]:
    """This rank's bucket ``(row_local, col, val)``."""
    ax = mesh_axis(mesh, axis)
    _check_mesh(sm, ax)
    return sm.bucket(ax.rank)
