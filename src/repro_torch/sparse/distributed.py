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
    ``torch.distributed``, row block in, row block out, as the reference's
    ``shard_map`` specs say: each rank all-gathers the input ``x`` from
    the ranks' row blocks (one collective a product) and index-adds its
    own bucket into its row block of ``A·x``.

Dense state on the mesh path is distributed the same way: a
:class:`RowBlock` names this rank's rows of an n-row array and carries the
collectives that a contraction over n needs (an all-reduce of the small
result, a tall-skinny QR).  On a one-rank axis, or off a mesh, each of them
is the identity or the plain one-device op.

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
from typing import Dict, Optional, Tuple

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

    # no collective of the plan broadcasts: "broadcast" stays 0, and a run
    # that shows it so says no rank's state is another's copy
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
    """``spmv(row_local, col, val, x_blk) -> y_blk``: this rank's row block
    ``x_blk`` [rows_per_shard], cast to ``gather_dtype`` (optional: bf16
    halves the bytes) and all-gathered into the whole ``x`` — one
    collective a product —, then the rank's bucket index-added (fp32) into
    its row block of ``W x``, returned in ``x_blk``'s dtype."""
    ax = mesh_axis(mesh, axis)
    _check_mesh(sm, ax)
    gdt = None if gather_dtype is None else getattr(torch, str(gather_dtype))

    def spmv(row_local, col, val, x_blk):
        rl, c, v = _local_bucket(sm, row_local, col, val, ax)
        x = all_gather(x_blk if gdt is None else x_blk.to(gdt), ax)
        y = torch.zeros(sm.rows_per_shard, dtype=torch.float32, device=x_blk.device)
        y.index_add_(0, rl, v.float() * x[c].float())
        return y.to(x_blk.dtype)

    return spmv


def _gather_block(x_blk: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The whole [n, b] block from the ranks' [rows, b] blocks, laid out as
    ``x_blk`` is: a column-major block (a Krylov block sliced from the basis)
    is gathered column by column, so the product's row gather ``x[c]``
    reads it as the caller laid it out (gathering a narrow block row-major
    made the world-size-1 mesh path on an H100 1.7× slower; PERF.md)."""
    b = x_blk.shape[1]
    if b == 1 or not x_blk.T.is_contiguous():
        return all_gather(x_blk, ax)
    cols = all_gather(x_blk.T, ax)  # [S·b, rows]: each rank's columns
    return cols.view(ax.size, b, -1).transpose(0, 1).reshape(b, -1).T


def make_sharded_spmm(mesh, sm: ShardedCOO, *, axis="data", gather_dtype=None):
    """``spmm(row_local, col, val, x_blk) -> y_blk`` for row blocks of shape
    [rows_per_shard, b]: one all-gather moves the whole [n_pad, b] input,
    so the collective cost a vector drops b× (the block eigensolver's
    amortization)."""
    ax = mesh_axis(mesh, axis)
    _check_mesh(sm, ax)
    gdt = None if gather_dtype is None else getattr(torch, str(gather_dtype))

    def spmm(row_local, col, val, x_blk):
        rl, c, v = _local_bucket(sm, row_local, col, val, ax)
        x = _gather_block(x_blk if gdt is None else x_blk.to(gdt), ax)
        y = torch.zeros((sm.rows_per_shard, x_blk.shape[1]), dtype=torch.float32,
                        device=x_blk.device)
        y.index_add_(0, rl, v.float()[:, None] * x[c].float())
        return y.to(x_blk.dtype)

    return spmm


def sharded_degrees(sm: ShardedCOO, ax: Axis) -> torch.Tensor:
    """The whole [n_pad] fp32 degree vector: each rank sums its own
    bucket's rows (fp32, in the bucket's edge order) and the blocks are
    all-gathered — one collective, and every rank holds the same degrees."""
    rl, _, v = _local_bucket(sm, sm.row_local, sm.col, sm.val, ax)
    d = torch.zeros(sm.rows_per_shard, dtype=torch.float32, device=v.device)
    return all_gather(d.index_add_(0, rl, v.float()), ax)


# ---------------------------------------------------------------------------
# Dense state by row blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RowBlock:
    """This rank's rows ``[lo, hi)`` of an ``n``-row array distributed by
    row blocks over ``ax`` (the sharded plan's layout of its Krylov basis,
    Chebyshev block and embedding; ``ax`` None off a mesh).

    A contraction over n is a local product plus :meth:`psum` of its small
    result; :meth:`qr` is a tall-skinny QR; a draw or a vector every rank
    holds whole is sliced with :meth:`take`.  Unless the axis has more
    than one rank (:attr:`split`), each method is the identity or the plain
    one-device op and makes no collective, so such a run computes bit for
    bit what it computes without a mesh.

    ``live`` (from :meth:`padded`) marks rows ``[live, n)`` as padding that
    :func:`partition_coo_by_rows` added to a graph of ``live`` rows: a draw
    or a start vector is zero there (:meth:`pad`), so a Krylov space that
    starts on the real rows stays on them, and :meth:`take`,
    :meth:`gather_live` and the ``*_padding`` methods leave the padding
    out."""

    ax: Optional[Axis]
    lo: int
    hi: int
    n: int
    live: Optional[int] = None  # rows past it are padding (None: none are)

    @classmethod
    def whole(cls, n: int) -> "RowBlock":
        return cls(None, 0, n, n)

    @classmethod
    def of(cls, ax: Axis, n: int) -> "RowBlock":
        """Coordinate ``ax.rank``'s block of ``n`` rows (``n`` divisible by
        the axis' size)."""
        if n % ax.size:
            raise ValueError(f"{n} rows do not split into {ax.size} equal row blocks")
        nl = n // ax.size
        return cls(ax, ax.rank * nl, (ax.rank + 1) * nl, n)

    @classmethod
    def padded(cls, ax: Axis, n: int) -> "RowBlock":
        """Coordinate ``ax.rank``'s block of ``n`` rows padded, as
        :func:`partition_coo_by_rows` pads them, to the next multiple of the
        axis' size (no padding when ``n`` divides)."""
        blk = cls.of(ax, padded_rows(n, ax.size))
        return blk if blk.n == n else dataclasses.replace(blk, live=n)

    @property
    def split(self) -> bool:
        return self.ax is not None and self.ax.size > 1

    @property
    def size(self) -> int:
        return self.hi - self.lo

    @property
    def live_size(self) -> int:
        """This rank's rows that are not padding."""
        if self.live is None:
            return self.size
        return max(0, min(self.hi, self.live) - self.lo)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t``, which every rank holds whole (of
        ``n`` rows, or of ``live``: then the rank's real rows)."""
        return t[self.lo:self.hi] if self.split else t

    def pad(self, t: torch.Tensor) -> torch.Tensor:
        """The whole ``t`` (of ``live`` or ``n`` rows) over all ``n`` rows,
        zero on the padding: a counter-based draw's real rows keep the bits
        of the unpadded draw."""
        if self.live is None:
            return t
        out = t.new_zeros((self.n,) + tuple(t.shape[1:]))
        out[:self.live] = t[:self.live]
        return out

    def drop_padding(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's real rows of its rows ``t``."""
        return t if self.live is None else t[:self.live_size]

    def fill_padding(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's real rows ``t`` as its rows, zero on the padding."""
        if self.live is None:
            return t
        out = t.new_zeros((self.size,) + tuple(t.shape[1:]))
        out[:t.shape[0]] = t
        return out

    def gather_live(self, t: torch.Tensor) -> torch.Tensor:
        """The whole array of real rows from the ranks' real rows ``t``."""
        if self.live is None:
            return self.gather(t)
        return self.gather(self.fill_padding(t))[:self.live]

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of each rank's partial ``t`` (a new tensor)."""
        if not self.split:
            return t
        return all_reduce(t.clone(memory_format=torch.contiguous_format), self.ax)

    def norm(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        """``torch.linalg.norm`` over the rows of all ranks (over every
        element, or along ``dim``)."""
        if not self.split:
            return torch.linalg.norm(x, dim=dim)
        sq = (x * x).sum() if dim is None else (x * x).sum(dim)
        return torch.sqrt(self.psum(sq))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole array from the ranks' row blocks."""
        return all_gather(t, self.ax) if self.split else t

    def qr(self, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reduced QR of the row-distributed [n, b] ``w``: this rank's rows
        of Q and the whole R, the same on every rank.  Tall-skinny: each
        rank factors its rows (its R padded with zero rows to [b, b] when it
        has fewer than b), one all-gather stacks the S small factors, and
        every rank factors the [S·b, b] stack and keeps its block of that Q.
        A column of ``w`` that R finds deficient gets an arbitrary direction,
        as in the one-device QR, but never on a padding row: Q is zero
        there."""
        if not self.split:
            return torch.linalg.qr(w)
        b = w.shape[1]
        q1, r1 = torch.linalg.qr(w)  # [nl, min(nl, b)], [min(nl, b), b]
        if r1.shape[0] < b:
            r1 = torch.cat([r1, r1.new_zeros((b - r1.shape[0], b))])
        q2, r = torch.linalg.qr(all_gather(r1.contiguous(), self.ax))
        blk = self.ax.rank * b
        q = q1 @ q2[blk:blk + q1.shape[1]]
        if self.live_size < self.size:
            q[self.live_size:] = 0.0
        return q, r


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


def gather_rows(t: torch.Tensor, ax: Optional[Axis], n: int) -> torch.Tensor:
    """The whole [n, ...] array from each rank's real rows ``t`` of it (the
    blocks of :meth:`RowBlock.padded`); ``t`` itself off a split axis."""
    if ax is None or ax.size == 1:
        return t
    return RowBlock.padded(ax, n).gather_live(t)


def shard_edges(mesh, sm: ShardedCOO, axis="data") -> Tuple[torch.Tensor, ...]:
    """This rank's bucket ``(row_local, col, val)``."""
    ax = mesh_axis(mesh, axis)
    _check_mesh(sm, ax)
    return sm.bucket(ax.rank)
