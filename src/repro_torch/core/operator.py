"""The ``LinearOperator`` protocol — ARPACK reverse communication, formalized
(mirrors :mod:`repro.core.operator`).

The eigensolver never sees the matrix, only ``mv`` ([n] → [n]) and ``mm``
([n, b] → [n, b]); operator representations swap freely behind it.
Matrix-backed operators also expose ``nnz`` (stored entries one application
streams, padding included) and the ``device`` their tensors live on.

Operators may also provide the optional ``cheb_step(x, prev, ca, cb)``
hook (``ca·(A x) + cb·x − prev``), which the Chebyshev filter uses when it
is there, and ``rows`` (a
:class:`~repro_torch.sparse.distributed.RowBlock`): the operator then maps
this rank's rows to this rank's rows, and the solvers keep their vectors
distributed by rows (:func:`row_block`): :class:`ShardedCooOperator` under a
mesh, and :class:`RowBlockEllOperator`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.sparse.formats import COO, BlockELL
from repro_torch.sparse.ops import spmm_coo, spmv_coo


@runtime_checkable
class LinearOperator(Protocol):
    """Symmetric linear operator contract driven by the eigensolver."""

    @property
    def shape(self) -> Tuple[int, int]: ...

    @property
    def dtype(self) -> Any: ...

    def mv(self, x: torch.Tensor) -> torch.Tensor: ...

    def mm(self, x: torch.Tensor) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class CooOperator:
    """Index-add SpMV/SpMM over a (pre-normalized) COO adjacency — the
    default single-device operator behind :class:`SpectralPipeline`."""

    a: COO

    @property
    def shape(self) -> Tuple[int, int]:
        return self.a.shape

    @property
    def dtype(self):
        return self.a.val.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    @property
    def nnz(self) -> int:
        return self.a.nnz

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return spmv_coo(self.a, x)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_coo(self.a, x)


@dataclasses.dataclass(frozen=True)
class BlockEllOperator:
    """BlockELL(+COO tail) operator: ``mv`` is the ``ell_spmv`` kernel,
    ``mm`` the ``ell_spmm`` kernel and ``cheb_step`` the fused Chebyshev
    step of ``ell_spmm`` on the card (their plain versions on the CPU)."""

    a: BlockELL

    @property
    def shape(self) -> Tuple[int, int]:
        return self.a.shape

    @property
    def dtype(self):
        return self.a.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    @property
    def nnz(self) -> int:
        # ELL padding slots are streamed like real entries
        return int(self.a.vals.numel()) + self.a.tail.nnz

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.ell_spmv.ops import ell_spmv

        return ell_spmv(self.a, x)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.ell_spmm.ops import ell_spmm

        return ell_spmm(self.a, x)

    def cheb_step(self, x: torch.Tensor, prev: torch.Tensor, ca, cb) -> torch.Tensor:
        """Fused Chebyshev three-term step ``ca·(A x) + cb·x − prev``: the
        recurrence's AXPY chain rides the ``ell_spmm`` epilogue instead of
        three more passes over the [n, b] iterates."""
        from repro_torch.kernels.ell_spmm.ops import ell_spmm_cheb_step

        return ell_spmm_cheb_step(self.a, x, prev, ca, cb)


@dataclasses.dataclass(frozen=True)
class RowBlockEllOperator:
    """This rank's rows of a BlockELL(+tail) operator under a mesh axis of
    more than one rank: ``mv``, ``mm`` and ``cheb_step`` map this rank's
    rows to this rank's rows through the ``ell_spmv`` and ``ell_spmm``
    kernels and the fused Chebyshev step, as :class:`ShardedCooOperator`
    does through its index-add.  The input's row blocks are all-gathered
    (one collective a product) into the whole input rotated so that this
    rank's rows come first, and the layout's column ids are rotated alike
    (``(col − lo) mod n``), so the fused step's ``cb·x`` term reads the
    rank's own rows.  It is the row analogue of the reference's
    ``BlockEllOperator`` over a COO graph, and like that operator it
    ignores ``Plan.gather_dtype``: the input is gathered at its own dtype.
    ``shape`` stays global; :attr:`rows` names the rank's rows.  Built by
    :meth:`of`.
    """

    a: BlockELL  # the rank's [rows, n] layout, column ids rotated by −rows.lo
    rows: Any  # RowBlock

    @classmethod
    def of(cls, row, col, val, rows, *, width=None) -> "RowBlockEllOperator":
        """From the rank's entries: in-block ``row`` ids, global ``col``
        ids and ``val``, laid out in row order (a stable sort keeps each
        row's entries in their order, so its ELL slots are those of the
        whole graph's layout at the same ``width``)."""
        from repro_torch.sparse.formats import coo_to_csr, csr_to_blockell

        order = torch.argsort(row, stable=True)
        local = COO(row[order], (col[order] - rows.lo) % rows.n, val[order],
                    (rows.size, rows.n))
        return cls(csr_to_blockell(coo_to_csr(local), width=width), rows)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows.n, self.rows.n)

    @property
    def dtype(self):
        return self.a.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.a.device

    @property
    def nnz(self) -> int:
        return int(self.a.vals.numel()) + self.a.tail.nnz

    def _whole(self, x_blk: torch.Tensor) -> torch.Tensor:
        """The whole input from the ranks' row blocks, this rank's first."""
        from repro_torch.sparse.distributed import _gather_block, all_gather

        ax, lo, n = self.rows.ax, self.rows.lo, self.rows.n
        g = all_gather(x_blk, ax) if x_blk.ndim == 1 else _gather_block(x_blk, ax)
        x = torch.empty(g.shape, dtype=x_blk.dtype, device=g.device)
        x[:n - lo] = g[lo:]
        x[n - lo:] = g[:lo]
        return x

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.ell_spmv.ops import ell_spmv

        return ell_spmv(self.a, self._whole(x))

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.ell_spmm.ops import ell_spmm

        return ell_spmm(self.a, self._whole(x))

    def cheb_step(self, x: torch.Tensor, prev: torch.Tensor, ca, cb) -> torch.Tensor:
        from repro_torch.kernels.ell_spmm.ops import ell_spmm_cheb_step

        return ell_spmm_cheb_step(self.a, self._whole(x), prev, ca, cb)


@dataclasses.dataclass(frozen=True)
class ShardedCooOperator:
    """Row-block-partitioned operator over a
    :class:`~repro_torch.sparse.distributed.ShardedCOO`.

    Without a mesh (``variant="gspmd"``) it is the single-process layout
    path: one index-add over the global rows, whole vectors in and out.
    With a mesh (a ``DeviceMesh``; required by ``variant="shard_map"``),
    whichever variant is named, ``mv``/``mm`` map this rank's rows to this
    rank's rows, as the reference's ``shard_map`` specs do: the input's row
    blocks are all-gathered (one collective an application; ``gather_dtype``
    casts them first) and the rank's bucket is index-added into its row
    block of the product.  ``mm`` moves one [n, b] block a collective (the
    block-Lanczos amortization).  ``shape`` stays global; :attr:`rows`
    names the rank's rows.  ``live_rows`` is set when the ShardedCOO pads a
    COO graph of that many rows for this operator
    (:meth:`~repro_torch.sparse.distributed.RowBlock.padded`: the solvers'
    draws are zero on the padding); a ShardedCOO a caller hands in keeps
    every row.
    """

    sm: Any  # ShardedCOO
    variant: str = "gspmd"
    mesh: Any = None
    axis: Any = "data"
    gather_dtype: Any = None
    live_rows: Optional[int] = None
    # the mesh path's product closures and row block, built once (None
    # without a mesh)
    _spmv: Any = dataclasses.field(default=None, init=False, repr=False, compare=False)
    _spmm: Any = dataclasses.field(default=None, init=False, repr=False, compare=False)
    _rows: Any = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        from repro_torch.sparse.distributed import (RowBlock, make_sharded_spmm,
                                                    make_sharded_spmv, mesh_axis)

        if self.variant not in ("gspmd", "shard_map"):
            raise ValueError(
                f"ShardedCooOperator.variant must be 'gspmd' or 'shard_map', "
                f"got {self.variant!r}")
        if self.variant == "shard_map" and self.mesh is None:
            raise ValueError(
                "ShardedCooOperator(variant='shard_map') needs a mesh — the "
                "explicit-collective SpMV is built per mesh axis")
        if self.mesh is not None:
            kw = dict(axis=self.axis, gather_dtype=self.gather_dtype)
            object.__setattr__(self, "_spmv", make_sharded_spmv(self.mesh, self.sm, **kw))
            object.__setattr__(self, "_spmm", make_sharded_spmm(self.mesh, self.sm, **kw))
            n = self.sm.shape[0] if self.live_rows is None else self.live_rows
            object.__setattr__(self, "_rows", RowBlock.padded(mesh_axis(self.mesh, self.axis), n))

    @property
    def shape(self) -> Tuple[int, int]:
        return self.sm.shape

    @property
    def dtype(self):
        return self.sm.val.dtype

    @property
    def device(self) -> torch.device:
        return self.sm.device

    @property
    def nnz(self) -> int:
        # per-shard padding (null edges) is streamed like real entries
        return int(self.sm.val.shape[0])

    @property
    def rows(self):
        """This rank's :class:`~repro_torch.sparse.distributed.RowBlock` of
        the operator's rows under a mesh (``None`` without one: whole)."""
        return self._rows

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.sparse.distributed import spmv_gspmd

        if self.mesh is None:
            return spmv_gspmd(self.sm, x)
        return self._spmv(self.sm.row_local, self.sm.col, self.sm.val, x)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.sparse.distributed import spmm_gspmd

        if self.mesh is None:
            return spmm_gspmd(self.sm, x)
        return self._spmm(self.sm.row_local, self.sm.col, self.sm.val, x)


def row_block(op, n: int):
    """The operator's :class:`~repro_torch.sparse.distributed.RowBlock`
    (``op.rows``), or all ``n`` rows when it has none: the rows of the
    vectors that ``op.mv``/``op.mm`` take and return."""
    from repro_torch.sparse.distributed import RowBlock

    rows = getattr(op, "rows", None)
    return RowBlock.whole(n) if rows is None else rows


@dataclasses.dataclass(frozen=True)
class CallableOperator:
    """Adapter wrapping bare ``matvec``/``matmat`` closures into the protocol.

    Without an explicit ``matmat``, ``mm`` applies ``matvec`` column by
    column — a correctness fallback that forfeits the single stream.
    """

    n: int
    matvec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    matmat: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    dtype: Any = torch.float32
    device: Any = torch.device("cpu")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        if self.matvec is None:
            raise ValueError("CallableOperator needs matvec for single-vector mode")
        return self.matvec(x)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        if self.matmat is not None:
            return self.matmat(x)
        if self.matvec is None:
            raise ValueError("CallableOperator needs matvec or matmat")
        return torch.stack([self.matvec(x[:, j]) for j in range(x.shape[1])], dim=1)
