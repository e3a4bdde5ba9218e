"""The ``LinearOperator`` protocol — ARPACK reverse communication, formalized
(mirrors :mod:`repro.core.operator`).

The eigensolver never sees the matrix, only ``mv`` ([n] → [n]) and ``mm``
([n, b] → [n, b]); operator representations swap freely behind it.
Matrix-backed operators also expose ``nnz`` (stored entries one application
streams, padding included) and the ``device`` their tensors live on.

Operators may also provide the optional ``cheb_step(x, prev, ca, cb)``
hook (``ca·(A x) + cb·x − prev``), which the Chebyshev filter uses when it
is there.
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
class ShardedCooOperator:
    """Row-block-partitioned operator over a
    :class:`~repro_torch.sparse.distributed.ShardedCOO`.

    Without a mesh (``variant="gspmd"``) it is the single-process layout
    path: one index-add over the global rows.  With a mesh (a
    ``DeviceMesh``; required by ``variant="shard_map"``) each rank
    index-adds its own bucket into its row block of the product and
    all-gathers it, one collective an application, whichever variant is
    named; ``gather_dtype`` casts the gathered block.  ``mm`` moves one
    [n, b] block a collective (the block-Lanczos amortization).
    """

    sm: Any  # ShardedCOO
    variant: str = "gspmd"
    mesh: Any = None
    axis: Any = "data"
    gather_dtype: Any = None
    # the mesh path's product closures, built once (None without a mesh)
    _spmv: Any = dataclasses.field(default=None, init=False, repr=False, compare=False)
    _spmm: Any = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        from repro_torch.sparse.distributed import make_sharded_spmm, make_sharded_spmv

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
