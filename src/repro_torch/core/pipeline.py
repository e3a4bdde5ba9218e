"""Deprecated flat entry points — thin shims over
:mod:`repro_torch.core.spectral` (mirrors :mod:`repro.core.pipeline`).

The public API is the stage-graph facade
(:class:`~repro_torch.core.spectral.SpectralPipeline` + ``Plan``); the
functions here keep the original flat-config signatures alive with bitwise-
identical results, emitting a ``DeprecationWarning``.  Migration map:

    spectral_cluster(w, cfg, gen)             → cfg.to_pipeline().run(w, gen)
    spectral_cluster_from_points(x, cfg, gen) → SpectralPipeline(...,
                                                  graph=GraphConfig(...)).run(x, gen)

The sharded shims of the reference live in its ``distributed_pipeline``
module, which is not ported (ROADMAP A12); ``cfg.to_pipeline(plan=
Plan(device="sharded"))`` raises ``NotImplementedError`` naming A12 when
run.  ``SpectralResult`` and ``default_basis_size`` are re-exported.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

import repro_torch.core.kmeans as km
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.operator import CallableOperator
from repro_torch.core.spectral import (  # noqa: F401  (re-exports)
    EigConfig,
    GraphConfig,
    Plan,
    SpectralPipeline,
    SpectralResult,
    default_basis_size,
)
from repro_torch.sparse.formats import COO


@dataclasses.dataclass(frozen=True)
class SpectralClusteringConfig:
    """Deprecated flat config — prefix-named knobs re-plumbed into the nested
    per-stage configs by :meth:`to_pipeline`."""

    n_clusters: int
    n_eigvecs: Optional[int] = None  # default: n_clusters
    lanczos_m: Optional[int] = None  # default: ARPACK-style 2k (scaled by block)
    lanczos_tol: float = 1e-5
    lanczos_max_restarts: int = 60
    lanczos_block_size: int = 1  # Krylov block width b (>1: SpMM block mode)
    kmeans_max_iters: int = 100
    kmeans_iter: str = "fused"  # one-pass Lloyd iteration | "two_pass"
    kmeans_update: str = "matmul"  # two-pass centroid update
    kmeans_assign: str = "auto"  # two-pass assignment path
    drop_first: bool = False  # drop the trivial eigenvector from the embedding
    fixed_restarts: Optional[int] = None  # static-cost mode (dry-run/bench)
    fixed_kmeans_iters: Optional[int] = None

    def to_pipeline(self, *, graph: Optional[GraphConfig] = None,
                    plan: Optional[Plan] = None) -> SpectralPipeline:
        """The equivalent :class:`SpectralPipeline` (the migration path)."""
        return SpectralPipeline(
            n_clusters=self.n_clusters,
            graph=graph or GraphConfig(),
            eig=EigConfig(
                n_eigvecs=self.n_eigvecs,
                basis_m=self.lanczos_m,
                tol=self.lanczos_tol,
                max_restarts=self.lanczos_max_restarts,
                block_size=self.lanczos_block_size,
                drop_first=self.drop_first,
                fixed_restarts=self.fixed_restarts,
            ),
            kmeans=km.KMeansConfig(
                max_iters=self.kmeans_max_iters,
                iter=self.kmeans_iter,
                update=self.kmeans_update,
                assign=self.kmeans_assign,
                fixed_iters=self.fixed_kmeans_iters,
            ),
            plan=plan or Plan(),
        )


def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new} (repro_torch.core.spectral)",
                  DeprecationWarning, stacklevel=3)


def spectral_cluster(
    w: COO,
    cfg: SpectralClusteringConfig,
    generator: Optional[torch.Generator] = None,
    *,
    matvec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    matmat: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    deg: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> SpectralResult:
    """Deprecated: ``cfg.to_pipeline().run(w, generator)``.

    ``matvec``/``matmat`` override the operator application (wrapped into a
    :class:`~repro_torch.core.operator.CallableOperator` on ``device``);
    prefer passing a ``LinearOperator`` to :meth:`SpectralPipeline.run`.
    ``deg`` was always ignored and remains so.
    """
    del deg  # kept for signature compatibility; never consumed
    _warn_deprecated("spectral_cluster", "SpectralPipeline.run")
    pipe = cfg.to_pipeline()
    op = None
    if matvec is not None or matmat is not None:
        op = CallableOperator(n=w.shape[0], matvec=matvec, matmat=matmat,
                              device=resolve_device(device))
    # one call into the stage DAG — run(operator=) carries the override to
    # the embed stage, with the same generator split as always (bitwise)
    return pipe.run(w, generator, operator=op, device=device)


def spectral_cluster_from_points(
    x,
    cfg: SpectralClusteringConfig,
    generator: Optional[torch.Generator] = None,
    *,
    knn_k: int = 10,
    points=None,
    measure: str = "exp_decay",
    sigma: float = 1.0,
    knn_eps: Optional[float] = None,
    knn_impl: str = "auto",
    device: DeviceLike = None,
) -> SpectralResult:
    """Deprecated: ``SpectralPipeline(..., graph=GraphConfig(...)).run(x,
    generator)``.  ``knn_impl`` is kept for config parity (the device of the
    input picks the kernel or its plain version)."""
    _warn_deprecated("spectral_cluster_from_points",
                     "SpectralPipeline.run with a GraphConfig")
    pipe = cfg.to_pipeline(graph=GraphConfig(
        knn_k=knn_k, measure=measure, sigma=sigma, eps=knn_eps, impl=knn_impl))
    return pipe.run(x, generator, points=points, device=device)
