"""Pipeline-wide fail-soft layer: health guards, stage reports, typed errors
(mirrors :mod:`repro.core.health`).

PyTorch runs eagerly, so every stage output is concrete:
:func:`is_concrete` is always true here and the escalation ladders of
:class:`~repro_torch.core.spectral.SpectralPipeline` always run — as they
do in the reference's eager (un-jitted) execution.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


class PipelineError(RuntimeError):
    """Structured stage failure: which stage, which recovery ladder was
    exhausted, and what the operator should change."""

    def __init__(self, stage: str, detail: str, *,
                 ladder: Tuple[str, ...] = (), remedy: str = ""):
        self.stage = stage
        self.ladder = tuple(ladder)
        self.remedy = remedy
        self.detail = detail
        msg = f"[{stage}] {detail}"
        if self.ladder:
            msg += f" (ladder exhausted: {' -> '.join(self.ladder)})"
        if remedy:
            msg += f"; remedy: {remedy}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Fail-soft knobs for the escalation controllers (see the reference):
    ``enabled`` master switch, ``max_attempts`` tries per stage,
    ``basis_widen`` Lanczos basis multiplier per retry, ``margin_widen``
    Chebyshev margin multiplier (kept for config parity)."""

    enabled: bool = True
    max_attempts: int = 3
    basis_widen: float = 1.5
    margin_widen: float = 10.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"HealthConfig.max_attempts must be >= 1, got {self.max_attempts}")
        if self.basis_widen <= 1.0:
            raise ValueError(
                f"HealthConfig.basis_widen must be > 1 (each rung must widen "
                f"the basis), got {self.basis_widen}")
        if self.margin_widen <= 1.0:
            raise ValueError(
                f"HealthConfig.margin_widen must be > 1, got {self.margin_widen}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class StageReport:
    """Per-stage health record: ladder rungs taken (plus notes such as
    ``isolated_vertices[3]``), attempts, convergence, a residual summary
    (embed: max eigenpair residual; cluster: inertia) and host wall time."""

    stage: str
    escalations: Tuple[str, ...] = ()
    attempts: Any = 1
    converged: Any = True
    residual_max: Any = 0.0
    wall_s: Any = -1.0

    def to_dict(self) -> dict:
        return {
            "stage": self.stage,
            "escalations": list(self.escalations),
            "attempts": int(self.attempts),
            "converged": bool(self.converged),
            "residual_max": float(self.residual_max),
            "wall_s": float(self.wall_s),
        }


def reports_to_dict(reports: Tuple[StageReport, ...]) -> list:
    """Serialize a report trail (the serve loop's structured log record)."""
    return [r.to_dict() for r in reports]


def is_concrete(*values) -> bool:
    """Always true: PyTorch has no traced values."""
    return True


def nonfinite_count(x) -> int:
    """Number of NaN/Inf entries (0 = healthy)."""
    t = torch.as_tensor(x)
    if not t.is_floating_point():
        return 0
    return int((~torch.isfinite(t)).sum())


def graph_signals(val: torch.Tensor, deg: Optional[torch.Tensor] = None) -> dict:
    """Degeneracy signals of a similarity graph: non-finite weights, negative
    weights, zero-degree (isolated) vertices."""
    sig = {
        "nonfinite_weights": nonfinite_count(val),
        "negative_weights": int((val < 0).sum()),
    }
    if deg is not None:
        sig["zero_degree"] = int((deg <= 0).sum())
    return sig


def embedding_signals(h: torch.Tensor, residuals: torch.Tensor) -> dict:
    return {
        "nonfinite_embedding": nonfinite_count(h),
        "residual_max": float(torch.as_tensor(residuals).float().max()),
    }


def check_points(x: torch.Tensor, n_clusters: int) -> None:
    """Stage-1 input guard: finite features and ``k <= #distinct points``.
    Counts on the points' device and reads back only the counts."""
    bad = nonfinite_count(x)
    if bad:
        raise PipelineError(
            "prepare", f"input points contain {bad} non-finite value(s)",
            remedy="sanitize the feature matrix (impute or drop rows) before "
                   "clustering — NaN propagates through kNN distances into "
                   "every downstream stage")
    n = x.shape[0]
    if n < n_clusters:
        raise PipelineError(
            "prepare", f"n_clusters={n_clusters} exceeds the number of "
                       f"points n={n}",
            remedy="reduce n_clusters")
    # + 0.0 turns -0.0 into 0.0: np.unique(axis=0) counts the two as one row
    distinct = torch.unique((x + 0.0).reshape(n, -1), dim=0).shape[0]
    if distinct < n_clusters:
        raise PipelineError(
            "prepare", f"n_clusters={n_clusters} exceeds the number of "
                       f"distinct points ({distinct} of {n} rows "
                       f"are unique)",
            remedy="deduplicate the input or reduce n_clusters — at most "
                   "one live cluster per distinct point exists")


def check_graph(val: torch.Tensor) -> None:
    """Prebuilt-graph input guard: finite, non-negative edge weights."""
    bad = nonfinite_count(val)
    if bad:
        raise PipelineError(
            "prepare", f"similarity graph contains {bad} non-finite "
                       f"weight(s)",
            remedy="rebuild or sanitize the graph — non-finite weights "
                   "poison degrees and the normalized operator")
    neg = int((val < 0).sum())
    if neg:
        raise PipelineError(
            "prepare", f"similarity graph contains {neg} negative weight(s)",
            remedy="similarity weights must be non-negative (the sym "
                   "normalization takes sqrt of degrees); clamp or rebuild "
                   "the graph")


def numeric_problems(tree, context: str = "") -> Tuple[str, ...]:
    """Non-finite scan of a nested dict/list/tuple of numbers, tensors or
    arrays: the :func:`result_problems` discipline generalized to metric
    trees and served rows.  Returns problem strings naming the offending
    path; empty means healthy.  Non-numeric leaves (strings, None, integer
    tensors) are ignored.  A tensor is counted on its own device; only the
    count is read back."""
    problems = []

    def visit(path, v):
        if isinstance(v, dict):
            for k, sub in v.items():
                visit(f"{path}.{k}" if path else str(k), sub)
        elif isinstance(v, (list, tuple)):
            for i, sub in enumerate(v):
                visit(f"{path}[{i}]", sub)
        elif isinstance(v, (int, bool, str, bytes)) or v is None:
            return
        elif isinstance(v, torch.Tensor):
            if v.is_floating_point() or v.is_complex():
                report(path, int((~torch.isfinite(v)).sum()), v.numel())
        else:
            try:
                arr = np.asarray(v)
            except (TypeError, ValueError):  # not array-like: not a number
                return
            if arr.dtype.kind in "fc":
                report(path, int((~np.isfinite(arr)).sum()), arr.size)

    def report(path, bad, size):
        if bad:
            problems.append(f"non-finite value at {path!r}"
                            + (f" in {context}" if context else "")
                            + (f" ({bad} entries)" if size > 1 else ""))

    visit("", tree)
    return tuple(problems)


def result_problems(result) -> Tuple[str, ...]:
    """Scan a finished :class:`SpectralResult` for the problems the guards
    would have raised on; empty means healthy."""
    problems = []
    bad = nonfinite_count(result.embedding)
    if bad:
        problems.append(f"non-finite embedding ({bad} values)")
    if nonfinite_count(result.kmeans_inertia):
        problems.append("non-finite k-means inertia")
    if nonfinite_count(result.eigenvalues):
        problems.append("non-finite eigenvalues")
    for rep in getattr(result, "reports", ()) or ():
        if not bool(rep.converged):
            problems.append(f"stage {rep.stage!r} reports converged=False "
                            f"(residual_max={float(rep.residual_max):.3e})")
    return tuple(problems)
