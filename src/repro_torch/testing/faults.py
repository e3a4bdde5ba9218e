"""Fault injection: exercise every rung of the recovery ladders from tests
(mirrors :mod:`repro.testing.faults`).

The fail-soft layer (:mod:`repro_torch.core.health`, the escalation
controllers in :class:`~repro_torch.core.spectral.SpectralPipeline`) is only
trustworthy if every fault class it claims to handle is injected somewhere:

* **operator faults** — :class:`NaNOperator` (NaN out of every mv/mm: the
  poisoned-graph / poisoned-kernel class), :class:`BoundsLiarOperator` (the
  Chebyshev bounds-containment miss: the power-iteration estimator sees the
  true spectrum through ``mv`` while the filter streams a ``scale``× larger
  one through ``mm``), :class:`CountingOperator` (attempt accounting);
* **solver faults** — :func:`forced_nonconvergence`, a context manager that
  wraps :func:`repro_torch.core.lanczos.eigsh` at the module attribute the
  pipeline dispatches through, forcing ``converged=False`` and above-tol
  residuals for its first ``recover_after`` calls (``None``: forever);
* **stage faults** — :func:`wrap_stage` grafts a state transform onto any
  ``_stage_<name>`` of a pipeline instance;
* **input corruptors** — :func:`poison_points` / :func:`poison_graph` (NaN
  features, negative or NaN weights), drawing the poisoned positions with
  the reference's ``numpy`` ``RandomState`` calls, so both packages poison
  the same entries.

The wrappers pass the wrapped operator's ``dtype`` and ``device`` through,
so they satisfy :class:`~repro_torch.core.operator.LinearOperator`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.sparse.formats import COO


# ---------------------------------------------------------------------------
# Operator faults
# ---------------------------------------------------------------------------

class _Wrapped:
    def __init__(self, op):
        self._op = op
        self.shape = op.shape
        self.dtype = getattr(op, "dtype", torch.float32)
        self.device = getattr(op, "device", torch.device("cpu"))


class NaNOperator(_Wrapped):
    """A LinearOperator whose every application emits NaN — the stand-in for
    a poisoned graph or a miscompiled kernel feeding the eigensolver."""

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self._op.mv(x) * float("nan")

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        return self._op.mm(x) * float("nan")


class BoundsLiarOperator(_Wrapped):
    """Splits the operator's personality to fabricate a Chebyshev
    bounds-containment miss deterministically: ``mv`` (the bounds
    estimator's power iterations, and single-vector Lanczos) sees the true
    operator, ``mm`` (the filter recurrence, moments, Rayleigh-Ritz) sees
    ``scale × A``, whose spectrum lies far outside the mapped interval, so
    the three-term recurrence diverges.  The Lanczos fallback rung recovers
    through ``mv``."""

    def __init__(self, op, scale: float = 4.0):
        super().__init__(op)
        self._scale = float(scale)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return self._op.mv(x)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        return self._op.mm(x) * self._scale


class CountingOperator(_Wrapped):
    """Pass-through wrapper counting mv/mm applications (a widened-basis
    retry must actually re-stream the operator)."""

    def __init__(self, op):
        super().__init__(op)
        self.mv_calls = 0
        self.mm_calls = 0

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        self.mv_calls += 1
        return self._op.mv(x)

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        self.mm_calls += 1
        return self._op.mm(x)


# ---------------------------------------------------------------------------
# Solver faults
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def forced_nonconvergence(residual: float = 1.0,
                          recover_after: Optional[int] = None):
    """Force ``converged=False`` (and ``residual`` in every residual slot) out
    of :func:`repro_torch.core.lanczos.eigsh` inside the block.

    Patches the module attribute the pipeline dispatches through, so the real
    solver still runs — only its verdict is falsified.  ``recover_after=n``
    lets calls from the n-th on (0-indexed) report the truth again, which is
    how tests exercise a ladder that succeeds mid-climb.  Yields a
    one-element call-count list.
    """
    import repro_torch.core.lanczos as lz

    orig = lz.eigsh
    calls = [0]

    def poisoned(op, cfg, **kw):
        i = calls[0]
        calls[0] += 1
        res = orig(op, cfg, **kw)
        if recover_after is not None and i >= recover_after:
            return res
        return res._replace(converged=False,
                            residuals=torch.full_like(res.residuals, residual))

    lz.eigsh = poisoned
    try:
        yield calls
    finally:
        lz.eigsh = orig


# ---------------------------------------------------------------------------
# Stage faults
# ---------------------------------------------------------------------------

def wrap_stage(pipe, stage: str, transform: Callable):
    """A copy of ``pipe`` whose ``_stage_<stage>`` output state passes
    through ``transform`` — a fault injected *between* two stages of the DAG.

    Built as a throwaway subclass, so the stage DAG (``run_stages``'s
    getattr dispatch, provenance, reports) is exactly the production path.
    """
    cls = type(pipe)
    name = f"_stage_{stage}"
    orig = getattr(cls, name)

    def patched(self, st):
        return transform(orig(self, st))

    sub = type(f"Faulty_{cls.__name__}", (cls,), {name: patched})
    return sub(**{f.name: getattr(pipe, f.name) for f in dataclasses.fields(pipe)})


def poison_embedding(st):
    """A :func:`wrap_stage` transform: NaN one entry of the embedding (the
    cached-embedding corruption the cluster stage's input guard catches)."""
    emb = st.embedding
    h = emb.embedding.clone()
    h[0, 0] = float("nan")
    return dataclasses.replace(st, embedding=emb._replace(embedding=h))


# ---------------------------------------------------------------------------
# Input corruptors
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def poison_points(x, n_bad: int = 3, value: float = np.nan, seed: int = 0) -> np.ndarray:
    """A host copy of the feature matrix with ``n_bad`` poisoned entries."""
    x = np.array(_host(x), dtype=np.float32, copy=True)
    rng = np.random.RandomState(seed)
    flat = rng.choice(x.size, size=n_bad, replace=False)
    x.reshape(-1)[flat] = value
    return x


def poison_graph(w: COO, n_bad: int = 3, value: float = np.nan, seed: int = 0) -> COO:
    """A copy of the similarity graph with ``n_bad`` poisoned edge weights
    (NaN by default; a negative ``value`` for the negative-weight guard), on
    the graph's device."""
    val = np.array(_host(w.val), dtype=np.float32, copy=True)
    rng = np.random.RandomState(seed)
    idx = rng.choice(val.size, size=min(n_bad, val.size), replace=False)
    val[idx] = value
    return COO(row=w.row, col=w.col, val=torch.as_tensor(val, device=w.val.device),
               shape=w.shape, sorted_rows=w.sorted_rows)
