"""Stage 2 alternative — Chebyshev polynomial-filter spectral embeddings
(mirrors :mod:`repro.core.chebyshev`).

Filtering a small block of random signals through a polynomial
approximation of the spectral projector ``P = 1_{λ ≥ λ_cut}(A)`` yields an
embedding whose pairwise geometry (and hence k-means labels) matches the
eigenvector embedding (Compressive Spectral Clustering, Tremblay et al.),
without Lanczos's reorthogonalization GEMMs or its tall-skinny QRs.  The
pipeline, driven through ``op.mv``/``op.mm`` (and the optional fused
``op.cheb_step``):

1. **spectral bounds** ``[lo, hi] ⊇ spec(A)`` from a few plain Lanczos
   steps on ``op.mv`` (:func:`estimate_spectral_bounds`);
2. **λ_cut selection** when only k is given: Chebyshev (KPM) moments of the
   spectral density from Hutchinson probes (:func:`chebyshev_moments`), then
   eigencount bisection on the moment vector (:func:`find_cut_from_moments`)
   — one degree-deep pass of the operator for the whole bisection;
3. **Jackson-damped step filter** h ≈ 1_{[λ_cut, hi]} applied to an
   ``[n, R]`` Rademacher sketch via the three-term recurrence
   (:func:`chebyshev_filter`) — no orthogonalization of any kind;
4. **one QR + Rayleigh-Ritz** on the filtered block, returning Ritz values
   and an ``[n, k]`` embedding through the
   :class:`~repro_torch.core.lanczos.LanczosResult` contract.

Cost: ``operator_streams(cfg)`` operator applications, fixed and
independent of convergence behaviour.

Random draws: the reference splits its key into three (bounds start vector,
moment probes, sketch).  Here :func:`draw_signals` makes the same three as
draws 0, 1, 2 of a counter-based stream (:mod:`repro_torch._random`) keyed
from the caller's CPU generator, on the device, each in one pass — one
module-level helper, so a parity test can substitute the reference's
draws.  The loops are Python loops over device tensors; the
spectral interval, the cut and the filter weights stay on the device, so
the filter reads nothing back to the host.

On a mesh (an operator with ``rows``, see :mod:`repro_torch.core.lanczos`)
the vectors and blocks are this rank's rows: the three draws are made whole
and sliced (zero on the rows a padded graph adds), the bounds estimator's dot products and norms, the Hutchinson
moments (summed locally, all-reduced once) and the Rayleigh–Ritz Gram are
all-reduced, and the QR is tall-skinny, so the interval, the cut, the Ritz
values and the residuals are the same on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import _random
from repro_torch._device import cpu_generator
from repro_torch.core.lanczos import LanczosResult, _eigh, _op_device
from repro_torch.sparse.distributed import RowBlock


@dataclasses.dataclass(frozen=True)
class ChebConfig:
    """Chebyshev polynomial-filter embedding knobs (the ``solver="chebyshev"``
    engine behind :class:`~repro_torch.core.spectral.EigConfig`).

    ``k`` is the number of returned columns/eigenvalue estimates; the sketch
    width R is ``n_signals`` (``None`` → k + 8; R < k is the compressive
    regime, where the embedding stays R wide).  ``lambda_cut`` is the
    passband edge in the operator's eigenvalue units ("keep eigenvalues ≥
    λ_cut" for ``which="LA"``); ``None`` locates it by eigencount bisection
    targeting k eigenvalues in the passband.
    """

    k: int  # wanted embedding columns / eigenpair estimates
    degree: int = 64  # Chebyshev filter degree M (transition sharpness)
    n_signals: Optional[int] = None  # sketch width R; None → k + 8
    lambda_cut: Optional[float] = None  # passband edge; None → bisection
    which: str = "LA"  # "LA": filter the top of the spectrum ("SA" negates)
    n_probes: int = 8  # Hutchinson probes for the eigencount moments
    bisect_iters: int = 30  # bisection steps on the moment-based eigencount
    bounds_iters: int = 12  # Lanczos steps for the spectral-interval estimate
    margin: float = 0.01  # relative widening of the estimated interval
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"ChebConfig.k must be >= 1, got {self.k}")
        if self.degree < 1:
            raise ValueError(f"ChebConfig.degree must be >= 1, got {self.degree}")
        if self.n_signals is not None and self.n_signals < 1:
            raise ValueError(f"ChebConfig.n_signals must be >= 1, got {self.n_signals}")
        if self.n_probes < 1:
            raise ValueError(f"ChebConfig.n_probes must be >= 1, got {self.n_probes}")
        if self.bounds_iters < 2:
            raise ValueError(f"ChebConfig.bounds_iters must be >= 2, got {self.bounds_iters}")
        if self.which not in ("LA", "SA"):
            raise ValueError(f"ChebConfig.which must be 'LA' or 'SA', got {self.which!r}")


def resolved_signals(cfg: ChebConfig) -> int:
    """The sketch width R the solver will actually run."""
    return cfg.n_signals if cfg.n_signals is not None else cfg.k + 8


def operator_streams(cfg: ChebConfig) -> int:
    """Operator applications of one Chebyshev embedding: bounds estimation
    + (moments, only when λ_cut must be located) + the filter + one
    Rayleigh-Ritz apply (cf. :func:`repro_torch.core.lanczos.operator_passes`)."""
    streams = cfg.bounds_iters + cfg.degree + 1
    if cfg.lambda_cut is None:
        streams += cfg.degree
    return streams


# ---------------------------------------------------------------------------
# Filter construction: Jackson-damped Chebyshev expansion of the step
# ---------------------------------------------------------------------------

def jackson_damping(degree: int, device=None) -> torch.Tensor:
    """Jackson damping factors g_0..g_M — they turn the truncated Chebyshev
    series into a positive kernel, so the step filter does not amplify
    eigenvalues just below the cut (Gibbs overshoot)."""
    m = degree + 1
    j = torch.arange(m, dtype=torch.float32, device=device)
    alpha = math.pi / (m + 1)
    tan_alpha = torch.tan(torch.tensor(alpha, dtype=torch.float32, device=device))
    g = ((m - j + 1) * torch.cos(j * alpha) + torch.sin(j * alpha) / tan_alpha) / (m + 1)
    return g / g[0]  # normalize g_0 = 1 exactly


def step_coefficients(a: torch.Tensor, degree: int) -> torch.Tensor:
    """Chebyshev coefficients c_0..c_M of the step 1_{[a, 1]} on [-1, 1]:
    c_0 = arccos(a)/π, c_j = 2 sin(j·arccos(a))/(jπ)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    theta = torch.arccos(torch.clamp(a, -1.0, 1.0))
    j = torch.arange(1, degree + 1, dtype=torch.float32, device=a.device)
    cj = 2.0 * torch.sin(j * theta) / (j * math.pi)
    return torch.cat([(theta / math.pi).reshape(1), cj])


def filter_weights(a: torch.Tensor, degree: int) -> torch.Tensor:
    """Damped filter coefficients g_j·c_j(a) — shared by the filter and the
    eigencount, so the bisection tunes the exact filter that is applied."""
    c = step_coefficients(a, degree)
    return jackson_damping(degree, c.device) * c


def filter_response(lam: torch.Tensor, a, lo, hi, degree: int) -> torch.Tensor:
    """Scalar transfer function h(λ) of the damped filter (diagnostics and
    tests: the dense-projector oracle is V·diag(h(Λ))·Vᵀ)."""
    lam = torch.as_tensor(lam, dtype=torch.float32)
    t = torch.clamp((2.0 * lam - (hi + lo)) / (hi - lo), -1.0, 1.0)
    w = filter_weights(torch.as_tensor(a, dtype=torch.float32, device=lam.device), degree)
    theta = torch.arccos(t)
    tj = torch.cos(torch.arange(degree + 1, dtype=torch.float32, device=lam.device)[:, None]
                   * theta[None, :])  # T_j(t) = cos(j·arccos t)
    return (w[:, None] * tj).sum(0)


# ---------------------------------------------------------------------------
# Random signals
# ---------------------------------------------------------------------------

def draw_signals(gen: torch.Generator, n: int, n_probes: int, r: int,
                 device: torch.device):
    """The solver's three draws, as the reference's ``split(key, 3)``: the
    bounds estimator's start vector (normal ``[n]``), the moment probes
    (Rademacher ``[n, n_probes]``) and the sketch (Rademacher ``[n, r]``),
    draws 0, 1, 2 of the stream keyed from ``gen``, made on ``device``."""
    rng = _random.Stream.from_generator(gen)
    return (rng.normal((n,), device), rng.rademacher((n, n_probes), device),
            rng.rademacher((n, r), device))


# ---------------------------------------------------------------------------
# Interval selection
# ---------------------------------------------------------------------------

def estimate_spectral_bounds(op, v: torch.Tensor, *, iters: int = 12, margin: float = 0.01,
                             rows: Optional[RowBlock] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi] ⊇ spec(op) from ``iters`` plain Lanczos steps on ``op.mv``
    started from ``v`` (the reference draws it from its key).

    The Ritz interval of an un-reorthogonalized run underestimates the true
    extremes; widening by the final residual norm β plus a relative
    ``margin`` keeps the interval safe for the Chebyshev map — an interval
    that misses part of the spectrum makes the recurrence diverge
    geometrically.  Returns 0-d float32 tensors on the device of ``v``.
    ``v`` is whole; ``rows`` (a mesh's) runs the steps on this rank's rows.
    """
    n = op.shape[0]
    rows = RowBlock.whole(n) if rows is None else rows
    steps = min(iters, max(2, n - 1))
    f32 = torch.float32
    v = v.to(f32)
    v = rows.take(v / torch.clamp(torch.linalg.norm(v), min=1e-30))
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=f32, device=v.device)
    alphas, betas = [], []
    for _ in range(steps):
        w = op.mv(v).to(f32) - beta * v_prev
        alpha = rows.psum(v @ w)
        w = w - alpha * v
        beta_new = rows.norm(w)
        # invariant-subspace breakdown: freeze the direction; the recorded
        # beta = 0 decouples the tridiagonal, which is exactly right
        v_new = torch.where(beta_new > 1e-10, w / torch.clamp(beta_new, min=1e-30), v)
        v_prev, v, beta = v, v_new, beta_new
        alphas.append(alpha)
        betas.append(beta_new)
    alphas, betas = torch.stack(alphas), torch.stack(betas)
    off = betas[:-1].double()
    t = torch.diag(alphas.double()) + torch.diag(off, 1) + torch.diag(off, -1)
    # float64, as the Rayleigh-Ritz eigh below (ROADMAP §C P1: float32
    # cuSOLVER eigh shifted every eigenvalue by ~5.5e-5 on the H100)
    ritz = torch.linalg.eigvalsh(t).to(f32)
    beta_last = betas[-1]
    lo = ritz[0] - beta_last
    hi = ritz[-1] + beta_last
    pad = margin * torch.clamp(hi - lo, min=1e-3)
    return lo - pad, hi + pad


def chebyshev_moments(op, lo, hi, degree: int, z: torch.Tensor, *,
                      rows: Optional[RowBlock] = None) -> torch.Tensor:
    """KPM moments μ_j ≈ tr(T_j(Ã)), j = 0..degree, from the Rademacher
    probe block ``z [n, n_probes]`` (Hutchinson: μ_j = mean_r z_rᵀ T_j(Ã)
    z_r).  One degree-deep recurrence over ``op.mm`` yields the whole
    moment vector; every eigencount evaluation is then a dot product.
    ``z`` is whole; ``rows`` (a mesh's) runs the recurrence on this rank's
    rows, and the probes' dot products are summed locally and all-reduced
    once, after the recurrence."""
    n = op.shape[0]
    rows = RowBlock.whole(n) if rows is None else rows
    f32 = torch.float32
    z = rows.take(z.to(f32))
    ca = 4.0 / (hi - lo)
    cb = -2.0 * (hi + lo) / (hi - lo)
    t0 = z
    t1 = 0.5 * (ca * op.mm(z).to(f32) + cb * z)
    dots = [(z * t1).sum(0)]  # [n_probes] a moment: Σ over this rank's rows
    tp, tc = t0, t1
    for _ in range(degree - 1):
        tn = ca * op.mm(tc).to(f32) + cb * tc - tp
        dots.append((z * tn).sum(0))
        tp, tc = tc, tn
    if rows.split:
        dots = list(rows.psum(torch.stack(dots)))
    n_live = n if rows.live is None else rows.live  # zᵀz exactly (zero padding rows)
    mus = [torch.tensor(float(n_live), dtype=f32, device=z.device)]
    return torch.stack(mus + [d.mean() for d in dots])[: degree + 1]


def eigencount_from_moments(moments: torch.Tensor, a) -> torch.Tensor:
    """Damped-step eigencount #{λ : mapped(λ) ≥ a} ≈ Σ_j g_j c_j(a) μ_j —
    smooth in ``a`` (the Jackson kernel), hence bisectable."""
    a = torch.as_tensor(a, dtype=torch.float32, device=moments.device)
    return filter_weights(a, moments.shape[0] - 1) @ moments


def find_cut_from_moments(moments: torch.Tensor, k: int, *, iters: int = 30) -> torch.Tensor:
    """Bisect the mapped cut a ∈ (-1, 1) so the damped eigencount ≈ k (the
    count is non-increasing in a).  Runs where the moments live, without
    reading them back."""
    dev = moments.device
    alo = torch.tensor(-0.999, dtype=torch.float32, device=dev)
    ahi = torch.tensor(0.999, dtype=torch.float32, device=dev)
    for _ in range(iters):
        mid = 0.5 * (alo + ahi)
        too_many = eigencount_from_moments(moments, mid) > float(k)
        alo, ahi = torch.where(too_many, mid, alo), torch.where(too_many, ahi, mid)
    return 0.5 * (alo + ahi)


# ---------------------------------------------------------------------------
# The filter
# ---------------------------------------------------------------------------

def chebyshev_filter(op, x: torch.Tensor, lo, hi, a, degree: int, *,
                     sign: float = 1.0) -> torch.Tensor:
    """h(A)·x for the Jackson-damped step filter h ≈ 1_{[a, 1]} on the
    mapped spectrum, by the three-term recurrence.

    Each step is one operator application plus an AXPY chain.  When the
    operator provides the fused ``cheb_step`` hook (``ca·(A x) + cb·x −
    prev`` — :class:`~repro_torch.core.operator.BlockEllOperator` runs it
    as the ``ell_spmm`` kernel's epilogue), the chain rides the SpMM pass.
    The damped sum accumulates in place.
    """
    f32 = torch.float32
    x = x.to(f32)
    ca = (sign * 4.0 / (hi - lo)).to(f32)
    cb = (-2.0 * (hi + lo) / (hi - lo)).to(f32)
    fused = getattr(op, "cheb_step", None)
    if fused is not None:
        def step(t_cur, t_prev):
            return fused(t_cur, t_prev, ca, cb)
    else:
        def step(t_cur, t_prev):
            return ca * op.mm(t_cur).to(f32) + cb * t_cur - t_prev

    w = filter_weights(torch.as_tensor(a, dtype=f32, device=x.device), degree)
    t0 = x
    t1 = 0.5 * step(x, torch.zeros_like(x))  # T_1 = Ã x
    acc = w[0] * t0 + w[1] * t1
    tp, tc = t0, t1
    for j in range(2, degree + 1):
        tn = step(tc, tp)
        acc.addcmul_(tn, w[j])
        tp, tc = tc, tn
    return acc


# ---------------------------------------------------------------------------
# The solver entry (dispatched from repro_torch.core.lanczos.eigsh)
# ---------------------------------------------------------------------------

def chebyshev_eigsh(op, cfg: ChebConfig, *, v0: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> LanczosResult:
    """Polynomial-filtered randomized embedding of the dominant eigenspace,
    returned through the :class:`~repro_torch.core.lanczos.LanczosResult`
    contract.

    Filter an [n, R] Rademacher sketch through the damped step filter, QR
    the result (whitening), then Rayleigh-Ritz on the R-dimensional basis:
    ``B = QᵀAQ`` (one more operator application), eigh of the R×R block,
    rotate.  Returns min(k, R) Ritz pairs in descending order.  ``restarts``
    is 0 and ``converged`` True (a fixed-cost filter, not an iterative
    solver); ``residuals`` carries ‖A u − θ u‖ as the accuracy diagnostic.
    Runs on the device of ``v0`` (else the operator's), where
    :func:`draw_signals` makes the draws from a stream keyed by the CPU
    ``generator`` (seed 0 by default).  ``v0`` is whole; under an operator
    with ``rows`` the Ritz vectors are this rank's rows of them.
    """
    from repro_torch.core.operator import row_block

    n = op.shape[0]
    r = resolved_signals(cfg)
    if r > n:
        raise ValueError(
            f"ChebConfig needs n_signals <= n, got R={r} > n={n} — the "
            f"filtered sketch is QR-factorized, so at most n columns are "
            f"independent; reduce n_signals (or k: the default R is k + 8)")
    if cfg.k > n:
        raise ValueError(f"ChebConfig.k={cfg.k} exceeds the operator dimension n={n}")
    gen = cpu_generator(0) if generator is None else generator
    dev = _op_device(op, v0)
    f32 = torch.float32
    sign = 1.0 if cfg.which == "LA" else -1.0  # "SA" filters -A's top

    rows = row_block(op, n)
    # zero on a padded graph's padding rows, so the moments, the bounds and
    # the sketch are those of the real rows
    v_bounds, z, g = (rows.pad(t) for t in draw_signals(gen, n, cfg.n_probes, r, dev))
    n_live = n if rows.live is None else rows.live
    lo, hi = estimate_spectral_bounds(_signed(op, sign), v_bounds, iters=cfg.bounds_iters,
                                      margin=cfg.margin, rows=rows)
    if cfg.lambda_cut is not None:
        cut = torch.tensor(sign * cfg.lambda_cut, dtype=f32, device=dev)
        a = torch.clamp((2.0 * cut - (hi + lo)) / (hi - lo), -0.999, 0.999)
    else:
        mom = chebyshev_moments(_signed(op, sign), lo, hi, cfg.degree, z, rows=rows)
        a = find_cut_from_moments(mom, cfg.k, iters=cfg.bisect_iters)

    if v0 is not None:
        # seed the sketch with the caller's start vector (the pipeline passes
        # the exact trivial eigenvector, so it is in the subspace)
        v = v0.to(dev, f32)
        g[:, 0] = rows.pad(v) * (math.sqrt(float(n_live))
                                 / torch.clamp(torch.linalg.norm(v), min=1e-30))

    y = chebyshev_filter(op, rows.take(g), lo, hi, a, cfg.degree, sign=sign)
    q, _ = rows.qr(y)  # [n, R] whitened basis
    aq = sign * op.mm(q).to(f32)  # one more operator application
    b = rows.psum(q.T @ aq)
    # the R×R Rayleigh-Ritz problem in float64; a diverged filter's
    # non-finite block comes back as NaN pairs for the embed stage's ladder
    theta, s = _eigh(b)  # ascending [R]
    kk = min(cfg.k, r)
    sel = s[:, r - kk:].flip(1)  # top-kk, descending
    vals = theta[r - kk:].flip(0)
    u = q @ sel  # [n, kk] Ritz vectors
    resid = rows.norm(aq @ sel - u * vals[None, :], dim=0)
    return LanczosResult(
        eigenvalues=(vals * sign).to(cfg.dtype),
        eigenvectors=u.to(cfg.dtype),
        residuals=resid.to(cfg.dtype),
        restarts=0,
        converged=True,
    )


def diverged(laplacian_eigenvalues, *, slack: float = 0.5) -> bool:
    """Host-side bounds-containment check on a finished filter embedding.

    The recurrence diverges geometrically when a true eigenvalue escapes the
    estimated ``[lo, hi]``, so a containment miss shows after the fact: the
    Laplacian eigenvalues of the sym-normalized graph lie in [0, 2];
    non-finite or far-outside values mean the subspace is garbage.  Read by
    the embed stage's escalation ladder (widen ``margin`` → fall back to
    Lanczos).
    """
    if isinstance(laplacian_eigenvalues, torch.Tensor):
        laplacian_eigenvalues = laplacian_eigenvalues.detach().cpu().numpy()
    vals = np.asarray(laplacian_eigenvalues)
    if not np.isfinite(vals).all():
        return True
    return bool(np.max(np.abs(1.0 - vals)) > 1.0 + slack)


class _signed:
    """Sign-flipping operator view (``which="SA"`` filters the top of −A)."""

    def __init__(self, op, sign: float):
        self._op = op
        self._sign = sign
        self.shape = op.shape

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        y = self._op.mv(x)
        return y if self._sign == 1.0 else -y

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        y = self._op.mm(x)
        return y if self._sign == 1.0 else -y
