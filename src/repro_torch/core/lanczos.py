"""Stage 2b — restarted Lanczos eigensolver (paper Alg. 3; mirrors
:mod:`repro.core.lanczos`).

Thick-restart Lanczos (Wu & Simon 2000; equivalent to ARPACK's symmetric
IRLM) with full two-pass Gram-Schmidt reorthogonalization, the projected
matrix ``T`` measured rather than assumed, and the m×m eigenproblem solved
with ``torch.linalg.eigh`` on the device.  Block mode (``block_size = b >
1``) grows the basis b columns per operator application, so the sparse
matrix is streamed m/b times per basis instead of m.

The reference's ``lax`` loops are Python loops here.  The host reads the
device once per restart cycle: whether any step of the cycle broke down
(an invariant subspace was hit) together with the converged count — and
not at all on ``meta`` tensors (the dry-run), where ``fixed_restarts`` sets
the cycle count and the converged flag stays a tensor.  A
breakdown needs fresh random directions, which are drawn only when they are
needed, each the next draw of a counter-based stream
(:mod:`repro_torch._random`) keyed from the caller's CPU generator; a
cycle that broke down is therefore replayed from its saved start with a
host check after every step, and its draws then land exactly where a
step-by-step run would have put them.  The draws are made on the device,
and one seed gives the same draws on the CPU and on the card.

On a mesh (an operator with a :class:`~repro_torch.sparse.distributed.RowBlock`,
``op.rows``, such as :class:`~repro_torch.core.operator.ShardedCooOperator`
over a mesh) the basis is distributed by rows as the reference's specs
distribute it: each rank keeps its [m+b, rows] block, every contraction
over n all-reduces its small result (the Gram–Schmidt couplings, the
norms), the QRs are tall-skinny (:meth:`RowBlock.qr`), and v0, X0 and the
careful path's random directions are drawn whole from the one stream and
sliced, so each rank's rows are the one-device draw's (zero on the rows
a padded graph adds, which the Krylov space then never reaches).  T, its eigenpairs,
the residuals and the breakdown and convergence flags come from
all-reduced values and are the same on every rank, so every rank takes the
same control path.  On a one-rank axis nothing of this changes a bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import _random
from repro_torch._device import cpu_generator
from repro_torch.core import health
from repro_torch.sparse.distributed import RowBlock


class LanczosResult(NamedTuple):
    eigenvalues: torch.Tensor  # [k]  descending (for which="LA")
    eigenvectors: torch.Tensor  # [n, k] (a mesh's rank: its rows of them)
    residuals: torch.Tensor  # [k]  per returned pair
    restarts: int  # restart cycles executed
    converged: bool


@dataclasses.dataclass(frozen=True)
class LanczosConfig:
    k: int  # wanted eigenpairs
    m: int  # Krylov basis size (ARPACK's ncv), > k
    max_restarts: int = 100
    tol: float = 1e-6
    which: str = "LA"  # "LA": largest algebraic; "SA": smallest
    fixed_restarts: Optional[int] = None  # exact cycle count (benchmarks)
    dtype: torch.dtype = torch.float32
    block_size: int = 1  # Krylov block width b (1 = classic single-vector)


def default_config(k: int, n: int, **kw) -> LanczosConfig:
    m = min(n, max(2 * k, k + 16))
    return LanczosConfig(k=k, m=m, **kw)


# ---------------------------------------------------------------------------
# Static shape/cost helpers
# ---------------------------------------------------------------------------

def effective_basis_size(cfg: LanczosConfig) -> int:
    """m rounded up to a multiple of the block size."""
    b = max(1, cfg.block_size)
    return ((cfg.m + b - 1) // b) * b


def restart_keep_size(cfg: LanczosConfig) -> int:
    """Ritz vectors kept at a thick restart: k + half the excess (block mode
    rounds up to a block multiple, capped at m - b)."""
    b = max(1, cfg.block_size)
    m = effective_basis_size(cfg)
    l0 = cfg.k + max(1, (m - cfg.k) // 2)
    if b == 1:
        return min(m - 1, l0)
    return min(m - b, ((l0 + b - 1) // b) * b)


def operator_passes(cfg: LanczosConfig, restarts: int) -> int:
    """Full streams of the sparse operator executed by a run of ``restarts``
    cycles (first cycle included)."""
    b = max(1, cfg.block_size)
    m = effective_basis_size(cfg)
    l_keep = restart_keep_size(cfg)
    return m // b + max(0, int(restarts) - 1) * ((m - l_keep) // b)


def solver_streams(cfg, result=None) -> int:
    """Operator streams of a Stage-2 run: for a
    :class:`~repro_torch.core.chebyshev.ChebConfig` its fixed
    :func:`~repro_torch.core.chebyshev.operator_streams` (``result``
    ignored); for a :class:`LanczosConfig` :func:`operator_passes` of the
    executed restart count (pass the :class:`LanczosResult` or an int)."""
    from repro_torch.core.chebyshev import ChebConfig, operator_streams

    if isinstance(cfg, ChebConfig):
        return operator_streams(cfg)
    if not isinstance(cfg, LanczosConfig):
        raise TypeError(
            f"solver_streams expects a LanczosConfig or ChebConfig, got "
            f"{type(cfg).__name__}")
    if result is None:
        raise ValueError(
            "solver_streams(LanczosConfig) needs the executed restart count "
            "— pass the LanczosResult (or an int restart count)")
    restarts = result if isinstance(result, int) else int(result.restarts)
    return operator_passes(cfg, restarts)


def streamed_nnz(op, cfg, result=None) -> int:
    """``solver_streams × op.nnz`` — stored entries moved by Stage 2."""
    nnz = getattr(op, "nnz", None)
    if nnz is None:
        raise TypeError(
            f"{type(op).__name__} exposes no nnz (closure-backed operators "
            f"have no stored-entry count) — report solver_streams alone")
    return solver_streams(cfg, result) * int(nnz)


def validate_basis(cfg: LanczosConfig, n: int) -> None:
    """Raise an actionable error for degenerate basis geometry."""
    b = max(1, cfg.block_size)
    if cfg.k < 1:
        raise ValueError(f"LanczosConfig.k must be >= 1, got {cfg.k}")
    if cfg.m <= cfg.k:
        raise ValueError(
            f"LanczosConfig.m={cfg.m} must exceed k={cfg.k} — the Krylov "
            f"basis (ARPACK's ncv) needs room beyond the wanted pairs")
    m = effective_basis_size(cfg)
    if m + b > n:
        raise ValueError(
            f"LanczosConfig(k={cfg.k}, m={cfg.m}, block_size={cfg.block_size})"
            f" needs {m} basis + {b} residual column(s) = {m + b} orthonormal"
            f" vectors in R^n but the operator dimension is n={n}: reduce k, "
            f"shrink m, or use a dense torch.linalg.eigh")
    if b > 1 and m < cfg.k + 2 * b:
        raise ValueError(
            f"block Lanczos needs m >= k + 2*block_size so every restart "
            f"cycle runs at least two block steps (m={m}, k={cfg.k}, b={b})")


def escalate_basis(cfg: LanczosConfig, n: int, *, widen: float = 1.5) -> LanczosConfig:
    """Next rung of the non-convergence ladder: widen the Krylov basis
    (clamped to ``n - b``) and double the restart budget."""
    if widen <= 1.0:
        raise ValueError(f"escalate_basis widen must be > 1, got {widen}")
    b = max(1, cfg.block_size)
    m = min(int(cfg.m * widen) + 1, n - b)
    return dataclasses.replace(
        cfg, m=max(m, cfg.m), max_restarts=max(1, cfg.max_restarts) * 2)


def _eigh(Tm: torch.Tensor):
    """Ascending eigenpairs of the projected matrix, symmetrized first as
    ``jnp.linalg.eigh`` does (T's two triangles are written separately).

    Solved in float64 and rounded to float32: with cuSOLVER's float32
    ``eigh`` on an H100 every converged Laplacian eigenvalue of the
    4000-voxel DTI graph came out ~5.5e-5 below a float64 reference
    (``tests/test_torch_cuda.py`` holds the card to it).  The m×m problem is
    small beside the [m, n] basis work.

    A non-finite T (a NaN operator) makes torch's ``eigh`` raise where the
    reference's returns NaN: a zero block is solved instead and NaN pairs
    returned, for the embed stage's ladder to catch, with no host read."""
    T = 0.5 * (Tm + Tm.T).double()
    finite = torch.isfinite(T).all()
    theta, S = torch.linalg.eigh(torch.where(finite, T, 0.0))
    return (torch.where(finite, theta, math.nan).float(),
            torch.where(finite, S, math.nan).float())


def _op_device(op, v0) -> torch.device:
    if v0 is not None:
        return v0.device
    return torch.device(getattr(op, "device", "cpu"))


def eigsh(op, cfg, *, v0: Optional[torch.Tensor] = None,
          generator: Optional[torch.Generator] = None) -> LanczosResult:
    """Top-k eigenpairs of a symmetric
    :class:`~repro_torch.core.operator.LinearOperator`: the solver only
    calls ``op.mv`` or, with ``cfg.block_size > 1``, ``op.mm``.  A
    :class:`~repro_torch.core.chebyshev.ChebConfig` dispatches to the
    polynomial-filter embedding
    (:func:`repro_torch.core.chebyshev.chebyshev_eigsh`) under the same
    contract.  Runs on the device of ``v0`` (else the operator's); random
    draws are made there, from a stream keyed by one draw from the CPU
    ``generator`` (seed 0 by default).  ``v0`` is whole; under an operator
    with ``rows`` the eigenvectors are this rank's rows of them."""
    from repro_torch.core.chebyshev import ChebConfig, chebyshev_eigsh
    from repro_torch.core.operator import row_block

    if isinstance(cfg, ChebConfig):
        return chebyshev_eigsh(op, cfg, v0=v0, generator=generator)
    if not isinstance(cfg, LanczosConfig):
        raise TypeError(
            f"eigsh expects a LanczosConfig or ChebConfig, got {type(cfg).__name__}")
    n = op.shape[0]
    validate_basis(cfg, n)
    rng = _random.Stream.from_generator(cpu_generator(0) if generator is None else generator)
    dev = _op_device(op, v0)
    rows = row_block(op, n)
    if cfg.block_size > 1:
        return _lanczos_topk_block(op.mm, n, cfg, v0=v0, rng=rng, device=dev, rows=rows)
    return _lanczos_topk_single(op.mv, n, cfg, v0=v0, rng=rng, device=dev, rows=rows)


def lanczos_topk(matvec, n: int, cfg: LanczosConfig, *,
                 v0: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 matmat=None) -> LanczosResult:
    """Closure-based surface: :func:`eigsh` over a
    :class:`~repro_torch.core.operator.CallableOperator`."""
    from repro_torch.core.operator import CallableOperator

    dev = v0.device if v0 is not None else torch.device("cpu")
    return eigsh(CallableOperator(n=n, matvec=matvec, matmat=matmat, device=dev),
                 cfg, v0=v0, generator=generator)


# ---------------------------------------------------------------------------
# Shared restart driver
# ---------------------------------------------------------------------------

def _host_flags(broke: torch.Tensor, n_conv: torch.Tensor):
    """``(broke, n_conv)`` read back in one host read — the cycle's one; on
    values that are not concrete (``meta``) nothing is read: no breakdown
    can be seen, and the converged count stays a tensor."""
    if not health.is_concrete(broke, n_conv):
        return False, n_conv
    broke_h, n = torch.stack([broke.long(), n_conv]).tolist()
    return broke_h, n


def _drive(cfg: LanczosConfig, start, l_keep: int, cycle):
    """Run the first cycle (from l = 0, on ``start()``'s basis and
    projection), then steady cycles (from l_keep) until k pairs converge,
    the budget ends, or ``fixed_restarts`` is met.  ``cycle(V, T, l)``
    returns ``(next_V, next_T, extract, n_conv)``; ``fixed_restarts`` needs
    nothing from the host.  No frame keeps a basis the cycles are done with
    (the initial one is made here, not by the caller)."""
    V, T, out, n_conv = cycle(*start(), 0)
    restarts = 1
    if cfg.fixed_restarts is not None:
        for _ in range(cfg.fixed_restarts):
            V, T, out, n_conv = cycle(V, T, l_keep)
        restarts = 1 + cfg.fixed_restarts
    elif not health.is_concrete(n_conv):
        raise ValueError(
            "a Lanczos run on values that are not concrete (meta) needs "
            "LanczosConfig.fixed_restarts: the converged count cannot be read")
    else:
        while restarts < cfg.max_restarts and n_conv < cfg.k:
            V, T, out, n_conv = cycle(V, T, l_keep)
            restarts += 1
    return out, restarts, n_conv


def _extract(cfg: LanczosConfig, out, sign: float, restarts: int, n_conv: int):
    theta, S, V_old, res = out
    m, k = S.shape[0], cfg.k
    topk = slice(m - k, m)
    vals = theta[topk].flip(0) * sign  # descending, undo "SA" negation
    U = (S[:, topk].T @ V_old[:m]).to(cfg.dtype)  # [k, n]
    return LanczosResult(
        eigenvalues=vals.to(cfg.dtype),
        eigenvectors=U.flip(0).T,
        residuals=res[topk].flip(0).to(cfg.dtype),
        restarts=restarts,
        converged=n_conv >= k,
    )


# ---------------------------------------------------------------------------
# Single-vector thick-restart Lanczos
# ---------------------------------------------------------------------------

def _orthonormal_against(basis, rng, rows: RowBlock):
    """Random unit vector orthogonal to the (zero-padded) basis rows: an [n]
    draw (zero on padding rows), this rank's rows of it."""
    r = rows.take(rows.pad(rng.normal((rows.n,), basis.device)))
    r = r - basis.T @ rows.psum(basis @ r)
    return r / torch.clamp(rows.norm(r), min=1e-30)


def _lanczos_topk_single(matvec: Callable, n: int, cfg: LanczosConfig, *,
                         v0, rng, device, rows: RowBlock) -> LanczosResult:
    k, m = cfg.k, cfg.m
    f32 = torch.float32
    v0 = rows.pad(rng.normal((n,), device) if v0 is None else v0.to(device, f32))
    v0 = rows.take(v0 / torch.clamp(torch.linalg.norm(v0), min=1e-30))
    sign = 1.0 if cfg.which == "LA" else -1.0
    l_keep = restart_keep_size(cfg)

    def step(V, T, j, careful):
        """Expand basis row j+1 and record T row/col j; returns the device
        breakdown flag (or None once handled on the host)."""
        w = matvec(V[j]).to(f32) * sign
        c = rows.psum(V @ w)
        T[j, :] = c
        T[:, j] = c
        w = w - V.T @ c
        w = w - V.T @ rows.psum(V @ w)  # second Gram-Schmidt pass
        beta = rows.norm(w)
        ok = beta > 1e-10
        v_next = w / torch.clamp(beta, min=1e-30)
        if careful:
            if not bool(ok):
                v_next = _orthonormal_against(V, rng, rows)
            ok = None
        V[j + 1] = v_next
        T[j + 1, j] = beta
        T[j, j + 1] = beta
        return ok

    def cycle(V, T, l):
        T0 = T.clone()  # a cycle writes V only from row l+1, zero until then
        broke = torch.zeros((), dtype=torch.bool, device=device)
        for j in range(l, m):
            broke |= ~step(V, T, j, careful=False)
        beta_m = T[m, m - 1]
        theta, S = _eigh(T[:m, :m])  # ascending
        res = torch.abs(beta_m * S[m - 1, :])
        scale = torch.clamp(theta.abs().max(), min=1e-12)
        n_conv_t = (res[m - k:] <= cfg.tol * scale).sum()
        broke_h, n_conv = _host_flags(broke, n_conv_t)
        if broke_h:  # replay the cycle with a host check per step
            V[l + 1:] = 0
            T = T0
            for j in range(l, m):
                step(V, T, j, careful=True)
            beta_m = T[m, m - 1]
            theta, S = _eigh(T[:m, :m])
            res = torch.abs(beta_m * S[m - 1, :])
            scale = torch.clamp(theta.abs().max(), min=1e-12)
            n_conv = int((res[m - k:] <= cfg.tol * scale).sum())
        keep = slice(m - l_keep, m)
        V_new = torch.zeros_like(V)
        V_new[:l_keep] = S[:, keep].T @ V[:m]  # Ritz vectors
        V_new[l_keep] = V[m]
        h = beta_m * S[m - 1, keep]
        T_new = torch.zeros_like(T)
        ar = torch.arange(l_keep, device=device)
        T_new[ar, ar] = theta[keep]
        T_new[l_keep, :l_keep] = h
        T_new[:l_keep, l_keep] = h
        return V_new, T_new, (theta, S, V, res), n_conv

    def start():
        V = torch.zeros((m + 1, rows.size), dtype=f32, device=device)
        V[0] = v0
        return V, torch.zeros((m + 1, m + 1), dtype=f32, device=device)

    out, restarts, n_conv = _drive(cfg, start, l_keep, cycle)
    return _extract(cfg, out, sign, restarts, n_conv)


# ---------------------------------------------------------------------------
# Block thick-restart Lanczos
# ---------------------------------------------------------------------------

def _orthonormal_block_against(basis, b: int, rng, rows: RowBlock):
    """[n, b] random directions orthogonal to the basis rows and to each
    other: an [n, b] draw (zero on padding rows), this rank's rows of it."""
    r = rows.take(rows.pad(rng.normal((rows.n, b), basis.device)))
    r = r - basis.T @ rows.psum(basis @ r)
    q, _ = rows.qr(r)
    return q


def _lanczos_topk_block(matmat: Callable, n: int, cfg: LanczosConfig, *,
                        v0, rng, device, rows: RowBlock) -> LanczosResult:
    """Block thick-restart Lanczos: one ``matmat`` streams the operator for
    b new columns; reorthogonalization is [m+b, n]·[n, b] GEMM pairs; the
    in-block factorization is a [n, b] QR whose R is the band coupling."""
    k, b = cfg.k, cfg.block_size
    m = effective_basis_size(cfg)
    f32 = torch.float32
    X0 = rng.normal((n, b), device)
    if v0 is not None:
        X0[:, 0] = v0.to(device, f32)
    Q0, _ = rows.qr(rows.take(rows.pad(X0)))  # column 0 keeps v0's direction
    sign = 1.0 if cfg.which == "LA" else -1.0
    l_keep = restart_keep_size(cfg)

    def step(V, T, j, careful):
        """Expand basis rows j+b..j+2b-1 and record the T blocks."""
        W = matmat(V[j:j + b].T).to(f32).T * sign  # [b, n] — one operator stream
        C = rows.psum(V @ W.T)  # [m+b, b] couplings
        T[:, j:j + b] = C
        T[j:j + b, :] = C.T
        W = W - C.T @ V
        W = W - rows.psum(V @ W.T).T @ V  # second Gram-Schmidt pass
        Q, R = rows.qr(W.T)  # [n, b], [b, b]
        ok = torch.diagonal(R).abs() > 1e-10
        if careful:
            if not bool(ok.all()):  # escape deficient directions
                E = _orthonormal_block_against(V, b, rng, rows)
                Q = torch.where(ok[None, :], Q, E)
            ok = None
        else:
            ok = ok.all()
        Qf = Q - V.T @ rows.psum(V @ Q)  # cleanup vs old basis
        Q2, R2 = rows.qr(Qf)
        B = R2 @ R  # deficient columns of R are ~0 -> ~zero coupling
        V[j + b:j + 2 * b] = Q2.T
        T[j + b:j + 2 * b, j:j + b] = B
        T[j:j + b, j + b:j + 2 * b] = B.T
        return ok

    def ritz(T):
        Bm = T[m:m + b, m - b:m]  # last band coupling block
        theta, S = _eigh(T[:m, :m])  # ascending
        res = torch.linalg.norm(Bm @ S[m - b:, :], dim=0)
        scale = torch.clamp(theta.abs().max(), min=1e-12)
        return Bm, theta, S, res, (res[m - k:] <= cfg.tol * scale).sum()

    def cycle(V, T, l):
        T0 = T.clone()  # a cycle writes V only from row l+b, zero until then
        broke = torch.zeros((), dtype=torch.bool, device=device)
        for j in range(l, m, b):
            broke |= ~step(V, T, j, careful=False)
        Bm, theta, S, res, n_conv_t = ritz(T)
        broke_h, n_conv = _host_flags(broke, n_conv_t)
        if broke_h:  # replay the cycle with a host check per step
            V[l + b:] = 0
            T = T0
            for j in range(l, m, b):
                step(V, T, j, careful=True)
            Bm, theta, S, res, n_conv_t = ritz(T)
            n_conv = int(n_conv_t)
        keep = slice(m - l_keep, m)
        V_new = torch.zeros_like(V)
        V_new[:l_keep] = S[:, keep].T @ V[:m]  # Ritz vectors
        V_new[l_keep:l_keep + b] = V[m:m + b]
        H = Bm @ S[m - b:, keep]  # [b, l_keep] restart couplings
        T_new = torch.zeros_like(T)
        ar = torch.arange(l_keep, device=device)
        T_new[ar, ar] = theta[keep]
        T_new[l_keep:l_keep + b, :l_keep] = H
        T_new[:l_keep, l_keep:l_keep + b] = H.T
        return V_new, T_new, (theta, S, V, res), n_conv

    def start():
        V = torch.zeros((m + b, rows.size), dtype=f32, device=device)
        V[:b] = Q0.T
        return V, torch.zeros((m + b, m + b), dtype=f32, device=device)

    out, restarts, n_conv = _drive(cfg, start, l_keep, cycle)
    return _extract(cfg, out, sign, restarts, n_conv)
