"""Stage 2 of the reference: the top-k eigenpairs of the normalised
adjacency, by Chebyshev-filtered subspace iteration with Rayleigh-Ritz
(Zhou & Saad 2007), a solver independent of the port's Lanczos.

The spectrum of ``D^{-1/2} W D^{-1/2}`` lies in [−1, 1] with 1 at its top.
A block of ``p > k`` vectors is filtered by a degree-``degree`` Chebyshev
polynomial that damps [−1, cut], where ``cut`` is the block's lowest Ritz
value, then orthonormalised (QR) and rotated onto the Ritz vectors of
``QᵀAQ``.  It stops when the k wanted pairs' residuals ``‖A u − θ u‖`` are
at most ``tol``, or after ``max_iter`` blocks.  Every product runs in the
precision asked for (:mod:`.precision`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from specbench.reference.precision import dtype_of, mm, sparse_operand


class Eigen(NamedTuple):
    values: torch.Tensor  # [k] descending
    vectors: torch.Tensor  # [n, k]
    residuals: torch.Tensor  # [k] ‖A u − θ u‖, computed in the solver's precision
    iterations: int


def _filter(a, x, lo: float, hi: float, degree: int, precision: str):
    """Chebyshev polynomial of degree ``degree`` in ``a`` applied to ``x``,
    damping [lo, hi]; each step rescaled (Zhou & Saad's scaled form)."""
    e, c = (hi - lo) / 2.0, (hi + lo) / 2.0
    sigma1 = e / (1.0 - c)  # the top, 1, maps to −1/σ1 ... scale by it
    sigma = sigma1
    y = (mm(a, x, precision) - c * x) * (sigma1 / e)
    for _ in range(2, degree + 1):
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        y_new = (mm(a, y, precision) - c * y) * (2.0 * sigma_new / e) - (sigma * sigma_new) * x
        x, y, sigma = y, y_new, sigma_new
    return y


def _ritz(a, q, k: int, precision: str):
    aq = mm(a, q, precision)
    h = mm(q.T, aq, precision)
    theta, s = torch.linalg.eigh(0.5 * (h + h.T).double())
    theta, s = theta.flip(0), s.flip(1).to(q.dtype)  # descending
    u = mm(q, s, precision)
    au = mm(aq, s, precision)
    res = torch.linalg.norm(au[:, :k] - u[:, :k] * theta[:k].to(q.dtype), dim=0)
    return theta.to(q.dtype), u, res


def top_eigenpairs(a: torch.Tensor, k: int, precision: str, *, tol: float = 1e-5,
                   degree: int = 24, max_iter: int = 60, seed: int = 0) -> Eigen:
    """The ``k`` largest eigenpairs of the symmetric sparse ``a``, from a
    block a fifth wider (at least 8 more), which speeds convergence."""
    a = sparse_operand(a, precision)
    n = a.shape[0]
    p = min(n, k + max(8, k // 5))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((n, p), generator=gen, dtype=torch.float64).to(a.device, dtype_of(precision))
    q, _ = torch.linalg.qr(x)
    theta, u, res = _ritz(a, q, k, precision)
    it = 0
    while it < max_iter and float(res.max()) > tol:
        cut = float(theta[-1])
        y = _filter(a, u, -1.0, min(cut, 0.999), degree, precision)
        q, _ = torch.linalg.qr(y)
        theta, u, res = _ritz(a, q, k, precision)
        it += 1
    return Eigen(theta[:k], u[:, :k], res, it)
