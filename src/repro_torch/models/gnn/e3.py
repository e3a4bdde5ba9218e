"""E(3)/SO(3) representation-theory substrate (mirrors
:mod:`repro.models.gnn.e3`; self-contained, no e3nn).

Host-side (numpy, float64, precomputed once per config; the reference's
tables, copied):
  * Clebsch-Gordan coefficients in the **real** spherical-harmonic basis,
    via the Racah formula + complex→real change of basis,
  * complex Wigner-d(β) polynomial coefficients (used to evaluate real
    Wigner-D matrices of per-edge rotations on the device).

Device-side (torch):
  * real spherical harmonics Y_l(r̂) up to l_max (associated-Legendre
    recurrences — no hard-coded tables, works to l=6+),
  * real Wigner-D(α, β) block matrices for the rotation taking r̂ → ẑ
    (the eSCN edge-alignment rotation).

Conventions: everything here is orthonormal on S²; the identities the
models use (Gaunt contraction, D-equivariance) are held in
tests/test_torch_e3.py, beside the reference's own tests/test_e3.py.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# complex-basis Clebsch-Gordan (Racah formula, host-side float64)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fact(n: int) -> float:
    return float(math.factorial(n))


def su2_cg(j1: int, j2: int, j3: int) -> np.ndarray:
    """⟨j1 m1 j2 m2 | j3 m3⟩ as array [2j1+1, 2j2+1, 2j3+1] (complex basis)."""
    C = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return C
    pre_delta = math.sqrt(
        _fact(j1 + j2 - j3) * _fact(j1 - j2 + j3) * _fact(-j1 + j2 + j3) / _fact(j1 + j2 + j3 + 1)
    )
    for m1 in range(-j1, j1 + 1):
        for m2 in range(-j2, j2 + 1):
            m3 = m1 + m2
            if abs(m3) > j3:
                continue
            pre = math.sqrt(
                (2 * j3 + 1)
                * _fact(j3 + m3)
                * _fact(j3 - m3)
                * _fact(j1 + m1)
                * _fact(j1 - m1)
                * _fact(j2 + m2)
                * _fact(j2 - m2)
            )
            s = 0.0
            for k in range(0, j1 + j2 - j3 + 1):
                denoms = [
                    k,
                    j1 + j2 - j3 - k,
                    j1 - m1 - k,
                    j2 + m2 - k,
                    j3 - j2 + m1 + k,
                    j3 - j1 - m2 + k,
                ]
                if any(d < 0 for d in denoms):
                    continue
                s += (-1.0) ** k / np.prod([_fact(d) for d in denoms])
            C[m1 + j1, m2 + j2, m3 + j3] = pre_delta * pre * s
    return C


@functools.lru_cache(maxsize=None)
def _real_basis_change(l: int) -> np.ndarray:
    """U[r, c]: real basis vector r as combination of complex |l, c⟩.

    m>0 : Y^real_{m}  = ((-1)^m Y_m + Y_{-m}) / √2
    m=0 : Y^real_0    = Y_0
    m<0 : Y^real_{-μ} = i (Y_{-μ} − (-1)^μ Y_{μ}) / √2
    """
    U = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    for m in range(-l, l + 1):
        r = m + l
        if m > 0:
            U[r, m + l] = (-1.0) ** m / math.sqrt(2)
            U[r, -m + l] = 1.0 / math.sqrt(2)
        elif m == 0:
            U[r, l] = 1.0
        else:
            mu = -m
            U[r, -mu + l] = 1j / math.sqrt(2)
            U[r, mu + l] = -1j * (-1.0) ** mu / math.sqrt(2)
    return U


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Clebsch-Gordan tensor in the real SH basis, [2l1+1, 2l2+1, 2l3+1].

    The complex→real transform can make the intertwiner purely imaginary
    (odd l1+l2+l3 parity paths, e.g. the 1⊗1→1 cross product); we then take
    the imaginary part — still a valid real intertwiner (e3nn does the same).
    """
    C = su2_cg(l1, l2, l3).astype(np.complex128)
    U1, U2, U3 = _real_basis_change(l1), _real_basis_change(l2), _real_basis_change(l3)
    # coefficients transform with conj(U) on outputs, U^T on inputs
    Cr = np.einsum("abc,ia,jb,kc->ijk", C, U1.conj(), U2.conj(), U3)
    re, im = np.linalg.norm(Cr.real), np.linalg.norm(Cr.imag)
    out = Cr.real if re >= im else Cr.imag
    assert min(re, im) < 1e-10 * max(re, im, 1e-30), (l1, l2, l3, re, im)
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# real spherical harmonics (device-side, arbitrary l_max)
# ---------------------------------------------------------------------------

def real_sph_harm(l_max: int, vec: Tensor, *, normalize_input: bool = True):
    """Real orthonormal spherical harmonics of unit vectors.

    vec: [..., 3] → list of tensors, entry l has shape [..., 2l+1]
    (m ordered -l..l).  Associated-Legendre recurrences in fp32.
    """
    v = vec.float()
    if normalize_input:
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    ct = z  # cos θ
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-24))  # sin θ  (>=0)
    # azimuth handled via cos(mφ), sin(mφ) recurrences on (x/st, y/st)
    cphi = torch.where(st > 1e-10, x / st, 1.0)
    sphi = torch.where(st > 1e-10, y / st, 0.0)

    # P_l^m(cosθ) with Condon-Shortley, normalized K_lm baked in afterwards
    P = {(0, 0): torch.ones_like(ct)}
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for l in range(2, l_max + 1):
        for m in range(0, l - 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)] - (l - 1 + m) * P[(l - 2, m)]) / (l - m)

    cos_m = [torch.ones_like(cphi), cphi]
    sin_m = [torch.zeros_like(sphi), sphi]
    for m in range(2, l_max + 1):
        cos_m.append(cphi * cos_m[m - 1] - sphi * sin_m[m - 1])
        sin_m.append(cphi * sin_m[m - 1] + sphi * cos_m[m - 1])

    out = []
    for l in range(l_max + 1):
        cols = []
        for m in range(-l, l + 1):
            am = abs(m)
            K = math.sqrt((2 * l + 1) / (4 * math.pi) * _fact(l - am) / _fact(l + am))
            if m > 0:
                col = math.sqrt(2) * K * P[(l, am)] * cos_m[am] * (-1.0) ** am
            elif m == 0:
                col = K * P[(l, 0)]
            else:
                col = math.sqrt(2) * K * P[(l, am)] * sin_m[am] * (-1.0) ** am
            cols.append(col)
        out.append(torch.stack(cols, dim=-1))
    return out


# ---------------------------------------------------------------------------
# real Wigner-D for edge-alignment rotations (eSCN)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _wigner_d_terms(l: int):
    """Polynomial expansion of complex d^l_{m'm}(β): list of
    (m'_idx, m_idx, coef, pow_cos, pow_sin) terms (host-side)."""
    terms = []
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pre = math.sqrt(_fact(l + mp) * _fact(l - mp) * _fact(l + m) * _fact(l - m))
            for k in range(0, 2 * l + 1):
                d1, d2, d3, d4 = l + m - k, k, mp - m + k, l - mp - k
                if min(d1, d2, d3, d4) < 0:
                    continue
                coef = (-1.0) ** (mp - m + k) * pre / (
                    _fact(d1) * _fact(d2) * _fact(d3) * _fact(d4)
                )
                pc = 2 * l + m - mp - 2 * k  # power of cos(β/2)
                ps = mp - m + 2 * k  # power of sin(β/2)
                terms.append((mp + l, m + l, coef, pc, ps))
    return terms


@functools.lru_cache(maxsize=None)
def _wigner_tables(l: int):
    """Vectorized term tables as numpy arrays for device evaluation, plus
    the 0/1 matrix [terms, (2l+1)²] that adds each term into its (m′, m)
    entry: many terms share an entry, and a matrix product sums them all
    (an indexed ``+=`` would keep one)."""
    t = _wigner_d_terms(l)
    idx = np.array([(a, b) for a, b, _, _, _ in t], np.int32)
    coef = np.array([c for _, _, c, _, _ in t], np.float64)
    pc = np.array([p for *_, p, _ in t], np.int32)
    ps = np.array([p for *_, p in t], np.int32)
    n = 2 * l + 1
    place = np.zeros((len(t), n * n), np.float32)
    place[np.arange(len(t)), idx[:, 0] * n + idx[:, 1]] = 1.0
    return idx, coef, pc, ps, place


@functools.lru_cache(maxsize=None)
def _device_tables(l: int, device: torch.device):
    """(coef, pc, ps, place) of :func:`_wigner_tables` and the rotation map
    of :func:`_real_rotation_map` as fp32 tensors on ``device``: copied
    there once a (degree, device), as ordinary tensors even when first
    asked for under inference mode."""
    _, coef, pc, ps, place = _wigner_tables(l)
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in (coef, pc, ps, place, _real_rotation_map(l)))


def _wigner_d_flat(l: int, beta: Tensor) -> Tensor:
    """d^l(β) flattened row-major: [..., (2l+1)²]."""
    coef, pc, ps, place, _ = _device_tables(l, beta.device)
    c = torch.cos(beta / 2.0)[..., None]
    s = torch.sin(beta / 2.0)[..., None]
    vals = coef * c ** pc * s ** ps
    return vals @ place


def _complex_wigner_d_beta(l: int, beta: Tensor) -> Tensor:
    """d^l(β): [..., 2l+1, 2l+1] real matrix (complex d is real-valued)."""
    return _wigner_d_flat(l, beta).reshape(beta.shape + (2 * l + 1, 2 * l + 1))


@functools.lru_cache(maxsize=None)
def _real_rotation_map(l: int) -> np.ndarray:
    """The [2·(2l+1)², (2l+1)²] float32 map K with D^l's flat entries =
    [cos(m_a α)·d_ab | sin(m_a α)·d_ab] · K, from the real basis change
    U = Ur + i·Ui (see :func:`real_wigner_D`), formed in float64."""
    U = _real_basis_change(l)
    ur, ui = U.real, U.imag
    n = 2 * l + 1
    kc = np.einsum("ra,cb->abrc", ur, ur) + np.einsum("ra,cb->abrc", ui, ui)
    ks = np.einsum("ra,cb->abrc", ur, ui) - np.einsum("ra,cb->abrc", ui, ur)
    return np.concatenate([kc.reshape(n * n, n * n), ks.reshape(n * n, n * n)]).astype(np.float32)


def real_wigner_D(l: int, alpha: Tensor, beta: Tensor) -> Tensor:
    """Real-basis Wigner D^l(Rz(α)·Ry(β)): [..., 2l+1, 2l+1].

    Complex D(α,β,0)_{m'm} = e^{-i m' α} d^l_{m'm}(β), transformed to the
    real SH basis with conj(U)·D·Uᵀ (a real result).  With U = Ur + i·Ui
    and Q = conj(U)·diag(e^{-imα}) = Qr + i·Qi, Qr = Ur·cos(mα) − Ui·sin(mα),
    Qi = −(Ur·sin(mα) + Ui·cos(mα)), and since d is real,
    Re(Q·d·Uᵀ) = Qr·d·Urᵀ − Qi·d·Uiᵀ, whose entries are linear in
    cos(m_a α)·d_ab and sin(m_a α)·d_ab: one fp32 product of those
    2·(2l+1)² values a rotation with a constant map
    (:func:`_real_rotation_map`).  Every op is elementwise over the leading
    axes or a 2-D product on them (no batched product, no view that folds
    them), so a DTensor sharded unevenly along the edges takes it as it is.
    """
    n = 2 * l + 1
    d = _wigner_d_flat(l, beta)  # [..., n²], entry (a, b) at a·n + b
    dev = alpha.device
    ms = torch.arange(-l, l + 1, dtype=torch.float32, device=dev).repeat_interleave(n)
    ang = alpha.float()[..., None] * ms  # [..., n²]: m_a α at (a, b)
    feat = torch.cat([torch.cos(ang) * d, torch.sin(ang) * d], -1)
    rot = feat @ _device_tables(l, dev)[4]
    return rot.reshape(alpha.shape + (n, n))


def edge_alignment_angles(vec: Tensor):
    """(α, β) such that Rz(α)Ry(β) ẑ = r̂;  D(α,β)ᵀ rotates features into the
    edge frame (r̂ → ẑ) and D(α,β) rotates them back."""
    v = vec / torch.clamp(torch.linalg.vector_norm(vec, dim=-1, keepdim=True), min=1e-12)
    beta = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))
    alpha = torch.atan2(v[..., 1], v[..., 0])
    return alpha, beta


# ---------------------------------------------------------------------------
# irrep feature helpers
# ---------------------------------------------------------------------------

def irrep_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def irrep_slices(l_max: int):
    """[(start, stop)] per l in the concatenated [..., (l_max+1)²] layout."""
    out, ofs = [], 0
    for l in range(l_max + 1):
        out.append((ofs, ofs + 2 * l + 1))
        ofs += 2 * l + 1
    return out


def block_diag_wigner(l_max: int, alpha: Tensor, beta: Tensor) -> Tensor:
    """Stacked-block real Wigner D over l=0..l_max: [..., (l_max+1)², (l_max+1)²]."""
    n = irrep_dim(l_max)
    D = torch.zeros(alpha.shape + (n, n), dtype=torch.float32, device=alpha.device)
    for l, (s, e) in enumerate(irrep_slices(l_max)):
        D[..., s:e, s:e] = real_wigner_D(l, alpha, beta)
    return D
