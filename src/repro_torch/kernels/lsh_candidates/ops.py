"""LSH candidate generation (mirrors :mod:`repro.kernels.lsh_candidates.ops`).

* :func:`hash_codes` — the kernel wrapper: a CUDA input launches the kernel
  in ``csrc/hash_codes.cu`` (or raises), a CPU input runs the plain version
  in :mod:`.ref`;
* :func:`lsh_candidates` — hashing → per-table lexicographic (code,
  tie-break) sort → fixed-size rank windows → per-query dedup.  Returns a
  bounded candidate set ``[nq, m]`` (unique ids ascending, −1 padding, the
  query itself excluded) that
  :func:`repro_torch.kernels.knn_topk.ops.knn_topk_rerank` reranks exactly
  — Stage 1 in O(n·m·d) instead of O(n²d).

The hyperplanes come from a CPU generator seeded with ``lsh_seed``
(:func:`make_planes`), so one seed gives the same planes on the CPU and on
the card; they are not the reference's ``jax.random`` planes (the parity
tests substitute those for this module's ``make_planes``).

The serving path persists the pool's tables instead of hashing it per call:
:func:`sorted_tables` keeps each table's (code, tie) order and
:func:`routed_candidates` ranks queries hashed elsewhere into it
(:class:`LshTables`).  Every sort is a stable ``argsort``: the reference's
rule that a query ranks after an equal pool key rests on it, and NaN keys
sort last, where ``jnp.argsort`` puts them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import cpu_generator
from repro_torch.kernels.lsh_candidates.kernel import hash_codes_cuda
from repro_torch.kernels.lsh_candidates.ref import hash_codes_ref

MAX_N_BITS = 24  # codes are packed via fp32-exact int paths; 2^24 is the cap

# Single source of the LSH knob defaults (GraphConfig, build_knn_graph)
DEFAULT_N_TABLES = 16
DEFAULT_N_BITS = 16

_CHUNK_ELEMS = 1 << 25  # bound on the live [queries, T·win] window block


def default_candidates(k: int, n_tables: int = DEFAULT_N_TABLES) -> int:
    """Default candidate budget m: ``n_tables`` windows of ``max(6k, 32)``
    (the reference's sizing: recall@k ≥ 0.95 on its 4k clustered-Gaussian
    gate with m independent of n)."""
    return n_tables * max(6 * k, 32)


def make_planes(d: int, n_tables: int, n_bits: int, seed: int) -> torch.Tensor:
    """[T, d, n_bits+1] hyperplane normals + tie-break direction (column
    ``n_bits``), standard normals from a CPU generator seeded with ``seed``."""
    return torch.randn((n_tables, d, n_bits + 1), generator=cpu_generator(seed),
                       dtype=torch.float32)


def hash_codes(x: torch.Tensor, planes: torch.Tensor):
    """(codes [T, n] int32, tie [T, n] f32) — see :mod:`.ref` for the
    contract."""
    n_bits = planes.shape[-1] - 1
    if not 1 <= n_bits <= MAX_N_BITS:
        raise ValueError(f"hash_codes supports 1 <= n_bits <= {MAX_N_BITS}, got {n_bits}")
    if x.device.type == "cuda":
        out = hash_codes_cuda(x.float().contiguous(), planes.to(x.device).float().contiguous())
        hash_codes.launches += 1
        return out
    if x.device.type == "cpu":
        return hash_codes_ref(x, planes)
    raise ValueError(f"hash_codes: unsupported device {x.device}")


hash_codes.launches = 0  # kernel launches (CUDA path only)


def lsh_candidates(x: torch.Tensor, *, m: int, n_tables: int = DEFAULT_N_TABLES,
                   n_bits: int = DEFAULT_N_BITS, seed: int = 0,
                   query_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bounded per-query candidate sets ``[nq, m]`` int32: unique candidate
    ids, the query itself excluded, invalid slots −1.  Valid ids are in
    ascending order but −1s may be interspersed (duplicates are masked in
    place after one per-row sort, as in the reference; every consumer masks
    on ``id >= 0``).  ``query_rows`` gives candidates for those rows of the
    pool ``x`` only (default: every row).

    Per table: a stable argsort by tie-break, then a stable argsort by code
    (bucket grouping, in-bucket order by the 1-D projection); a query's
    candidates are the ``m // n_tables`` points around its own sorted
    position, the window clipped to ``[0, n − win]``.
    """
    n, d = x.shape
    if n_tables < 1 or m < n_tables:
        raise ValueError(
            f"lsh_candidates needs n_tables >= 1 and m >= n_tables (one "
            f"window slot per table), got n_tables={n_tables}, m={m}")
    dev = x.device
    win = min(max(m // n_tables, 1), n)
    codes, tie = hash_codes(x, make_planes(d, n_tables, n_bits, seed))
    order = _lex_order(codes, tie)  # [T, n]
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(n, device=dev).expand(n_tables, n))

    qid = torch.arange(n, device=dev) if query_rows is None else query_rows.to(dev).long()
    nq = qid.shape[0]
    start = torch.clamp(pos[:, qid] - win // 2, 0, n - win)  # [T, nq]
    steps = torch.arange(win, device=dev)
    out = torch.full((nq, m), -1, dtype=torch.int32, device=dev)
    chunk = max(1, _CHUNK_ELEMS // (n_tables * win))
    for s in range(0, nq, chunk):
        st = start[:, s:s + chunk]
        q = st.shape[1]
        widx = (st[..., None] + steps).reshape(n_tables, q * win)
        cand = order.gather(1, widx).reshape(n_tables, q, win).permute(1, 0, 2) \
            .reshape(q, n_tables * win)
        out[s:s + q, : n_tables * win] = _dedup(cand, qid[s:s + q], n)
    return out


def _dedup(cand: torch.Tensor, qid: torch.Tensor, n: int) -> torch.Tensor:
    """Window ids ``[nq, w]`` deduped in place: one ascending sort a row (the
    query's own id → sentinel n lands at the tail), then duplicates —
    adjacent after the sort — and the sentinel masked to −1 (int32)."""
    c = torch.sort(torch.where(cand == qid[:, None], n, cand), dim=1).values
    dup = torch.zeros_like(c, dtype=torch.bool)
    dup[:, 1:] = c[:, 1:] == c[:, :-1]
    return torch.where(dup | (c >= n), -1, c).to(torch.int32)


# ---------------------------------------------------------------------------
# Persistent / routed tables — hash the pool once, look queries up later
# ---------------------------------------------------------------------------

class LshTables(NamedTuple):
    """Per-table sorted bucket structure of a candidate pool: for each of T
    tables the pool ids in (bucket code, tie-break) ascending order and the
    sorted keys themselves, so a query's window position is a rank
    computation needing no re-hash of the pool."""

    order: torch.Tensor  # [T, n] int32 — pool ids, (code, tie) ascending per table
    codes: torch.Tensor  # [T, n] int32 — bucket codes in sorted order
    ties: torch.Tensor  # [T, n] f32 — tie-break projections in sorted order


def _lex_order(codes: torch.Tensor, ties: torch.Tensor) -> torch.Tensor:
    """Per row, the (code, tie) lexicographic order: a stable argsort by
    tie, then a stable argsort by code."""
    p1 = torch.argsort(ties, dim=1, stable=True)
    return p1.gather(1, torch.argsort(codes.gather(1, p1), dim=1, stable=True))


def sorted_tables(codes: torch.Tensor, ties: torch.Tensor) -> LshTables:
    """:class:`LshTables` from :func:`hash_codes` output ([T, n] each): the
    same lexicographic sort as :func:`lsh_candidates`, so a pool point's
    rank here is the window position the fused path gives it."""
    order = _lex_order(codes, ties)
    return LshTables(order=order.to(torch.int32), codes=codes.gather(1, order),
                     ties=ties.gather(1, order))


def routed_candidates(tables: LshTables, qcodes: torch.Tensor, qties: torch.Tensor, *,
                      win: int, query_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Candidate pool ids ``[nq, T·win]`` for queries hashed elsewhere
    (``qcodes``/``qties`` [T, nq]): each query's lexicographic insertion
    rank among a table's sorted (code, tie) keys centres a ``win``-wide
    window of pool ids; the union over tables is deduped in place (unique
    ids ascending, −1 interspersed — the ``knn_topk_rerank`` contract).

    The rank comes from one combined sort of [pool keys; query keys], as in
    the reference: a query's pool-only rank is its combined position less
    the queries sorted before it.  An equal key ranks the query after the
    pool point (the stable sort keeps pool entries first).  ``query_rows``
    masks each query's own pool id from its candidates; ids outside
    ``[0, n)`` never match.
    """
    order = tables.order.long()
    T, n = order.shape
    nq = qcodes.shape[1]
    dev = order.device
    win = min(max(win, 1), n)
    comb = _lex_order(torch.cat([tables.codes, qcodes.to(dev)], 1),
                      torch.cat([tables.ties, qties.to(dev)], 1))  # [T, n + nq]
    isq = comb >= n
    # pool-only rank at each combined position: the position less the
    # queries strictly before it
    rank = torch.arange(n + nq, device=dev) - (torch.cumsum(isq.long(), 1) - isq.long())
    qpos = torch.empty((T, nq), dtype=torch.long, device=dev)
    qpos.scatter_(1, (comb[isq] - n).reshape(T, nq), rank[isq].reshape(T, nq))
    start = torch.clamp(qpos - win // 2, 0, n - win)
    widx = (start[..., None] + torch.arange(win, device=dev)).reshape(T, nq * win)
    cand = order.gather(1, widx).reshape(T, nq, win).permute(1, 0, 2).reshape(nq, T * win)
    qid = (torch.full((nq,), -1, dtype=torch.long, device=dev) if query_rows is None
           else query_rows.to(dev).long())
    return _dedup(cand, qid, n)
