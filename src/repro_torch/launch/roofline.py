"""Roofline terms of a dry-run cell (mirrors :mod:`repro.launch.roofline`
for the port's dry-run on a fake process group).

Hardware model: one NVIDIA H100 SXM5 a rank, the datasheet's figures (not
measurements):

    PEAK_FLOPS  989 TFLOP/s   dense bf16 tensor-core peak
    HBM_BW      3.35 TB/s     HBM3 bandwidth
    LINK_BW     450 GB/s      NVLink 4 within an 8-GPU node, each direction
                              (900 GB/s bidirectional)

The dry-run counts one rank's work (rank 0 of the fake group), so the three
terms are per-rank seconds:

    compute    = flops_dev / PEAK_FLOPS
    memory     = bytes_dev / HBM_BW
    collective = collective_bytes_dev / LINK_BW

``bytes_dev`` is the sum over the rank's local ops of the bytes each reads
and writes, unfused (every op's inputs read once and its outputs written
once) — an upper bound of what a fusing compiler's kernels move, not XLA's
post-fusion "bytes accessed".  ``collective_bytes_dev`` sums the output
bytes of each functional collective the rank issues (all_gather,
all_reduce, reduce_scatter, all_to_all), by kind: :func:`collective_bytes`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12  # bf16 dense / H100 SXM5 (datasheet)
HBM_BW = 3.35e12  # B/s / H100 SXM5 HBM3 (datasheet)
LINK_BW = 450e9  # B/s / NVLink 4, one direction, 8-GPU node (datasheet)

COLLECTIVE_KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum the output bytes of a rank's collectives by kind: ``records`` is
    ``(kind, output bytes)`` a collective, as the dry-run's dispatch mode
    logs them."""
    out = {k: 0 for k in COLLECTIVE_KINDS}
    for kind, n in records:
        out[kind] += int(n)
    return out


@dataclasses.dataclass
class RooflineReport:
    cell: str
    mesh: str
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    coll_by_kind: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float  # analytic "useful" flops, whole step, all ranks
    useful_ratio: float  # model_flops / (flops_dev * ranks)
    memory_per_device_gb: float
    compile_s: float  # the dry-run's seconds for the cell (no compile here)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)


def analyze_raw(cell_name: str, mesh_name: str, n_chips: int, *, flops_dev: float,
                bytes_dev: float, coll_by_kind: Dict[str, float],
                model_flops_total: float, mem_gb: float,
                compile_s: float) -> RooflineReport:
    from repro_torch.core.health import numeric_problems

    problems = numeric_problems(
        {"flops_dev": flops_dev, "bytes_dev": bytes_dev,
         "coll_by_kind": coll_by_kind, "model_flops_total": model_flops_total,
         "memory_per_device_gb": mem_gb},
        context=f"roofline terms of {cell_name}@{mesh_name}")
    if problems:
        # a NaN here would poison every downstream ratio: fail the cell
        # (the dry-run records it and exits non-zero)
        raise ValueError("; ".join(problems))
    coll_total = float(sum(coll_by_kind.values()))
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_total / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    denom = flops_dev * n_chips
    return RooflineReport(
        cell=cell_name,
        mesh=mesh_name,
        flops_dev=flops_dev,
        bytes_dev=bytes_dev,
        coll_bytes_dev=coll_total,
        coll_by_kind=coll_by_kind,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_total=model_flops_total,
        useful_ratio=(model_flops_total / denom) if denom else 0.0,
        memory_per_device_gb=mem_gb,
        compile_s=compile_s,
    )


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS per family (the "useful work" yardstick)
# ---------------------------------------------------------------------------

def lm_model_flops(cfg, shape_name: str, dims: dict) -> float:
    """6·N_active·D train / 2·N_active·D forward (+ attention term)."""
    n_active = cfg.active_param_count()
    B = dims["global_batch"]
    S = dims["seq_len"]
    tokens = B * S
    # causal attention flops: 2 (QK) + 2 (PV) matmuls, halved by causality
    attn = 2 * cfg.n_layers * B * (S * S) * cfg.n_heads * cfg.d_head  # fwd, causal-halved x2 ops
    if shape_name == "train_4k":
        return 6.0 * n_active * tokens + 3.0 * attn
    if shape_name == "prefill_32k":
        return 2.0 * n_active * tokens + attn
    # decode: 1 token per sample, attention reads the full cache
    dec_attn = 4 * cfg.n_layers * B * S * cfg.n_heads * cfg.d_head
    return 2.0 * n_active * B + dec_attn


def spectral_model_flops(dims: dict, restarts: int, kmeans_iters: int) -> float:
    """Eq. (10) of the paper, instantiated: matvec + reorth + eigh + k-means."""
    n, nnz, k = dims["n_nodes"], dims["n_edges"], dims["k"]
    m = 2 * k
    per_cycle = 2.0 * nnz * m + 6.0 * n * m * m + 10.0 * m**3
    lanczos = per_cycle * (restarts + 1)
    kmeans = kmeans_iters * (2.0 * n * k * k + 2.0 * n * k)  # dist GEMM + update
    return lanczos + kmeans


def gnn_model_flops(arch_name: str, cfg, dims: dict, n_nodes: int, n_edges: int) -> float:
    """Per-family dominant-term estimates."""
    if arch_name == "gcn-cora":
        per = 0
        dims_seq = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
        for i in range(cfg.n_layers):
            per += 2 * n_nodes * dims_seq[i] * dims_seq[i + 1] + 2 * n_edges * dims_seq[i + 1]
        return 3.0 * per  # fwd+bwd
    if arch_name == "pna":
        d = cfg.d_hidden
        per = cfg.n_layers * (2 * n_edges * (2 * d) * d + 2 * n_edges * d * d + 2 * n_nodes * 13 * d * d)
        return 3.0 * (per + 2 * n_nodes * cfg.d_in * d)
    if arch_name == "nequip":
        C = cfg.channels
        paths = 19  # l_max=2
        tp = n_edges * paths * 27 * C * 2  # CG contraction upper bound
        rad = n_edges * (cfg.n_rbf * 64 + 64 * paths * C) * 2
        si = n_nodes * (cfg.l_max + 1) ** 2 * C * C * 2 * 2
        return 3.0 * cfg.n_layers * (tp + rad + si)
    # equiformer-v2
    C = cfg.channels
    L = cfg.l_max
    rot = n_edges * sum((2 * l + 1) ** 2 for l in range(L + 1)) * C * 2 * 2 * 2  # in+out × src/dst
    nl = L + 1
    so2 = n_edges * 2 * ((nl * 2 * C) * (nl * C) + 2 * 2 * ((nl - 1) * 2 * C) * ((nl - 1) * C))
    mixes = n_nodes * (L + 1) ** 2 * C * C * 2 * 2
    return 3.0 * cfg.n_layers * (rot + so2 + mixes)


def recsys_model_flops(cfg, sspec_name: str, dims: dict) -> float:
    F, d, H, da = cfg.n_fields, cfg.embed_dim, cfg.n_heads, cfg.d_attn
    B = dims.get("batch", 1)
    d_in = d
    per = 0.0
    for _ in range(cfg.n_attn_layers):
        per += 2 * F * d_in * 3 * H * da + 2 * F * F * H * da * 2 + 2 * F * d_in * H * da
        d_in = H * da
    per += 2 * F * d_in
    fwd = B * per
    if sspec_name == "train_batch":
        return 3.0 * fwd
    if sspec_name == "retrieval_cand":
        return fwd + 2.0 * dims["n_candidates"] * 64
    return fwd
