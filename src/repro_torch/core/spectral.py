"""Stage-graph API: the paper's three-stage pipeline as one configured object
(mirrors :mod:`repro.core.spectral`)::

    pipe  = SpectralPipeline(n_clusters=8)
    state = pipe.build_graph(x)        # Stage 1 (or pipe.prepare(w))
    emb   = pipe.embed(state, gen)     # Stage 2: eigensolver → spectral embedding
    out   = pipe.cluster(emb, gen2)    # Stage 3: k-means on the embedding
    out   = pipe.run(x_or_graph, gen)  # or all three at once

Random inputs are keyed by CPU ``torch.Generator``s (the reference's PRNG
keys; the draws themselves are made on the device, :mod:`repro_torch._random`);
``run`` derives one per stage from the caller's, in the reference's split
order.  Every entry point takes ``device=``: the card unless the caller asks
for the CPU, raising when there is none.  ``Plan.device`` keeps the
reference's meaning ("single" | "sharded") so the reference's JSON loads.

Stages ``("prepare", "sparsify", "coarsen", "embed", "refine",
"cluster")`` as in the reference, with checkpoint-on-error and resume
(:mod:`repro_torch.core.state_io`).

Plan dispatch as in the reference: one device (``Plan()``); a row-partitioned
:class:`~repro_torch.sparse.distributed.ShardedCOO` input (the layout path
in one process without a mesh, one all-gather a product over a
``torch.distributed`` ``DeviceMesh`` with one); and ``Plan(device="sharded",
mesh=...)`` on raw points, whose Stage 1 runs row-block-parallel
(:mod:`repro_torch.core.distributed_pipeline`).  Under a mesh every rank
runs the same call on the same inputs, and Stage 2's and Stage 3's dense
state is distributed by rows as the reference's specs distribute it: each
rank holds its own row block of the Krylov basis or Chebyshev block and of
the embedding (:class:`~repro_torch.sparse.distributed.RowBlock`); a COO
graph whose n does not divide by the ranks is padded for Stage 2, and its
padding rows never enter the result.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional, Tuple

import torch

import repro_torch.core.chebyshev as cheb
import repro_torch.core.health as health
import repro_torch.core.kmeans as km
import repro_torch.core.lanczos as lz
import repro_torch.core.laplacian as lap
import repro_torch.core.reduce as red
from repro_torch._device import DeviceLike, cpu_generator, fold_in, resolve_device
from repro_torch.core.health import HealthConfig, PipelineError, StageReport
from repro_torch.core.operator import (BlockEllOperator, CooOperator, LinearOperator,
                                       RowBlockEllOperator, ShardedCooOperator, row_block)
from repro_torch.core.reduce import CoarsenConfig, ReduceInfo, ReductionState, SparsifyConfig
from repro_torch.core.similarity import build_knn_graph
from repro_torch.kernels.lsh_candidates.ops import (DEFAULT_N_BITS, DEFAULT_N_TABLES,
                                                    MAX_N_BITS)
from repro_torch.sparse.distributed import (RowBlock, ShardedCOO, all_gather, all_reduce,
                                            gather_rows, global_rows, mesh_axis,
                                            normalize_sharded, partition_coo_by_rows,
                                            sharded_degrees, spmv_gspmd)
from repro_torch.sparse.formats import COO, coo_to_csr, csr_to_blockell, ell_width

KMeansConfig = km.KMeansConfig  # the Stage-3 nested config (re-exported)

_MEASURES = ("cosine", "cross_correlation", "exp_decay")
_METHODS = ("exact", "lsh")
_KNN_IMPLS = ("auto", "pallas", "ref")
_DEVICES = ("single", "sharded")
_VARIANTS = ("gspmd", "shard_map")
_EXCHANGES = ("gather", "ring")
_SOLVERS = ("lanczos", "chebyshev")
_REPRESENTATIONS = ("coo", "blockell")


class SpectralResult(NamedTuple):
    labels: torch.Tensor  # [n] cluster assignment
    embedding: torch.Tensor  # [n, k] row-normalized spectral embedding (a mesh's rank: its rows)
    eigenvalues: torch.Tensor  # [k] of L_sym (ascending; ~0 first)
    eig_residuals: torch.Tensor
    kmeans_inertia: torch.Tensor
    lanczos_restarts: int
    kmeans_iterations: int
    reports: Tuple[StageReport, ...] = ()


def default_basis_size(n: int, k: int, b: int = 1) -> int:
    """ARPACK-style ncv ≥ 2k, widened with the Krylov block."""
    return min(n, max(2 * k, k + 16, k + 8 * b))


# ---------------------------------------------------------------------------
# Per-stage configs (field for field the reference's, so its JSON loads)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Stage-1 knobs (kNN similarity graph, paper Alg. 1).  ``method``
    selects the neighbour search: ``"exact"`` (the O(n²d) ``knn_topk``
    kernel) or ``"lsh"`` (random-hyperplane candidates reranked exactly,
    O(n·m·d)); ``n_tables``/``n_bits``/``candidates``/``lsh_seed`` are the
    LSH knobs and ``block_q`` the rerank's query chunk.  ``impl``,
    ``block_k`` and ``interpret`` select Pallas paths in the reference and
    are kept for config parity only: here the device of the input picks the
    kernel or its plain version."""

    knn_k: int = 10
    measure: str = "exp_decay"
    sigma: float = 1.0
    eps: Any = None  # degree-capped ε-ball radius
    method: str = "exact"  # "exact" | "lsh"
    n_tables: int = DEFAULT_N_TABLES
    n_bits: int = DEFAULT_N_BITS
    candidates: Optional[int] = None
    lsh_seed: int = 0
    impl: str = "auto"
    block_q: Optional[int] = None
    block_k: Optional[int] = None
    interpret: Optional[bool] = None

    def __post_init__(self):
        if self.measure not in _MEASURES:
            raise ValueError(
                f"GraphConfig.measure must be one of {_MEASURES}, got {self.measure!r}")
        if self.method not in _METHODS:
            raise ValueError(
                f"GraphConfig.method must be one of {_METHODS}, got {self.method!r}")
        if self.impl not in _KNN_IMPLS:
            raise ValueError(
                f"GraphConfig.impl must be one of {_KNN_IMPLS}, got {self.impl!r}")
        if self.knn_k < 1:
            raise ValueError(f"GraphConfig.knn_k must be >= 1, got {self.knn_k}")
        if self.n_tables < 1:
            raise ValueError(f"GraphConfig.n_tables must be >= 1, got {self.n_tables}")
        if not 1 <= self.n_bits <= MAX_N_BITS:
            raise ValueError(
                f"GraphConfig.n_bits must be in [1, {MAX_N_BITS}], got {self.n_bits}")
        if self.candidates is not None and self.candidates < self.n_tables:
            raise ValueError(
                f"GraphConfig.candidates={self.candidates} < n_tables="
                f"{self.n_tables} — each table needs a window of at least 1")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["eps"] is not None:
            if torch.as_tensor(d["eps"]).numel() != 1:
                raise ValueError(
                    "GraphConfig.eps is a per-node array — not JSON-"
                    "serializable; to_dict() needs a scalar radius (or None)")
            d["eps"] = float(d["eps"])
        return d


@dataclasses.dataclass(frozen=True)
class EigConfig:
    """Stage-2 knobs (paper Alg. 2-3).  ``solver`` is ``"lanczos"``
    (thick-restart, exact to ``tol``) or ``"chebyshev"`` (Jackson-damped
    polynomial-filter embedding: ``cheb_degree``, ``n_signals``,
    ``lambda_cut``, ``cheb_margin``).  ``representation="blockell"``
    converts a COO graph to BlockELL(+tail) so both solvers stream the
    ``ell_spmm`` kernel (and the Chebyshev filter its fused step); under a
    mesh axis of more than one rank each rank converts its own rows.  A
    ShardedCOO graph runs its own index-add operator whatever this says,
    as in the reference."""

    n_eigvecs: Optional[int] = None  # embedding width; default: n_clusters
    basis_m: Optional[int] = None  # Krylov basis (ARPACK ncv); default 2k-ish
    tol: float = 1e-5
    max_restarts: int = 60
    block_size: int = 1
    drop_first: bool = False
    fixed_restarts: Optional[int] = None
    solver: str = "lanczos"
    cheb_degree: int = 64
    n_signals: Optional[int] = None
    lambda_cut: Optional[float] = None
    cheb_margin: float = 0.01
    representation: str = "coo"  # "coo" | "blockell"
    strict: bool = False  # raise PipelineError on an unconverged embed

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"EigConfig.block_size must be >= 1, got {self.block_size}")
        if self.tol <= 0:
            raise ValueError(f"EigConfig.tol must be > 0, got {self.tol}")
        if self.solver not in _SOLVERS:
            raise ValueError(
                f"EigConfig.solver must be one of {_SOLVERS}, got {self.solver!r}")
        if self.cheb_degree < 1:
            raise ValueError(f"EigConfig.cheb_degree must be >= 1, got {self.cheb_degree}")
        if self.n_signals is not None and self.n_signals < 1:
            raise ValueError(f"EigConfig.n_signals must be >= 1, got {self.n_signals}")
        if self.cheb_margin <= 0:
            raise ValueError(f"EigConfig.cheb_margin must be > 0, got {self.cheb_margin}")
        if self.representation not in _REPRESENTATIONS:
            raise ValueError(
                f"EigConfig.representation must be one of {_REPRESENTATIONS}, "
                f"got {self.representation!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Execution plan, as in the reference.

    device        "single" (default) or "sharded" — where the stage graph
                  runs, not a torch device.  A ShardedCOO input always runs
                  the sharded Stage 2; ``"sharded"`` also row-block-shards
                  Stage 1 on raw points (needs ``mesh``) and, with
                  ``variant="shard_map"`` and ``KMeansConfig(iter="fused")``,
                  routes Stage 3 to ``kmeans_sharded``.
    mesh          a ``torch.distributed.device_mesh.DeviceMesh`` (not
                  serialized by :meth:`to_dict`); every rank of it calls the
                  pipeline with the same inputs.  Stage 2 and Stage 3 keep
                  their dense state as each rank's own row block of the n
                  rows (n/S each; a ShardedCOO's padded n): the Krylov basis
                  or Chebyshev block, and ``EmbedState.embedding`` /
                  ``SpectralResult.embedding``, which hold the rank's [n/S, k]
                  rows — a caller that needs them whole gathers them
                  (``sparse.distributed.all_gather``).  The labels, the
                  eigenvalues, the residuals and the flags are whole and the
                  same on every rank.  A COO graph (raw points' Stage 1) is
                  partitioned by rows for Stage 2 on more than one rank,
                  padded when its n does not divide by the axis' size; the
                  padding rows are dropped from the embedding (the last
                  ranks then hold fewer rows, ``EmbedState.n_rows`` says how
                  many in all), and Stage 3 gathers the n real rows once
                  and runs ``kmeans``, as the reference does when n does not
                  tile the axis.
    axis          the mesh dimension the rows are partitioned over.
    variant       "gspmd" | "shard_map": the reference's two collective
                  schedules.  Both values load; under a mesh of more than
                  one rank both run the one all-gather a product and the
                  row-local Lloyd loop (fused or two-pass); without a mesh
                  the layout path.
    gather_dtype  optional cast of the gathered operator input (e.g.
                  "bfloat16").
    stage1_exchange
                  "gather" (every rank all-gathers the points) | "ring"
                  (blocks stream round the ring; no rank holds the pool).
    """

    device: str = "single"
    mesh: Any = None
    axis: Any = "data"
    variant: str = "gspmd"
    gather_dtype: Any = None
    stage1_exchange: str = "gather"

    def __post_init__(self):
        if self.device not in _DEVICES:
            raise ValueError(f"Plan.device must be one of {_DEVICES}, got {self.device!r}")
        if self.variant not in _VARIANTS:
            raise ValueError(f"Plan.variant must be one of {_VARIANTS}, got {self.variant!r}")
        if self.stage1_exchange not in _EXCHANGES:
            raise ValueError(
                f"Plan.stage1_exchange must be one of {_EXCHANGES}, got "
                f"{self.stage1_exchange!r}")
        if self.gather_dtype is not None:  # canonical dtype name, JSON-safe
            object.__setattr__(self, "gather_dtype",
                               str(self.gather_dtype).replace("torch.", ""))

    def to_dict(self) -> dict:
        return {
            "device": self.device,
            "axis": list(self.axis) if isinstance(self.axis, tuple) else self.axis,
            "variant": self.variant,
            "gather_dtype": self.gather_dtype,
            "stage1_exchange": self.stage1_exchange,
        }

    @classmethod
    def from_dict(cls, d: dict, *, mesh: Any = None) -> "Plan":
        axis = d.get("axis", "data")
        return cls(
            device=d.get("device", "single"),
            mesh=mesh,
            axis=tuple(axis) if isinstance(axis, list) else axis,
            variant=d.get("variant", "gspmd"),
            gather_dtype=d.get("gather_dtype"),
            stage1_exchange=d.get("stage1_exchange", "gather"),
        )


# ---------------------------------------------------------------------------
# Stage states
# ---------------------------------------------------------------------------

class GraphState(NamedTuple):
    """Stage-1 output: the sym-normalized adjacency + degree bookkeeping."""

    adj: Any  # COO or ShardedCOO: D^{-1/2} W D^{-1/2}
    deg: torch.Tensor  # [n] degrees of the raw graph
    inv_sqrt_deg: torch.Tensor  # [n] D^{-1/2} (0 where isolated)

    def to(self, device) -> "GraphState":
        return GraphState(self.adj.to(device), self.deg.to(device),
                          self.inv_sqrt_deg.to(device))


class EmbedState(NamedTuple):
    """Stage-2 output: the spectral embedding, cacheable/re-clusterable
    (under a mesh of more than one rank, the rank's rows of it)."""

    embedding: torch.Tensor  # [n, k] row-normalized spectral embedding
    eigenvalues: torch.Tensor  # [k] Laplacian eigenvalues 1-θ (ascending)
    residuals: torch.Tensor  # eigensolver residuals
    restarts: int  # Lanczos restart count
    converged: bool = True
    # the embedding's rows in all when a mesh's ranks hold blocks that do not
    # tile them (a padded graph's real rows); None: each rank's rows × ranks
    n_rows: Optional[int] = None

    def to(self, device) -> "EmbedState":
        return self._replace(embedding=self.embedding.to(device),
                             eigenvalues=self.eigenvalues.to(device),
                             residuals=self.residuals.to(device))


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """The typed value the stage DAG threads; each stage fills the slots it
    owns and appends to ``provenance``.  ``reduction`` is the coarsen →
    refine hand-off and ``reductions`` every reduction's numbers;
    ``gen_embed``/``gen_cluster`` are the per-stage CPU generators ``run``
    derives; ``device`` is where the stages run."""

    points: Optional[torch.Tensor] = None
    search_points: Optional[torch.Tensor] = None
    input_graph: Any = None  # COO or ShardedCOO
    graph: Optional[GraphState] = None
    embedding: Optional[EmbedState] = None
    result: Optional[SpectralResult] = None
    reduction: Optional[ReductionState] = None
    reductions: Tuple[ReduceInfo, ...] = ()
    gen_embed: Optional[torch.Generator] = None
    gen_cluster: Optional[torch.Generator] = None
    operator_override: Optional[LinearOperator] = None
    device: Optional[torch.device] = None
    provenance: Tuple[str, ...] = ()
    reports: Tuple[StageReport, ...] = ()


_STAGE_ORDER = ("prepare", "sparsify", "coarsen", "embed", "refine", "cluster")
_REQUIRED_STAGES = ("prepare", "embed", "cluster")
DEFAULT_STAGES = ("prepare", "embed", "cluster")


def _stage_done(name: str, provenance: Tuple[str, ...]) -> bool:
    return any(p == name or p.startswith(name + "[") for p in provenance)


def _as_points(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev)


def _raw_weights(state: GraphState) -> COO:
    """The raw similarity weights of a Stage-1 state, ``W = D^{1/2} A_sym
    D^{1/2}`` entrywise: the reduction stages resample or merge raw weights
    and normalize the reduced graph again through :meth:`SpectralPipeline.prepare`.
    A ShardedCOO comes back as a COO over its global rows, null edges
    included (:func:`_drop_null_edges`)."""
    sq = torch.sqrt(torch.clamp(state.deg.float(), min=0.0))
    adj = state.adj
    sharded = isinstance(adj, ShardedCOO)
    row = global_rows(adj) if sharded else adj.row
    # one product of the two scales, as in normalize_sym: the two
    # orientations of an edge keep one value, so the sparsifier's backbone
    # test (an exact comparison with the other endpoint's row maximum) is not
    # decided by rounding
    val = adj.val.float() * (sq[row] * sq[adj.col])
    return COO(row=row, col=adj.col, val=val, shape=adj.shape,
               sorted_rows=False if sharded else adj.sorted_rows)


def _drop_null_edges(w: COO) -> COO:
    """``w`` without its zero-valued entries (a ShardedCOO's padding), so the
    sharded reduction stages measure their ratios on real entries (the
    reference's ``host_compact``, done here on the graph's device)."""
    keep = w.val != 0
    return COO(row=w.row[keep], col=w.col[keep], val=w.val[keep], shape=w.shape,
               sorted_rows=False)


def _row_block_ell(adj: COO, rows: RowBlock) -> RowBlockEllOperator:
    """This rank's ``rows`` of a COO graph, which every rank holds whole, as
    a :class:`RowBlockEllOperator`: laid out at the whole graph's ELL width,
    so each row's slots are those of the one-device layout (a padding row
    has none)."""
    width = ell_width(torch.bincount(adj.row, minlength=adj.shape[0]))
    own = (adj.row >= rows.lo) & (adj.row < rows.hi)
    return RowBlockEllOperator.of(adj.row[own] - rows.lo, adj.col[own], adj.val[own], rows,
                                  width=width)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpectralPipeline:
    """The paper's three-stage pipeline as one configured object, JSON
    round-trippable via :meth:`to_dict` / :meth:`from_dict` (which accepts
    the reference's JSON)."""

    n_clusters: int
    graph: GraphConfig = GraphConfig()
    eig: EigConfig = EigConfig()
    kmeans: KMeansConfig = KMeansConfig()
    plan: Plan = Plan()
    stages: Tuple[str, ...] = DEFAULT_STAGES
    sparsify: SparsifyConfig = SparsifyConfig()
    coarsen: CoarsenConfig = CoarsenConfig()
    health: HealthConfig = HealthConfig()

    def __post_init__(self):
        if self.n_clusters < 1:
            raise ValueError(
                f"SpectralPipeline.n_clusters must be >= 1, got {self.n_clusters}")
        if self.kmeans.k is not None and self.kmeans.k != self.n_clusters:
            raise ValueError(
                f"KMeansConfig.k={self.kmeans.k} conflicts with "
                f"n_clusters={self.n_clusters} — leave k unset (the pipeline "
                f"fills it) or pass n_clusters= to cluster()")
        stages = tuple(self.stages)
        object.__setattr__(self, "stages", stages)
        unknown = [s for s in stages if s not in _STAGE_ORDER]
        if unknown:
            raise ValueError(
                f"SpectralPipeline.stages contains unknown stage(s) {unknown} "
                f"— known stages (canonical order): {_STAGE_ORDER}")
        if len(set(stages)) != len(stages):
            raise ValueError(f"SpectralPipeline.stages has duplicates: {stages}")
        ranks = [_STAGE_ORDER.index(s) for s in stages]
        if ranks != sorted(ranks):
            raise ValueError(
                f"SpectralPipeline.stages must follow the canonical order "
                f"{_STAGE_ORDER}, got {stages}")
        missing = [s for s in _REQUIRED_STAGES if s not in stages]
        if missing:
            raise ValueError(
                f"SpectralPipeline.stages must include {_REQUIRED_STAGES} "
                f"(missing {missing})")
        if ("coarsen" in stages) != ("refine" in stages):
            raise ValueError("coarsen and refine are paired: include both or neither")

    # -- config plumbing ----------------------------------------------------

    def _lanczos_config(self, n: int, eig: Optional[EigConfig] = None) -> lz.LanczosConfig:
        e = eig if eig is not None else self.eig
        k = e.n_eigvecs or self.n_clusters
        b = e.block_size
        m = e.basis_m or default_basis_size(n, k, b)
        return lz.LanczosConfig(
            k=k + (1 if e.drop_first else 0),
            m=max(m, k + (2 if e.drop_first else 1)),
            max_restarts=e.max_restarts,
            tol=e.tol,
            which="LA",
            fixed_restarts=e.fixed_restarts,
            block_size=b,
        )

    def _cheb_config(self, n: int, eig: Optional[EigConfig] = None) -> cheb.ChebConfig:
        e = eig if eig is not None else self.eig
        k = (e.n_eigvecs or self.n_clusters) + (1 if e.drop_first else 0)
        return cheb.ChebConfig(k=k, degree=e.cheb_degree, n_signals=e.n_signals,
                               lambda_cut=e.lambda_cut, margin=e.cheb_margin, which="LA")

    def _eig_config(self, n: int, eig: Optional[EigConfig] = None):
        """The engine config :func:`repro_torch.core.lanczos.eigsh`
        dispatches on; ``eig`` overrides the pipeline's Stage-2 config (the
        escalation ladder's retry handle)."""
        e = eig if eig is not None else self.eig
        if e.solver == "chebyshev":
            return self._cheb_config(n, e)
        return self._lanczos_config(n, e)

    def operator(self, state: GraphState) -> LinearOperator:
        """The Stage-2 operator for this graph, by the reference's routes.
        A ShardedCOO gets its :class:`ShardedCooOperator` under this plan's
        mesh and variant at every world size, whatever
        ``eig.representation`` says (a ShardedCOO is its own
        representation).  A COO graph under a mesh axis of more than one
        rank is cut into the ranks' row blocks, padded when its n does not
        divide by them (:meth:`RowBlock.padded`, the layout of
        ``partition_coo_by_rows``): with ``eig.representation="blockell"``
        a :class:`RowBlockEllOperator` (the ``ell_spmv``/``ell_spmm``
        kernels on each rank's rows; it ignores ``gather_dtype``, as the
        reference's ``BlockEllOperator`` does), else a
        :class:`ShardedCooOperator` over the graph partitioned by rows.  Off
        such an axis a COO graph gets the index-add operator, or with
        ``"blockell"`` a BlockELL(+tail) built on the graph's device, whose
        products are the ``ell_spmv``/``ell_spmm`` kernels."""
        p = self.plan
        adj = state.adj
        if isinstance(adj, ShardedCOO):
            return ShardedCooOperator(adj, variant=p.variant, mesh=p.mesh, axis=p.axis,
                                      gather_dtype=p.gather_dtype)
        ax = self._split_axis()
        if ax is not None:
            rows = RowBlock.padded(ax, adj.shape[0])
            if self.eig.representation == "blockell":
                return _row_block_ell(adj, rows)
            return ShardedCooOperator(partition_coo_by_rows(adj, ax.size), variant=p.variant,
                                      mesh=p.mesh, axis=p.axis, gather_dtype=p.gather_dtype,
                                      live_rows=rows.live)
        if self.eig.representation == "blockell":
            return BlockEllOperator(csr_to_blockell(coo_to_csr(adj)))
        return CooOperator(adj)

    # -- Stage 1 ------------------------------------------------------------

    def prepare(self, w, *, device: DeviceLike = None) -> GraphState:
        """Admit a prebuilt similarity graph — a COO or a row-partitioned
        ShardedCOO — as Stage-1 output (normalize + degree bookkeeping)."""
        w = w.to(resolve_device(device))
        if isinstance(w, ShardedCOO):
            # the degree pass; under a mesh each rank sums its own rows and
            # the blocks are gathered, so every rank holds the same degrees
            # (an index-add on the card rounds differently from run to run);
            # a rank may hold only its own bucket, whose shard is its
            # coordinate on the axis
            ax = self._axis()
            if ax is None:
                deg = spmv_gspmd(w, torch.ones(w.shape[0], device=w.device))
            else:
                deg = sharded_degrees(w, ax)
            d32 = deg.float()
            isd = torch.where(d32 > 0, torch.rsqrt(torch.clamp(d32, min=1e-30)),
                              torch.zeros_like(d32)).to(w.val.dtype)
            return GraphState(adj=normalize_sharded(w, deg, ax), deg=deg, inv_sqrt_deg=isd)
        g = lap.normalized_graph(w)
        return GraphState(adj=g.adj_sym, deg=g.deg, inv_sqrt_deg=g.inv_sqrt_deg)

    def build_graph(self, x, *, points=None, device: DeviceLike = None) -> GraphState:
        """Stage 1 from raw points: kNN search → similarity → normalized
        COO.  ``points`` separates the search coordinates from the
        similarity features (DTI: spatial kNN, profile cross-correlation).
        Under ``Plan(device="sharded")`` the neighbour search runs
        row-block-parallel over the mesh (``graph.method`` exact or LSH,
        ``plan.stage1_exchange`` gather or ring), its [n, k] results are
        all-gathered, and every rank assembles the same graph."""
        dev = resolve_device(device)
        g = self.graph
        if self.plan.device == "sharded":
            return self._build_graph_sharded(_as_points(x, dev),
                                             None if points is None else _as_points(points, dev),
                                             dev)
        w = build_knn_graph(
            _as_points(x, dev), g.knn_k,
            points=None if points is None else _as_points(points, dev),
            measure=g.measure, sigma=g.sigma, eps=g.eps, method=g.method,
            n_tables=g.n_tables, n_bits=g.n_bits, candidates=g.candidates,
            lsh_seed=g.lsh_seed, block_q=g.block_q)
        return self.prepare(w, device=dev)

    def _build_graph_sharded(self, x, points, dev) -> GraphState:
        from repro_torch.core.distributed_pipeline import make_knn_rowblock
        from repro_torch.core.similarity import graph_from_knn

        g, plan = self.graph, self.plan
        if points is not None and points.shape[0] != x.shape[0]:
            raise ValueError(
                f"points rows ({points.shape[0]}) must match feature rows "
                f"({x.shape[0]}) — one search point per feature row")
        if plan.mesh is None:
            raise ValueError(
                "Plan(device='sharded') needs a mesh for the row-block Stage 1 (build_graph)")
        p = x if points is None else points
        ax = mesh_axis(plan.mesh, plan.axis)
        n = p.shape[0]
        if n % ax.size:
            raise ValueError(
                f"the row-block Stage 1 needs n divisible by the mesh axis' size: "
                f"n={n}, {ax.size} ranks")
        nl = n // ax.size
        knn = make_knn_rowblock(
            plan.mesh, g.knn_k, axis=plan.axis, block_q=g.block_q or 1024, method=g.method,
            n_tables=g.n_tables, n_bits=g.n_bits, candidates=g.candidates,
            lsh_seed=g.lsh_seed, exchange=plan.stage1_exchange)
        d_blk, i_blk = knn(p[ax.rank * nl:(ax.rank + 1) * nl])
        w = graph_from_knn(x, all_gather(d_blk, ax), all_gather(i_blk, ax),
                           measure=g.measure, sigma=g.sigma, eps=g.eps,
                           dist2_in_x_space=points is None)
        return self.prepare(w, device=dev)

    # -- Stage 2 ------------------------------------------------------------

    def embed(self, state: GraphState, generator: Optional[torch.Generator] = None, *,
              operator: Optional[LinearOperator] = None,
              eig: Optional[EigConfig] = None, device: DeviceLike = None) -> EmbedState:
        """Stage 2: the top-k eigenpairs of the normalized adjacency via
        thick-restart Lanczos (``eig.solver="lanczos"``) or the Chebyshev
        polynomial-filter sketch (``"chebyshev"``), mapped to
        Ng-Jordan-Weiss rows.  ``operator`` overrides the plan-chosen
        operator; ``eig`` the Stage-2 config.  On an operator that pads the
        graph's rows (:meth:`operator`) the start vector is zero on the
        padding, and the embedding holds the rank's real rows only."""
        dev = resolve_device(device)
        state = state.to(dev)
        n = state.adj.shape[0]
        op = self.operator(state) if operator is None else operator
        rows = row_block(op, op.shape[0])
        if self._split_axis() is not None and not rows.split:
            raise ValueError(
                f"{type(op).__name__} has no rows on this plan's mesh: under a mesh of "
                f"more than one rank Stage 2 runs on each rank's rows (ShardedCooOperator, "
                f"RowBlockEllOperator)")
        scfg = self._eig_config(n, eig)
        # D^{1/2}·1 is exactly the trivial eigenvector of A_sym (the
        # Chebyshev path seeds its sketch with it)
        v0 = rows.pad(torch.sqrt(torch.clamp(state.deg.float(), min=0.0)) + 1e-3)
        ecfg = eig if eig is not None else self.eig
        res = lz.eigsh(op, scfg, v0=v0,
                       generator=cpu_generator(0) if generator is None else generator)
        vecs, vals = res.eigenvectors, res.eigenvalues
        if ecfg.drop_first:
            vecs, vals = vecs[:, 1:], vals[1:]
        # under a mesh the eigenvectors are this rank's rows; the
        # eigenvalues, residuals and flags come from all-reduced values and
        # are the same on every rank
        return EmbedState(
            embedding=lap.embed_rows(rows.drop_padding(vecs),
                                     rows.take(state.inv_sqrt_deg)),
            eigenvalues=lap.smallest_laplacian_eigs_from_adj(vals),
            residuals=res.residuals,
            restarts=res.restarts,
            converged=res.converged,
            n_rows=rows.live,
        )

    def _axis(self):
        """The plan's mesh :class:`~repro_torch.sparse.distributed.Axis`
        (None without a mesh)."""
        return None if self.plan.mesh is None else mesh_axis(self.plan.mesh, self.plan.axis)

    def _split_axis(self):
        """The plan's mesh axis when it has more than one rank — the
        embedding is then distributed by rows —, else None."""
        ax = self._axis()
        return ax if ax is not None and ax.size > 1 else None

    def _nonfinite_rows(self, h: torch.Tensor) -> int:
        """Non-finite entries of an embedding: under a split axis this
        rank's rows are counted and the counts all-reduced, so every rank
        takes the same rung of a ladder."""
        bad = health.nonfinite_count(h)
        ax = self._split_axis()
        if ax is None:
            return bad
        return int(all_reduce(torch.tensor([float(bad)], dtype=torch.float64,
                                            device=h.device), ax)[0])

    # -- Stage 3 ------------------------------------------------------------

    def cluster(self, state: EmbedState, generator: Optional[torch.Generator] = None, *,
                n_clusters: Optional[int] = None,
                kmeans: Optional[KMeansConfig] = None,
                device: DeviceLike = None) -> SpectralResult:
        """Stage 3: k-means over a (possibly cached) spectral embedding;
        ``n_clusters`` re-clusters at another k, ``kmeans`` overrides the
        Stage-3 config."""
        state = state.to(resolve_device(device))
        base = kmeans if kmeans is not None else self.kmeans
        kcfg = base.resolved(n_clusters or self.n_clusters)
        res = self._run_kmeans(state.embedding, self._embedding_rows(state), kcfg,
                               cpu_generator(0) if generator is None else generator)
        return SpectralResult(
            labels=res.labels,
            embedding=state.embedding,
            eigenvalues=state.eigenvalues,
            eig_residuals=state.residuals,
            kmeans_inertia=res.inertia,
            lanczos_restarts=state.restarts,
            kmeans_iterations=res.iterations,
        )

    def _shards(self) -> int:
        return self._axis().size

    def _embedding_rows(self, state: EmbedState) -> int:
        """The embedding's rows in all (under a split axis, across the
        ranks)."""
        if state.n_rows is not None:
            return state.n_rows
        ax = self._split_axis()
        return state.embedding.shape[0] * (1 if ax is None else ax.size)

    def _kmeans_sharded_dispatch(self, n: int, kcfg: KMeansConfig) -> bool:
        """True iff Stage 3 runs ``kmeans_sharded`` on the ``n`` rows of
        the embedding: rows distributed over more than one rank that tile
        the axis, under either variant and either iteration (the reference
        computes the gspmd plan's and the two-pass Lloyd iterations through
        GSPMD on the same rows); or, as the reference routes it to its
        ``shard_map`` loop, the sharded plan under ``variant="shard_map"``
        on a mesh of one rank with the fused iteration."""
        if self._split_axis() is not None:
            return n % self._shards() == 0
        plan = self.plan
        return (kcfg.iter == "fused" and plan.device == "sharded"
                and plan.variant == "shard_map" and plan.mesh is not None)

    def _run_kmeans(self, h: torch.Tensor, n: int, kcfg: KMeansConfig, generator):
        if self._kmeans_sharded_dispatch(n, kcfg):
            from repro_torch.core.distributed_pipeline import kmeans_sharded

            return kmeans_sharded(h, kcfg, generator, mesh=self.plan.mesh, axis=self.plan.axis)
        # n rows that do not tile a split axis: the reference's route, its n
        # real rows gathered once
        return km.kmeans(gather_rows(h, self._split_axis(), n), kcfg, generator)

    # -- the stage DAG ------------------------------------------------------

    def _stage_prepare(self, st: PipelineState) -> PipelineState:
        t0 = time.perf_counter()
        if self.health.enabled:
            if st.input_graph is not None:
                health.check_graph(st.input_graph.val)
            elif st.points is not None:
                health.check_points(st.points, self.n_clusters)
        if st.input_graph is not None:
            g = self.prepare(st.input_graph, device=st.device)
        elif st.points is not None:
            g = self.build_graph(st.points, points=st.search_points, device=st.device)
        else:
            raise ValueError(
                "the prepare stage needs a PipelineState with points= or input_graph= set")
        notes: Tuple[str, ...] = ()
        eager = health.is_concrete(g.deg)
        if self.health.enabled and eager:
            iso = int((g.deg <= 0).sum())  # handled (pinned to 0): a note, not a fault
            if iso:
                notes += (f"isolated_vertices[{iso}]",)
        rep = StageReport("prepare", escalations=notes,
                          wall_s=_wall(t0, st.device) if eager else -1.0)
        return dataclasses.replace(st, graph=g, reports=st.reports + (rep,),
                                   provenance=st.provenance + ("prepare",))

    def _stage_sparsify(self, st: PipelineState) -> PipelineState:
        if st.graph is None:
            raise ValueError("sparsify runs after prepare (no graph in state)")
        sharded = isinstance(st.graph.adj, ShardedCOO)
        w = _raw_weights(st.graph)
        if sharded:
            w = _drop_null_edges(w)
        ws = red.sparsify_coo(w, self.sparsify)
        info = ReduceInfo(kind="sparsify", n_before=w.shape[0], n_after=w.shape[0],
                          nnz_before=w.nnz, nnz_after=ws.nnz)
        if sharded:  # the same shard count, so the plan's collectives are unchanged
            ws = partition_coo_by_rows(ws, st.graph.adj.num_shards)
        g = self.prepare(ws, device=st.device)
        return dataclasses.replace(
            st, graph=g, reductions=st.reductions + (info,),
            provenance=st.provenance + (f"sparsify[nnz {info.nnz_before}→{info.nnz_after}]",))

    def _stage_coarsen(self, st: PipelineState) -> PipelineState:
        if st.graph is None:
            raise ValueError("coarsen runs after prepare (no graph in state)")
        sharded = isinstance(st.graph.adj, ShardedCOO)
        w = _raw_weights(st.graph)
        if sharded:
            w = _drop_null_edges(w)
        wc, prolong = red.coarsen_coo(w, self.coarsen)
        info = ReduceInfo(kind="coarsen", n_before=w.shape[0], n_after=wc.shape[0],
                          nnz_before=w.nnz, nnz_after=wc.nnz)
        if sharded:
            wc = partition_coo_by_rows(wc, st.graph.adj.num_shards)
        g = self.prepare(wc, device=st.device)
        reduction = ReductionState(fine_graph=st.graph, prolong=prolong, info=info)
        return dataclasses.replace(
            st, graph=g, reduction=reduction, reductions=st.reductions + (info,),
            provenance=st.provenance + (f"coarsen[n {info.n_before}→{info.n_after}]",))

    def _stage_refine(self, st: PipelineState) -> PipelineState:
        if st.reduction is None or st.reduction.prolong is None:
            raise ValueError(
                "refine needs the coarsen stage's ReductionState (prolong map) in the "
                "PipelineState — stage order is prepare → coarsen → embed → refine → cluster")
        if st.embedding is None:
            raise ValueError("refine runs after embed (no embedding in state)")
        fine = st.reduction.fine_graph
        # lift through the partition prolongation, smooth on the fine
        # operator, map to NJW rows with the fine degrees; under a mesh the
        # coarse embedding is gathered once (a fine row may point at any
        # coarse row) and each rank lifts its own fine rows
        op = self.operator(fine)
        rows = row_block(op, op.shape[0])
        coarse = gather_rows(st.embedding.embedding, self._split_axis(),
                             self._embedding_rows(st.embedding))
        u0 = rows.fill_padding(coarse[rows.take(st.reduction.prolong)])
        u, theta, resid = red.lift_and_smooth(op, u0, steps=self.coarsen.refine_steps)
        emb = EmbedState(
            embedding=lap.embed_rows(rows.drop_padding(u), rows.take(fine.inv_sqrt_deg)),
            eigenvalues=lap.smallest_laplacian_eigs_from_adj(theta),
            residuals=resid,
            restarts=st.embedding.restarts,
            converged=st.embedding.converged,
            n_rows=rows.live,
        )
        return dataclasses.replace(st, graph=fine, embedding=emb, reduction=None,
                                   provenance=st.provenance + ("refine",))

    def _embed_failure(self, emb: EmbedState, ecfg: EigConfig) -> Optional[str]:
        """``None`` (healthy), ``"cheb_diverged"`` (the polynomial filter
        left its bounds interval), ``"nonfinite"`` or ``"unconverged"``."""
        bad = self._nonfinite_rows(emb.embedding) + health.nonfinite_count(emb.eigenvalues)
        if ecfg.solver == "chebyshev" and (bad or cheb.diverged(emb.eigenvalues)):
            return "cheb_diverged"
        if bad:
            return "nonfinite"
        if not bool(emb.converged):
            return "unconverged"
        return None

    def _escalate_embed(self, ecfg: EigConfig, failure: str,
                        n: int) -> Tuple[Optional[EigConfig], str]:
        """The next rung of the Stage-2 ladder for this failure, or
        ``(None, "")`` when none applies.  Chebyshev: widen the bounds
        margin by ``HealthConfig.margin_widen`` once, then fall back to
        Lanczos.  Lanczos: widen the Krylov basis and double the restart
        budget (:func:`repro_torch.core.lanczos.escalate_basis`)."""
        hc = self.health
        if ecfg.solver == "chebyshev":
            if ecfg.cheb_margin < self.eig.cheb_margin * hc.margin_widen:
                new = dataclasses.replace(ecfg, cheb_margin=ecfg.cheb_margin * hc.margin_widen)
                return new, f"cheb_margin_widen[{new.cheb_margin:g}]"
            return dataclasses.replace(ecfg, solver="lanczos"), "fallback_lanczos"
        if failure in ("unconverged", "nonfinite"):
            lcfg = self._lanczos_config(n, ecfg)
            wid = lz.escalate_basis(lcfg, n, widen=hc.basis_widen)
            new = dataclasses.replace(ecfg, basis_m=wid.m, max_restarts=wid.max_restarts)
            return new, f"lanczos_widen[m={wid.m},restarts={wid.max_restarts}]"
        return None, ""

    def _stage_embed(self, st: PipelineState) -> PipelineState:
        if st.graph is None:
            raise ValueError("embed runs after prepare (no graph in state)")
        if st.gen_embed is None:
            raise ValueError("embed needs PipelineState.gen_embed")
        hc = self.health
        t0 = time.perf_counter()
        op = st.operator_override if st.operator_override is not None \
            else self.operator(st.graph)
        ecfg = self.eig
        emb = self.embed(st.graph, st.gen_embed, operator=op, eig=ecfg, device=st.device)
        attempts = 1
        rungs = []
        if hc.enabled and health.is_concrete(emb.embedding, emb.eigenvalues, emb.converged):
            # host-driven escalation: only on concrete outputs
            failure = self._embed_failure(emb, ecfg)
            while failure and attempts < hc.max_attempts:
                ecfg, rung = self._escalate_embed(ecfg, failure, st.graph.adj.shape[0])
                if ecfg is None:
                    break
                rungs.append(rung)
                emb = self.embed(st.graph, fold_in(st.gen_embed, attempts), operator=op,
                                 eig=ecfg, device=st.device)
                attempts += 1
                failure = self._embed_failure(emb, ecfg)
            if failure in ("nonfinite", "cheb_diverged"):
                raise PipelineError(
                    "embed", f"spectral embedding is {failure.replace('_', ' ')} "
                             f"after {attempts} attempt(s)",
                    ladder=tuple(rungs),
                    remedy="check the similarity graph / operator for "
                           "degenerate values (health.check_graph), or raise "
                           "HealthConfig.max_attempts")
            if failure == "unconverged" and self.eig.strict:
                raise PipelineError(
                    "embed",
                    f"eigensolver unconverged after {attempts} attempt(s) "
                    f"(residual_max={float(emb.residuals.max()):.3e}, "
                    f"tol={self.eig.tol:g}) and EigConfig.strict is set",
                    ladder=tuple(rungs),
                    remedy="raise max_restarts/basis_m, loosen tol, or drop "
                           "strict to accept the degraded subspace")
        eager = health.is_concrete(emb.embedding, emb.residuals, emb.converged)
        resid_max = emb.residuals.float().max()
        rep = StageReport(
            "embed", escalations=tuple(rungs), attempts=attempts,
            converged=bool(emb.converged) if eager else emb.converged,
            residual_max=float(resid_max) if eager else resid_max,
            wall_s=_wall(t0, st.device) if eager else -1.0)
        return dataclasses.replace(st, embedding=emb, reports=st.reports + (rep,),
                                   provenance=st.provenance + ("embed",))

    def _stage_cluster(self, st: PipelineState) -> PipelineState:
        if st.embedding is None:
            raise ValueError("cluster runs after embed (no embedding in state)")
        if st.gen_cluster is None:
            raise ValueError("cluster needs PipelineState.gen_cluster")
        hc = self.health
        t0 = time.perf_counter()
        kcfg = self.kmeans.resolved(self.n_clusters)
        res = self.cluster(st.embedding, st.gen_cluster, device=st.device)
        attempts = 1
        rungs = []
        eager = health.is_concrete(res.labels, res.kmeans_inertia, st.embedding.embedding)
        if hc.enabled and eager:
            if self._nonfinite_rows(st.embedding.embedding):
                raise PipelineError(
                    "cluster", "input embedding contains non-finite values",
                    remedy="run the embed stage with health enabled (its "
                           "ladder catches this) or sanitize the cached "
                           "embedding before re-clustering")
            empty = kcfg.k - int(torch.unique(res.labels).numel())
            bad = bool(health.nonfinite_count(res.kmeans_inertia))
            # one reseed rung; under kmeans_sharded (fused or two-pass) it
            # needs k rows a shard
            n = self._embedding_rows(st.embedding)
            can_reseed = kcfg.empty == "keep"
            if can_reseed and self._kmeans_sharded_dispatch(n, kcfg):
                can_reseed = n // self._shards() >= kcfg.k
            if (empty > 0 or bad) and attempts < hc.max_attempts and can_reseed:
                rungs.append(f"kmeans_reseed_farthest[empty={empty}]")
                retry = dataclasses.replace(self.kmeans, empty="reseed_farthest")
                res = self.cluster(st.embedding, fold_in(st.gen_cluster, attempts),
                                   kmeans=retry, device=st.device)
                attempts += 1
                bad = bool(health.nonfinite_count(res.kmeans_inertia))
            if bad:
                raise PipelineError(
                    "cluster", "k-means inertia is non-finite", ladder=tuple(rungs),
                    remedy="inspect the embedding scale — k-means over a "
                           "finite embedding cannot produce non-finite inertia")
        if eager:
            counts = torch.bincount(res.labels.long(), minlength=kcfg.k)
            converged, inertia = int((counts > 0).sum()) == kcfg.k, float(res.kmeans_inertia)
        else:  # the reference's traced report: tensors, no wall time
            live = torch.zeros(kcfg.k, dtype=torch.bool, device=res.labels.device)
            live[res.labels.long()] = True
            converged, inertia = live.all(), res.kmeans_inertia
        rep = StageReport(
            "cluster", escalations=tuple(rungs), attempts=attempts,
            converged=converged, residual_max=inertia,
            wall_s=_wall(t0, st.device) if eager else -1.0)
        reports = st.reports + (rep,)
        return dataclasses.replace(st, result=res._replace(reports=reports),
                                   reports=reports,
                                   provenance=st.provenance + ("cluster",))

    def run_stages(self, state: PipelineState, *,
                   checkpoint_dir: Optional[str] = None) -> PipelineState:
        """Execute the configured stage DAG over a :class:`PipelineState`;
        stages already in ``state.provenance`` are skipped — the whole resume
        mechanism.  With ``checkpoint_dir`` set, a :class:`PipelineError`
        first saves the completed-stage prefix there
        (:func:`repro_torch.core.state_io.save_state`) and gains a
        ``checkpoint`` attribute naming the directory."""
        if state.device is None:
            state = dataclasses.replace(state, device=resolve_device(None))
        for name in self.stages:
            if _stage_done(name, state.provenance):
                continue
            try:
                state = getattr(self, f"_stage_{name}")(state)
            except PipelineError as e:
                if checkpoint_dir is not None:
                    from repro_torch.core import state_io

                    e.checkpoint = state_io.save_state(checkpoint_dir, state, self)
                    note = (f"completed-stage prefix saved to {checkpoint_dir!r} — fix "
                            f"the config and run(resume_from=...)")
                    e.remedy = (e.remedy + "; " if e.remedy else "") + note
                    e.args = (f"{e.args[0]}; {note}",) if e.args else (note,)
                raise
        return state

    # -- end to end ---------------------------------------------------------

    def run(self, data=None, generator: Optional[torch.Generator] = None, *,
            points=None, operator: Optional[LinearOperator] = None,
            checkpoint_dir: Optional[str] = None, resume_from: Optional[str] = None,
            device: DeviceLike = None) -> SpectralResult:
        """Points/graph in, labels out — the whole stage DAG under one call.
        ``data`` is raw points ([n, d] tensor or array → Stage 1 runs), a
        COO similarity graph or a row-partitioned ShardedCOO; ``generator``
        is a CPU ``torch.Generator``.
        ``checkpoint_dir`` saves the completed-stage prefix when a stage
        raises :class:`PipelineError`; ``resume_from`` loads such a prefix
        onto ``device`` in place of ``data``/``generator``/``points`` (pass
        none of them) and runs the stages that are left."""
        return self.run_state(data, generator, points=points, operator=operator,
                              checkpoint_dir=checkpoint_dir, resume_from=resume_from,
                              device=device).result

    def run_state(self, data=None, generator: Optional[torch.Generator] = None, *,
                  points=None, operator: Optional[LinearOperator] = None,
                  checkpoint_dir: Optional[str] = None, resume_from: Optional[str] = None,
                  device: DeviceLike = None) -> PipelineState:
        """:meth:`run`, returning the final :class:`PipelineState`."""
        dev = resolve_device(device)
        if resume_from is not None:
            if data is not None or generator is not None or points is not None:
                raise ValueError(
                    "run(resume_from=...) restores points/graph/generators from the "
                    "checkpoint — don't pass data/generator/points alongside")
            from repro_torch.core import state_io

            state, _ = state_io.load_state(resume_from, self, device=dev)
            if operator is not None:
                state = dataclasses.replace(state, operator_override=operator)
            return self.run_stages(state, checkpoint_dir=checkpoint_dir)
        if data is None:
            raise ValueError("run needs data (points, a COO or a ShardedCOO) — or resume_from=")
        if isinstance(data, (COO, ShardedCOO)):
            if points is not None:
                raise ValueError(
                    "points= only applies to Stage 1 (raw-points input); a "
                    "prebuilt graph already fixed its neighbor structure")
            state = PipelineState(input_graph=data.to(dev))
        else:
            state = PipelineState(
                points=_as_points(data, dev),
                search_points=None if points is None else _as_points(points, dev))
        if operator is not None and ("sparsify" in self.stages or "coarsen" in self.stages):
            raise ValueError(
                "operator= overrides the Stage-2 operator for the input "
                "graph, but a reduction stage replaces that graph")
        gen = cpu_generator(0) if generator is None else generator
        # the reference's split(key, 3): [next key, embed key, cluster key]
        seeds = torch.randint(0, 2**62, (3,), generator=gen).tolist()
        state = dataclasses.replace(
            state, gen_embed=cpu_generator(seeds[1]), gen_cluster=cpu_generator(seeds[2]),
            operator_override=operator, device=dev)
        return self.run_stages(state, checkpoint_dir=checkpoint_dir)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "n_clusters": self.n_clusters,
            "graph": self.graph.to_dict(),
            "eig": self.eig.to_dict(),
            "kmeans": dataclasses.asdict(self.kmeans),
            "plan": self.plan.to_dict(),
            "stages": list(self.stages),
            "sparsify": self.sparsify.to_dict(),
            "coarsen": self.coarsen.to_dict(),
            "health": self.health.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict, *, mesh: Any = None) -> "SpectralPipeline":
        """Build from :meth:`to_dict` output — this package's or the
        reference's (the field sets are the same)."""
        return cls(
            n_clusters=d["n_clusters"],
            graph=GraphConfig(**d.get("graph", {})),
            eig=EigConfig(**d.get("eig", {})),
            kmeans=KMeansConfig(**d.get("kmeans", {})),
            plan=Plan.from_dict(d.get("plan", {}), mesh=mesh),
            stages=tuple(d.get("stages", DEFAULT_STAGES)),
            sparsify=SparsifyConfig(**d.get("sparsify", {})),
            coarsen=CoarsenConfig(**d.get("coarsen", {})),
            health=HealthConfig(**d.get("health", {})),
        )


def _wall(t0: float, device: Optional[torch.device]) -> float:
    """Host wall seconds since ``t0``, after the device has finished."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0
