"""Stage-graph API: the paper's three-stage pipeline as one configured object
(mirrors :mod:`repro.core.spectral`, single device)::

    pipe  = SpectralPipeline(n_clusters=8)
    state = pipe.build_graph(x)        # Stage 1 (or pipe.prepare(w))
    emb   = pipe.embed(state, gen)     # Stage 2: Lanczos → spectral embedding
    out   = pipe.cluster(emb, gen2)    # Stage 3: k-means on the embedding
    out   = pipe.run(x_or_graph, gen)  # or all three at once

Random draws come from CPU ``torch.Generator``s (the reference's PRNG keys);
``run`` derives one per stage from the caller's, in the reference's split
order.  Every entry point takes ``device=``: the card unless the caller asks
for the CPU, raising when there is none.  ``Plan.device`` keeps the
reference's meaning ("single" | "sharded") so the reference's JSON loads.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``Plan(device="sharded")`` (A12), ``solver="chebyshev"`` (A6),
``method="lsh"`` (A7), the sparsify/coarsen/refine stages (A8),
checkpointing (A9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional, Tuple

import torch

import repro_torch.core.health as health
import repro_torch.core.kmeans as km
import repro_torch.core.lanczos as lz
import repro_torch.core.laplacian as lap
from repro_torch._device import DeviceLike, cpu_generator, fold_in, resolve_device
from repro_torch.core.health import HealthConfig, PipelineError, StageReport
from repro_torch.core.operator import BlockEllOperator, CooOperator, LinearOperator
from repro_torch.core.reduce import CoarsenConfig, SparsifyConfig
from repro_torch.core.similarity import build_knn_graph
from repro_torch.sparse.formats import COO, coo_to_csr, csr_to_blockell

KMeansConfig = km.KMeansConfig  # the Stage-3 nested config (re-exported)

_MEASURES = ("cosine", "cross_correlation", "exp_decay")
_METHODS = ("exact", "lsh")
_KNN_IMPLS = ("auto", "pallas", "ref")
_DEVICES = ("single", "sharded")
_VARIANTS = ("gspmd", "shard_map")
_EXCHANGES = ("gather", "ring")
_SOLVERS = ("lanczos", "chebyshev")
_REPRESENTATIONS = ("coo", "blockell")
# LSH knobs of GraphConfig (the LSH search itself is ROADMAP A7)
_DEFAULT_LSH_TABLES = 16
_DEFAULT_LSH_BITS = 16
_MAX_LSH_BITS = 24


class SpectralResult(NamedTuple):
    labels: torch.Tensor  # [n] cluster assignment
    embedding: torch.Tensor  # [n, k] row-normalized spectral embedding
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
    """Stage-1 knobs (kNN similarity graph, paper Alg. 1).  ``impl``,
    ``block_q``, ``block_k`` and ``interpret`` select Pallas paths in the
    reference and are kept for config parity only: here the device of the
    input picks the kernel or its plain version."""

    knn_k: int = 10
    measure: str = "exp_decay"
    sigma: float = 1.0
    eps: Any = None  # degree-capped ε-ball radius
    method: str = "exact"  # "exact" | "lsh" (ROADMAP A7)
    n_tables: int = _DEFAULT_LSH_TABLES
    n_bits: int = _DEFAULT_LSH_BITS
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
        if not 1 <= self.n_bits <= _MAX_LSH_BITS:
            raise ValueError(
                f"GraphConfig.n_bits must be in [1, {_MAX_LSH_BITS}], got {self.n_bits}")
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
    """Stage-2 knobs (paper Alg. 2-3).  ``representation="blockell"``
    converts the graph to BlockELL(+tail) host-side so block Lanczos streams
    the ``ell_spmm`` kernel.  The Chebyshev knobs are kept for config parity
    (``solver="chebyshev"`` is ROADMAP A6)."""

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
    """Execution plan, as in the reference: ``device`` is "single" or
    "sharded" (where the stage graph runs, not a torch device).  Only the
    single-device plan is ported; a sharded plan loads but raises when run
    (ROADMAP A12)."""

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

    adj: COO  # D^{-1/2} W D^{-1/2}
    deg: torch.Tensor  # [n] degrees of the raw graph
    inv_sqrt_deg: torch.Tensor  # [n] D^{-1/2} (0 where isolated)

    def to(self, device) -> "GraphState":
        return GraphState(self.adj.to(device), self.deg.to(device),
                          self.inv_sqrt_deg.to(device))


class EmbedState(NamedTuple):
    """Stage-2 output: the spectral embedding, cacheable/re-clusterable."""

    embedding: torch.Tensor  # [n, k] row-normalized spectral embedding
    eigenvalues: torch.Tensor  # [k] Laplacian eigenvalues 1-θ (ascending)
    residuals: torch.Tensor  # eigensolver residuals
    restarts: int  # Lanczos restart count
    converged: bool = True

    def to(self, device) -> "EmbedState":
        return self._replace(embedding=self.embedding.to(device),
                             eigenvalues=self.eigenvalues.to(device),
                             residuals=self.residuals.to(device))


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """The typed value the stage DAG threads; each stage fills the slots it
    owns and appends to ``provenance``.  ``gen_embed``/``gen_cluster`` are
    the per-stage CPU generators ``run`` derives; ``device`` is where the
    stages run."""

    points: Optional[torch.Tensor] = None
    search_points: Optional[torch.Tensor] = None
    input_graph: Optional[COO] = None
    graph: Optional[GraphState] = None
    embedding: Optional[EmbedState] = None
    result: Optional[SpectralResult] = None
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

    def _check_plan(self) -> None:
        if self.plan.device != "single":
            raise NotImplementedError(
                "Plan(device='sharded') is not ported yet — ROADMAP A12 "
                "(multi-GPU over torch.distributed)")

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

    def _eig_config(self, n: int, eig: Optional[EigConfig] = None) -> lz.LanczosConfig:
        e = eig if eig is not None else self.eig
        if e.solver == "chebyshev":
            raise NotImplementedError(
                "EigConfig(solver='chebyshev') is not ported yet — ROADMAP A6")
        return self._lanczos_config(n, e)

    def operator(self, state: GraphState) -> LinearOperator:
        """The Stage-2 operator for this graph: the COO index-add operator,
        or with ``eig.representation="blockell"`` a BlockELL(+tail) built
        host-side, whose block product is the ``ell_spmm`` kernel."""
        self._check_plan()
        if self.eig.representation == "blockell":
            return BlockEllOperator(csr_to_blockell(coo_to_csr(state.adj)))
        return CooOperator(state.adj)

    # -- Stage 1 ------------------------------------------------------------

    def prepare(self, w: COO, *, device: DeviceLike = None) -> GraphState:
        """Admit a prebuilt similarity graph as Stage-1 output (normalize +
        degree bookkeeping)."""
        self._check_plan()
        g = lap.normalized_graph(w.to(resolve_device(device)))
        return GraphState(adj=g.adj_sym, deg=g.deg, inv_sqrt_deg=g.inv_sqrt_deg)

    def build_graph(self, x, *, points=None, device: DeviceLike = None) -> GraphState:
        """Stage 1 from raw points: kNN search → similarity → normalized
        COO.  ``points`` separates the search coordinates from the
        similarity features (DTI: spatial kNN, profile cross-correlation)."""
        self._check_plan()
        dev = resolve_device(device)
        g = self.graph
        w = build_knn_graph(
            _as_points(x, dev), g.knn_k,
            points=None if points is None else _as_points(points, dev),
            measure=g.measure, sigma=g.sigma, eps=g.eps, method=g.method)
        return self.prepare(w, device=dev)

    # -- Stage 2 ------------------------------------------------------------

    def embed(self, state: GraphState, generator: Optional[torch.Generator] = None, *,
              operator: Optional[LinearOperator] = None,
              eig: Optional[EigConfig] = None, device: DeviceLike = None) -> EmbedState:
        """Stage 2: the top-k eigenpairs of the normalized adjacency via
        thick-restart Lanczos, mapped to Ng-Jordan-Weiss rows.  ``operator``
        overrides the plan-chosen operator; ``eig`` the Stage-2 config."""
        dev = resolve_device(device)
        state = state.to(dev)
        n = state.adj.shape[0]
        op = self.operator(state) if operator is None else operator
        scfg = self._eig_config(n, eig)
        # D^{1/2}·1 is exactly the trivial eigenvector of A_sym
        v0 = torch.sqrt(torch.clamp(state.deg.float(), min=0.0)) + 1e-3
        ecfg = eig if eig is not None else self.eig
        res = lz.eigsh(op, scfg, v0=v0,
                       generator=cpu_generator(0) if generator is None else generator)
        vecs, vals = res.eigenvectors, res.eigenvalues
        if ecfg.drop_first:
            vecs, vals = vecs[:, 1:], vals[1:]
        return EmbedState(
            embedding=lap.embed_rows(vecs, state.inv_sqrt_deg),
            eigenvalues=lap.smallest_laplacian_eigs_from_adj(vals),
            residuals=res.residuals,
            restarts=res.restarts,
            converged=res.converged,
        )

    # -- Stage 3 ------------------------------------------------------------

    def cluster(self, state: EmbedState, generator: Optional[torch.Generator] = None, *,
                n_clusters: Optional[int] = None,
                kmeans: Optional[KMeansConfig] = None,
                device: DeviceLike = None) -> SpectralResult:
        """Stage 3: k-means over a (possibly cached) spectral embedding;
        ``n_clusters`` re-clusters at another k, ``kmeans`` overrides the
        Stage-3 config."""
        self._check_plan()
        state = state.to(resolve_device(device))
        base = kmeans if kmeans is not None else self.kmeans
        kcfg = base.resolved(n_clusters or self.n_clusters)
        res = km.kmeans(state.embedding, kcfg,
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
        if self.health.enabled:
            iso = int((g.deg <= 0).sum())  # handled (pinned to 0): a note, not a fault
            if iso:
                notes += (f"isolated_vertices[{iso}]",)
        rep = StageReport("prepare", escalations=notes, wall_s=_wall(t0, st.device))
        return dataclasses.replace(st, graph=g, reports=st.reports + (rep,),
                                   provenance=st.provenance + ("prepare",))

    def _stage_sparsify(self, st: PipelineState) -> PipelineState:
        raise NotImplementedError("the sparsify stage is not ported yet — ROADMAP A8")

    def _stage_coarsen(self, st: PipelineState) -> PipelineState:
        raise NotImplementedError("the coarsen stage is not ported yet — ROADMAP A8")

    def _stage_refine(self, st: PipelineState) -> PipelineState:
        raise NotImplementedError("the refine stage is not ported yet — ROADMAP A8")

    def _embed_failure(self, emb: EmbedState) -> Optional[str]:
        """``None`` (healthy), ``"nonfinite"`` or ``"unconverged"``."""
        if health.nonfinite_count(emb.embedding) + health.nonfinite_count(emb.eigenvalues):
            return "nonfinite"
        if not bool(emb.converged):
            return "unconverged"
        return None

    def _escalate_embed(self, ecfg: EigConfig, n: int) -> Tuple[EigConfig, str]:
        """Next rung of the Stage-2 ladder: widen the Krylov basis and double
        the restart budget (:func:`repro_torch.core.lanczos.escalate_basis`)."""
        lcfg = self._lanczos_config(n, ecfg)
        wid = lz.escalate_basis(lcfg, n, widen=self.health.basis_widen)
        new = dataclasses.replace(ecfg, basis_m=wid.m, max_restarts=wid.max_restarts)
        return new, f"lanczos_widen[m={wid.m},restarts={wid.max_restarts}]"

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
        if hc.enabled:
            failure = self._embed_failure(emb)
            while failure and attempts < hc.max_attempts:
                ecfg, rung = self._escalate_embed(ecfg, st.graph.adj.shape[0])
                rungs.append(rung)
                emb = self.embed(st.graph, fold_in(st.gen_embed, attempts), operator=op,
                                 eig=ecfg, device=st.device)
                attempts += 1
                failure = self._embed_failure(emb)
            if failure == "nonfinite":
                raise PipelineError(
                    "embed", f"spectral embedding is nonfinite after {attempts} attempt(s)",
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
        rep = StageReport(
            "embed", escalations=tuple(rungs), attempts=attempts,
            converged=bool(emb.converged),
            residual_max=float(emb.residuals.float().max()),
            wall_s=_wall(t0, st.device))
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
        if hc.enabled:
            if health.nonfinite_count(st.embedding.embedding):
                raise PipelineError(
                    "cluster", "input embedding contains non-finite values",
                    remedy="run the embed stage with health enabled (its "
                           "ladder catches this) or sanitize the cached "
                           "embedding before re-clustering")
            empty = kcfg.k - int(torch.unique(res.labels).numel())
            bad = bool(health.nonfinite_count(res.kmeans_inertia))
            if (empty > 0 or bad) and attempts < hc.max_attempts and kcfg.empty == "keep":
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
        counts = torch.bincount(res.labels.long(), minlength=kcfg.k)
        rep = StageReport(
            "cluster", escalations=tuple(rungs), attempts=attempts,
            converged=int((counts > 0).sum()) == kcfg.k,
            residual_max=float(res.kmeans_inertia),
            wall_s=_wall(t0, st.device))
        reports = st.reports + (rep,)
        return dataclasses.replace(st, result=res._replace(reports=reports),
                                   reports=reports,
                                   provenance=st.provenance + ("cluster",))

    def run_stages(self, state: PipelineState) -> PipelineState:
        """Execute the configured stage DAG over a :class:`PipelineState`;
        stages already in ``state.provenance`` are skipped."""
        if state.device is None:
            state = dataclasses.replace(state, device=resolve_device(None))
        for name in self.stages:
            if _stage_done(name, state.provenance):
                continue
            state = getattr(self, f"_stage_{name}")(state)
        return state

    # -- end to end ---------------------------------------------------------

    def run(self, data, generator: Optional[torch.Generator] = None, *,
            points=None, operator: Optional[LinearOperator] = None,
            device: DeviceLike = None) -> SpectralResult:
        """Points/graph in, labels out — the whole stage DAG under one call.
        ``data`` is raw points ([n, d] tensor or array → Stage 1 runs) or a
        COO similarity graph; ``generator`` is a CPU ``torch.Generator``."""
        return self.run_state(data, generator, points=points, operator=operator,
                              device=device).result

    def run_state(self, data, generator: Optional[torch.Generator] = None, *,
                  points=None, operator: Optional[LinearOperator] = None,
                  device: DeviceLike = None) -> PipelineState:
        """:meth:`run`, returning the final :class:`PipelineState`."""
        dev = resolve_device(device)
        if data is None:
            raise ValueError("run needs data (points or a COO graph)")
        if isinstance(data, COO):
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
        return self.run_stages(state)

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
