"""The port's dry-run cells (``repro_torch.configs.cells``), its roofline
formulas (``launch.roofline``) and its dry-run (``launch.dryrun``), against
the reference's where the reference still runs on this jax.

Cells: ``build_cell`` over every (arch, shape) gives the reference's names
and skip reasons (at least 39 built, the 5 long_500k skips), and every
argument leaf's shape and dtype equals the reference's
``ShapeDtypeStruct`` (its ``jax.eval_shape``) — and every spec leaf the
reference's ``PartitionSpec`` entries, under the production rules.  The
model-flops formulas equal the reference's exactly, cell by cell.

The dry-run runs in a subprocess (the fake process group is
process-global): one cell of each model family on a (2, 2) and on the
(16, 16) fake mesh — every term finite, the rank's argument bytes the sum
of its local shards' bytes, a collective counted where a redistribution
must happen.  The paper's own cell ``spectral/fb`` on the (16, 16) mesh:
its pipeline runs on ``meta`` tensors (no host read: ``health.is_concrete``
is false there), each rank on its own edge bucket; its outputs' shapes and
dtypes are the reference's ``jax.eval_shape``, and its component cells'
flops a call are the analytic formulas of the port's ops (the reference's
XLA counts printed beside them).  ``main`` with a cell made to raise
records the cell with its error and exits 1.  equiformer-v2's equivariant
norm on an uneven 16-way node shard, rank by rank, is the plain-tensor
result.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import types

import jax
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import cells as j_cells
from repro.launch import mesh as j_mesh
from repro.launch import roofline as j_rl
from repro.launch.sharding import DEFAULT_RULES
from repro_torch._device import cpu_generator
from repro_torch.configs import ARCHS
from repro_torch.configs import cells as t_cells
from repro_torch.core.health import is_concrete
from repro_torch.core.pipeline import SpectralClusteringConfig
from repro_torch.core.spectral import Plan
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import roofline as t_rl
from repro_torch.sparse.distributed import ShardedCOO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in ARCHS for s in ARCHS[a].shapes]
NAMES = ("data", "model")


def _stub(names):
    return types.SimpleNamespace(axis_names=names, mesh_dim_names=names,
                                 shape={n: 16 for n in names},
                                 mesh=types.SimpleNamespace(shape=(16,) * len(names)))


def _walk(tree, path=""):
    """(path, leaf) pairs of a cell tree of either package: dicts, lists,
    tuples and dataclasses opened; arrays, specs and statics as leaves."""
    from repro_torch.launch.sharding import PartitionSpec

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, (PartitionSpec, jax.sharding.PartitionSpec)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _walk(getattr(tree, f.name), f"{path}/{f.name}")
    else:
        yield path, tree


def _leaf_key(x):
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    if isinstance(x, (tuple, list)) or x is None:
        return None if x is None else tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                                            for e in x)
    return x


def _j_model_flops(arch, shape):
    """The reference dry-run's ``model_flops_for`` (its module is not
    imported: it sets XLA_FLAGS for 512 devices when imported)."""
    sspec = arch.shapes[shape]
    if arch.family == "lm":
        return j_rl.lm_model_flops(arch.config, shape, sspec.dims)
    if arch.family == "spectral":
        return j_rl.spectral_model_flops(sspec.dims, arch.config.fixed_restarts,
                                         arch.config.fixed_kmeans_iters)
    if arch.family == "recsys":
        return j_rl.recsys_model_flops(arch.config, shape, sspec.dims)
    cfg = j_cells.gnn_shape_config(arch, sspec)
    batch, _ = j_cells.gnn_batch_shapes(arch, sspec, {})
    return j_rl.gnn_model_flops(arch.name, cfg, sspec.dims, batch.node_feat.shape[0],
                                batch.edge_src.shape[0])


def test_every_cell_builds_with_the_reference_names_and_skips():
    rules = t_mesh.rules_for_mesh(_stub(NAMES))
    j_rules = j_mesh.rules_for_mesh(_stub(NAMES))
    built = skipped = 0
    for a, s in CELLS:
        got = t_cells.build_cell(ARCHS[a], s, rules)
        want = j_cells.build_cell(J_ARCHS[a], s, j_rules)
        assert (got.name, got.skip) == (want.name, want.skip)
        if got.skip:
            skipped += 1
        else:
            assert got.fn is not None and len(got.args) == len(got.in_specs)
            assert got.donate == want.donate and got.meta == want.meta
            built += 1
    assert built >= 39 and skipped == 5


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cell_arguments_and_specs_equal_the_reference(arch):
    rules = t_mesh.rules_for_mesh(_stub(NAMES))
    j_rules = j_mesh.rules_for_mesh(_stub(NAMES))
    for s in ARCHS[arch].shapes:
        got = t_cells.build_cell(ARCHS[arch], s, rules)
        want = j_cells.build_cell(J_ARCHS[arch], s, j_rules)
        if got.skip:
            continue
        g_args, w_args = list(_walk(got.args)), list(_walk(want.args))
        assert [p for p, _ in g_args] == [p for p, _ in w_args], got.name
        for (p, g), (_, w) in zip(g_args, w_args):
            assert _leaf_key(g) == _leaf_key(w), (got.name, p)
        g_specs, w_specs = list(_walk(got.in_specs)), list(_walk(want.in_specs))
        assert [(p, _leaf_key(x)) for p, x in g_specs] == \
            [(p, _leaf_key(x)) for p, x in w_specs], got.name


def test_cost_variant_cells_equal_the_reference():
    rules = t_mesh.rules_for_mesh(_stub(NAMES))
    j_rules = j_mesh.rules_for_mesh(_stub(NAMES))
    got = [(L, c.name) for L, c in t_cells.lm_cost_cells(ARCHS["qwen3-0.6b"], "train_4k", rules)]
    want = [(L, c.name) for L, c in j_cells.lm_cost_cells(J_ARCHS["qwen3-0.6b"], "train_4k",
                                                          j_rules)]
    assert got == want
    for a in ("equiformer-v2", "nequip", "pna", "gcn-cora"):
        for s in ARCHS[a].shapes:
            g = t_cells.gnn_cost_cell(ARCHS[a], s, rules)
            w = j_cells.gnn_cost_cell(J_ARCHS[a], s, j_rules)
            assert (g is None) == (w is None) and (g is None or g.name == w.name)
    got = t_cells.spectral_component_cells(ARCHS["spectral"], "dti", rules)
    want = j_cells.spectral_component_cells(J_ARCHS["spectral"], "dti", j_rules)
    assert [(lbl, c.name, n) for lbl, c, n in got] == [(lbl, c.name, n) for lbl, c, n in want]


def test_model_flops_equal_the_reference_cell_by_cell():
    for a, s in CELLS:
        assert t_dryrun.model_flops_for(ARCHS[a], s) == _j_model_flops(J_ARCHS[a], s), (a, s)


def test_roofline_terms_use_the_h100_datasheet_and_gate_nan():
    rep = t_rl.analyze_raw("c", "single", 256, flops_dev=989e12, bytes_dev=3.35e12,
                           coll_by_kind={"all_reduce": 900e9}, model_flops_total=1.0,
                           mem_gb=1.0, compile_s=0.0)
    assert (rep.compute_s, rep.memory_s, rep.collective_s) == (1.0, 1.0, 2.0)
    assert rep.bottleneck == "collective"
    with pytest.raises(ValueError, match="non-finite"):
        t_rl.analyze_raw("c", "single", 256, flops_dev=float("nan"), bytes_dev=1.0,
                         coll_by_kind={}, model_flops_total=1.0, mem_gb=1.0, compile_s=0.0)


# ---------------------------------------------------------------------------
# the dry-run, in a subprocess
# ---------------------------------------------------------------------------

DRY_CELLS = ["qwen3-0.6b/decode_32k", "gcn-cora/full_graph_sm", "autoint/serve_p99"]


@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    script = f"""
        import json, math, sys
        import torch
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
        from repro_torch import _tree
        from repro_torch.configs import ARCHS
        from repro_torch.configs.cells import build_cell
        from repro_torch.launch import dryrun, sharding as shd
        from repro_torch.launch.mesh import make_mesh, rules_for_mesh

        def expected_arg_bytes(cell, mesh):
            total = 0
            def one(spec, x):
                nonlocal total
                if isinstance(x, torch.Tensor):
                    pl = shd.placements(spec or shd.P(), mesh, x.ndim)
                    shape, _ = compute_local_shape_and_global_offset(x.shape, mesh, pl)
                    total += math.prod(shape) * x.element_size()
            for a, s in zip(cell.args, cell.in_specs):
                shd.spec_map(one, s, a)
            return total

        def spectral_fb(mesh, rules):
            # spectral/fb's report, its outputs' shapes and dtypes, the
            # collectives of one Lanczos step, and is_concrete on a DTensor
            from torch.distributed.tensor import DTensor, Replicate, Shard
            from torch.distributed.tensor.experimental import implicit_replication
            from repro_torch.configs.cells import spectral_component_cells
            from repro_torch.core.health import is_concrete

            res = {{"fb": dryrun.run_cell("spectral", "fb", "single", mesh=mesh),
                    "dti": dryrun.run_cell("spectral", "dti", "single", mesh=mesh,
                                           skip_cost_pass=True)}}
            cell = build_cell(ARCHS["spectral"], "fb", rules, mesh=mesh)
            step = spectral_component_cells(ARCHS["spectral"], "fb", rules, mesh=mesh)[0][1]
            with shd.axis_rules(rules, mesh), implicit_replication():
                got = cell.fn(*dryrun._distribute(cell.args, cell.in_specs, mesh))
                res["fb_outputs"] = [[list(t.shape), str(t.dtype).replace("torch.", ""),
                                      t.device.type] for t in got]
                counter = dryrun.RankCounter()
                with counter:
                    step.fn(*dryrun._distribute(step.args, step.in_specs, mesh))
                res["fb_step_coll"] = counter.coll
            pl = [Shard(0), Replicate()]
            res["is_concrete"] = [
                is_concrete(DTensor.from_local(torch.empty(4, device="meta"), mesh, pl,
                                               run_check=False)),
                is_concrete(DTensor.from_local(torch.zeros(4), mesh, pl, run_check=False))]
            return res

        def equiv_norm_on_uneven_shards():
            # _equiv_norm's output rows on each rank of a 16-way node shard
            # of 37 nodes (the fake group joined as each rank in turn) against
            # the plain-tensor result; constrain is kept out, so the output
            # stays node-sharded (it would gather the indivisible dim)
            import torch.distributed as dist
            from torch.distributed.tensor import DTensor, Replicate, Shard
            from torch.distributed.tensor.experimental import implicit_replication
            from torch.testing._internal.distributed.fake_pg import FakeStore
            from repro_torch.models.gnn import e3
            from repro_torch.models.gnn import equiformer_v2 as eqv2

            g = torch.Generator().manual_seed(0)
            n, l_max, c = 37, 3, 8
            h = torch.randn(n, (l_max + 1) ** 2, c, generator=g)
            scale = torch.randn((l_max + 1) ** 2, c, generator=g)
            sl = e3.irrep_slices(l_max)
            want = eqv2._equiv_norm(h, scale, sl)
            chunks, rows, constrain = torch.chunk(h, 16), [], eqv2.constrain
            eqv2.constrain = lambda x, *axes: x
            try:
                for r in range(16):
                    dist.destroy_process_group()
                    dist.init_process_group("fake", store=FakeStore(), rank=r, world_size=16)
                    m16 = make_mesh((16, 1), ("data", "model"), "cpu")
                    local = chunks[r] if r < len(chunks) else h[:0]
                    with shd.axis_rules(rules_for_mesh(m16), m16), implicit_replication():
                        hd = DTensor.from_local(local, m16, [Shard(0), Replicate()],
                                                run_check=False, shape=h.shape, stride=h.stride())
                        rows.append(eqv2._equiv_norm(hd, scale, sl).to_local())
            finally:
                eqv2.constrain = constrain
            got = torch.cat(rows)
            return {{"local_rows": [t.shape[0] for t in rows],
                     "bitwise": bool(torch.equal(got, want)),
                     "max_abs": float((got - want).abs().max())}}

        out = {{}}
        for world, shape in ((4, (2, 2)), (256, (16, 16))):
            dryrun.join_fake_group(world)
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            rules = rules_for_mesh(mesh)
            for name in {DRY_CELLS!r}:
                a, s = name.split("/")
                res = dryrun.run_cell(a, s, "single", mesh=mesh, skip_cost_pass=(world == 256))
                cell = build_cell(ARCHS[a], s, rules, mesh=mesh)
                res["expected_arg_bytes"] = expected_arg_bytes(cell, mesh)
                out[f"{{world}}:{{name}}"] = res
        out.update(spectral_fb(mesh, rules_for_mesh(mesh)))
        out["equiv_norm"] = equiv_norm_on_uneven_shards()

        # a cell that raises: recorded with its error, and the run exits 1
        from repro_torch.configs import cells
        def raising(*a, **kw):
            raise RuntimeError("injected cell failure")
        cells.spectral_cell = raising
        rc = dryrun.main(["--cell", "spectral/fb", "--out", {str(tmp / "out")!r}])
        with open({str(tmp / "out" / "single" / "spectral__fb.json")!r}) as f:
            out["failing"] = {{"rc": rc, **json.load(f)}}
        print("RESULT " + json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.split("RESULT ", 1)[1])


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield float(tree)


@pytest.mark.parametrize("world", [4, 256])
@pytest.mark.parametrize("name", DRY_CELLS)
def test_dryrun_cell_terms(dry_runs, world, name):
    res = dry_runs[f"{world}:{name}"]
    assert "error" not in res and res["chips"] == world
    assert all(math.isfinite(x) for x in _numbers(res))
    mem = res["memory_analysis"]
    assert mem["argument_size_gb"] * 2 ** 30 == pytest.approx(res["expected_arg_bytes"], rel=1e-12)
    assert res["flops_dev"] > 0 and res["bytes_dev"] > 0 and mem["total_hbm_gb"] > 0
    assert res["model_flops_total"] == t_dryrun.model_flops_for(*[ARCHS[name.split("/")[0]],
                                                                   name.split("/")[1]])
    if name.startswith("qwen3"):
        # the vocab-sharded embedding's partial sums must be reduced, and the
        # L = 2/4 cost fit ran at world 4
        assert res["coll_by_kind"]["all_reduce"] > 0
        assert world == 256 or set(res["cost_fit"]) == {"2", "4"}


def test_dryrun_records_a_failing_cell_and_exits_1(dry_runs):
    res = dry_runs["failing"]
    assert res["rc"] == 1 and res["cell"] == "spectral/fb"
    assert res["error"] == "RuntimeError: injected cell failure"


def test_spectral_cell_runs_on_meta_with_the_reference_output_shapes(dry_runs):
    """spectral/fb on the (16, 16) fake mesh: every term finite, a rank's
    arguments its own bucket (3 arrays of edges_per_shard 4-byte entries)
    and the key, and the outputs the reference's ``jax.eval_shape`` of its
    cell at ``mesh=None`` — shapes and dtypes."""
    res = dry_runs["fb"]
    assert "error" not in res and res["chips"] == 256
    assert all(math.isfinite(x) for x in _numbers(res))
    sm = t_cells.build_cell(ARCHS["spectral"], "fb", {}).args[0]
    key_bytes = 2 * 4  # the uint32 pair standing for the PRNG key
    assert res["memory_analysis"]["argument_size_gb"] * 2 ** 30 == \
        3 * sm.edges_per_shard * 4 + key_bytes
    j = j_cells.spectral_cell(J_ARCHS["spectral"], J_ARCHS["spectral"].shapes["fb"],
                              DEFAULT_RULES, mesh=None)
    want = jax.eval_shape(j.fn, *j.args)
    assert dry_runs["fb_outputs"] == [[list(w.shape), str(w.dtype), "meta"] for w in want]


def test_is_concrete_is_false_on_meta_only(dry_runs):
    assert not is_concrete(torch.empty(3, device="meta"))
    assert not is_concrete(torch.zeros(2), torch.empty(3, device="meta"))
    assert is_concrete(torch.zeros(3), 1.0, True)
    assert dry_runs["is_concrete"] == [False, True]  # a DTensor over meta, over the CPU


def _j_component_flops():
    """The reference's XLA flop counts of its fb component cells at
    ``mesh=None`` (whole arrays on one device), a call each."""
    out = {}
    for label, cell, _ in j_cells.spectral_component_cells(J_ARCHS["spectral"], "fb",
                                                           DEFAULT_RULES, mesh=None):
        cost = jax.jit(cell.fn).lower(*cell.args).cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        out[label] = cost.get("flops")
    return out


def test_spectral_component_flops_are_the_analytic_formulas(dry_runs):
    """Each fb component cell's flops a call on one rank of (16, 16), as the
    port's plan computes: its own bucket of E edges and its own rps = n/16
    rows of V, v and h (the reference's specs), derived from the shapes.
    The products are exact — SpMV 2·E, GEMV 2·rows·cols, GEMM 2·m·n·k, B2
    2·n·k·d plus its n·(d+1) epilogue adds —, and what the counter adds for
    the elementwise ops beside them (XLA's convention: one flop a result
    element, a reduction one an input element) stays within a few passes
    over the step's vectors.  The reference's XLA counts on one device are
    printed beside; PERF.md §6 breaks the gap down."""
    d = ARCHS["spectral"].shapes["fb"].dims
    k, m = d["k"], 2 * d["k"]
    sm = t_cells.build_cell(ARCHS["spectral"], "fb", {}).args[0]
    n, E = sm.shape[0], sm.edges_per_shard
    rps = n // 16
    l_keep = min(m - 1, k + max(1, (m - k) // 2))
    products = {
        # SpMV over the own bucket, 4 GEMVs against the rank's V [m+1, rps]
        "lanczos_step": 2 * E + 4 * 2 * (m + 1) * rps,
        # the Ritz rotation, a [l_keep, m] × [m, rps] GEMM (eigh's 10·m³ is
        # added analytically per run)
        "restart": 2 * l_keep * m * rps,
        # B2 (d = k) on the rank's rows
        "kmeans_iter": 2 * rps * k * k + rps * (k + 1),
        # h·c, one GEMV against the rank's h [rps, k] (the drawn row is
        # fetched by an index, not a product)
        "kmeanspp_step": 2 * rps * k,
    }
    elementwise = {
        "lanczos_step": 4 * rps,  # the two subtractions over the rank's rows
        "restart": m * m,  # none beside the GEMM
        # the inertia's sum over the rank's rows, the centroid update
        "kmeans_iter": 2 * rps + 4 * k * (k + 1),
        # ‖h‖², a dozen vector ops over the rank's rows, the fetch of [k]
        "kmeanspp_step": 2 * rps * k + 12 * rps + 4 * k,
    }
    comps = dry_runs["fb"]["spectral_components"]
    ref = _j_component_flops()
    for label, flops in products.items():
        got = comps[label]["per_call"]["flops"]
        print(f"{label}: port {got:,.0f} a rank (products {flops:,}, elementwise "
              f"{got - flops:,.0f} of at most {elementwise[label]:,}); reference XLA "
              f"{ref[label]:,.0f} on one device")
        assert flops <= got <= flops + elementwise[label], label


def test_lanczos_step_gathers_one_product(dry_runs):
    """The reference's schedule of a Lanczos step on the mesh: one
    all-gather of the operator's input, n_pad fp32 entries, and two
    all-reduces of the (m+1)-entry coefficients ``V @ w``."""
    n = t_cells.build_cell(ARCHS["spectral"], "fb", {}).args[0].shape[0]
    m = 2 * ARCHS["spectral"].shapes["fb"].dims["k"]
    assert dry_runs["fb_step_coll"] == [["all_gather", n * 4], ["all_reduce", (m + 1) * 4],
                                        ["all_reduce", (m + 1) * 4]]
    assert dry_runs["fb"]["spectral_components"]["lanczos_step"]["per_call"]["coll"] == {
        "all_gather": n * 4, "all_reduce": 2 * (m + 1) * 4, "reduce_scatter": 0,
        "all_to_all": 0}


@pytest.mark.parametrize("cell", ["fb", "dti"])
def test_spectral_cell_plans_each_rank_its_own_rows(dry_runs, cell):
    """At (16, 16) a rank of ``spectral/fb`` or ``spectral/dti`` holds its
    own rows of the Krylov basis and the embedding, not the whole of them:
    at most 0.4 GB (GiB, as the report's) at peak — DTI's whole basis alone
    is 0.53 GiB."""
    res = dry_runs[cell]
    assert "error" not in res
    assert res["memory_analysis"]["total_hbm_gb"] <= 0.4, res["memory_analysis"]


def test_equiv_norm_on_an_uneven_node_shard_is_the_plain_result(dry_runs):
    res = dry_runs["equiv_norm"]
    assert res["local_rows"] == [3] * 12 + [1, 0, 0, 0]  # 37 nodes over 16 ranks
    assert res["bitwise"], res["max_abs"]


def test_the_pipeline_runs_on_meta_and_reports_traced_diagnostics():
    """The sharded layout path on ``meta`` tensors, one process: nothing is
    read back (a host read raises on ``meta``), so the stage reports carry
    the reference's traced diagnostics — tensors, and ``wall_s`` −1.0 — and
    the outputs their eager shapes and dtypes.  Without fixed counts the
    Lanczos loop cannot run on ``meta``, and says so."""
    S, E, rps, k = 4, 50, 16, 4
    sm = ShardedCOO(row_local=torch.empty(S * E, dtype=torch.int32, device="meta"),
                    col=torch.empty(S * E, dtype=torch.int32, device="meta"),
                    val=torch.empty(S * E, device="meta"), shape=(S * rps, S * rps),
                    rows_per_shard=rps, num_shards=S, edges_per_shard=E)
    cfg = SpectralClusteringConfig(n_clusters=k, lanczos_m=2 * k, fixed_restarts=1,
                                   fixed_kmeans_iters=2)
    st = cfg.to_pipeline(plan=Plan(device="sharded")).run_state(sm, cpu_generator(0),
                                                                device="meta")
    res = st.result
    assert [(t.shape, t.dtype, t.device.type) for t in
            (res.labels, res.eigenvalues, res.kmeans_inertia)] == \
        [((S * rps,), torch.int32, "meta"), ((k,), torch.float32, "meta"),
         ((), torch.float32, "meta")]
    assert [r.stage for r in st.reports] == ["prepare", "embed", "cluster"]
    assert all(r.wall_s == -1.0 for r in st.reports)
    for r in st.reports[1:]:
        assert r.converged.device.type == "meta" and r.residual_max.device.type == "meta"
    assert res.lanczos_restarts == 2 and res.kmeans_iterations == 2
    free = dataclasses.replace(cfg, fixed_restarts=None)
    with pytest.raises(ValueError, match="fixed_restarts"):
        free.to_pipeline(plan=Plan(device="sharded")).run(sm, cpu_generator(0), device="meta")
