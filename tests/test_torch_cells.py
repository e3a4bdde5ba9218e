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
must happen — and ``main`` on a spectral cell, which cannot run on
``meta`` tensors (its pipeline reads values on the host): recorded with
its error, exit code 1.
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

from repro.configs import ARCHS as J_ARCHS
from repro.configs import cells as j_cells
from repro.launch import mesh as j_mesh
from repro.launch import roofline as j_rl
from repro_torch.configs import ARCHS
from repro_torch.configs import cells as t_cells
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import roofline as t_rl

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
        rc = dryrun.main(["--cell", "spectral/fb", "--out", {str(tmp / "out")!r}])
        with open({str(tmp / "out" / "single" / "spectral__fb.json")!r}) as f:
            out["spectral"] = {{"rc": rc, **json.load(f)}}
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
    res = dry_runs["spectral"]
    assert res["rc"] == 1 and res["cell"] == "spectral/fb"
    assert "meta" in res["error"]
