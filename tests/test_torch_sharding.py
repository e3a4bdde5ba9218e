"""The port's sharding layer (``repro_torch.launch.sharding``/``mesh``,
``ckpt.elastic``, ``optim.compress.compressed_psum_mean``, the
expert-parallel ``moe_ffn_shard_map``, ``core.kmeans.row_at``) against the
reference's.

Specs are compared as plain tuples: every ``logical_specs`` tree of every
arch, ``to_partition_specs`` under ``rules_for_mesh`` of a (16, 16) and a
(2, 16, 16) mesh (the reference's only reads ``axis_names``, so a stub mesh
serves both), and ``zero1_opt_specs`` on every LM arch's full-size
parameter shapes (the reference's from ``jax.eval_shape``, the port's from
``init_params`` on ``meta``).  The collectives run on 4 gloo ranks
(``repro_torch.testing.dist``) against the reference on 4 fake host devices
in a subprocess: ``moe_ffn_shard_map`` on a (2, 2) mesh — y and every
gradient of Σy² + aux within 1e-5 of their max, the aux losses within
1e-6 relative — and ``compressed_psum_mean`` over 4 ranks, mean and
residual within 1 ulp.
"""
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import cells as j_cells
from repro.launch import mesh as j_mesh
from repro.launch import sharding as j_shd
from repro_torch.configs import ARCHS
from repro_torch.configs import cells as t_cells
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import sharding as t_shd
from repro_torch.testing import dist as td

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_ARCHS = [a for a in ARCHS if ARCHS[a].family != "spectral"]


def _j_module(arch):
    fam = J_ARCHS[arch].family
    if fam == "lm":
        from repro.models import transformer as mod
    elif fam == "recsys":
        from repro.models import recsys as mod
    else:
        mod = j_cells._gnn_model(J_ARCHS[arch])
    return mod


def _t_module(arch):
    fam = ARCHS[arch].family
    if fam == "lm":
        from repro_torch.models import transformer as mod
    elif fam == "recsys":
        from repro_torch.models import recsys as mod
    else:
        mod = t_cells._gnn_model(ARCHS[arch])
    return mod


def _plain(tree):
    """A spec tree of either package as nested dicts/lists of tuples (a
    spec's tuple entries kept)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if tree is None:
        return None
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in tree)


def _j_specs(arch, cfg_attr="config"):
    return _j_module(arch).logical_specs(getattr(J_ARCHS[arch], cfg_attr))


def _t_specs(arch, cfg_attr="config"):
    return _t_module(arch).logical_specs(getattr(ARCHS[arch], cfg_attr))


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_logical_specs_equal_the_reference(arch):
    for attr in ("config", "smoke_config"):
        assert _plain(_t_specs(arch, attr)) == _plain(_j_specs(arch, attr))


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_logical_specs_tag_every_parameter_leaf(arch):
    """Leaf for leaf the port's own parameter tree (SMOKE config, drawn on
    ``meta``), each spec as long as its leaf's rank — the stacked-layer axis
    included."""
    from repro_torch import _tree
    from repro_torch._device import cpu_generator

    cfg = ARCHS[arch].smoke_config
    if ARCHS[arch].family == "gnn":
        cfg = t_cells.gnn_shape_config(ARCHS[arch], ARCHS[arch].shapes["full_graph_sm"])
    mod = _t_module(arch)
    params = mod.init_params(cfg, cpu_generator(0), device="meta")
    specs = mod.logical_specs(cfg)
    pairs = []
    t_shd.spec_map(lambda s, p: pairs.append((s, p)), specs, params)
    assert len(pairs) == len(_tree.leaves(params))
    assert all(len(s) == p.ndim for s, p in pairs)


def _stub(names, sizes=None):
    sizes = sizes or (16,) * len(names)
    return types.SimpleNamespace(axis_names=names, mesh_dim_names=names,
                                 size=lambda i: sizes[i])


@pytest.mark.parametrize("names", [("data", "model"), ("pod", "data", "model")])
def test_partition_specs_under_the_mesh_rules_equal_the_reference(names):
    j_rules = j_mesh.rules_for_mesh(_stub(names))
    t_rules = t_mesh.rules_for_mesh(_stub(names))
    assert t_rules == j_rules
    for arch in MODEL_ARCHS:
        want = j_shd.to_partition_specs(_j_specs(arch), j_rules)
        got = t_shd.to_partition_specs(_t_specs(arch), t_rules)
        assert _plain(got) == _plain(jax.tree.map(
            tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    from repro.models import transformer as j_tfm
    from repro_torch.models import transformer as t_tfm

    assert _plain(t_shd.to_partition_specs(t_tfm.cache_logical_specs(), t_rules)) == _plain(
        jax.tree.map(tuple, j_shd.to_partition_specs(j_tfm.cache_logical_specs(), j_rules),
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


@pytest.mark.parametrize("arch", [a for a in ARCHS if ARCHS[a].family == "lm"])
def test_zero1_opt_specs_equal_the_reference(arch):
    from repro.models import transformer as j_tfm
    from repro_torch._device import cpu_generator
    from repro_torch.models import transformer as t_tfm

    names = ("pod", "data", "model")
    j_rules, t_rules = j_mesh.rules_for_mesh(_stub(names)), t_mesh.rules_for_mesh(_stub(names))
    jcfg, tcfg = J_ARCHS[arch].config, ARCHS[arch].config
    j_shapes = jax.eval_shape(lambda: j_tfm.init_params(jcfg, jax.random.PRNGKey(0)))
    want = j_cells.zero1_opt_specs(j_shd.to_partition_specs(j_tfm.logical_specs(jcfg), j_rules),
                                   j_shapes, j_rules)
    t_shapes = t_tfm.init_params(tcfg, cpu_generator(0), device="meta")
    got = t_cells.zero1_opt_specs(t_shd.to_partition_specs(t_tfm.logical_specs(tcfg), t_rules),
                                  t_shapes, t_rules)
    assert _plain(got) == _plain(jax.tree.map(
        tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


def test_resolve_trims_and_placements_translate():
    from torch.distributed.tensor import Replicate, Shard

    rules = t_mesh.rules_for_mesh(_stub(("pod", "data", "model")))
    assert tuple(t_shd.resolve(("batch", None, None), rules)) == (("pod", "data"),)
    assert tuple(t_shd.resolve((None, "heads"), rules)) == (None, "model")
    mesh = _stub(("pod", "data", "model"))
    assert t_shd.placements(t_shd.P(("pod", "data"), "model"), mesh, 3) == [
        Shard(0), Shard(0), Shard(1)]
    assert t_shd.placements(t_shd.P(), mesh, 2) == [Replicate()] * 3
    # a mesh dim of one rank holds the whole dim: replicated
    one = _stub(("pod", "data", "model"), (2, 1, 1))
    assert t_shd.placements(t_shd.P(("pod", "data"), "model"), one, 3) == [
        Shard(0), Replicate(), Replicate()]
    with pytest.raises(ValueError, match="mesh's dim order"):
        t_shd.placements(t_shd.P(("data", "pod")), mesh, 1)
    with pytest.raises(ValueError, match="twice"):
        t_shd.placements(t_shd.P("data", "data"), mesh, 2)
    # no rules installed, or not a DTensor: the identity
    x = torch.ones(3)
    assert t_shd.constrain(x, "batch") is x
    with t_shd.axis_rules(rules):
        assert t_shd.constrain(x, "batch") is x


def test_row_at_is_bitwise_the_reference():
    from repro.core.kmeans import row_at as j_row_at
    from repro_torch.core.kmeans import row_at

    h = np.random.default_rng(0).normal(size=(37, 5)).astype(np.float32)
    for idx in (0, 17, 36):
        np.testing.assert_array_equal(row_at(torch.as_tensor(h), torch.tensor(idx)).numpy(),
                                      np.asarray(j_row_at(jax.numpy.asarray(h), idx)))


# ---------------------------------------------------------------------------
# collectives: 4 gloo ranks against 4 fake host devices
# ---------------------------------------------------------------------------

def _reference(out: str) -> dict:
    script = f"""
        import dataclasses
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.compat import SHARD_MAP_NO_CHECK, shard_map
        from repro.configs import ARCHS
        from repro.launch import sharding as shd
        from repro.launch.mesh import rules_for_mesh
        from repro.models import moe
        from repro.optim.compress import compressed_psum_mean
        cfg = ARCHS["granite-moe-3b-a800m"].smoke_config
        mc = cfg.moe
        p = moe.init_moe_params(jax.random.PRNGKey(0), cfg.d_model, mc, 1, jnp.float32)
        p = {{k: v[0] for k, v in p.items()}}
        x = jax.random.normal(jax.random.PRNGKey(1), (128, cfg.d_model), jnp.float32)
        mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
        def loss(p, x):
            y, a = moe.moe_ffn_shard_map(p, x, mc, mesh)
            return (y * y).sum() + a["load_balance"] + a["router_z"], (y, a)
        with shd.axis_rules(rules_for_mesh(mesh), mesh):
            (l, (y, a)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                               has_aux=True))(p, x)
        rng = np.random.default_rng(2)
        grad = rng.normal(size=(4, 300)).astype(np.float32)
        grad[1] *= 10.0
        res = (rng.normal(size=(4, 300)) * 0.01).astype(np.float32)
        mesh1 = Mesh(np.array(jax.devices()), ("pod",))
        f = shard_map(lambda g, r: compressed_psum_mean(g[0], r[0], "pod"), mesh=mesh1,
                      in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
                      **SHARD_MAP_NO_CHECK)
        mean, nres = jax.jit(lambda g, r: f(g, r))(grad, res)
        np.savez({out!r}, x=np.asarray(x), y=np.asarray(y), lb=np.asarray(a["load_balance"]),
                 rz=np.asarray(a["router_z"]), gx=np.asarray(gx),
                 **{{"p_" + k: np.asarray(v) for k, v in p.items()}},
                 **{{"g_" + k: np.asarray(v) for k, v in gp.items()}},
                 grad=grad, res=res, mean=np.asarray(mean).reshape(4, -1),
                 nres=np.asarray(nres).reshape(4, -1))
    """
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    ref = _reference(str(tmp / "ref.npz"))
    mc = ARCHS["granite-moe-3b-a800m"].smoke_config.moe
    mesh = ((2, 2), ("data", "model"))
    tree = {"w": np.arange(64 * 6, dtype=np.float32).reshape(64, 6),
            "t": np.random.default_rng(3).normal(size=(4, 32, 8)).astype(np.float32),
            "b": np.ones(5, np.float32)}
    logical = {"w": ("batch", None), "t": (None, "table_rows", None), "b": (None,)}
    tasks = [
        ("moe_rank", {"mesh": mesh, "x": ref["x"],
                      "p": {k[2:]: ref[k] for k in ref if k.startswith("p_")},
                      "cfg": {f: getattr(mc, f) for f in mc.__dataclass_fields__}}),
        ("compress_rank", {"grad": ref["grad"], "residual": ref["res"]}),
        ("reshard_rank", {"mesh": mesh, "tree": tree, "logical": logical}),
    ]
    outs = td.run_ranks(td.tasks_rank, 4, tasks, tmpdir=str(tmp / "ranks"), join_timeout=300)
    return ref, outs, tree


def test_moe_ffn_shard_map_matches_the_reference_on_4_ranks(collective_runs):
    ref, outs, _ = collective_runs
    for moe_out, _, _ in outs:
        y = moe_out["y"]
        assert np.abs(y - ref["y"]).max() <= 1e-5 * np.abs(ref["y"]).max()
        np.testing.assert_allclose(moe_out["load_balance"], float(ref["lb"]), rtol=1e-6)
        np.testing.assert_allclose(moe_out["router_z"], float(ref["rz"]), rtol=1e-6)
        for k, g in moe_out["grads"].items():
            want = ref["g_" + k]
            assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max(), k
        assert np.abs(moe_out["x_grad"] - ref["gx"]).max() <= 1e-5 * np.abs(ref["gx"]).max()


def test_compressed_psum_mean_matches_the_reference_on_4_ranks(collective_runs):
    ref, outs, _ = collective_runs
    for r, (_, comp, _) in enumerate(outs):
        np.testing.assert_array_max_ulp(comp["mean"], ref["mean"][r], maxulp=1)
        np.testing.assert_array_max_ulp(comp["residual"], ref["nres"][r], maxulp=1)


def test_reshard_tree_places_by_the_resolved_specs(collective_runs):
    _, outs, tree = collective_runs
    for _, _, resh in outs:
        assert resh["w"]["placements"] == ["Shard(dim=0)", "Replicate()"]
        assert resh["w"]["local_shape"] == (32, 6)
        assert resh["t"]["placements"] == ["Replicate()", "Shard(dim=1)"]
        assert resh["t"]["local_shape"] == (4, 16, 8)
        assert resh["b"]["placements"] == ["Replicate()", "Replicate()"]
        for k, v in tree.items():
            np.testing.assert_array_equal(resh[k]["whole"], v)
