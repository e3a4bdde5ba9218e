"""The port's mesh launcher (``repro_torch.launch.train`` on a DeviceMesh)
against the reference's (``repro.launch.train`` on a jax mesh), from the
same initial weights: the reference's ``init_params(cfg, PRNGKey(0))``,
put into the port's ranks by ``repro_torch.testing.dist.launch_rank``.

One device: both launchers build and install a (1, 1) mesh, so
granite-moe's MoE layers take the expert-parallel path with its local
capacity in both.  Four ranks: the port on 4 gloo ranks, the reference in a
subprocess with 4 fake host devices, ``--data-parallel 2 --model-parallel
2``; then ``--elastic`` resumes each package's step-2 checkpoint on 2
ranks / devices (mesh (1, 2)) to step 4.

Gates: the final states (read from each run's last checkpoint with the
port's manager) within 1e-5 of max|p| over the tree, and the printed lines
equal up to each line's ``dt=`` field.
"""
import contextlib
import io
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as tfm
from repro_torch.testing import dist as td
from repro_torch.train.state import init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["--smoke", "--steps", "2", "--batch", "4", "--seq", "32"]
MESH = ["--data-parallel", "2", "--model-parallel", "2"]
ELASTIC = ["--smoke", "--steps", "4", "--batch", "4", "--seq", "32", "--elastic",
           "--model-parallel", "2"]


def _reference_init(arch: str) -> dict:
    """The reference launcher's initial parameters, flat by key path."""
    import jax

    from repro.configs import ARCHS as J_ARCHS
    from repro.models import transformer as j_tfm

    tree = j_tfm.init_params(J_ARCHS[arch].smoke_config, jax.random.PRNGKey(0))
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + [k], v)
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk([], tree)
    return flat


def _final_state(arch: str, ckpt_dir) -> list:
    """The newest checkpoint under ``ckpt_dir``, restored with the port's
    manager into a plain CPU template: its leaves in flatten order."""
    from repro_torch._device import cpu_generator

    cfg = ARCHS[arch].smoke_config
    template = init_state(tfm.init_params(cfg, cpu_generator(0), device="cpu"))
    mgr = CheckpointManager(str(ckpt_dir))
    return _tree.leaves(mgr.restore(mgr.all_steps()[-1], template))


def _assert_states_close(got, want):
    assert len(got) == len(want)
    scale = max(float(w.abs().max()) for w in want if w.is_floating_point())
    worst = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    assert worst <= 1e-5 * scale, (worst, scale)


def _no_dt(lines):
    return [re.sub(r" dt=\S+", "", ln) for ln in lines]


def _reference_runs(n_devices: int, runs, tmp_path) -> list:
    """``repro.launch.train.main(argv)`` for each argv of ``runs`` in one
    subprocess with ``n_devices`` fake host devices; each run's lines, or
    its error's text."""
    script = f"""
        import contextlib, io, json, sys
        from repro.launch import train
        outs = []
        for argv in {runs!r}:
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    train.main(argv)
                outs.append(buf.getvalue().splitlines())
            except Exception as e:
                outs.append("error: " + type(e).__name__ + ": " + str(e))
        print("RESULT " + json.dumps(outs))
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], capture_output=True,
                          text=True, env=env, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    import json

    return json.loads(proc.stdout.split("RESULT ", 1)[1])


def _port_lines(argv, init):
    """The port's launcher in this process on ``--device cpu``."""
    out = io.StringIO()
    saved = tfm.init_params
    tfm.init_params = lambda cfg, gen, *, device=None: _unflat(init, device)
    try:
        with contextlib.redirect_stdout(out):
            t_train.main(argv + ["--device", "cpu"])
    finally:
        tfm.init_params = saved
    return out.getvalue().splitlines()


def _unflat(flat, device):
    tree: dict = {}
    for path, a in flat.items():
        *outer, last = path.split("/")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[last] = torch.tensor(a, device=device)
    return tree


def test_one_device_granite_moe_takes_the_reference_expert_parallel_path(tmp_path):
    """P9: on one device the reference installs a (1, 1) mesh and its MoE
    layers route with the local capacity C = int(T·K·cf/E) (40 at 128
    tokens); the port's launcher does the same."""
    arch = "granite-moe-3b-a800m"
    init = _reference_init(arch)
    argv = ["--arch", arch] + RUN
    want = _reference_runs(1, [argv + ["--ckpt-dir", str(tmp_path / "ref")]], tmp_path)[0]
    got = _port_lines(argv + ["--ckpt-dir", str(tmp_path / "port")], init)
    assert _no_dt(got) == _no_dt(want)
    _assert_states_close(_final_state(arch, tmp_path / "port"),
                         _final_state(arch, tmp_path / "ref"))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Both archs on (2, 2) then elastically on (1, 2), in each package."""
    tmp = tmp_path_factory.mktemp("mesh")
    archs = ["qwen3-0.6b", "granite-moe-3b-a800m"]
    ref4 = [["--arch", a] + RUN + MESH + ["--ckpt-dir", str(tmp / f"ref-{a}")] for a in archs]
    ref4.append(["--arch", archs[0], "--smoke", "--steps", "1", "--data-parallel", "3",
                 "--model-parallel", "2"])
    ref = _reference_runs(4, ref4, tmp)
    ref_el = _reference_runs(2, [["--arch", a] + ELASTIC + ["--ckpt-dir", str(tmp / f"ref-{a}")]
                                 for a in archs], tmp)
    tasks = [("launch_rank", {"argv": ["--arch", a] + RUN + MESH + [
        "--device", "cpu", "--ckpt-dir", str(tmp / f"port-{a}")], "init": _reference_init(a)})
        for a in archs]
    port = td.run_ranks(td.tasks_rank, 4, tasks, tmpdir=str(tmp / "ranks4"), join_timeout=400)
    el_tasks = [("launch_rank", {"argv": ["--arch", a] + ELASTIC + [
        "--device", "cpu", "--ckpt-dir", str(tmp / f"port-{a}")]}) for a in archs]
    port_el = td.run_ranks(td.tasks_rank, 2, el_tasks, tmpdir=str(tmp / "ranks2"),
                           join_timeout=400)
    return {"tmp": tmp, "archs": archs, "ref": ref, "ref_el": ref_el, "port": port,
            "port_el": port_el}


@pytest.mark.parametrize("i", [0, 1], ids=["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_mesh_launcher_on_2x2_matches_the_reference(mesh_runs, i):
    arch = mesh_runs["archs"][i]
    want = mesh_runs["ref"][i]
    got = mesh_runs["port"][0][i]["lines"]
    assert got[0] == "mesh {'data': 2, 'model': 2}  " + want[0].split("  ", 1)[1]
    assert _no_dt(got) == _no_dt(want)
    # only rank 0 prints
    assert all(r[i]["lines"] == [] for r in mesh_runs["port"][1:])
    _assert_states_close(_final_state(arch, mesh_runs["tmp"] / f"port-{arch}"),
                         _final_state(arch, mesh_runs["tmp"] / f"ref-{arch}"))


@pytest.mark.parametrize("i", [0, 1], ids=["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_elastic_restart_resumes_the_4_rank_checkpoint_on_2(mesh_runs, i):
    arch = mesh_runs["archs"][i]
    want = mesh_runs["ref_el"][i]
    got = mesh_runs["port_el"][0][i]["lines"]
    assert got[0].startswith("mesh {'data': 1, 'model': 2}")
    assert got[1] == "[resume] restored checkpoint at step 2"
    assert _no_dt(got) == _no_dt(want)
    _assert_states_close(_final_state(arch, mesh_runs["tmp"] / f"port-{arch}"),
                         _final_state(arch, mesh_runs["tmp"] / f"ref-{arch}"))


def test_a_grid_larger_than_the_ranks_is_refused(mesh_runs):
    """``--data-parallel 3 --model-parallel 2`` on 4 devices: the
    reference's reshape of 4 devices into (3, 2) fails, the port's mesh
    builder refuses the same grid."""
    assert mesh_runs["ref"][2].startswith("error: ValueError")
    with pytest.raises(SystemExit, match=r"cannot lay 4 ranks out as a \(data 3, model 2\)"):
        t_train.build_mesh(4, 3, 2, False, "cpu")


def test_elastic_plan_leaves_the_ranks_past_the_grid_out(tmp_path):
    """3 ranks, model axis 2: ``plan_elastic_mesh`` keeps a (1, 2) grid of
    ranks 0 and 1; rank 2 is in no mesh and its launcher returns at once
    instead of waiting in a collective."""
    spec = {"model": 2, "argv": ["--smoke", "--steps", "1", "--batch", "2", "--seq", "8",
                                 "--device", "cpu"]}
    outs = td.run_ranks(td.tasks_rank, 3, [("elastic_rank", spec)],
                        tmpdir=str(tmp_path / "ranks"), join_timeout=200)
    assert [o[0] for o in outs] == [{"coordinate": [0, 0], "trained": True},
                                    {"coordinate": [0, 1], "trained": True},
                                    {"coordinate": None, "trained": False}]


def test_grad_compress_is_accepted_and_changes_nothing(tmp_path):
    """The reference parses ``--grad-compress`` and never reads it; the
    port says in one line that the (data, model) mesh has no pod axis, and
    trains exactly as without the flag."""
    init = _reference_init("qwen3-0.6b")
    plain = _port_lines(RUN + ["--ckpt-dir", str(tmp_path / "a")], init)
    flagged = _port_lines(RUN + ["--grad-compress", "--ckpt-dir", str(tmp_path / "b")], init)
    assert flagged[1].startswith("[grad-compress]") and "not engaged" in flagged[1]
    assert _no_dt(flagged[:1] + flagged[2:]) == _no_dt(plain)
    a = _final_state("qwen3-0.6b", tmp_path / "a")
    b = _final_state("qwen3-0.6b", tmp_path / "b")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
