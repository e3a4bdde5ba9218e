"""The manifest and the harness's lookups by name; a run on the CPU at a tiny
size end to end; a metric, and a traffic mix with a loop of its own, added
as files alone; the check that no module of JAX or the JAX package is
loaded."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap

import pytest

from specbench import harness, runner
from specbench_tiny import REPO, TINY_CELL, add_cell, make_root

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
ONE_LINE = re.compile(r"[^\n\t]{1,200}")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["specbench"] and MAN["command"][1] == "specbench/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MAN[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert harness.NAME.fullmatch(name), name
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in MAN["workloads"]] + [c["source"] for c in MAN["configs"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert ONE_LINE.fullmatch(text), text
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", [c["name"] for c in MAN["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    wl = harness.cell(MAN, cell)
    cfg_path = harness.config_path(REPO, MAN, wl["config"])
    cfg = json.loads(cfg_path.read_text())
    assert cfg_path.name == f"{wl['config']}.json" and cfg["name"] == wl["config"]
    assert harness.part_path(REPO, "datasets", cfg["data"]["maker"]).is_file()
    traffic = json.loads(harness.part_path(REPO, "traffic", wl["traffic"]).read_text())
    assert hasattr(harness.load_module(harness.part_path(REPO, "loops", traffic["loop"])),
                   "Loop")
    assert wl["chips"] == 1
    e2e = harness.metrics_for(MAN, cell, trace=False)
    per_layer = harness.metrics_for(MAN, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    shown = {m["name"] for m in e2e}
    for m in e2e + per_layer:
        assert hasattr(harness.load_module(harness.part_path(REPO, "metrics", m["name"])),
                       "read")
    for m in per_layer:
        assert m["moves"] in shown


def test_every_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {c["name"] for c in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m["workloads"]) <= cells
        target = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(target.get("workloads", cells))


def test_every_configuration_is_used_and_every_file_is_a_name():
    used = {c["config"] for c in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for path in (REPO / "specbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            for part in path.relative_to(REPO).with_suffix("").parts:
                assert harness.NAME.fullmatch(part), path


@pytest.mark.parametrize("bad", ["", "a b", "../x", "x/y", "-x", ".x", "a" * 65, "ü",
                                 "a,b", "a\tb", None])
def test_a_name_of_any_other_character_is_refused(bad):
    with pytest.raises(ValueError):
        harness.check_name(bad)
    for kind in harness.PARTS:
        with pytest.raises(ValueError):
            harness.part_path(REPO, kind, bad)


@pytest.mark.parametrize("good", ["a", "dti-exact.serial", "_x", "9z", "a" * 64])
def test_a_name_of_allowed_characters_is_taken(good):
    assert harness.check_name(good) == good


def test_a_tiny_run_on_the_cpu_is_correct(root):
    out = runner.run_cell(root, TINY_CELL, 2**31 + 7, 0.2, False, device="cpu")
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    names = {m["name"] for m in harness.metrics_for(json.loads((root / "BENCHMARK.json")
                                                               .read_text()), TINY_CELL, False)}
    assert set(out["metrics"]) == names - {"peak_gb"}  # no peak on the CPU
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["check"]) == set(json.loads(
        (root / "specbench" / "configs" / "tiny-exact.json").read_text())["check"]["limits"])


def test_each_job_clusters_a_dataset_of_the_seed(root):
    """Job j runs on dataset j mod D, drawn from (seed, j mod D): two seeds
    give other data, one seed the same."""
    import torch

    from specbench.datasets.dti_points import make

    cfg = json.loads((root / "specbench" / "configs" / "tiny-exact.json").read_text())
    first = [make(cfg["data"], harness.data_seed(3, i))["features"] for i in range(2)]
    assert not torch.equal(first[0], first[1])
    assert torch.equal(first[0], make(cfg["data"], harness.data_seed(3, 0))["features"])
    assert not torch.equal(first[0], make(cfg["data"], harness.data_seed(4, 0))["features"])
    # a mix that judges each of the first three jobs: datasets 0, 1 and 0 again
    traffic = json.loads((root / "specbench" / "traffic" / "tiny-serial.json").read_text())
    traffic.update(judge_among=3, judge_count=3)
    (root / "specbench" / "traffic" / "tiny-serial3.json").write_text(json.dumps(traffic))
    add_cell(root, "tiny-exact.serial3", "tiny-exact", "tiny-serial3")
    out = runner.run_cell(root, "tiny-exact.serial3", 3, 0.0, False, device="cpu")
    assert out["correct"], out["check"]
    assert out["attempted"] == 3


def test_a_metric_added_as_a_file_needs_no_edit(root, tmp_path):
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "dummy.jobs", "unit": "count", "better": "higher",
                             "source": "program_counter", "layer": "device",
                             "moves": "labels_s", "workloads": [TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (root / "specbench" / "metrics" / "dummy.jobs.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    try:
        out = runner.run_cell(root, TINY_CELL, 5, 0.2, True, device="cpu")
        assert out["metrics"]["dummy.jobs"]["value"] == out["attempted"]
        assert "embed_s" in out["metrics"]
    finally:
        man["per_layer"].pop()
        (root / "BENCHMARK.json").write_text(json.dumps(man))


# A loop of its own, as a later cell would bring it: re-clustering the
# set-up job's cached embedding at the cluster counts of its traffic, each
# clustering judged on that job's graph and pairs.
RECLUSTER_LOOP = """
import time
import torch
from specbench import harness
from specbench.reference import judge as rj
import repro_torch.core.lanczos as lz
from repro_torch.core.spectral import SpectralPipeline


class Loop:
    def __init__(self, ctx):
        self.ctx, self.labels = ctx, []

    def setup(self):
        ctx = self.ctx
        self.pipe = SpectralPipeline.from_dict(ctx.cfg["pipeline"])
        self.data = {k: v.to(ctx.device) for k, v in ctx.dataset(0).items()}
        orig, pairs = lz.eigsh, []
        lz.eigsh = lambda *a, **kw: pairs.append(orig(*a, **kw)) or pairs[-1]
        try:
            st = self.pipe.run_state(self.data["features"], torch.Generator().manual_seed(1),
                                     points=self.data["points"], device=ctx.device)
        finally:
            lz.eigsh = orig
        a, e = st.graph.adj, pairs[-1]
        self.graph = (a.row, a.col, a.val, e.eigenvalues, e.eigenvectors, e.residuals)
        self.embed = st.embedding
        ctx.run.sizes = dict(n=a.shape[0], d_points=3, knn_k=self.pipe.graph.knn_k,
                             graph_pairs=1)

    def window(self, seconds, jobs):
        w0, j = time.perf_counter(), 0
        while True:
            k = self.ctx.traffic["k_cycle"][j % len(self.ctx.traffic["k_cycle"])]
            gen = torch.Generator().manual_seed(harness.job_seed(self.ctx.seed, j))
            t0 = time.perf_counter()
            res = self.pipe.cluster(self.embed, gen, n_clusters=k, device=self.ctx.device)
            self.labels.append((res.labels, k, float(res.kmeans_inertia)))
            jobs.append({"wall_s": time.perf_counter() - t0,
                         "kmeans_iterations": res.kmeans_iterations})
            j += 1
            if time.perf_counter() - w0 >= seconds:
                return

    def check(self):
        return rj.judge(rj.Outputs(*self.graph, self.labels), self.data["points"],
                        self.data["features"], self.ctx.cfg["pipeline"])

    def close(self):
        pass
"""


def test_a_traffic_mix_with_a_loop_of_its_own_needs_no_edit(tmp_path):
    """A cell of a new kind (another entry of the program, a loop of its
    own) comes in as new files and a manifest entry; no existing file of
    the benchmark changes."""
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "specbench").rglob("*") if p.is_file()}
    (root / "specbench" / "loops" / "recluster_cached.py").write_text(RECLUSTER_LOOP)
    (root / "specbench" / "traffic" / "tiny-recluster.json").write_text(json.dumps(
        {"why": "re-clustering a cached embedding", "loop": "recluster_cached",
         "k_cycle": [5, 8, 11]}))
    add_cell(root, "tiny-exact.recluster", "tiny-exact", "tiny-recluster", ["kmeans_iters"])
    out = runner.run_cell(root, "tiny-exact.recluster", 9, 0.1, True, device="cpu")
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["metrics"]["kmeans_iters"]["value"] >= 1
    assert all(p.read_bytes() == b for p, b in before.items())
    out = runner.run_cell(root, TINY_CELL, 9, 0.05, False, device="cpu")
    assert out["correct"], out["check"]  # the cells that were there run as before


def test_result_line_is_json_with_the_check_last():
    line = harness.result_line(correct=True, attempted=2, failed=0, metrics={}, device={},
                               breakdown=None, check={"x": [float("inf"), 1.0]})
    out = json.loads(line)
    assert list(out)[-1] == "check" and out["check"]["x"] == ["inf", 1.0]


def test_job_seeds_take_large_seeds_and_differ():
    seeds = {f(s, j) for f in (harness.job_seed, harness.data_seed)
             for s in (0, 2**31 + 3, 2**40) for j in range(3)}
    assert len(seeds) == 18 and all(0 <= s < 2**63 for s in seeds)
    assert harness.judged(2**33, 3, 1)[0] in (0, 1, 2)


def test_no_jax_after_a_run_in_a_fresh_process(root):
    """The run's process, not this one (the repository's conftest imports
    jax here): after a tiny run no module named jax, jaxlib, flax or repro
    is loaded, and a planted one is found."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from specbench import harness, runner
        out = runner.run_cell({str(root)!r}, {TINY_CELL!r}, 11, 0.1, False, device="cpu")
        assert out["correct"], out["check"]
        print("FOUND", harness.foreign_modules(), "PORT", "repro_torch" in sys.modules)
        import types
        sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
        print("PLANTED", harness.foreign_modules())
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND [] PORT True" in proc.stdout  # the port's name is not the JAX package's
    assert "PLANTED ['jax']" in proc.stdout
