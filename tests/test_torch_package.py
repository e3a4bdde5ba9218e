"""Hygiene of the port: what it imports, where its entry points run, and that
a kernel wrapper never hides the device or the kernel.

The CUDA tests need a card and skip elsewhere (the condition is evaluated
when the test runs); on the card run them with
``PYTHONPATH=src python -m pytest -q tests/test_torch_package.py tests/test_torch_cuda.py``.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmm import kernel as ell_kernel
from repro_torch.kernels.ell_spmv import kernel as spmv_kernel
from repro_torch.kernels.kmeans_assign import kernel as ka_kernel
from repro_torch.kernels.kmeans_iter import kernel as km_kernel
from repro_torch.kernels.knn_topk import kernel as knn_kernel
from repro_torch.kernels.lsh_candidates import kernel as lsh_kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the Hopper kernels run only on the card")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 20
    names = {str(f.relative_to(ROOT)) for f in files}
    for new in ("optim/adamw.py", "optim/compress.py", "train/state.py", "train/loop.py",
                "launch/train.py", "data/tokens.py", "models/recsys.py", "configs/cells.py",
                "configs/autoint.py", "_tree.py", "launch/sharding.py", "launch/mesh.py",
                "launch/dryrun.py", "launch/roofline.py", "launch/report.py", "ckpt/elastic.py"):
        assert f"src/repro_torch/{new}" in names
    assert "examples/train_lm_torch.py" in names
    offenders = {str(f.relative_to(ROOT)): sorted({m for m in _imported_roots(f)
                                                   if m in ("jax", "jaxlib", "repro")})
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.configs import ARCHS
    from repro_torch.core.spectral import SpectralPipeline
    from repro_torch.data.pointcloud import dti_like_pointcloud
    from repro_torch.data.sbm import sbm_graph
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import recsys as rs
    from repro_torch.models import transformer as tfm

    x = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    pipe = SpectralPipeline(n_clusters=2)
    for call in (lambda: pipe.run(x, torch.Generator()),
                 lambda: pipe.build_graph(x),
                 lambda: sbm_graph(10, 2),
                 lambda: dti_like_pointcloud(50, 4, 2),
                 lambda: tfm.init_params(ARCHS["qwen3-0.6b"].smoke_config, torch.Generator()),
                 lambda: tfm.make_cache(ARCHS["qwen3-0.6b"].smoke_config, 1, 4),
                 lambda: launch_serve.main(["--mode", "decode", "--smoke"]),
                 lambda: launch_train.main(["--smoke", "--steps", "1"]),
                 lambda: launch_train.main(["--smoke", "--steps", "1", "--data-parallel", "1",
                                            "--model-parallel", "1", "--elastic"]),
                 lambda: rs.init_params(ARCHS["autoint"].smoke_config, torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pipe.run(x, torch.Generator(), device="cpu")  # the explicit CPU path works
    launch_train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq", "8",
                       "--device", "cpu"])


@pytest.mark.parametrize("package", ["core", "sparse", "data", "ckpt", "optim", "train",
                                     "serve", "configs"])
def test_packages_export_the_reference_names(package):
    """Each package ``__init__`` of the port re-exports the public names of
    the reference's (read from its source, nothing imported); ``core`` keeps
    the ``kmeans`` submodule unshadowed.  (``launch``'s reference
    ``__init__`` exports no names.)"""
    import importlib

    def exported(path):
        tree = ast.parse(path.read_text(), filename=str(path))
        return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                for a in node.names} | {t.id for node in tree.body if isinstance(node, ast.Assign)
                                        for t in node.targets if isinstance(t, ast.Name)}

    want = {n for n in exported(ROOT / "src" / "repro" / package / "__init__.py")
            if not n.startswith("_")}
    mod = importlib.import_module(f"repro_torch.{package}")
    assert want - set(dir(mod)) == set()
    if package == "core":
        import types

        assert isinstance(mod.kmeans, types.ModuleType)


def test_serving_entry_points_refuse_a_missing_card(tmp_path):
    """The serving entry points default to the card as well: the index
    builder, the batcher, a registry load and the launcher."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    import types

    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import EmbeddingRegistry, MicroBatcher, build_index

    x = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    result = types.SimpleNamespace(labels=np.zeros(30, np.int32), embedding=x)
    for call in (lambda: build_index(x, result),
                 lambda: MicroBatcher(lambda b: b, 3),
                 lambda: EmbeddingRegistry(str(tmp_path)).load(),
                 lambda: launch_serve.main(["--mode", "serve", "--n", "40"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_raw_kernel_entries_refuse_cpu_tensors():
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_kernel.knn_topk_cuda(x, x, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ell_kernel.ell_spmm_cuda(x, torch.zeros(8, 2, dtype=torch.int32), torch.zeros(8, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        km_kernel.kmeans_iter_cuda(x, x[:2], torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ka_kernel.kmeans_assign_cuda(x, x[:2], torch.zeros(2))
    cols, vals = torch.zeros(8, 2, dtype=torch.int32), torch.zeros(8, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmv_kernel.ell_spmv_cuda(x[:, 0].contiguous(), cols, vals)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ell_kernel.ell_spmm_cheb_cuda(x, cols, vals, x, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lsh_kernel.hash_codes_cuda(x, torch.zeros(2, 4, 5))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source nvcc rejects (here: a stand-in compiler that always fails)
    raises with the kernel's name — no fallback to the plain version."""
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed for broken"):
        _build.build(["broken"])
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))


def test_library_path_tracks_the_source(tmp_path, monkeypatch):
    """The library's name follows the source and every local header it
    includes, recursively — an edited shared header never loads a stale
    build — and every kernel the package builds has its source."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    seen = {_build.library_path("k")}
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint b;\n')
    seen.add(_build.library_path("k"))
    (tmp_path / "g.cuh").write_text("int g2;\n")
    seen.add(_build.library_path("k"))
    assert len(seen) == 3
    assert [p.name for p in _build._sources("k")] == ["k.cu", "h.cuh", "g.cuh"]
    monkeypatch.undo()
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()
    for name in ("kmeans_iter", "kmeans_assign"):  # the tile both k-means kernels run
        assert "kmeans_tile.cuh" in [p.name for p in _build._sources(name)]


@needs_cuda
def test_cuda_wrappers_never_reach_the_plain_versions(monkeypatch):
    """On the card every wrapper launches its kernel: the plain versions are
    replaced by tripwires, and each launch counter moves."""
    from repro_torch.kernels.ell_spmm import ops as ell_ops
    from repro_torch.kernels.ell_spmv import ops as spmv_ops
    from repro_torch.kernels.kmeans_assign import ops as ka_ops
    from repro_torch.kernels.kmeans_iter import ops as km_ops
    from repro_torch.kernels.knn_topk import ops as knn_ops
    from repro_torch.kernels.lsh_candidates import ops as lsh_ops
    from repro_torch.sparse import formats as tf

    def tripwire(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for mod, name in ((knn_ops, "knn_topk_ref"), (ell_ops, "ell_spmm_ref"),
                      (ell_ops, "ell_spmm_cheb_ref"), (km_ops, "kmeans_iter_ref"),
                      (spmv_ops, "ell_spmv_ref"), (ka_ops, "kmeans_assign_ref"),
                      (lsh_ops, "hash_codes_ref")):
        monkeypatch.setattr(mod, name, tripwire)
    wrappers = (knn_ops.knn_topk, ell_ops.ell_spmm, ell_ops.ell_spmm_cheb_step,
                km_ops.kmeans_iter, spmv_ops.ell_spmv, ka_ops.kmeans_assign,
                lsh_ops.hash_codes)
    dev = torch.device("cuda")
    x = torch.randn(100, 3, device=dev)
    before = [w.launches for w in wrappers]
    knn_ops.knn_topk(x, 5)
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, 100, 600), rng.integers(0, 100, 600)
    m = tf.csr_to_blockell(tf.coo_to_csr(
        tf.coo_from_edges(r, c, np.ones(600, np.float32), (100, 100), device=dev)))
    y = torch.randn(100, 4, device=dev)
    ell_ops.ell_spmm(m, y)
    ell_ops.ell_spmm_cheb_step(m, y, y, 1.0, 0.5)
    km_ops.kmeans_iter(x, x[:7])
    spmv_ops.ell_spmv(m, y[:, 0])
    ka_ops.kmeans_assign(x, x[:7])
    lsh_ops.hash_codes(x, torch.randn(4, 3, 9, device=dev))
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
