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
from repro_torch.kernels.kmeans_iter import kernel as km_kernel
from repro_torch.kernels.knn_topk import kernel as knn_kernel

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
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = {str(f.relative_to(ROOT)): sorted({m for m in _imported_roots(f)
                                                   if m in ("jax", "jaxlib", "repro")})
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.core.spectral import SpectralPipeline
    from repro_torch.data.pointcloud import dti_like_pointcloud
    from repro_torch.data.sbm import sbm_graph

    x = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    pipe = SpectralPipeline(n_clusters=2)
    for call in (lambda: pipe.run(x, torch.Generator()),
                 lambda: pipe.build_graph(x),
                 lambda: sbm_graph(10, 2),
                 lambda: dti_like_pointcloud(50, 4, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    pipe.run(x, torch.Generator(), device="cpu")  # the explicit CPU path works


def test_raw_kernel_entries_refuse_cpu_tensors():
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_kernel.knn_topk_cuda(x, x, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ell_kernel.ell_spmm_cuda(x, torch.zeros(8, 2, dtype=torch.int32), torch.zeros(8, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        km_kernel.kmeans_iter_cuda(x, x[:2], torch.zeros(2))


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
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("a")
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("b")
    assert _build.library_path("k") != first


@needs_cuda
def test_cuda_wrappers_never_reach_the_plain_versions(monkeypatch):
    """On the card every wrapper launches its kernel: the plain versions are
    replaced by tripwires, and each launch counter moves."""
    from repro_torch.kernels.ell_spmm import ops as ell_ops
    from repro_torch.kernels.kmeans_iter import ops as km_ops
    from repro_torch.kernels.knn_topk import ops as knn_ops
    from repro_torch.sparse import formats as tf

    def tripwire(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(knn_ops, "knn_topk_ref", tripwire)
    monkeypatch.setattr(ell_ops, "ell_spmm_ref", tripwire)
    monkeypatch.setattr(km_ops, "kmeans_iter_ref", tripwire)
    dev = torch.device("cuda")
    x = torch.randn(100, 3, device=dev)
    before = (knn_ops.knn_topk.launches, ell_ops.ell_spmm.launches,
              km_ops.kmeans_iter.launches)
    knn_ops.knn_topk(x, 5)
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, 100, 600), rng.integers(0, 100, 600)
    m = tf.csr_to_blockell(tf.coo_to_csr(
        tf.coo_from_edges(r, c, np.ones(600, np.float32), (100, 100), device=dev)))
    ell_ops.ell_spmm(m, torch.randn(100, 4, device=dev))
    km_ops.kmeans_iter(x, x[:7])
    torch.cuda.synchronize()
    after = (knn_ops.knn_topk.launches, ell_ops.ell_spmm.launches,
             km_ops.kmeans_iter.launches)
    assert all(a == b + 1 for a, b in zip(after, before))
