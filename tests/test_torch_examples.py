"""Port parity: ``examples/dti_pointcloud_torch.py`` and
``examples/ann_retrieval_torch.py`` print the lines of the reference's
examples, on the CPU (the DTI example at its default size, the ANN one
small).

Held: the same lines in the same order (each line's text before its first
number), the sizes equal (voxels, ε-pairs, graph nnz, cluster counts), the
DTI purity no more than 0.02 below the reference's and the IVF recall@10
within 0.05 of it.  The two packages draw different k-means++ seeds, and
with 12 clusters over 6 latent regions k-means settles in different local
optima, so purity is held one-sided.
"""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *args: str) -> list:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]


def _shape(lines: list) -> list:
    return [re.split(r"\d", ln, maxsplit=1)[0] for ln in lines]


def _numbers(line: str) -> list:
    return [float(v) for v in re.findall(r"\d+(?:\.\d+)?", line)]


@pytest.mark.parametrize("device_stage1", [False, True])
def test_dti_example_prints_the_reference_lines(device_stage1):
    args = ["--device-stage1"] if device_stage1 else []
    want = _run("dti_pointcloud.py", *args)
    got = _run("dti_pointcloud_torch.py", *args, "--device", "cpu")
    assert _shape(got) == _shape(want)
    assert _numbers(got[0])[:2] == _numbers(want[0])[:2]  # voxels, ε-pairs
    if not device_stage1:
        assert _numbers(got[1])[0] == _numbers(want[1])[0]  # nnz of the host graph
    assert _numbers(got[-2])[:2] == _numbers(want[-2])[:2]  # non-empty / k
    assert _numbers(got[-1])[0] >= _numbers(want[-1])[0] - 0.02  # purity


def test_ann_example_prints_the_reference_lines():
    args = ["--candidates", "5000", "--clusters", "32", "--queries", "16",
            "--kmeans-iter", "two_pass"]
    want = _run("ann_retrieval.py", *args)
    got = _run("ann_retrieval_torch.py", *args, "--device", "cpu")
    assert _shape(got) == _shape(want)
    assert _numbers(got[0])[0] == _numbers(want[0])[0] == 32
    assert abs(_numbers(got[1])[1] - _numbers(want[1])[1]) <= 0.05  # recall@10
