"""The port's training launcher (``repro_torch.launch.train``) and example
(``examples/train_lm_torch.py``) on the CPU, against the reference's
(``repro.launch.train``, ``examples/train_lm.py``).

Held: the same printed lines in the same order (each line's text before
its first number; the first line whole), a resume from the newest
checkpoint that ends bit for bit where an uninterrupted run does, and the
reference's refusal of a non-LM arch.  The two packages draw different
initial weights, so losses are not compared across packages here (the
mesh flags, from the same weights: ``test_torch_launch_mesh.py``).
"""
import contextlib
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.launch import train as j_train
from repro_torch import _tree
from repro_torch.launch import train as t_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--smoke", "--steps", "4", "--batch", "2", "--seq", "16"]


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return out.getvalue().splitlines(), result


def _shape(lines):
    return [re.split(r"\d", ln, maxsplit=1)[0] for ln in lines]


def test_launcher_prints_the_reference_lines_and_resumes(tmp_path):
    want, _ = _lines(j_train.main, SMOKE + ["--ckpt-dir", str(tmp_path / "ref")])
    got, st = _lines(t_train.main, SMOKE + ["--device", "cpu", "--ckpt-dir",
                                            str(tmp_path / "a")])
    assert _shape(got) == _shape(want) and got[0] == want[0]
    assert int(st.step) == 4 and st.params["embed"].device.type == "cpu"
    # ckpt_every = max(steps // 5, 1): every step of a 4-step run, the last 3 kept
    assert sorted(os.listdir(tmp_path / "a")) == [f"step_{s:08d}" for s in (2, 3, 4)]

    more = ["--smoke", "--steps", "7", "--batch", "2", "--seq", "16", "--device", "cpu"]
    resumed, st = _lines(t_train.main, more + ["--ckpt-dir", str(tmp_path / "a")])
    assert resumed[1] == "[resume] restored checkpoint at step 4"
    _, whole = _lines(t_train.main, more)
    assert int(st.step) == int(whole.step) == 7
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(st), _tree.leaves(whole)))


def test_launcher_rejects_a_non_lm_arch():
    with pytest.raises(SystemExit, match="drives the LM family"):
        j_train.main(["--arch", "autoint", "--smoke"])
    with pytest.raises(SystemExit, match="drives the LM family"):
        t_train.main(["--arch", "autoint", "--smoke", "--device", "cpu"])


def _example(script, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def test_example_trains_resumes_and_prints_the_reference_lines(tmp_path):
    want = _example("train_lm.py", "--steps", "6", "--ckpt-dir", str(tmp_path / "ref"))
    got = _example("train_lm_torch.py", "--steps", "6", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path / "port"))
    assert _shape(got) == _shape(want) and got[0] == want[0]
    again = _example("train_lm_torch.py", "--steps", "12", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "port"))
    assert again[1] == "[resume] restored checkpoint at step 6"
    losses = [float(re.search(r"loss=([0-9.]+)", ln)[1]) for ln in got[1:] + again[2:]]
    assert len(losses) == 3 and losses[0] > losses[1] > losses[2]
