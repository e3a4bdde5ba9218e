"""On the card: the control at a configuration's own size comes out not
correct on three seeds, as the CPU test holds it at a tiny size.  Run there
with ``PYTHONPATH=src python -m pytest -q --noconftest
specbench/tests/test_specbench_card.py`` (``--noconftest``: the
repository's conftest imports jax, which that machine does not have)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from specbench_tiny import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cells' own size")


@pytest.mark.card
@pytest.mark.parametrize("config", ["dti-exact"])
def test_the_control_fails_at_full_size(card, config):
    proc = subprocess.run([sys.executable, str(REPO / "specbench" / "control.py"), "--config",
                           config, "--seeds", "41", "42", "43"],
                          capture_output=True, text=True, timeout=1800, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3 and not any(x["correct"] for x in lines), lines
