"""The port's serving launcher, ``repro_torch.launch.serve``, in process on
the CPU (``--device cpu``) at small sizes with its faults injected: each mode
returns exactly the number of poisoned requests (the exit code), logs one
structured JSON error line for each, and prints its summary; ``--mode
decode`` runs the LM decode path and prints the reference's line.  Beside
it, the reference's ``serve_cluster`` on the same arguments counts the same
failures.
"""
import argparse
import json
import re

import pytest

from repro_torch.launch import serve


def _events(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("method", ["exact", "lsh"])
def test_serve_mode_counts_poisoned_requests(tmp_path, capsys, method):
    rc = serve.main(["--mode", "serve", "--device", "cpu", "--n", "600", "--clusters", "4",
                     "--dim", "8", "--requests", "10", "--rows-per-request", "3",
                     "--batch-size", "16", "--oos-method", method,
                     "--inject-fault", "nan-query", "--registry-dir", str(tmp_path)])
    out, err = capsys.readouterr()
    assert rc == 5  # the odd requests
    errors = _events(err)
    assert [e["req"] for e in errors] == [1, 3, 5, 7, 9]
    assert all(e["event"] == "request_error" and e["stage"] == "post_hoc" for e in errors)
    summary = _events(out)[-1]
    assert summary["event"] == "serve_summary" and summary["failures"] == 5
    assert summary["train_ari_vs_served"] >= 0.99
    assert summary["batches"] >= 10 and 0 < summary["fill"] <= 1
    assert {"event": "index_published", "version": 1} in _events(out)


def test_serve_mode_without_faults_exits_zero(capsys):
    rc = serve.main(["--mode", "serve", "--device", "cpu", "--n", "400", "--clusters", "4",
                     "--dim", "8", "--requests", "4"])
    assert rc == 0
    assert _events(capsys.readouterr().out)[-1]["failures"] == 0


def test_cluster_mode_counts_poisoned_requests(capsys):
    rc = serve.main(["--mode", "cluster", "--device", "cpu", "--n", "120", "--clusters", "3",
                     "--requests", "4", "--inject-fault", "nan-graph", "--recluster-k", "2"])
    out, err = capsys.readouterr()
    assert rc == 2
    errors = _events(err)
    assert [(e["req"], e["stage"]) for e in errors] == [(1, "prepare"), (3, "prepare")]
    assert "non-finite" in errors[0]["error"]
    assert "re-cluster k=2" in out
    assert _events(out)[-1] == {"event": "serve_summary", "requests": 4, "failures": 2}


def test_cluster_mode_matches_reference_failure_count():
    from repro.launch.serve import serve_cluster as j_serve_cluster

    args = argparse.Namespace(n=80, clusters=2, requests=2, recluster_k=None, deadline_s=None,
                              strict=False, inject_fault="nan-graph")
    want = j_serve_cluster(args)
    got = serve.serve_cluster(argparse.Namespace(**vars(args), device="cpu"))
    assert got == want == 1


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_decode_mode_runs_on_cpu(capsys, arch):
    """``--mode decode --smoke`` on a dense and an MoE arch: exit 0 and the
    reference's line."""
    rc = serve.main(["--mode", "decode", "--smoke", "--device", "cpu", "--arch", arch,
                     "--batch", "2", "--seq", "16", "--tokens", "5"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"decoded 5 tokens x batch 2: [0-9.]+ tok/s \([0-9.]+ ms/step\)",
                        out[-1])
