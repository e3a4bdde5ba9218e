"""Each roofline count against a hand count at a small shape: the graph's
true entries (not the BlockELL's padded width), each input read once and
each output written once; a share reads at most 100 % when the time is the
least time."""
from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

from specbench import harness, peaks, work
from specbench.trace import Trace
from specbench_tiny import REPO

SERIAL = harness.load_module(harness.part_path(REPO, "loops", "serial_jobs"))


def _adj(row, col, val, n):
    return SimpleNamespace(row=torch.tensor(row), col=torch.tensor(col),
                           val=torch.tensor(val, dtype=torch.float32), shape=(n, n))


def test_graph_pairs_count_true_entries_once():
    # 4 nodes; pair {0,1} listed twice (both lists) and {1,2} once, each in
    # both orientations; a zero-weight self entry (an empty slot) and a
    # clipped pair; no ELL padding enters
    row = [0, 0, 1, 1, 1, 2, 2, 3, 3, 3]
    col = [1, 1, 0, 0, 2, 1, 3, 2, 3, 3]
    val = [.5, .5, .5, .5, .2, .2, 0., 0., 0., 0.]
    assert SERIAL.graph_pairs(_adj(row, col, val, 4)) == 2


def test_spmm_count_by_hand():
    flops, nbytes = work.spmm(pairs=2, n=4, b=3)
    assert flops == 2 * 4 * 3  # 4 stored entries of the whole matrix, 3 columns
    assert nbytes == 2 * 4 + 4 * 4 * 3 * 2  # one triangle's values, x in, y out


def test_kmeans_counts_by_hand():
    n, d, k = 10, 3, 2
    assert work.kmeans_iter(n, d, k) == (2 * n * k * d,
                                         4 * (n * d + k * d + k) + 8 * n + 4 * k * (d + 1))


def test_knn_count_by_hand():
    assert work.knn_topk(100, 3, 16) == (0.0, 4 * 100 * 3 + 8 * 100 * 16)
    assert work.knn_topk(100, 3, 49) == (0.0, 4 * 100 * 3 + 8 * 100 * 49)


@pytest.mark.parametrize("flops,nbytes,peak,by", [
    (1e12, 1e6, peaks.FP32_EXACT_MMA_FLOPS, "flops"),
    (1e6, 1e10, peaks.FP32_EXACT_MMA_FLOPS, "bytes"),
])
def test_least_time_is_the_larger_bound(flops, nbytes, peak, by):
    t = peaks.least_seconds(flops, nbytes, peak)
    assert t == (flops / peak if by == "flops" else nbytes / peaks.HBM_BYTES_S)
    assert math.isclose(peaks.share([(flops, nbytes)], t, peak), 100.0)
    assert peaks.share([(flops, nbytes)], 2 * t, peak) == pytest.approx(50.0)


def test_kernel_share_reads_only_matched_launches():
    tr = Trace(device=[("void kmeans_iter_kernel<4>(float const*)", 0.0, 1e-3),
                       ("void kmeans_iter_kernel<4>(float const*)", 2e-3, 3e-3),
                       ("Memset (Device)", 3e-3, 4e-3)], host=[], busy_s=3e-3)
    one = work.kmeans_iter(1000, 500, 500)
    run = SimpleNamespace(trace=tr)
    got = peaks.kernel_share(run, ("kmeans_iter_kernel",), [one, one], peaks.FP32_EXACT_MMA_FLOPS)
    assert got == pytest.approx(100 * 2 * peaks.least_seconds(*one, peaks.FP32_EXACT_MMA_FLOPS)
                                / 2e-3)
    assert peaks.kernel_share(run, ("kmeans_iter_kernel",), [one], 1.0) is None
    assert peaks.kernel_share(SimpleNamespace(trace=None), ("x",), [one], 1.0) is None
