"""The operations and bytes of one launch of each kernel: the problem's
work, from its shapes and the graph's true entries, never the
implementation's (no padded ELL slot, no candidate read twice): each input
read once, each output written once.  Every function returns
``(flops, bytes)``; fp32 values and int32 ids are 4 bytes.
"""
from __future__ import annotations


def knn_topk(n: int, d: int, k: int):
    """All-pairs kNN of n points in d dimensions: the points read once, the
    [n, k] distances and ids written once.  No operations are counted: for
    points in 3 dimensions a spatial grid finds the k nearest from O(k)
    candidates a point, so no count of distance evaluations binds every
    correct implementation."""
    return 0.0, 4.0 * n * d + 8.0 * n * k


def spmm(pairs: int, n: int, b: int):
    """A symmetric sparse matrix with ``pairs`` distinct nonzero pairs (one
    triangle: its values, which any correct product must read) times an
    [n, b] block: the values once, the block in, the result out; two
    operations a stored entry of the whole matrix and column."""
    return 2.0 * (2 * pairs) * b, 4.0 * pairs + 4.0 * n * b * 2


def kmeans_iter(n: int, d: int, k: int):
    """A fused Lloyd iteration: x [n, d], the centroids and their norms
    read; labels and distances a point, the [k, d] sums and [k] counts
    written; the n·k distance products 2·n·k·d."""
    return 2.0 * n * k * d, 4.0 * (n * d + k * d + k) + 8.0 * n + 4.0 * k * (d + 1)
