"""Uniform fanout neighbor sampler (GraphSAGE-style) for ``minibatch_lg``
(a copy of :mod:`repro.data.sampler`: the same draws for the same seed).

Host-side (numpy over CSR adjacency) — samplers are data-pipeline work; the
device step consumes fixed-size padded subgraphs so the lowered program is
static.  Capacities are computed from (batch_nodes, fanout) and padding is
masked, so the same compiled step serves every minibatch.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Fixed-capacity padded subgraph (device-ready)."""

    node_ids: np.ndarray  # [cap_nodes] global ids (0-padded)
    node_mask: np.ndarray  # [cap_nodes]
    edge_src: np.ndarray  # [cap_edges] local indices
    edge_dst: np.ndarray  # [cap_edges]
    edge_mask: np.ndarray  # [cap_edges]
    seed_count: int  # first seed_count nodes are the labeled batch


def subgraph_capacities(batch_nodes: int, fanout: Tuple[int, ...]) -> Tuple[int, int]:
    """Static (cap_nodes, cap_edges) for a fanout schedule."""
    nodes, frontier, edges = batch_nodes, batch_nodes, 0
    for f in fanout:
        edges += frontier * f
        frontier = frontier * f
        nodes += frontier
    return nodes, edges


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray, *, seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray, fanout: Tuple[int, ...]) -> SampledSubgraph:
        cap_nodes, cap_edges = subgraph_capacities(len(seeds), fanout)
        local_of = {int(s): i for i, s in enumerate(seeds)}
        nodes: List[int] = list(map(int, seeds))
        src, dst = [], []
        frontier = list(map(int, seeds))
        for f in fanout:
            nxt = []
            for u in frontier:
                lo, hi = self.indptr[u], self.indptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                picks = self.rng.choice(deg, size=take, replace=False)
                for p in picks:
                    v = int(self.indices[lo + p])
                    if v not in local_of:
                        local_of[v] = len(nodes)
                        nodes.append(v)
                        nxt.append(v)
                    # message flows neighbor -> frontier node
                    src.append(local_of[v])
                    dst.append(local_of[u])
            frontier = nxt
        n, e = len(nodes), len(src)
        node_ids = np.zeros(cap_nodes, np.int64)
        node_ids[:n] = nodes
        node_mask = np.zeros(cap_nodes, np.float32)
        node_mask[:n] = 1
        edge_src = np.zeros(cap_edges, np.int32)
        edge_dst = np.zeros(cap_edges, np.int32)
        edge_mask = np.zeros(cap_edges, np.float32)
        edge_src[:e] = src
        edge_dst[:e] = dst
        edge_mask[:e] = 1
        return SampledSubgraph(node_ids, node_mask, edge_src, edge_dst, edge_mask, len(seeds))
