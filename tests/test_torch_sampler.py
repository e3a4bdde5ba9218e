"""The port's neighbor sampler (``repro_torch.data.sampler``) against the
reference's (``repro.data.sampler``): the same seed draws the same
subgraph, bitwise, and the capacities are the static shapes the step
wants (the checks of ``tests/test_arch_smoke.py``)."""
import dataclasses

import numpy as np
import pytest

from repro.data.sampler import NeighborSampler as JSampler
from repro.data.sampler import subgraph_capacities as j_caps
from repro.data.sbm import sbm_graph
from repro.sparse.formats import coo_to_csr
from repro_torch.data import NeighborSampler
from repro_torch.data.sampler import SampledSubgraph, subgraph_capacities


@pytest.fixture(scope="module")
def csr():
    coo, _ = sbm_graph(100, 5, 0.2, 0.02, seed=3)
    c = coo_to_csr(coo)
    return np.asarray(c.indptr), np.asarray(c.indices)


@pytest.mark.parametrize("fanout", [(5, 3), (15, 10), (2,), (4, 4, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_bitwise_equal_to_reference(csr, fanout, seed):
    indptr, indices = csr
    seeds = np.random.default_rng(seed).choice(len(indptr) - 1, 16, replace=False)
    got_s, want_s = NeighborSampler(indptr, indices, seed=seed), JSampler(indptr, indices,
                                                                         seed=seed)
    for _ in range(2):  # the generator's state carries over from call to call
        got, want = got_s.sample(seeds, fanout), want_s.sample(seeds, fanout)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(SampledSubgraph):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_sampler_capacities(csr):
    """The sampler produces exactly the static shapes the step wants."""
    indptr, indices = csr
    s = NeighborSampler(indptr, indices, seed=0)
    sub = s.sample(np.arange(16), (5, 3))
    cn, ce = subgraph_capacities(16, (5, 3))
    assert sub.edge_src.shape == (ce,) and sub.node_ids.shape == (cn,)
    k = int(sub.edge_mask.sum())
    assert 0 < k <= ce
    # all edges point into sampled local node ids
    assert sub.edge_dst[:k].max() < sub.node_mask.sum()
    assert sub.edge_src[:k].max() < sub.node_mask.sum()
    assert sub.seed_count == 16 and (sub.node_ids[:16] == np.arange(16)).all()


@pytest.mark.parametrize("batch,fanout", [(16, (5, 3)), (1024, (15, 10)), (7, (1,)), (3, ())])
def test_subgraph_capacities_match_reference(batch, fanout):
    assert subgraph_capacities(batch, fanout) == j_caps(batch, fanout)
    assert subgraph_capacities(1024, (15, 10)) == (169984, 168960)


def test_isolated_seed_draws_no_edge():
    indptr = np.array([0, 0, 2, 3], np.int64)  # node 0 has no neighbor
    indices = np.array([2, 0, 1], np.int32)
    got = NeighborSampler(indptr, indices, seed=0).sample(np.array([0]), (3,))
    want = JSampler(indptr, indices, seed=0).sample(np.array([0]), (3,))
    assert got.edge_mask.sum() == 0 and got.node_mask.sum() == 1
    np.testing.assert_array_equal(got.node_ids, want.node_ids)
