"""The frozen data generator gives the port's loader's arrays, value for
value."""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.data.pointcloud import dti_like_pointcloud
from specbench.datasets.dti_points import dti_points, make


@pytest.mark.parametrize("n,d,regions,seed", [(1000, 90, 12, 0), (4000, 16, 250, 2**31 + 11),
                                              (20000, 8, 40, 3_000_000_019)])
def test_frozen_generator_is_the_ports(n, d, regions, seed):
    pos, prof, region = dti_points(n, d, regions, seed)
    want = dti_like_pointcloud(n, d, regions, neighbors="none", seed=seed, device="cpu")
    np.testing.assert_array_equal(pos, want[0].numpy())
    np.testing.assert_array_equal(prof, want[1].numpy())
    np.testing.assert_array_equal(region, want[3].numpy())
    assert pos.dtype == prof.dtype == np.float32


def test_make_gives_the_generators_arrays_as_tensors():
    params = {"maker": "dti_points", "n_points": 1000, "d_profile": 12, "n_regions": 7}
    d = make(params, 2**40 + 3)
    pos, prof, _ = dti_points(1000, 12, 7, 2**40 + 3)
    assert np.array_equal(d["points"].numpy(), pos)
    assert np.array_equal(d["features"].numpy(), prof)
