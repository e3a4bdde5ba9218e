"""Synthetic inputs (mirrors :mod:`repro.data`): numpy generators that give
arrays identical to the reference's for the same seed, and the host-side
neighbor sampler.  ``tokens`` holds the LM token stream (not re-exported,
as in the reference)."""

from repro_torch.data.sbm import sbm_graph  # noqa: F401
from repro_torch.data.pointcloud import dti_like_pointcloud  # noqa: F401
from repro_torch.data.sampler import NeighborSampler  # noqa: F401
