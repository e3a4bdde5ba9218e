"""Elastic restart: reshard a restored state onto a *different* mesh
(mirrors :mod:`repro.ckpt.elastic` over DTensor).

Scenario: a job loses ranks and restarts on fewer (or scales up).
Checkpoint leaves are stored unsharded (global arrays), so resharding is a
``distribute_tensor`` of each leaf onto the new mesh by its spec.

``plan_elastic_mesh`` picks the largest (data, model) grid that fits the
surviving rank count while keeping the model axis fixed (the TP degree is
a property of the program; DP shrinks elastically).
"""
from __future__ import annotations

from repro_torch.launch.sharding import P, Rules, distribute_tree, to_partition_specs


def plan_elastic_mesh(n_devices: int, model_parallel: int, *, device_type=None):
    """A ``("data", "model")`` DeviceMesh over the first ``data·model``
    ranks, ``data = n_devices // model_parallel``.  Every rank of the
    default group must call it; the ranks past ``data·model`` are left out
    of the mesh (they get a mesh they are not in: check
    ``mesh.get_coordinate() is None``), not hung."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import _device_type

    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep model axis {model_parallel} with only {n_devices} devices")
    data = n_devices // model_parallel
    usable = data * model_parallel
    ranks = torch.arange(usable).reshape(data, model_parallel)
    return DeviceMesh(device_type or _device_type(), ranks, mesh_dim_names=("data", "model"))


def reshard_tree(tree, logical_tree, rules: Rules, mesh):
    """Every leaf of ``tree`` (global tensors) distributed onto ``mesh`` by
    its logical spec."""
    return distribute_tree(tree, to_partition_specs(logical_tree, rules), mesh)


def replicate_tree(tree, mesh):
    """Every tensor leaf of ``tree`` replicated on ``mesh``."""
    from repro_torch import _tree

    return distribute_tree(tree, _tree.map(lambda _: P(), tree), mesh)
