"""Production mesh construction (mirrors :mod:`repro.launch.mesh` over
``torch.distributed``'s ``DeviceMesh``).

FUNCTIONS, not module constants: importing this module touches no process
group.  Each call needs an initialized default group of the mesh's size
(``torchrun``'s ranks, a one-rank group, or the dry-run's fake group).
"""
from __future__ import annotations


def _device_type() -> str:
    import torch.distributed as dist

    backend = dist.get_backend()
    if backend == "nccl":
        return "cuda"
    return "cpu"


def make_mesh(shape, names, device_type=None):
    """``init_device_mesh`` over the default group's ranks, row-major."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16×16 = 256 ranks a pod; multi-pod adds a leading 2-pod axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_smoke_mesh(data: int = 2, model: int = 2, device_type=None):
    """A small (data, model) mesh for multi-rank tests."""
    return make_mesh((data, model), ("data", "model"), device_type)


def mesh_shape(mesh) -> dict:
    """``{dim name: size}``, the reference's ``dict(mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def rules_for_mesh(mesh, base=None):
    """Filter logical-axis rules to the axes this mesh actually has
    (reads only ``mesh.mesh_dim_names``)."""
    from repro_torch.launch.sharding import DEFAULT_RULES

    base = dict(DEFAULT_RULES if base is None else base)
    names = set(mesh.mesh_dim_names)
    out = {}
    for k, v in base.items():
        if v is None:
            out[k] = None
        elif isinstance(v, tuple):
            kept = tuple(a for a in v if a in names)
            out[k] = kept if kept else None
        else:
            out[k] = v if v in names else None
    return out
