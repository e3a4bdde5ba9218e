"""Logical-axis sharding shared by all models (mirrors
:mod:`repro.launch.sharding` over DTensor).

Models annotate activations with *logical* axis names
(``constrain(x, "batch", "seq", "embed")``); the launcher installs a rule set
mapping logical names to mesh dimension names.  With no rules installed
(unit tests, single-device runs) annotation is the identity, and so it is
for a tensor that is not a ``DTensor``: model code never depends on a mesh
being present, and every single-device path runs exactly as it would
without this module.

Parameter trees get specs the same way: ``logical_specs`` functions tag each
leaf with logical axes via :class:`logical_spec`, and
:func:`to_partition_specs` resolves the tags against rules.  A resolved
:class:`PartitionSpec` holds, for each tensor dim, a mesh dim name, a tuple
of them, or None — the reference's ``jax.sharding.PartitionSpec`` entries —
and :func:`placements` turns it into DTensor placements on a
``DeviceMesh``: one ``Shard(tensor dim)`` or ``Replicate()`` a mesh dim.
"""
from __future__ import annotations

import contextlib
import math
import types
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicate)
Rules = Dict[str, Optional[str | Tuple[str, ...]]]

# the installed rules and mesh: process-wide, not thread-local — the
# backward pass (a checkpointed layer's recompute included) runs on the
# autograd engine's device threads, and must see what the forward saw
_state = types.SimpleNamespace(rules=None, mesh=None)


DEFAULT_RULES: Rules = {
    # data-parallel axes
    "batch": ("pod", "data"),
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "points": ("pod", "data"),
    # tensor-parallel axes
    "embed": None,
    "heads": "model",
    "kv_heads": None,  # GQA: kv head count < model axis -> replicate
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "table_rows": "model",  # recsys embedding tables: row (hash) sharded
    "feat": None,
    # equivariant-GNN irrep features: channel multiplicity over the TP axis
    "channels": "model",
    "seq": None,
    # KV caches shard their sequence dim over the TP axis
    "kv_seq": "model",
    "candidates": ("pod", "data"),
    "clusters": None,
}


class PartitionSpec(tuple):
    """A resolved spec: one entry a tensor dim (mesh dim name, tuple of
    names, or None), trailing Nones trimmed by :func:`resolve` — the
    entries of the reference's ``P``."""

    def __new__(cls, *entries):
        # a one-name tuple is that name, as jax normalizes it
        entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def current_rules() -> Optional[Rules]:
    return _state.rules


def current_mesh():
    return _state.mesh


@contextlib.contextmanager
def axis_rules(rules: Rules, mesh=None):
    """Install logical→mesh axis rules (and optionally the mesh) for model code."""
    prev_r, prev_m = _state.rules, _state.mesh
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = prev_r
        _state.mesh = prev_m


def resolve(logical_axes: Sequence[Optional[str]], rules: Optional[Rules] = None) -> PartitionSpec:
    rules = current_rules() if rules is None else rules
    if rules is None:
        return P()
    out = [None if ax is None else rules.get(ax) for ax in logical_axes]
    while out and out[-1] is None:  # trim trailing Nones, as the reference does
        out.pop()
    return P(*out)


def placements(spec: Sequence, mesh, ndim: int) -> List:
    """DTensor placements of a ``ndim``-dim tensor laid out by ``spec`` on
    ``mesh``: for each mesh dim, ``Shard(d)`` where entry ``d`` of the spec
    names it, else ``Replicate()``.  A tuple entry shards one tensor dim
    over several mesh dims, the first the major one (as JAX orders them):
    DTensor shards a dim over mesh dims in mesh order, so the tuple's names
    must come in the mesh's order.  A mesh dim of one rank is always
    ``Replicate()``.  A spec naming a mesh dim twice, a dim the mesh lacks,
    or more dims than the tensor has raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the tensor's {ndim} dims")
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names mesh dim {a!r}; the mesh has {names}")
            if a in seen:
                raise ValueError(f"spec {tuple(spec)} names mesh dim {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's dim order {names}")
        for i in idx:
            # a mesh dim of one rank holds the whole dim: replicated, so no
            # view or strategy has to reason about a one-way shard
            out[i] = Shard(d) if mesh.size(i) > 1 else Replicate()
    return out


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axes: the identity when no rules
    are installed or ``x`` is not a DTensor, else ``x`` redistributed to the
    placements the axes resolve to (a dim those mesh dims do not divide
    evenly left unsharded)."""
    rules = current_rules()
    from torch.distributed.tensor import DTensor, Replicate

    if rules is None or not isinstance(x, DTensor):
        return x
    mesh = current_mesh() or x.device_mesh
    want = placements(resolve(logical_axes, rules), mesh, x.ndim)
    for d in {p.dim for p in want if p.is_shard()}:
        # a dim the mesh dims do not divide evenly stays replicated: a view
        # cannot reshape an uneven shard (GSPMD pads instead)
        on = [i for i, p in enumerate(want) if p.is_shard(d)]
        if x.shape[d] % math.prod(mesh.size(i) for i in on):
            want = [Replicate() if i in on else p for i, p in enumerate(want)]
    have = tuple(x.placements)
    if tuple(want) == have:
        return x
    if all(w == h or mesh.size(i) == 1 for i, (w, h) in enumerate(zip(want, have))):
        # differences only on mesh dims of one rank: relabel, move nothing
        return DTensor.from_local(x.to_local(), mesh, want, run_check=False)
    return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# parameter logical specs
# ---------------------------------------------------------------------------

class logical_spec(tuple):
    """A tuple of logical axis names tagged onto a param leaf's metadata tree."""


def _is_spec_leaf(x) -> bool:
    return isinstance(x, (logical_spec, PartitionSpec)) or x is None


def spec_map(fn, spec_tree, *rest):
    """``fn`` over a tree of specs (``logical_spec``/``PartitionSpec`` leaves,
    or None), with the matching subtrees of ``rest`` — the port's
    ``jax.tree.map(..., is_leaf=...)`` over spec trees."""
    if _is_spec_leaf(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, spec_tree[k], *[r[k] for r in rest]) for k in spec_tree}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(spec_map(fn, s, *[r[i] for r in rest])
                               for i, s in enumerate(spec_tree))
    import dataclasses

    if dataclasses.is_dataclass(spec_tree):
        return dataclasses.replace(spec_tree, **{
            f.name: spec_map(fn, getattr(spec_tree, f.name), *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(spec_tree)})
    return spec_tree  # a static field (an int, a string)


def to_partition_specs(logical_tree, rules: Rules):
    """Map a tree of ``logical_spec`` tuples to PartitionSpecs."""
    return spec_map(lambda ls: ls if ls is None else resolve(ls, rules), logical_tree)


def distribute_tree(tree, spec_tree, mesh):
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` laid out by the
    matching spec of ``spec_tree`` (None: replicated)."""
    from torch.distributed.tensor import distribute_tensor

    def put(spec, x):
        if not isinstance(x, torch.Tensor):
            return x
        return distribute_tensor(x, mesh, placements(spec or P(), mesh, x.ndim))

    return spec_map(put, spec_tree, tree)
