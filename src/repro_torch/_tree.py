"""Nested containers of tensors ("trees") in ``jax.tree.flatten``'s order.

A dict's values come in sorted-key order, a list's or tuple's in order, a
dataclass's fields in declaration order (the reference registers its
``TrainState`` with its fields in that order); anything else is a leaf.
The optimizer, the train step and the checkpoint manager walk parameter
trees with these, so a checkpoint's leaves are in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return None


def leaves(tree) -> List[Any]:
    """The tree's leaves in flatten order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with ``new_leaves`` (in flatten order) in
    place of its leaves (dicts rebuilt in sorted-key order, as
    ``jax.tree.unflatten`` builds them)."""
    it = iter(new_leaves)
    out = _rebuild(template, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template has")
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), it)
                                            for f in dataclasses.fields(tree)})
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the template has") from None


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 (jax.tree.map's name)
    """``fn`` over the leaves of ``tree`` (and of ``rest``, same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
