"""Checkpoint manager (mirrors :mod:`repro.ckpt.manager`, on the same disk
format, so either package restores the other's checkpoints).

* **crash consistency** — writes go to ``step_XXXXXXXX.tmp/`` and are renamed
  to ``step_XXXXXXXX/`` only after every leaf file and the manifest are
  fsynced; a half-written checkpoint is never restored;
* **async** — ``save(..., blocking=False)`` snapshots to host memory at once
  and writes in a background thread; ``wait()`` joins it;
* **retention** — the ``keep`` newest checkpoints stay, older ones go.

Layout::

    <dir>/step_00000100/manifest.json
    <dir>/step_00000100/leaf_00000.npy ...

A tree is nested dicts, lists and dataclasses (a ``TrainState``) over
arrays (numpy or torch).  Leaves are written in ``jax.tree.flatten``'s order
(:mod:`repro_torch._tree`: dict keys sorted, then a dataclass's fields in
order), and the manifest's ``treedef`` is the JSON the reference writes:
``{name: leaf index}`` for a flat dict — which ``restore_dict`` reads with
no template — and the repr of the index tree for a dataclass.  bfloat16
leaves are written as the reference writes them (2-byte void records,
manifest dtype ``bfloat16``).  ``restore(step, template)`` puts the leaves
back into a template tree of either package: a reference ``TrainState``
checkpoint restores into the port's and back.

On a mesh the leaves are DTensors: ``save`` gathers each one whole (every
rank of the mesh calls it) and only global rank 0 writes, and ``restore``
into a DTensor template distributes each leaf onto the template leaf's mesh
and placements — whatever mesh the checkpoint was written from, which is
the elastic restart's resharding (:mod:`repro_torch.ckpt.elastic`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import _tree


def _host(x) -> np.ndarray:
    """A host copy of a leaf (never a view: the caller may go on updating
    the tensor in place while an async save writes)."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:  # numpy has no bfloat16: its 2-byte records
        return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()


def _leaf(a: np.ndarray, dtype: str, like) -> Any:
    """A restored leaf: a tensor on ``like``'s device when the template's
    leaf is a tensor, else the numpy array."""
    if not isinstance(like, torch.Tensor):
        return a
    from torch.distributed.tensor import DTensor, distribute_tensor

    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if isinstance(like, DTensor):
        return distribute_tensor(t.to(like.device), like.device_mesh, like.placements)
    return t.to(like.device)


def _writes(leaves) -> bool:
    """Whether this process writes a tree with these leaves: always, unless
    they hold DTensors — then global rank 0 alone."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not any(isinstance(x, DTensor) for x in leaves):
        return True
    return dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        leaves = _tree.leaves(tree)
        dtypes = ["bfloat16" if getattr(x, "dtype", None) == torch.bfloat16 else None
                  for x in leaves]
        writes = _writes(leaves)
        host_leaves = [_host(x) for x in leaves]  # device → host snapshot
        if not writes:
            return
        index = _tree.unflatten(tree, range(len(leaves)))
        self.wait()  # serialize with any in-flight async save (same-step race)
        args = (step, host_leaves, dtypes, index)
        if blocking:
            self._write(*args)
        else:
            self._thread = threading.Thread(target=self._write, args=args, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, dtypes, index) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "treedef": json.dumps(index, default=repr),
            "leaves": [
                {"file": f"leaf_{i:05d}.npy", "shape": list(x.shape),
                 "dtype": dt or str(x.dtype)}
                for i, (x, dt) in enumerate(zip(host_leaves, dtypes))
            ],
        }
        for i, x in enumerate(host_leaves):
            with open(os.path.join(tmp, f"leaf_{i:05d}.npy"), "wb") as f:
                np.save(f, x)
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _complete(self, step: int) -> bool:
        p = os.path.join(self.dir, f"step_{step:08d}")
        mf = os.path.join(p, "manifest.json")
        if not os.path.exists(mf):
            return False
        try:
            with open(mf) as f:
                manifest = json.load(f)
            return all(os.path.exists(os.path.join(p, leaf["file"]))
                       for leaf in manifest["leaves"])
        except (OSError, ValueError, KeyError, TypeError):
            return False

    def restore_dict(self, step: int) -> Dict[str, np.ndarray]:
        """The flat dict saved at ``step``, as numpy arrays: the manifest's
        ``treedef`` is literal JSON ``{name: leaf index}``."""
        p = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(p, "manifest.json")) as f:
            manifest = json.load(f)
        try:
            index = json.loads(manifest["treedef"])
        except json.JSONDecodeError as e:
            raise ValueError(
                f"checkpoint step {step} was not saved from a flat dict (treedef is not "
                f"literal JSON)") from e
        if not isinstance(index, dict):
            raise ValueError(
                f"checkpoint step {step} holds a {type(index).__name__} tree, not a flat dict")
        leaves = [np.load(os.path.join(p, leaf["file"])) for leaf in manifest["leaves"]]
        return {name: leaves[i] for name, i in index.items()}

    def restore(self, step: int, example_tree: Any) -> Any:
        """The tree saved at ``step`` in ``example_tree``'s structure (leaves
        in flatten order): a tensor leaf of the template comes back as a
        tensor on its device, in the saved dtype; other leaves as numpy."""
        p = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(p, "manifest.json")) as f:
            manifest = json.load(f)
        like = _tree.leaves(example_tree)
        if len(like) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint step {step} holds {len(manifest['leaves'])} leaves, "
                             f"the template {len(like)}")
        leaves = [_leaf(np.load(os.path.join(p, leaf["file"])), leaf["dtype"], t)
                  for leaf, t in zip(manifest["leaves"], like)]
        return _tree.unflatten(example_tree, leaves)

    def restore_latest(self, example_tree: Any = None) -> Optional[Tuple[int, Any]]:
        """``(step, tree)`` of the newest intact checkpoint, or None: the tree
        in ``example_tree``'s structure, or without a template the flat dict
        (``restore_dict``)."""
        for step in reversed(self.all_steps()):
            if self._complete(step):
                if example_tree is None:
                    return step, self.restore_dict(step)
                return step, self.restore(step, example_tree)
        return None

    def delete(self, step: int) -> None:
        """Drop one checkpoint (and any half-written copy of it)."""
        self.wait()
        shutil.rmtree(os.path.join(self.dir, f"step_{step:08d}"), ignore_errors=True)
        shutil.rmtree(os.path.join(self.dir, f"step_{step:08d}.tmp"), ignore_errors=True)
