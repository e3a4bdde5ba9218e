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

The trees are flat dicts of arrays (numpy or torch), the one tree shape the
pipeline stores.  Leaves are in sorted-name order, as ``jax.tree.flatten``
orders a dict, and the manifest's ``treedef`` is the JSON of ``{name: leaf
index}``, which the reference's ``restore_dict`` reads.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Dict[str, object], *, blocking: bool = True) -> None:
        names = sorted(tree)
        host_leaves = [_host(tree[k]) for k in names]  # device → host snapshot
        index = {k: i for i, k in enumerate(names)}
        self.wait()  # serialize with any in-flight async save (same-step race)
        if blocking:
            self._write(step, host_leaves, index)
        else:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, host_leaves, index), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, index: Dict[str, int]) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "treedef": json.dumps(index),
            "leaves": [
                {"file": f"leaf_{i:05d}.npy", "shape": list(x.shape), "dtype": str(x.dtype)}
                for i, x in enumerate(host_leaves)
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

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
        """``(step, flat dict)`` of the newest intact checkpoint, or None."""
        for step in reversed(self.all_steps()):
            if self._complete(step):
                return step, self.restore_dict(step)
        return None

    def delete(self, step: int) -> None:
        """Drop one checkpoint (and any half-written copy of it)."""
        self.wait()
        shutil.rmtree(os.path.join(self.dir, f"step_{step:08d}"), ignore_errors=True)
        shutil.rmtree(os.path.join(self.dir, f"step_{step:08d}.tmp"), ignore_errors=True)
