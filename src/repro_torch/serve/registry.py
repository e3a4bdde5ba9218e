"""Versioned embeddings — zero-downtime refresh with a health gate (mirrors
:mod:`repro.serve.registry`, on its disk format, so either package loads
the other's snapshots).

Layout (all under one directory)::

    <dir>/step_00000001/            # version 1 snapshot (ckpt/manager.py
    <dir>/step_00000002/            #   crash-consistent rename protocol)
    <dir>/ACTIVE.json               # {"version": N} — the serving pointer

* **publish** — snapshot the :class:`~repro_torch.serve.oos.ServingIndex`
  through :class:`~repro_torch.ckpt.manager.CheckpointManager`, restore it
  from disk onto the index's device, run the health gate on the restored
  copy, then swap ``ACTIVE.json`` with tmp + fsync + ``os.replace``.  A
  gate failure deletes the snapshot and leaves ACTIVE untouched: serving
  stays on the previous version.
* **load** — resolve ACTIVE (or an explicit version) to an index on
  ``device`` (the card unless the caller asks for the CPU).  A missing or
  corrupt ACTIVE falls back to the newest intact snapshot.
* **rollback** — point ACTIVE at the newest intact version below the
  current one.

A snapshot is a flat name → array dict: ``points``, ``embedding``,
``centroids``, ``labels``, the ``lsh.order``/``lsh.codes``/``lsh.ties``
tables when the index has them, and ``__meta__``, the UTF-8 JSON
``{"config": OOSConfig.to_dict()}`` as uint8.
"""
from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.kernels.lsh_candidates.ops import LshTables
from repro_torch.serve.oos import OOSConfig, ServingIndex, index_problems

ACTIVE_FILE = "ACTIVE.json"
_META_KEY = "__meta__"


class RegistryGateError(RuntimeError):
    """A published index failed its health gate; ACTIVE was not moved."""

    def __init__(self, version: int, problems: Tuple[str, ...]):
        self.version = version
        self.problems = problems
        super().__init__(
            f"index version {version} failed the health gate "
            f"({', '.join(problems)}) — rejected, serving stays on the "
            f"previous version")


def _index_to_tree(index: ServingIndex) -> dict:
    meta = json.dumps({"config": index.config.to_dict()})
    tree = {
        "points": index.points,
        "embedding": index.embedding,
        "centroids": index.centroids,
        "labels": index.labels,
        _META_KEY: np.frombuffer(meta.encode("utf-8"), np.uint8).copy(),
    }
    if index.lsh_tables is not None:
        tree["lsh.order"] = index.lsh_tables.order
        tree["lsh.codes"] = index.lsh_tables.codes
        tree["lsh.ties"] = index.lsh_tables.ties
    return tree


def _index_from_tree(tree: dict, device: torch.device) -> ServingIndex:
    meta = json.loads(bytes(np.asarray(tree[_META_KEY])).decode("utf-8"))

    def t(name):
        return torch.from_numpy(np.asarray(tree[name])).to(device)

    tables = None
    if "lsh.order" in tree:  # absent in snapshots without persisted tables
        tables = LshTables(order=t("lsh.order"), codes=t("lsh.codes"), ties=t("lsh.ties"))
    return ServingIndex(points=t("points"), embedding=t("embedding"),
                        centroids=t("centroids"), labels=t("labels"),
                        config=OOSConfig(**meta["config"]), lsh_tables=tables)


class EmbeddingRegistry:
    """Versioned :class:`ServingIndex` snapshots with an atomic ACTIVE
    pointer.  ``keep`` retains that many newest snapshots (the rollback
    window)."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._mgr = CheckpointManager(directory, keep=keep)

    # -- queries ------------------------------------------------------------

    def versions(self) -> List[int]:
        """All intact snapshot versions, ascending."""
        return [s for s in self._mgr.all_steps() if self._mgr._complete(s)]

    def active_version(self) -> Optional[int]:
        """The served version: ACTIVE.json if intact, else the newest
        snapshot."""
        path = os.path.join(self.dir, ACTIVE_FILE)
        try:
            with open(path) as f:
                v = int(json.load(f)["version"])
            if self._mgr._complete(v):
                return v
        except (OSError, ValueError, KeyError, TypeError):
            pass
        avail = self.versions()
        return avail[-1] if avail else None

    def load(self, version: Optional[int] = None, *,
             device: DeviceLike = None) -> Tuple[int, ServingIndex]:
        """(version, index on ``device``) for ``version`` (default: the
        active one)."""
        dev = resolve_device(device)
        if version is None:
            version = self.active_version()
            if version is None:
                raise FileNotFoundError(f"no intact index versions in {self.dir!r}")
        if not self._mgr._complete(version):
            raise FileNotFoundError(
                f"index version {version} is missing or incomplete in {self.dir!r}")
        return version, _index_from_tree(self._mgr.restore_dict(version), dev)

    # -- mutations ----------------------------------------------------------

    def publish(self, index: ServingIndex, *,
                health_gate: Optional[Callable[[ServingIndex], Tuple[str, ...]]]
                = index_problems) -> int:
        """Snapshot → read back → gate → atomic ACTIVE swap.  Returns the new
        version.  Raises :class:`RegistryGateError` (snapshot deleted,
        ACTIVE untouched) when the gate reports problems."""
        avail = self._mgr.all_steps()
        version = (avail[-1] if avail else 0) + 1
        self._mgr.save(version, _index_to_tree(index), blocking=True)
        restored = _index_from_tree(self._mgr.restore_dict(version), index.device)
        problems = tuple(health_gate(restored)) if health_gate else ()
        if problems:
            self._mgr.delete(version)
            raise RegistryGateError(version, problems)
        self._swap_active(version)
        return version

    def rollback(self) -> int:
        """Point ACTIVE at the newest intact version below the current one."""
        current = self.active_version()
        older = [v for v in self.versions() if current is None or v < current]
        if not older:
            raise FileNotFoundError(
                f"no intact version below {current} to roll back to in {self.dir!r}")
        self._swap_active(older[-1])
        return older[-1]

    def _swap_active(self, version: int) -> None:
        # the pointer file is either the old version or the new one, never
        # half-written
        path = os.path.join(self.dir, ACTIVE_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": version}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
