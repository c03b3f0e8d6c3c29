"""Checkpoints: directory handles, top-K retention and tree save/load
(port of ray_tpu/train/checkpoint.py).

Trees are saved in the checkpoint plane's manifest format
(ray_tpu_torch/checkpoint/: zero-pickle, reshard-on-restore), so a
checkpoint written here is one the JAX package reads, and the other way
round. The JAX package's retired layout (`{name}.npz` + a pickled JAX
treedef, `{name}.treedef.pkl`) cannot be read without jax: `load_pytree`
refuses it with a CheckpointError that names it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.checkpoint import (CheckpointError, CheckpointNotCommitted,
                                      has_manifest, restore_tree,
                                      save_sharded)


class Checkpoint:
    """A handle to a checkpoint directory."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @staticmethod
    def from_directory(path: str) -> "Checkpoint":
        return Checkpoint(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: str) -> str:
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def __repr__(self):
        return f"Checkpoint({self.path})"

    # -- tree helpers ------------------------------------------------------

    @staticmethod
    def save_pytree(tree: Any, path: str, name: str = "state") -> "Checkpoint":
        """Synchronously save `tree` in the manifest format (a 1-shard
        checkpoint: the whole tree in one npz plus a path-based JSON leaf
        table)."""
        save_sharded(tree, path, name=name, rank=0, world=1)
        return Checkpoint(path)

    def load_pytree(self, name: str = "state", template: Any = None,
                    device=None) -> Any:
        """Load a tree saved under this checkpoint in the manifest format
        (any shard count; global leaves as CPU tensors, or on `device`).
        `template` restores into its structure (tuples, Python scalars).
        The legacy treedef layout needs jax and raises."""
        if has_manifest(self.path, name):
            return restore_tree(self.path, name=name, template=template,
                                device=device)
        if os.path.exists(os.path.join(self.path, f"{name}.treedef.pkl")):
            raise CheckpointError(
                f"{self.path!r} holds the legacy {name}.npz + "
                f"{name}.treedef.pkl layout: its structure is a pickled JAX "
                "treedef, which only the JAX package can read; re-save it "
                "there in the manifest format (save_pytree)")
        raise CheckpointNotCommitted(
            f"no {name!r} checkpoint (manifest or legacy) under "
            f"{self.path!r}")


class CheckpointManager:
    """Top-K checkpoint retention under a run directory."""

    def __init__(self, run_path: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.run_path = run_path
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries: List[Tuple[float, str, Dict]] = []
        self._counter = 0
        os.makedirs(run_path, exist_ok=True)

    def register(self, source_dir: str, metrics: Dict) -> Checkpoint:
        self._counter += 1
        dest = os.path.join(self.run_path, f"checkpoint_{self._counter:06d}")
        if os.path.abspath(source_dir) != dest:
            shutil.copytree(source_dir, dest, dirs_exist_ok=True)
        with open(os.path.join(dest, "metrics.json"), "w") as f:
            json.dump({k: v for k, v in metrics.items()
                       if isinstance(v, (int, float, str, bool))}, f)
        score = float(metrics.get(self.score_attribute, self._counter)) \
            if self.score_attribute else float(self._counter)
        self._entries.append((score, dest, dict(metrics)))
        self._prune()
        return Checkpoint(dest)

    def _prune(self):
        if self.num_to_keep is None or len(self._entries) <= self.num_to_keep:
            return
        reverse = self.score_order == "max"
        ranked = sorted(self._entries, key=lambda e: e[0], reverse=reverse)
        keep = ranked[:self.num_to_keep]
        # The most recent checkpoint is never pruned, even when it scores
        # worst: resume paths read `latest_checkpoint`, which must not
        # point at a deleted directory.
        latest = self._entries[-1]
        if latest not in keep:
            if keep:
                keep[-1] = latest
            else:
                keep = [latest]
        for entry in self._entries:
            if entry not in keep:
                shutil.rmtree(entry[1], ignore_errors=True)
        self._entries = [e for e in self._entries if e in keep]

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        reverse = self.score_order == "max"
        best = sorted(self._entries, key=lambda e: e[0], reverse=reverse)[0]
        return Checkpoint(best[1])

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return Checkpoint(self._entries[-1][1])
