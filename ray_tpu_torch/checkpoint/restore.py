"""Reshard-on-restore: manifest -> global leaves -> the CURRENT world
(port of ray_tpu/checkpoint/restore.py).

Restore never assumes the saving topology: it reads the committed
manifest, reassembles each global leaf by concatenating its shard slices
in shard order (bit-exact), and hands the result back whole
(`restore_tree`) or re-sliced for a NEW (rank, world) (`restore_shard`).
An N-rank checkpoint therefore restores onto M ranks for any M.

Leaves come back as CPU tensors (or on `device`), one global leaf at a
time (`iter_global_leaves`): `restore_shard` and the serving loader keep
only their slice of each, so host memory peaks at the largest leaf, not
the whole tree. A leaf whose record says "bfloat16" and whose npy entry
holds 2-byte void values (what `np.savez` writes for ml_dtypes' bfloat16)
is read back as bf16 from its bits; the JAX package's own restore refuses
that leaf (its dtype check compares `|V2` with "bfloat16").

Structure comes back from the encoded key paths as nested dicts and lists,
or, with `template=`, in the template's structure (tuples, Python
scalars) after the paths are checked against it.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.checkpoint.manifest import (BF16, CheckpointError,
                                               flatten_with_paths, path_str,
                                               read_manifest, shard_axis_for,
                                               shard_npz)


class _ShardReader:
    """Lazy npz handles for one checkpoint's shard files."""

    def __init__(self, directory: str, name: str, world: int):
        self.directory = directory
        self.name = name
        self.world = world
        self._files: dict = {}

    def _file(self, rank: int):
        f = self._files.get(rank)
        if f is None:
            path = os.path.join(self.directory,
                                shard_npz(self.name, rank, self.world))
            if not os.path.exists(path):
                raise CheckpointError(
                    f"manifest committed but shard file missing: {path}")
            f = self._files[rank] = np.load(path, allow_pickle=False)
        return f

    def leaf(self, index: int, record: dict) -> np.ndarray:
        """Reassemble leaf `index` to its GLOBAL host value."""
        key = f"leaf_{index}"
        if record["shard_axis"] is None:
            return self._file(0)[key]
        parts = [self._file(r)[key] for r in range(self.world)]
        return np.concatenate(parts, axis=record["shard_axis"])

    def close(self):
        for f in self._files.values():
            try:
                f.close()
            except Exception:
                pass


def _as_tensor(arr: np.ndarray, rec: dict) -> torch.Tensor:
    """A reassembled host leaf as a CPU tensor of the record's dtype,
    owning its memory; raises where shape or dtype disagree."""
    is_bf16 = (rec["dtype"] == BF16 and arr.dtype.kind == "V"
               and arr.dtype.itemsize == 2)
    got = BF16 if is_bf16 else str(arr.dtype)
    if list(arr.shape) != list(rec["global_shape"]) or got != rec["dtype"]:
        raise CheckpointError(
            f"leaf {path_str(rec['path'])}: reassembled "
            f"{arr.shape}/{arr.dtype}, manifest says "
            f"{rec['global_shape']}/{rec['dtype']}")
    if is_bf16:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def iter_global_leaves(directory: str, name: str = "state",
                       select=None) -> Iterator[Tuple[int, dict,
                                                      torch.Tensor]]:
    """(index, record, global CPU tensor) for each leaf of the committed
    checkpoint (each whose record `select` accepts), one at a time: the
    caller drops each before the next."""
    manifest = read_manifest(directory, name)
    reader = _ShardReader(directory, name, int(manifest["world"]))
    try:
        for i, rec in enumerate(manifest["leaves"]):
            if select is None or select(rec):
                yield i, rec, _as_tensor(reader.leaf(i, rec), rec)
    finally:
        reader.close()


def _global_leaves(directory: str, name: str, device=None) -> tuple:
    manifest = read_manifest(directory, name)
    leaves = [t if device is None else t.to(device)
              for _, _, t in iter_global_leaves(directory, name)]
    return manifest, leaves


def _rebuild_from_paths(records: List[dict], leaves: List) -> Any:
    """Nested dicts and lists from the encoded paths. Containers that need
    a type (tuples come back as lists) need a `template` instead."""
    if not records:
        return {}
    if not records[0]["path"]:
        if len(records) != 1:
            raise CheckpointError("multiple leaves at the tree root")
        return leaves[0]

    def build(items):  # items: [(remaining_path, leaf)]
        first = [p[0] for p, _ in items]
        if all("key" in seg for seg in first):
            out: dict = {}
            for p, leaf in items:
                out.setdefault(p[0]["key"], []).append((p[1:], leaf))
            return {k: build(v) if v[0][0] else v[0][1]
                    for k, v in out.items()}
        if all("idx" in seg for seg in first):
            slots: dict = {}
            for p, leaf in items:
                slots.setdefault(p[0]["idx"], []).append((p[1:], leaf))
            if sorted(slots) != list(range(len(slots))):
                raise CheckpointError("non-contiguous sequence indices")
            return [build(v) if v[0][0] else v[0][1]
                    for _, v in sorted(slots.items())]
        raise CheckpointError(
            "checkpoint tree has attribute/custom container nodes; pass "
            "`template=` to restore into the original structure")

    return build([(list(r["path"]), l) for r, l in zip(records, leaves)])


def _like(t_leaf: Any, leaf: torch.Tensor) -> Any:
    """A restored leaf as a Python scalar where the template has one, else
    the tensor."""
    if isinstance(t_leaf, (bool, int, float)):
        return type(t_leaf)(leaf.item())
    return leaf


def _fill(template: Any, leaves: Iterator) -> Any:
    """`template`'s structure with its leaves replaced in flatten order."""
    if template is None:
        return None
    if isinstance(template, dict):
        filled = {k: _fill(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(v, leaves) for v in template)
    return _like(template, next(leaves))


def _unflatten_template(template: Any, records: List[dict], leaves: List,
                        global_shapes: bool = True) -> Any:
    """Check the manifest against `template`'s flatten order (paths, and
    the global shapes when `global_shapes`), then put the leaves into the
    template's structure."""
    flat = flatten_with_paths(template)
    if len(flat) != len(records):
        raise CheckpointError(
            f"template has {len(flat)} leaves, checkpoint {len(records)}")
    for (path, t_leaf), rec in zip(flat, records):
        if path != rec["path"]:
            raise CheckpointError(
                f"template/checkpoint structure mismatch: "
                f"{path_str(path)} vs {path_str(rec['path'])}")
        t_shape = tuple(int(d) for d in getattr(t_leaf, "shape", ()))
        if global_shapes and list(t_shape) != list(rec["global_shape"]):
            raise CheckpointError(
                f"leaf {path_str(path)}: template shape {t_shape}, "
                f"checkpoint {tuple(rec['global_shape'])}")
    return _fill(template, iter(leaves))


def restore_tree(directory: str, *, name: str = "state",
                 template: Any = None, device=None) -> Any:
    """Read the committed checkpoint under `directory` and return the FULL
    tree (global leaves as CPU tensors, or on `device`), however many
    ranks saved it."""
    manifest, leaves = _global_leaves(directory, name, device)
    if template is not None:
        return _unflatten_template(template, manifest["leaves"], leaves)
    return _rebuild_from_paths(manifest["leaves"], leaves)


def restore_shard(directory: str, *, rank: int, world: int,
                  name: str = "state", template: Any = None,
                  device=None) -> Any:
    """Restore onto the CURRENT topology: reassemble each global leaf, then
    keep the slice of (`rank`, `world`) by the writer's rule. The saving
    world N and the restoring world M are independent. One global leaf is
    held at a time."""
    manifest = read_manifest(directory, name)
    out = []
    for _, _, leaf in iter_global_leaves(directory, name):
        axis = shard_axis_for(tuple(leaf.shape), world)
        if axis is not None:
            per = leaf.shape[axis] // world
            leaf = leaf[rank * per:(rank + 1) * per].clone()
        out.append(leaf if device is None else leaf.to(device))
    if template is not None:
        return _unflatten_template(template, manifest["leaves"], out,
                                   global_shapes=False)
    return _rebuild_from_paths(manifest["leaves"], out)
