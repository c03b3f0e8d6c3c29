"""Checkpoint manifest: path-based leaf records and an atomic commit (port
of ray_tpu/checkpoint/manifest.py, the `ray-tpu-ckpt-v1` format).

Structure crosses process and storage boundaries as a JSON table of key
paths, never as a pickle. Each record carries the leaf's GLOBAL shape and
dtype and how the saving world split it, so restore can reassemble the
global leaf from any number of shard files and re-slice it for another
world size.

On-disk layout for a checkpoint named `state` saved by an N-rank world:

    state-shard-00000-of-00004.npz    per-rank leaf arrays
    state-shard-00000-of-00004.json   per-rank leaf table + nbytes
    ...
    state.manifest.json               committed LAST, atomically

The files are the JAX package's byte for byte: leaves are numbered in the
order of `jax.tree_util.tree_flatten_with_path` (dict keys sorted, list
positions in order), the npz holds `leaf_{i}.npy` entries as `np.savez`
writes them, and a bf16 leaf is its raw 2-byte values under the npy descr
`'<V2'` (what `np.savez` writes for an ml_dtypes bfloat16 array) with the
record's dtype "bfloat16". numpy has no bf16, so host copies of bf16
leaves are their uint16 bits.

Commit protocol: every rank writes its shard npz + json (tmp file, fsync,
rename), then calls `try_commit`; whichever rank finds all N shard jsons
present writes the manifest the same way. A crash at any point leaves
either no manifest (the previous checkpoint stays latest) or a complete
one.
"""

from __future__ import annotations

import json
import os
import time
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

FORMAT = "ray-tpu-ckpt-v1"
BF16 = "bfloat16"
# The npy descr np.savez writes for an ml_dtypes bfloat16 array.
BF16_DESCR = "<V2"


class CheckpointError(RuntimeError):
    pass


class CheckpointNotCommitted(CheckpointError):
    """No committed manifest at the path: the save never completed (or
    crashed mid-persist). Callers fall back to the previous checkpoint."""


# -- key paths --------------------------------------------------------------

def flatten_with_paths(tree: Any) -> List[Tuple[List[dict], Any]]:
    """(encoded key path, leaf) for every leaf of nested dicts, lists and
    tuples, in `jax.tree_util.tree_flatten_with_path`'s order: dict keys
    sorted, sequence positions in order. None is an empty subtree, as in
    JAX. A path is [{"key": k} | {"idx": i}, ...]."""
    out: List[Tuple[List[dict], Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                if not isinstance(k, (str, int)):
                    raise CheckpointError(
                        f"non-JSON dict key {k!r} in checkpoint tree")
                walk(node[k], path + [{"key": k}])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [{"idx": i}])
        else:
            out.append((path, node))

    walk(tree, [])
    return out


def path_str(encoded: Sequence[dict]) -> str:
    return "/".join(str(next(iter(seg.values()))) for seg in encoded) or "."


# -- leaves -----------------------------------------------------------------

def dtype_name(leaf: Any) -> str:
    """The record's dtype: numpy's name, "bfloat16" for bf16 (JAX's
    `str(np.dtype(leaf.dtype))`); Python scalars as np.asarray takes
    them."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.dtype(getattr(leaf, "dtype", np.asarray(leaf).dtype)))


def leaf_shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", ()))


def host_array(leaf: Any) -> np.ndarray:
    """A leaf as a host array: bf16 tensors as their uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            return t.cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def shard_axis_for(shape: Tuple[int, ...], world: int) -> Optional[int]:
    """Axis 0 when the leading dim splits evenly across the world; None =
    replicated (stored by shard 0 only). Restore recomputes the rule for
    the NEW world size, so N-way and M-way layouts of the same tree both
    follow from the global shape alone."""
    if world > 1 and len(shape) >= 1 and shape[0] >= world \
            and shape[0] % world == 0:
        return 0
    return None


def leaf_records(tree: Any, world: int) -> Tuple[List[dict], List[Any]]:
    """Flatten `tree` with paths into (records, leaves). Records carry the
    GLOBAL shape and dtype and shard_axis for `world`; every rank derives
    the same table from its tree of global leaves."""
    records, leaves = [], []
    for path, leaf in flatten_with_paths(tree):
        shape = leaf_shape(leaf)
        records.append({"path": path, "global_shape": list(shape),
                        "dtype": dtype_name(leaf),
                        "shard_axis": shard_axis_for(shape, world)})
        leaves.append(leaf)
    return records, leaves


# -- file naming ------------------------------------------------------------

def shard_npz(name: str, rank: int, world: int) -> str:
    return f"{name}-shard-{rank:05d}-of-{world:05d}.npz"


def shard_meta(name: str, rank: int, world: int) -> str:
    return f"{name}-shard-{rank:05d}-of-{world:05d}.json"


def manifest_file(name: str) -> str:
    return f"{name}.manifest.json"


def has_manifest(directory: str, name: str = "state") -> bool:
    return os.path.exists(os.path.join(directory, manifest_file(name)))


# -- durable writes ---------------------------------------------------------

def _fsync_write(path: str, write_fn, fsync: bool = True) -> None:
    """Write via tmp + (fsync) + atomic rename, so readers only ever see
    absent-or-complete files."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        write_fn(f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # not all filesystems support directory fsync


def _savez(f, entries: Dict[str, Tuple[np.ndarray, bool]]) -> None:
    """np.savez's container, entry by entry as numpy writes it; a bf16
    entry (its uint16 bits) gets the header ml_dtypes' bfloat16 gets."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, bf16) in entries.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if not bf16:
                    np.lib.format.write_array(fid, arr, allow_pickle=False)
                    continue
                arr = np.ascontiguousarray(arr)
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": BF16_DESCR, "fortran_order": False,
                    "shape": arr.shape})
                fid.write(arr.tobytes())


def write_shard(directory: str, name: str, rank: int, world: int,
                records: Sequence[dict], local_leaves: Sequence,
                fsync: bool = True) -> int:
    """Persist one rank's shard: npz of its local leaf arrays + the json
    leaf table. `local_leaves[i]` (a host array; bf16 as uint16 bits) is
    None for leaves this rank does not store (replicated leaves on rank >
    0). Returns bytes written."""
    os.makedirs(directory, exist_ok=True)
    entries = {f"leaf_{i}": (np.asarray(l), rec["dtype"] == BF16)
               for i, (rec, l) in enumerate(zip(records, local_leaves))
               if l is not None}
    nbytes = int(sum(a.nbytes for a, _ in entries.values()))
    _fsync_write(os.path.join(directory, shard_npz(name, rank, world)),
                 lambda f: _savez(f, entries), fsync=fsync)
    meta = {"format": FORMAT, "name": name, "rank": rank, "world": world,
            "nbytes": nbytes, "leaves": list(records)}
    payload = json.dumps(meta).encode()
    _fsync_write(os.path.join(directory, shard_meta(name, rank, world)),
                 lambda f: f.write(payload), fsync=fsync)
    return nbytes


def try_commit(directory: str, name: str, world: int, *,
               step: Optional[int] = None, fsync: bool = True,
               extra: Optional[Dict[str, Any]] = None) -> Optional[dict]:
    """Atomically commit the manifest if (and only if) every shard's meta
    is on disk. Returns the manifest dict when THIS call committed; None
    while shards are still missing or when another rank committed first
    (exactly one caller reports the commit)."""
    path = os.path.join(directory, manifest_file(name))
    if os.path.exists(path):
        return None
    tables = []
    for rank in range(world):
        p = os.path.join(directory, shard_meta(name, rank, world))
        if not os.path.exists(p):
            return None
        with open(p) as f:
            tables.append(json.load(f))
    canonical = tables[0]["leaves"]
    for t in tables[1:]:
        if t["leaves"] != canonical:
            raise CheckpointError(
                f"shard leaf tables disagree under {directory!r}; "
                "ranks snapshotted different trees")
    manifest = {"format": FORMAT, "name": name, "world": world,
                "step": step,
                "nbytes": int(sum(t["nbytes"] for t in tables)),
                "leaves": canonical}
    if extra:
        manifest["extra"] = dict(extra)
    payload = json.dumps(manifest).encode()
    _fsync_write(path, lambda f: f.write(payload), fsync=fsync)
    _fsync_dir(directory)
    return manifest


def read_manifest(directory: str, name: str = "state") -> dict:
    path = os.path.join(directory, manifest_file(name))
    if not os.path.exists(path):
        raise CheckpointNotCommitted(
            f"no committed manifest {manifest_file(name)!r} under "
            f"{directory!r} (crashed mid-persist, or not a checkpoint)")
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise CheckpointError(
            f"unknown checkpoint format {manifest.get('format')!r}")
    return manifest


def wait_committed(directory: str, name: str, timeout: float) -> bool:
    """Poll (a cheap stat) until the manifest lands: how rank 0 learns
    that the LAST rank's commit made the checkpoint real, with no
    cross-rank message."""
    deadline = time.monotonic() + timeout
    while True:
        if has_manifest(directory, name):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.02)
