"""A mesh's train state through the `ray-tpu-ckpt-v1` format.

    save_state(state, specs, mesh, directory)        # every rank calls it
    state = restore_state(directory, specs, mesh)    # any world, any mesh

`state` and `specs` are what `fsdp.build_train_step`'s `init_fn` returns.
The file layout is the JAX package's and does not depend on the mesh:
leaf by leaf, each rank all-gathers the global leaf over the mesh axes of
its spec, then writes the axis-0 piece that `shard_axis_for(shape, world)`
gives it (replicated leaves on rank 0), so one global leaf at a time sits
on the device. The tree written is {"params", "opt", "step"} ("opt" is the
AdamW state: count, mu, nu), the same keys as the single-card state of
`train/step.py` plus the step count.

Restore reads each global leaf back (reassembled from however many shards
wrote it) and keeps this rank's slice of it under the new mesh's spec, so
training resumes on another mesh shape or world size.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.checkpoint import manifest as manifest_mod
from ray_tpu_torch.checkpoint.restore import (_rebuild_from_paths,
                                              iter_global_leaves)
from ray_tpu_torch.checkpoint.snapshot import _local_slice
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import mesh_device
from ray_tpu_torch.parallel.sharding import shard

_KEYS = {"params": "params", "opt": "opt_state", "step": "step"}


def _file_tree(tree: Dict) -> Dict:
    """The state (or its specs) under the file's keys."""
    return {k: tree[v] for k, v in _KEYS.items()}


def _at(tree: Any, path: List[dict]) -> Any:
    for seg in path:
        tree = tree[seg["key"] if "key" in seg else seg["idx"]]
    return tree


def save_state(state: Dict, specs: Dict, mesh, directory: str, *,
               name: str = "state", step: Optional[int] = None,
               fsync: bool = True) -> dict:
    """Every rank of the mesh's world writes its shard of the global train
    state; returns once the manifest is committed (a barrier), with this
    rank's {"bytes", "committed"}."""
    rank, world = dist.get_rank(), dist.get_world_size()
    tree, spec_tree = _file_tree(state), _file_tree(specs)
    records, pieces = [], []
    for path, leaf in manifest_mod.flatten_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            for dim, axes in enumerate(_at(spec_tree, path)):
                leaf = col.gather_global(leaf.detach(), mesh, dim, axes)
        shape = manifest_mod.leaf_shape(leaf)
        axis = manifest_mod.shard_axis_for(shape, world)
        records.append({"path": path, "global_shape": list(shape),
                        "dtype": manifest_mod.dtype_name(leaf),
                        "shard_axis": axis})
        piece = _local_slice(leaf, axis, rank, world)
        pieces.append(None if piece is None
                      else manifest_mod.host_array(piece))
    nbytes = manifest_mod.write_shard(directory, name, rank, world, records,
                                      pieces, fsync=fsync)
    committed = manifest_mod.try_commit(directory, name, world,
                                        step=state["step"] if step is None
                                        else step, fsync=fsync)
    dist.barrier()
    if not manifest_mod.has_manifest(directory, name):
        raise manifest_mod.CheckpointError(
            f"no manifest under {directory!r} after every rank wrote")
    return {"bytes": nbytes, "committed": committed is not None}


def restore_state(directory: str, specs: Dict, mesh, *,
                  name: str = "state") -> Dict:
    """This rank's train state under `mesh` and `specs` (the new mesh's
    `init_fn` specs) from a checkpoint any world wrote. Parameters require
    grad; the AdamW count and the step come back as Python ints."""
    spec_tree = _file_tree(specs)
    dev = mesh_device(mesh)
    records, leaves = [], []
    for _, rec, leaf in iter_global_leaves(directory, name):
        if leaf.dim() == 0 and not leaf.is_floating_point():
            leaf = int(leaf.item())
        else:
            leaf = shard(leaf, _at(spec_tree, rec["path"]), mesh).to(
                dev, copy=True).contiguous()
            if rec["path"][0] == {"key": "params"}:
                leaf.requires_grad_(True)
        records.append(rec)
        leaves.append(leaf)
    tree = _rebuild_from_paths(records, leaves)
    return {v: tree[k] for k, v in _KEYS.items()}

