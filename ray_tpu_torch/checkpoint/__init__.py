"""Async sharded checkpoints in the JAX package's `ray-tpu-ckpt-v1` format
(port of ray_tpu/checkpoint/).

- `snapshot`  device -> pinned host buffers; the only part a train step
              waits for.
- `manifest`  path-based (zero-pickle) leaf tables, per-rank shard files,
              atomic manifest commit; the JAX package's bytes.
- `restore`   manifest -> global leaves, one at a time -> re-sliced for
              the CURRENT world size (reshard-on-restore, N -> M ranks).
- `plane`     the background persister tying them together.

A mesh's train state goes through the format with
`parallel.checkpoint.save_state` / `restore_state`.
"""

from ray_tpu_torch.checkpoint.manifest import (
    CheckpointError,
    CheckpointNotCommitted,
    FORMAT,
    has_manifest,
    read_manifest,
    shard_axis_for,
)
from ray_tpu_torch.checkpoint.plane import (
    CheckpointPlane,
    PendingSave,
    save_sharded,
)
from ray_tpu_torch.checkpoint.restore import restore_shard, restore_tree
from ray_tpu_torch.checkpoint.snapshot import (BufferPool, Snapshot,
                                               snapshot_shard)

__all__ = [
    "BufferPool",
    "CheckpointError",
    "CheckpointNotCommitted",
    "CheckpointPlane",
    "FORMAT",
    "PendingSave",
    "Snapshot",
    "has_manifest",
    "read_manifest",
    "restore_shard",
    "restore_tree",
    "save_sharded",
    "shard_axis_for",
    "snapshot_shard",
]
