"""Snapshots: device -> pinned host buffers (port of
ray_tpu/checkpoint/snapshot.py).

A train step's whole checkpoint stall is here: one copy of each local
leaf (or this rank's slice of it) into a host buffer. Serialization,
fsync and the manifest commit happen later on the plane's persister
thread against the captured buffers, so changing the live parameters
after `snapshot_shard` returns cannot corrupt the checkpoint.

Buffers come from a `BufferPool` keyed by (shape, dtype): steady
checkpointing reuses the same host memory every interval. Buffers for
CUDA leaves are pinned, so every device->host copy is queued without
waiting and the snapshot waits once, for the last of them.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.checkpoint import manifest as manifest_mod


class BufferPool:
    """Reusable host staging buffers (CPU tensors), keyed by (shape, dtype,
    pinned). `acquire` hands out a free buffer or allocates one; `release`
    returns buffers once the persist is done with them. Thread-safe: the
    train thread acquires while the persister releases."""

    def __init__(self):
        self._free: Dict[Tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()
        self.allocated = 0      # buffers ever allocated (reuse observability)
        self.acquired = 0

    @staticmethod
    def _key(shape, dtype, pinned) -> Tuple:
        return tuple(shape), dtype, bool(pinned)

    def acquire(self, shape, dtype: torch.dtype,
                pinned: bool = False) -> torch.Tensor:
        key = self._key(shape, dtype, pinned)
        with self._lock:
            self.acquired += 1
            free = self._free.get(key)
            if free:
                return free.pop()
            self.allocated += 1
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=pinned)

    def release(self, buffers) -> None:
        with self._lock:
            for buf in buffers:
                key = self._key(buf.shape, buf.dtype, buf.is_pinned())
                self._free.setdefault(key, []).append(buf)


class Snapshot:
    """A captured shard: host arrays + the leaf table that describes them.
    `leaves[i]` is None for leaves this rank does not store (replicated
    leaves on rank > 0); bf16 leaves are their uint16 bits."""

    def __init__(self, name: str, rank: int, world: int,
                 records: List[dict], leaves: List, nbytes: int,
                 snapshot_ms: float, pool: Optional[BufferPool],
                 buffers: List[torch.Tensor]):
        self.name = name
        self.rank = rank
        self.world = world
        self.records = records
        self.leaves = leaves
        self.nbytes = nbytes
        self.snapshot_ms = snapshot_ms
        self._pool = pool
        self._buffers = buffers

    def release(self) -> None:
        """Return the staging buffers to the pool (persister side, after
        the shard file is durable)."""
        if self._pool is not None:
            self._pool.release(self._buffers)
            self._pool = None
        self._buffers = []


def _local_slice(leaf, axis: Optional[int], rank: int, world: int):
    """This rank's piece of a leaf: an axis-0 slice when sharded, the whole
    leaf on rank 0 when replicated, None otherwise."""
    if axis is None:
        return leaf if rank == 0 else None
    per = leaf.shape[axis] // world
    return leaf[rank * per:(rank + 1) * per]


def snapshot_shard(tree: Any, *, rank: int = 0, world: int = 1,
                   name: str = "state",
                   pool: Optional[BufferPool] = None) -> Snapshot:
    """Capture this rank's shard of `tree` (global leaves: tensors on any
    device, numpy arrays, Python scalars) into host buffers and return.

    Leaves whose leading dim divides by `world` are sliced (each rank
    captures 1/world of the bytes); the rest are captured whole by rank 0
    only. Every device->host copy is queued first (into pinned buffers,
    without waiting), then one wait covers them all."""
    t0 = time.perf_counter()
    records, leaves = manifest_mod.leaf_records(tree, world)
    slices = [_local_slice(leaf, rec["shard_axis"], rank, world)
              for rec, leaf in zip(records, leaves)]
    buffers: List[torch.Tensor] = []
    staged: List = []
    cuda = False
    for s in slices:
        if s is None or not isinstance(s, torch.Tensor):
            staged.append(s)
            continue
        pinned = s.is_cuda
        cuda = cuda or pinned
        shape, dtype = tuple(s.shape), s.dtype
        buf = (pool.acquire(shape, dtype, pinned) if pool is not None
               else torch.empty(shape, dtype=dtype, pin_memory=pinned))
        buf.copy_(s.detach(), non_blocking=pinned)
        buffers.append(buf)
        staged.append(buf)
    if cuda:
        torch.cuda.synchronize()
    captured: List = []
    nbytes = 0
    for s in staged:
        if s is None:
            captured.append(None)
            continue
        # Host leaves (numpy, scalars) are copied: the caller may change
        # them in place after the snapshot.
        a = (manifest_mod.host_array(s) if isinstance(s, torch.Tensor)
             else np.array(manifest_mod.host_array(s)))
        captured.append(a)
        nbytes += a.nbytes
    return Snapshot(name, rank, world, records, captured, nbytes,
                    (time.perf_counter() - t0) * 1e3, pool, buffers)
