"""The checkpoint plane: async save = snapshot now, persist in the
background (port of ray_tpu/checkpoint/plane.py).

`save_async` stalls the caller for the device->host snapshot only
(snapshot.py), then hands the captured buffers to a daemon persister
thread, which

  1. writes this rank's shard npz + leaf table (tmp + fsync + rename),
  2. with replication on, replicates the completed shard to the peer
     nodes' object stores through the `util/broadcast.py` fanout tree and
     registers the replica object in the GCS drain relocation table, so
     a draining node's shards are already elsewhere when its deadline
     kill lands (a failed replication never fails the save),
  3. tries the atomic manifest commit (manifest.py: whichever rank lands
     last commits; a crash anywhere leaves the previous checkpoint valid).

Rank 0's handle also waits (bounded, by cheap stat polls) for the commit
when another rank lands it, so exactly one rank can report "checkpoint
real" without any cross-rank message.

The JAX package's `ray_tpu.config` knobs `ckpt_fsync` and
`ckpt_commit_wait_s` are keyword arguments here with the same defaults
(`fsync=True`, `commit_wait_s=60`); `replicate` defaults to the port's
`cfg().ckpt_replicate` (read at each persist, as JAX reads it), and
`cfg().ckpt_replicate_timeout_s` bounds a shard's fanout.
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import threading
import time
from typing import Any, Callable, List, Optional

from ray_tpu_torch.checkpoint import manifest as manifest_mod
from ray_tpu_torch.checkpoint import snapshot as snapshot_mod
from ray_tpu_torch.checkpoint.manifest import CheckpointError

logger = logging.getLogger(__name__)


class PendingSave:
    """Handle for one rank's in-flight save. `wait()` blocks until the
    background persist finished (NOT until the global commit; rank 0's
    handle observes the commit through `committed`)."""

    def __init__(self, directory: str, name: str, rank: int, world: int,
                 step: Optional[int], snapshot_ms: float, nbytes: int):
        self.directory = directory
        self.name = name
        self.rank = rank
        self.world = world
        self.step = step
        self.snapshot_ms = snapshot_ms
        self.nbytes = nbytes
        self.persist_ms = 0.0
        # {"nodes", "ms", "bytes", "oid", "parts_ms"} of this shard's
        # replication, or None (replication off, or it failed).
        self.replica: Optional[dict] = None
        self.committed = False
        self.error: Optional[BaseException] = None
        self.done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    @property
    def ok(self) -> bool:
        return self.done.is_set() and self.error is None

    def info(self) -> dict:
        return {"directory": self.directory, "name": self.name,
                "rank": self.rank, "world": self.world, "step": self.step,
                "snapshot_ms": self.snapshot_ms,
                "persist_ms": self.persist_ms, "bytes": self.nbytes,
                "committed": self.committed, "ok": self.ok}


class CheckpointPlane:
    """Per-process checkpoint pipeline: one staging-buffer pool + one
    background persister thread, shared by every save this process
    makes."""

    def __init__(self, *, reuse_buffers: bool = True, fsync: bool = True,
                 commit_wait_s: float = 60.0,
                 replicate: Optional[bool] = None):
        self.fsync = fsync
        self.commit_wait_s = commit_wait_s
        self.replicate = replicate
        # Replica shard objects stay referenced here so the object plane
        # keeps them alive across the drain window (bounded: old
        # checkpoints age out of the deque and become collectable).
        self._replica_refs: "collections.deque" = collections.deque(
            maxlen=32)
        self._pool = snapshot_mod.BufferPool() if reuse_buffers else None
        self._queue: "queue.Queue" = queue.Queue()
        self._pending: List[PendingSave] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- public API --------------------------------------------------------

    def _snapshot(self, tree, directory, name, rank, world, step):
        snap = snapshot_mod.snapshot_shard(tree, rank=rank, world=world,
                                           name=name, pool=self._pool)
        pending = PendingSave(os.path.abspath(directory), name, rank, world,
                              step, snap.snapshot_ms, snap.nbytes)
        with self._lock:
            self._pending.append(pending)
        return snap, pending

    def save_async(self, tree: Any, directory: str, *, name: str = "state",
                   rank: int = 0, world: int = 1,
                   step: Optional[int] = None,
                   wait_commit: Optional[bool] = None,
                   on_done: Optional[Callable[[dict], None]] = None
                   ) -> PendingSave:
        """Snapshot `tree`'s (rank, world) shard into host buffers and
        return; persistence happens on the background thread. The caller
        stalls only for the device->host copy."""
        if self._closed:
            raise CheckpointError("checkpoint plane is closed")
        snap, pending = self._snapshot(tree, directory, name, rank, world,
                                       step)
        if wait_commit is None:
            wait_commit = rank == 0
        self._ensure_thread()
        self._queue.put((snap, pending, wait_commit, on_done))
        return pending

    def save_sync(self, tree: Any, directory: str, *, name: str = "state",
                  rank: int = 0, world: int = 1,
                  step: Optional[int] = None) -> PendingSave:
        """Snapshot AND persist inline on the calling thread (the
        synchronous baseline, and the flush-at-exit path)."""
        if self._closed:
            raise CheckpointError("checkpoint plane is closed")
        snap, pending = self._snapshot(tree, directory, name, rank, world,
                                       step)
        self._persist(snap, pending, wait_commit=False, on_done=None)
        if pending.error is not None:
            raise pending.error
        return pending

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every in-flight persist finished. True iff all
        completed without error inside the timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        while True:
            with self._lock:
                pendings = list(self._pending)
            if not pendings:
                return ok
            for p in pendings:
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if not p.done.wait(remaining):
                    return False
                ok = ok and p.error is None
            # Loop: a save issued while we waited joins the flush.

    def close(self) -> None:
        self._closed = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=5)

    # -- persister ---------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="ckpt-persister", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            self._persist(*job)

    def _persist(self, snap, pending: PendingSave, wait_commit: bool,
                 on_done: Optional[Callable[[dict], None]]) -> None:
        t0 = time.perf_counter()
        try:
            manifest_mod.write_shard(
                pending.directory, pending.name, pending.rank, pending.world,
                snap.records, snap.leaves, fsync=self.fsync)
            if self._replicating():
                self._replicate_shard(pending)
            pending.committed = manifest_mod.try_commit(
                pending.directory, pending.name, pending.world,
                step=pending.step, fsync=self.fsync) is not None
        except Exception as e:  # surfaced on the handle
            pending.error = e
            logger.warning("checkpoint persist failed for %s",
                           pending.directory, exc_info=True)
        pending.persist_ms = (time.perf_counter() - t0) * 1e3
        snap.release()
        if pending.error is None and not pending.committed and wait_commit:
            # This rank's shard is durable but another rank holds the last
            # one. Watch for that commit OFF the persister thread: blocking
            # here would starve queued saves (and, when several ranks share
            # one process, the very save that commits).
            threading.Thread(
                target=self._await_commit, args=(pending, on_done),
                name="ckpt-commit-wait", daemon=True).start()
        else:
            self._finalize(pending, on_done)

    def _await_commit(self, pending: PendingSave,
                      on_done: Optional[Callable[[dict], None]]) -> None:
        try:
            pending.committed = manifest_mod.wait_committed(
                pending.directory, pending.name, self.commit_wait_s)
        except Exception as e:
            pending.error = e
        self._finalize(pending, on_done)

    def _finalize(self, pending: PendingSave,
                  on_done: Optional[Callable[[dict], None]]) -> None:
        with self._lock:
            try:
                self._pending.remove(pending)
            except ValueError:
                pass
        pending.done.set()
        if on_done is not None:
            try:
                on_done(pending.info())
            except Exception:
                logger.warning("checkpoint on_done callback failed",
                               exc_info=True)

    def _replicating(self) -> bool:
        if self.replicate is not None:
            return self.replicate
        from ray_tpu_torch.config import cfg

        return cfg().ckpt_replicate

    def _replicate_shard(self, pending: PendingSave) -> int:
        """Fan the durable shard bytes out to peer object stores and
        register the replica in the GCS drain relocation table.
        Best-effort: a failed replication never fails the save."""
        try:
            import numpy as np

            from ray_tpu_torch.config import cfg
            from ray_tpu_torch.core import api
            from ray_tpu_torch.core import worker as worker_mod
            from ray_tpu_torch.util.broadcast import broadcast_object

            if not api.is_initialized():
                return 0
            t = [time.perf_counter()]
            path = os.path.join(
                pending.directory,
                manifest_mod.shard_npz(pending.name, pending.rank,
                                       pending.world))
            data = np.fromfile(path, dtype=np.uint8)
            t.append(time.perf_counter())
            ref = api.put(data)
            t.append(time.perf_counter())
            covered = broadcast_object(
                ref, timeout=cfg().ckpt_replicate_timeout_s)
            t.append(time.perf_counter())
            core = worker_mod.global_worker()
            core.io.run(core.gcs.call(
                "register_checkpoint_shards",
                path=pending.directory, name=pending.name,
                shard=pending.rank, world=pending.world, step=pending.step,
                nbytes=int(data.nbytes), oids=[ref.binary()],
                node_id=core.node_id), timeout=10)
            t.append(time.perf_counter())
            self._replica_refs.append(ref)
            parts = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
            pending.replica = {
                "nodes": covered, "bytes": int(data.nbytes),
                "ms": (t[-1] - t[0]) * 1e3, "oid": ref.binary().hex(),
                "parts_ms": dict(zip(("read", "put", "relay", "register"),
                                     parts))}
            return covered
        except Exception:
            logger.warning("checkpoint shard replication failed for %s",
                           pending.directory, exc_info=True)
            return 0


def save_sharded(tree: Any, directory: str, *, name: str = "state",
                 rank: int = 0, world: int = 1,
                 step: Optional[int] = None, fsync: bool = True) -> dict:
    """One-shot synchronous save of one rank's shard (world=1: a whole
    tree in the manifest format, `Checkpoint.save_pytree`'s backend).
    Commits the manifest when this shard completes the set."""
    snap = snapshot_mod.snapshot_shard(tree, rank=rank, world=world,
                                       name=name, pool=None)
    nbytes = manifest_mod.write_shard(directory, name, rank, world,
                                      snap.records, snap.leaves, fsync=fsync)
    committed = manifest_mod.try_commit(directory, name, world, step=step,
                                        fsync=fsync)
    return {"bytes": nbytes, "committed": committed is not None,
            "snapshot_ms": snap.snapshot_ms}
