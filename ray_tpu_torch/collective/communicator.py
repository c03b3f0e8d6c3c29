"""Communicator interface (port of ray_tpu/collective/communicator.py).

Reference analog: python/ray/experimental/channel/communicator.py:19
(Communicator ABC used by compiled-graph channels and util.collective).
Collectives split into two planes:

  * in-program: `torch.distributed` collectives that the models issue
    inside a step over a world of ranks (ray_tpu_torch/parallel/).
  * out-of-program: collectives between actors of the runtime, outside
    any one program (rendezvous, data-parallel gradient sync, control).
    This interface covers those, with a TCP implementation over host
    arrays (collective/cpu_group.py) and a torch implementation that
    keeps tensors on their device (NCCL for CUDA tensors, gloo for CPU
    tensors; collective/torch_backend.py).

Nothing here imports torch: a CPU worker's tcp group never pays for it.
"""

from __future__ import annotations

import abc
import contextlib
import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.core.exceptions import CollectiveAbortError

logger = logging.getLogger(__name__)

REDUCE_OPS = ("sum", "prod", "min", "max", "mean")


def abort_key(group_name: str) -> str:
    """GCS KV key of a group's abort flag (non-empty value = abort reason).
    Settable by ANY process — the Train controller uses it to unblock a
    worker group's in-flight collectives during a gang restart."""
    return f"collective:{group_name}:abort"


def heartbeat_key(group_name: str, rank: int) -> str:
    return f"collective:{group_name}:hb:{rank}"


class Work:
    """Handle for an asynchronously launched collective op.

    Reference analog: torch.distributed's Work / NCCL's stream events. Ops
    submitted through a communicator's `*_async` methods complete in FIFO
    submission order (one op thread per group drains them); `op_id` is the
    per-group sequence number, identical across ranks when every rank
    submits the same op stream — the invariant bucketed gradient reduction
    relies on. Errors (including CollectiveAbortError from a watchdog
    abort) surface at `wait()`, never silently."""

    __slots__ = ("op_id", "group_name", "rank", "world_size", "_done",
                 "_result", "_error")

    def __init__(self, op_id: int, group_name: str,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        self.op_id = op_id
        self.group_name = group_name
        self.rank = rank
        self.world_size = world_size
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def _finish(self, result=None, error: Optional[BaseException] = None):
        self._result = result
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None):
        """Block until the op completes; return its result or re-raise its
        error. The executing op observes the group's abort flag and per-op
        deadline itself, so an aborted group completes this (exceptionally)
        within one watchdog tick."""
        if not self._done.is_set():
            # The caller is about to park: make the hang diagnosable
            # (stack dumps / wait-graph name the group + op id).
            from ray_tpu_torch.core import blocked as blocked_mod

            with blocked_mod.blocked_on(
                    blocked_mod.COLLECTIVE_OP, group=self.group_name,
                    op_id=self.op_id, rank=self.rank,
                    world_size=self.world_size):
                if not self._done.wait(timeout):
                    raise TimeoutError(
                        f"collective op {self.op_id} on group "
                        f"{self.group_name!r} not done after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class Communicator(abc.ABC):
    """A process group: `world_size` ranks that communicate collectively."""

    def __init__(self, rank: int, world_size: int, group_name: str):
        assert 0 <= rank < world_size
        self.rank = rank
        self.world_size = world_size
        self.group_name = group_name
        # Abort plumbing: the flag is checked at op entry and, for blocking
        # backends, from inside receive loops (poll-timeout ticks), so a
        # set flag surfaces CollectiveAbortError within one watchdog
        # interval instead of the socket timeout.
        self._abort_event = threading.Event()
        self._abort_reason = ""
        self._watchdog: Optional["CollectiveWatchdog"] = None
        self._active_ops = 0
        self._op_lock = threading.Lock()
        # Sequence number of the op the op thread is currently executing
        # (backends with a real op thread keep it current); blocked-on
        # records use it to name which op a stuck rank is inside.
        self._current_op_id = 0

    # ---- abort -----------------------------------------------------------

    def abort(self, reason: str = "aborted") -> None:
        """Set the group's abort flag locally: every blocking op in flight
        (and every future op) raises CollectiveAbortError. Subclasses with
        a KV rendezvous also propagate to peers (see TCPCommunicator)."""
        if not self._abort_event.is_set():
            self._abort_reason = reason or "aborted"
            self._abort_event.set()

    @property
    def aborted(self) -> bool:
        return self._abort_event.is_set()

    def check_abort(self) -> None:
        if self._abort_event.is_set():
            raise CollectiveAbortError(self.group_name, self._abort_reason)

    @property
    def op_active(self) -> bool:
        return self._active_ops > 0

    @contextlib.contextmanager
    def _op(self):
        """Blocking-op guard: the watchdog only applies peer-liveness
        staleness checks while an op is actually in flight (an idle group
        whose peers exited cleanly must not abort retroactively)."""
        self.check_abort()
        with self._op_lock:
            self._active_ops += 1
        from ray_tpu_torch.core import blocked as blocked_mod

        try:
            with blocked_mod.blocked_on(
                    blocked_mod.COLLECTIVE_OP, group=self.group_name,
                    op_id=self._current_op_id, rank=self.rank,
                    world_size=self.world_size):
                yield
        finally:
            with self._op_lock:
                self._active_ops -= 1

    @abc.abstractmethod
    def allreduce(self, array: np.ndarray, op: str = "sum") -> np.ndarray:
        ...

    @abc.abstractmethod
    def allgather(self, array: np.ndarray) -> List[np.ndarray]:
        ...

    @abc.abstractmethod
    def reducescatter(self, arrays: Sequence[np.ndarray], op: str = "sum") -> np.ndarray:
        ...

    @abc.abstractmethod
    def broadcast(self, array: np.ndarray, src_rank: int = 0) -> np.ndarray:
        ...

    @abc.abstractmethod
    def send(self, array: np.ndarray, dst_rank: int) -> None:
        ...

    @abc.abstractmethod
    def recv(self, shape, dtype, src_rank: int) -> np.ndarray:
        ...

    @abc.abstractmethod
    def barrier(self) -> None:
        ...

    # ---- async handles ---------------------------------------------------
    # Default: run synchronously and hand back a completed Work, so every
    # backend supports the async API; backends with a real op thread (the
    # TCP ring transport) override these to actually overlap.

    def _completed_work(self, fn) -> Work:
        work = Work(0, self.group_name)
        try:
            work._finish(result=fn())
        except BaseException as e:
            work._finish(error=e)
        return work

    def allreduce_async(self, array: np.ndarray, op: str = "sum") -> Work:
        return self._completed_work(lambda: self.allreduce(array, op))

    def allgather_async(self, array: np.ndarray) -> Work:
        return self._completed_work(lambda: self.allgather(array))

    def reducescatter_async(self, arrays: Sequence[np.ndarray],
                            op: str = "sum") -> Work:
        return self._completed_work(lambda: self.reducescatter(arrays, op))

    def broadcast_async(self, array: np.ndarray, src_rank: int = 0) -> Work:
        return self._completed_work(lambda: self.broadcast(array, src_rank))

    def alltoall(self, arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Default all-to-all via send/recv pairs (override for better)."""
        out: List[np.ndarray] = [None] * self.world_size  # type: ignore
        out[self.rank] = np.asarray(arrays[self.rank])
        for offset in range(1, self.world_size):
            dst = (self.rank + offset) % self.world_size
            src = (self.rank - offset) % self.world_size
            if self.rank % 2 == 0:
                self.send(np.asarray(arrays[dst]), dst)
                out[src] = self.recv(None, None, src)
            else:
                out[src] = self.recv(None, None, src)
                self.send(np.asarray(arrays[dst]), dst)
        return out

    def close(self) -> None:
        pass


class CollectiveWatchdog:
    """Peer-liveness + abort propagation for out-of-graph collectives.

    One thread per communicator. Each tick (cfg().collective_watchdog_
    interval_s) it:

      * bumps this rank's heartbeat counter in the rendezvous KV,
      * reads the group's abort key — any non-empty value aborts the local
        communicator (this is how a remote `abort_collective_group` or the
        Train controller's gang-restart reaches a rank blocked in recv),
      * while a blocking op is in flight, checks every peer's heartbeat
        counter: a counter unchanged for `collective_peer_miss_threshold`
        consecutive ticks means the peer's process is gone (its watchdog
        died with it) — the group aborts in seconds instead of hanging to
        the 120 s socket timeout.

    KV failures are tolerated (the GCS may be briefly down); the watchdog
    just retries next tick.
    """

    def __init__(self, comm: Communicator,
                 kv_put: Callable[[str, str], None],
                 kv_get: Callable[[str], Optional[str]],
                 interval_s: Optional[float] = None,
                 miss_threshold: Optional[int] = None):
        from ray_tpu_torch.config import cfg

        self.comm = comm
        self._kv_put = kv_put
        self._kv_get = kv_get
        self.interval_s = (interval_s if interval_s is not None
                           else cfg().collective_watchdog_interval_s)
        self.miss_threshold = (miss_threshold if miss_threshold is not None
                               else cfg().collective_peer_miss_threshold)
        self._beats = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # peer rank -> (last seen counter value, consecutive stale ticks)
        self._peer_state: dict = {}

    def start(self) -> "CollectiveWatchdog":
        # First beat synchronously: peers must be able to see us from the
        # moment the group exists, or a slow-to-start watchdog thread would
        # read as a dead peer.
        self._beat()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"collective-watchdog-{self.comm.group_name}-"
                 f"{self.comm.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 5.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _beat(self):
        self._beats += 1
        try:
            self._kv_put(heartbeat_key(self.comm.group_name, self.comm.rank),
                         str(self._beats))
        except Exception:
            pass

    def _run(self):
        while not self._stop.wait(self.interval_s):
            if self.comm.aborted:
                return
            self._beat()
            try:
                self._check_abort_key()
                if self.comm.op_active:
                    self._check_peers()
            except Exception:
                logger.debug("collective watchdog tick failed", exc_info=True)
            if self.comm.aborted:
                return

    def _check_abort_key(self):
        try:
            value = self._kv_get(abort_key(self.comm.group_name))
        except Exception:
            return
        if value:
            self.comm.abort(value)

    def _check_peers(self):
        for peer in range(self.comm.world_size):
            if peer == self.comm.rank:
                continue
            try:
                value = self._kv_get(heartbeat_key(self.comm.group_name, peer))
            except Exception:
                return
            if value is None:
                continue  # peer not through rendezvous yet
            last, stale = self._peer_state.get(peer, (None, 0))
            stale = stale + 1 if value == last else 0
            self._peer_state[peer] = (value, stale)
            if stale >= self.miss_threshold:
                self.comm.abort(
                    f"peer rank {peer} lost (no watchdog heartbeat for "
                    f"{stale} x {self.interval_s:g}s)")
                return


def reduce_arrays(arrays: Sequence[np.ndarray], op: str) -> np.ndarray:
    stack = np.stack([np.asarray(a) for a in arrays])
    if op == "sum":
        return stack.sum(axis=0)
    if op == "prod":
        return stack.prod(axis=0)
    if op == "min":
        return stack.min(axis=0)
    if op == "max":
        return stack.max(axis=0)
    if op == "mean":
        return stack.mean(axis=0)
    raise ValueError(f"unknown reduce op {op!r}")
