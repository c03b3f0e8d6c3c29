"""The per-process core worker: connections, object access, task submission.

Reference analog: src/ray/core_worker/core_worker.h CoreWorker (Put
core_worker.cc:1522, Get :1823, SubmitTask via
transport/normal_task_submitter.cc:23 with per-SchedulingKey lease caching,
SubmitActorTask :2803 via actor_task_submitter.h:75) plus the in-process
memory store for inlined results (store_provider/memory_store/).

One instance per process (driver or worker), created by ray_tpu_torch.init() /
worker bootstrap. Synchronous public methods; all I/O on a dedicated asyncio
thread (the instrumented_io_context analog).

The port's copy of ray_tpu/core/worker.py, without task events and the
wait-graph edges they carry (the GCS handlers wait), metrics, and
runtime_env.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import logging
import os
import threading
import time
from concurrent.futures import Future as SyncFuture
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.exceptions import (
    ActorDiedError, GetTimeoutError, ObjectLostError, RayTpuError, TaskError,
    WorkerCrashedError, actor_death_error)
from ray_tpu_torch.core.generator import ObjectRefGenerator, _GeneratorState
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import ActorSpec, TaskSpec
from ray_tpu_torch.runtime.object_store import ObjectNotFoundError, ObjectStore
from ray_tpu_torch.runtime.object_store.spill import SpillManager
from ray_tpu_torch.runtime.object_store.store import StoreFullError
from ray_tpu_torch.runtime.rpc import (ConnectionLost, EventLoopThread, RpcClient,
                                 RpcError, RpcServer)
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils.ids import ObjectID, TaskID

logger = logging.getLogger(__name__)

from ray_tpu_torch.config import cfg

_MISSING = object()


class _LeasedWorker:
    def __init__(self, lease_id, worker_id, address, node_id, raylet):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.address = address
        self.node_id = node_id
        self.raylet = raylet  # the raylet client that granted this lease
        self.client: Optional[RpcClient] = None
        self.busy = False
        self.return_timer: Optional[asyncio.TimerHandle] = None


class _KeyState:
    """Per-SchedulingKey submission state (normal_task_submitter.h:52)."""

    def __init__(self):
        self.queue: List[TaskSpec] = []
        self.leases: List[_LeasedWorker] = []
        self.inflight_reqs: set = set()  # outstanding lease request ids


class CoreWorker:
    def __init__(self, mode: str, gcs_address: Tuple[str, int],
                 raylet_address: Optional[Tuple[str, int]],
                 store_path: Optional[str], session_dir: str,
                 node_id: Optional[bytes] = None):
        self.mode = mode
        self.session_dir = session_dir
        self.node_id = node_id
        self.io = EventLoopThread()
        self.gcs = self.io.run(self._connect(gcs_address, auto_reconnect=True))
        # Lease-batch plumbing must exist before any raylet client is up:
        # a lease_grant push can arrive as soon as the socket connects.
        self._lease_grant_waiters: Dict[bytes, "asyncio.Future"] = {}
        self._lease_batch_buf: Dict[Any, list] = {}  # raylet client -> queue
        self.raylet = (self.io.run(self._connect(
            raylet_address, on_push=self._on_raylet_push))
            if raylet_address else None)
        self.store = ObjectStore(store_path, create=False) if store_path else None
        self.spill = (SpillManager(self.store, os.path.join(session_dir, "spill"))
                      if self.store is not None else None)
        self._node_addrs: Dict[bytes, Tuple[str, int]] = {}  # node_id -> raylet addr
        self.memory_store: Dict[bytes, Any] = {}      # oid -> deserialized value
        self._object_locations: Dict[bytes, bytes] = {}  # oid -> node_id (plasma results)
        self.result_futures: Dict[bytes, SyncFuture] = {}
        # Pending return oid -> {task_id, name, actor_id}: lets a blocked
        # get() name the task/actor it is waiting for (wait-graph edges,
        # `scripts stack` annotations). Popped with result_futures.
        self._result_meta: Dict[bytes, dict] = {}
        self._mem_lock = threading.Lock()
        self._registered_fns: set = set()
        self._keys: Dict[Tuple, _KeyState] = {}
        self._raylet_clients: Dict[Tuple[str, int], RpcClient] = {}
        self._actor_clients: Dict[bytes, "_ActorClient"] = {}
        self._put_refs: set = set()                   # plasma ids this process created
        self._lineage: Dict[bytes, dict] = {}         # return oid -> lineage record
        self._generators: Dict[bytes, _GeneratorState] = {}  # task_id -> state
        # Cancellation (ray.cancel analog, task_manager.h MarkTaskCanceled):
        # cancelled ids suppress every retry/reconstruction path; in-flight
        # maps a dispatched task to the lease whose worker is running it.
        self._cancelled_tasks: set = set()
        self._inflight_tasks: Dict[bytes, "_LeasedWorker"] = {}
        # ---- ownership / distributed refcount (reference_count.h analog) --
        # Owner-side: oid -> {"locations": set[node_id], "borrowers": set[id],
        #   "containers": set[container_oid], "children": [(oid, addr)],
        #   "inline": bool}
        self._owned: Dict[bytes, dict] = {}
        self._local_refs: Dict[bytes, int] = {}       # live ObjectRef pyobjects
        self._borrowed: Dict[bytes, Tuple] = {}       # oid -> owner addr
        self._arg_pins: Dict[bytes, int] = {}         # oid -> in-flight task uses
        # GC-safe drop queue: ObjectRef.__del__ appends here (lock-free);
        # drained outside GC context (see ref_dropped).
        import collections

        self._dropped_refs: "collections.deque" = collections.deque()
        self._deferred_unborrow: set = set()
        self._pending_borrows: list = []              # in-flight borrow RPCs
        self._owner_clients: Dict[Tuple, RpcClient] = {}
        self._owner_locks: Dict[Tuple, "asyncio.Lock"] = {}
        self._death_sub_client: Optional[RpcClient] = None
        # node_id -> True/False: was the node's death an ANNOUNCED
        # drain/preemption? Filled lazily from the GCS node table on the
        # (rare) death paths that decide whether to consume retry budget.
        self._node_death_cause: Dict[bytes, bool] = {}
        self.worker_ident = (os.environ.get("RAY_TPU_TORCH_WORKER_ID")
                             or "drv" + os.urandom(6).hex())
        # Every process (driver AND worker) serves the ownership protocol:
        # borrow/unborrow, containment pins, owner-side object fetch.
        self.core_server = RpcServer("127.0.0.1", 0)
        self.core_server.register("borrow", self._h_borrow)
        self.core_server.register("unborrow", self._h_unborrow)
        self.core_server.register("pin_container", self._h_pin_container)
        self.core_server.register("unpin_container", self._h_unpin_container)
        self.core_server.register("get_object", self._h_get_object)
        self.core_server.register("force_free", self._h_force_free)
        self.io.run(self.core_server.start())
        self.owner_addr = self.core_server.address
        self.current_actor_id: Optional[bytes] = None
        self.current_task_name: Optional[str] = None
        self.job_id = None
        # Dropped refs of an otherwise idle process are still processed.
        self.io.spawn(self._drain_dropped_refs_loop())

    @staticmethod
    async def _connect(addr, auto_reconnect: bool = False, on_push=None):
        client = RpcClient(addr[0], addr[1], auto_reconnect=auto_reconnect,
                           on_push=on_push)
        await client.connect(timeout=60)
        return client

    # ------------------------------------------------------------------ put/get

    def _require_store(self) -> ObjectStore:
        if self.store is None:
            raise RayTpuError(
                "this process is not colocated with a node object store "
                "(remote-attached driver); put/get of plasma objects is unavailable")
        return self.store

    def put(self, value: Any) -> ObjectRef:
        self._drain_dropped_refs()
        if isinstance(value, ObjectRef):
            raise TypeError("put() does not accept ObjectRefs")
        oid = ObjectID.generate().binary()
        segments, total, contained = serialization.serialize_with_refs(value)
        if self.store is not None:
            self._write_segments_to_plasma(oid, segments, total)
        else:
            # Remote-client driver (Ray Client analog): no colocated store —
            # materialize into the attached node's store over chunked RPC.
            self._remote_put(oid, serialization.join_segments(segments))
        self._put_refs.add(oid)
        children = self._pin_children(oid, contained)
        self._new_owned(oid, location=self.node_id, children=children)
        ref = ObjectRef(oid, owner=self.node_id, owner_addr=self.owner_addr)
        self.register_ref(ref)
        return ref

    def _remote_put(self, oid: bytes, payload: bytes):
        if self.raylet is None:
            raise RayTpuError("no attached raylet for remote put")
        chunk_size = cfg().pull_chunk_bytes

        async def _send_raw():
            # Zero-pickle: each chunk ships as the raw-frame payload (a
            # memoryview slice straight onto the socket), only the small
            # ObjPutMsg header is encoded.
            from ray_tpu_torch.runtime import wire

            total = len(payload)
            view = memoryview(payload)
            off = 0
            while True:
                end = min(off + chunk_size, total)
                m, _ = await self.raylet.call_raw(
                    "put_object_raw",
                    m=wire.ObjPutMsg(oid=oid, offset=off, total=total,
                                     seal=(end >= total)).encode(),
                    payload=view[off:end])
                ack = wire.AckMsg.decode(m)
                if not ack.ok:
                    raise RayTpuError(f"remote put failed: {ack.error}")
                off = end
                if off >= total:
                    return

        self.io.run(_send_raw(), timeout=600)
        self._object_locations[oid] = self.node_id

    def spill_create(self, oid: bytes, size: int, metadata: bytes = b"") -> memoryview:
        """store.create with spill-before-evict when a spill dir is available."""
        if self.spill is not None:
            return self.spill.create_with_spill(oid, size, metadata)
        return self._require_store().create(oid, size, metadata)

    def _write_segments_to_plasma(self, oid: bytes, segments, total: int):
        store = self._require_store()
        buf = self.spill_create(oid, total)
        try:
            serialization.write_segments(buf, segments)
        except BaseException:
            buf.release()
            store.abort(oid)
            raise
        buf.release()
        store.seal(oid)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            out.append(self.get_one(ref, remaining))
        return out

    def get_one(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        self._drain_dropped_refs()
        oid = ref.binary()
        with self._mem_lock:
            if oid in self.memory_store:
                return self._raise_if_error(self.memory_store[oid])
            fut = self.result_futures.get(oid)
        # Everything below may block: register what we are blocked on so
        # stack dumps and the cluster wait-graph can explain the stall.
        with self._blocked_get_ctx(oid, ref):
            if fut is not None:
                try:
                    fut.result(timeout)
                # On 3.10 concurrent.futures.TimeoutError is NOT the builtin
                # TimeoutError (they merge in 3.11) — catch both.
                except (TimeoutError, concurrent.futures.TimeoutError):
                    raise GetTimeoutError(f"get() timed out waiting for {ref}")
                with self._mem_lock:
                    if oid in self.memory_store:
                        return self._raise_if_error(self.memory_store[oid])
                # fell through: result is in plasma
            start = time.monotonic()
            # A BORROWED ref (we never submitted the producing task and
            # another process owns it) may resolve ONLY at its owner: an
            # inline result never lands in plasma, even on this node. Probe
            # plasma briefly, then spend the budget on the owner fetch —
            # otherwise a same-node borrow waits the full timeout for a
            # local appearance that can never happen.
            borrowed = (fut is None and ref.owner_addr is not None
                        and tuple(ref.owner_addr) != tuple(self.owner_addr))
            plasma_timeout = timeout
            if borrowed:
                plasma_timeout = 0.05 if timeout is None else min(timeout, 0.05)
            try:
                value = self._get_plasma_value(oid, ref.owner, plasma_timeout)
            except ObjectNotFoundError:
                # The plasma wait may have consumed the whole budget: the
                # owner fallback only gets what remains (never doubles the
                # timeout).
                remaining = (None if timeout is None else
                             timeout - (time.monotonic() - start))
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"get() timed out waiting for {ref}")
                value = self._fetch_from_owner(ref, remaining)
            except ObjectLostError:
                # Drain relocation first: a draining node migrates its
                # primary copies to live peers and records the new homes in
                # the GCS relocation table — a moved object is readable
                # WITHOUT lineage re-execution.
                value = self._get_relocated_value(oid, timeout)
                if value is not _MISSING:
                    return self._raise_if_error(value)
                # Lineage reconstruction: re-execute the producing task, then
                # re-enter the full read path (the new result may be inline).
                # An announced preemption does not consume the
                # reconstruction budget (the loss was planned, not a bug).
                preempted = self._node_was_preempted(
                    self._object_locations.get(oid))
                if not self._reconstruct(oid, timeout, preempted=preempted):
                    raise
                return self.get_one(ref, timeout)
        return self._raise_if_error(value)

    def _get_relocated_value(self, oid: bytes, timeout: Optional[float]):
        """Ask the GCS where a drain migration put `oid`; on a hit, retry
        the plasma read from the new home. Returns _MISSING when there is
        no (new) relocation or the read fails anyway."""
        try:
            reply = self.io.run(
                self.gcs.call("locate_object", oid=oid), timeout=10)
        except Exception:
            return _MISSING
        if not reply or not reply.get("found"):
            return _MISSING
        node_id = reply["node_id"]
        if node_id == self._object_locations.get(oid):
            return _MISSING  # that's where we just failed to read from
        self._object_locations[oid] = node_id
        addr = reply.get("address")
        if addr:
            self._node_addrs[node_id] = tuple(addr)
        try:
            return self._get_plasma_value(oid, node_id, timeout)
        except (ObjectNotFoundError, ObjectLostError):
            return _MISSING

    def _preemption_verdict(self, node_id: bytes, nodes) -> bool:
        """Classify `node_id` against a GCS node-table snapshot; caches
        only FINAL (dead-node) verdicts — a live, non-draining node may
        still receive a drain notice later."""
        from ray_tpu_torch.core.exceptions import CAUSE_PREEMPTION, death_cause

        verdict = False
        for n in nodes:
            nid = n["node_id"]
            if isinstance(nid, str):
                nid = bytes.fromhex(nid)
            if nid != node_id:
                continue
            verdict = bool(n.get("draining")) or death_cause(
                n.get("death_reason")) == CAUSE_PREEMPTION
            if not n.get("alive", True):
                self._node_death_cause[node_id] = verdict
            break
        return verdict

    def _node_was_preempted(self, node_id: Optional[bytes]) -> bool:
        """True when `node_id` died (or is dying) from an ANNOUNCED
        drain/preemption — such deaths never consume retry budgets
        (max_retries / reconstruction_attempts). Lazily resolved from the
        GCS node table; only called on (rare) death paths. Sync — must not
        be called from the IO loop (use _node_was_preempted_async there)."""
        if node_id is None:
            return False
        cached = self._node_death_cause.get(node_id)
        if cached is not None:
            return cached
        try:
            nodes = self.io.run(
                self.gcs.call("get_nodes", only_alive=False), timeout=10)
        except Exception:
            return False
        return self._preemption_verdict(node_id, nodes)

    async def _node_was_preempted_async(self, node_id: Optional[bytes]) -> bool:
        """IO-loop twin of _node_was_preempted."""
        if node_id is None:
            return False
        cached = self._node_death_cause.get(node_id)
        if cached is not None:
            return cached
        try:
            nodes = await self.gcs.call("get_nodes", only_alive=False,
                                        timeout=10)
        except Exception:
            return False
        return self._preemption_verdict(node_id, nodes)

    def _blocked_get_ctx(self, oid: bytes, ref: ObjectRef, **extra):
        """blocked_on("object_get") context for a (possibly) blocking read
        of `ref`, annotated with everything this process knows about the
        object: its owner and — when we submitted the producing task
        ourselves — the target task/actor (the wait-graph edge)."""
        from ray_tpu_torch.core import blocked as blocked_mod

        detail = {"oid": oid.hex()}
        owner = ref.owner_addr or ref.owner
        if owner is not None:
            detail["owner"] = (owner.hex()
                               if isinstance(owner, (bytes, bytearray))
                               else f"{owner[0]}:{owner[1]}")
        meta = self._result_meta.get(oid)
        if meta:
            detail["target_task"] = meta.get("task_id")
            detail["target_name"] = meta.get("name")
            if meta.get("actor_id"):
                detail["target_actor"] = meta["actor_id"]
        detail.update(extra)
        return blocked_mod.blocked_on(blocked_mod.OBJECT_GET, **detail)


    def _get_plasma_value(self, oid: bytes, owner: Optional[bytes],
                          timeout: Optional[float]) -> Any:
        """Plasma read path: local shm store -> local spill dir -> remote pull
        from the object's location (ObjectManager pull protocol analog,
        object_manager.proto:60; ours is chunked raylet RPC over the control
        plane since tensors ride XLA collectives, not the object plane)."""
        location = self._object_locations.get(oid) or owner
        remote = (location is not None and self.node_id is not None
                  and location != self.node_id)
        store = self.store
        if store is not None:
            # With a remote fallback available, don't burn the whole timeout
            # waiting for a local appearance that will never happen.
            local_timeout = 0.05 if remote else timeout
            try:
                buf = store.get(oid, timeout=local_timeout)
                # `pin=buf` keeps the store read reference alive for as long
                # as any zero-copy array deserialized out of this payload is.
                return serialization.deserialize(buf.data, pin=buf)
            except ObjectNotFoundError:
                pass
            if self.spill is not None and self.spill.restore(oid):
                buf = store.get(oid, timeout=5)
                return serialization.deserialize(buf.data, pin=buf)
        if (remote or store is None) and location is not None:
            data = self._pull_remote(oid, location)
            if store is not None:
                # Cache locally so repeated gets are zero-copy shm reads.
                try:
                    view = self.spill_create(oid, len(data))
                    view[:] = data
                    view.release()
                    store.seal(oid)
                    buf = store.get(oid, timeout=5)
                    return serialization.deserialize(buf.data, pin=buf)
                except (ValueError, StoreFullError, ObjectNotFoundError):
                    pass  # concurrent create/restore or no room: use the copy
            return serialization.deserialize(memoryview(data))
        raise ObjectNotFoundError(oid.hex())

    def _fetch_from_owner(self, ref: ObjectRef, timeout: Optional[float]):
        """Last-resort read path: ask the object's OWNER process (nested refs
        whose value lives only in the owner's memory store, or whose plasma
        location we never learned). GetObjectStatus analog
        (core_worker.proto: the owner resolves inlined values/locations)."""
        addr = ref.owner_addr
        oid = ref.binary()
        if addr is None or tuple(addr) == tuple(self.owner_addr):
            raise GetTimeoutError(f"get() timed out waiting for {ref}")
        budget = 30.0 if timeout is None else max(0.1, min(timeout, 30.0))

        async def _ask():
            try:
                return await asyncio.wait_for(
                    self._owner_call(tuple(addr), "get_object", oid=oid),
                    budget)
            except asyncio.TimeoutError:
                return None

        reply = self.io.run(_ask(), timeout=budget + 5)
        if not reply or not reply.get("found"):
            raise GetTimeoutError(f"get() timed out waiting for {ref}")
        if "payload" in reply:
            return serialization.deserialize(memoryview(reply["payload"]))
        location = reply.get("location")
        if location is not None:
            self._object_locations[oid] = location
            return self._get_plasma_value(oid, location, timeout)
        raise GetTimeoutError(f"get() timed out waiting for {ref}")

    def _node_address(self, node_id: bytes) -> Optional[Tuple[str, int]]:
        addr = self._node_addrs.get(node_id)
        if addr is not None:
            return addr
        for n in self.io.run(self.gcs.call("get_nodes")):
            nid = n["node_id"]
            if isinstance(nid, str):
                nid = bytes.fromhex(nid)
            self._node_addrs[nid] = tuple(n["address"])
        return self._node_addrs.get(node_id)

    def _pull_remote(self, oid: bytes, node_id: bytes) -> bytes:
        """Chunked pull of a sealed object from another node's raylet:
        raw-frame fast path (zero-pickle — chunk bytes come off the socket
        as views over the receive buffer and land in ONE preallocated
        bytearray, no intermediate pickle buffer ever materializes)."""
        pull_start = time.monotonic()
        addr = self._node_address(node_id)
        if addr is None:
            raise ObjectLostError(
                f"object {oid.hex()[:12]} lives on unknown/dead node "
                f"{node_id.hex()[:12]}", oid=oid)

        async def _pull_raw(client):
            from ray_tpu_torch.runtime import wire

            buf, off, total = None, 0, 0
            while True:
                m, payload = await client.call_raw(
                    "pull_object_raw",
                    m=wire.ObjChunkRequestMsg(
                        oid=oid, offset=off,
                        length=cfg().pull_chunk_bytes).encode())
                rep = wire.ObjChunkReplyMsg.decode(m)
                if not rep.found:
                    raise ObjectLostError(
                        f"object {oid.hex()[:12]} not found on node "
                        f"{node_id.hex()[:12]} (evicted or node restarted)",
                        oid=oid)
                if buf is None:
                    total = rep.total
                    buf = bytearray(total)
                n = len(payload)
                buf[off:off + n] = payload
                off += n
                if off >= total:
                    return buf
                if n == 0:
                    raise ObjectLostError(
                        f"truncated pull of {oid.hex()[:12]}", oid=oid)

        async def _pull():
            return await _pull_raw(await self._raylet_for(addr))

        try:
            data = self.io.run(_pull())
        except (ConnectionLost, OSError):
            raise ObjectLostError(
                f"node {node_id.hex()[:12]} unreachable while pulling "
                f"{oid.hex()[:12]}", oid=oid)
        return data

    @staticmethod
    def _raise_if_error(value):
        if isinstance(value, RayTpuError):
            raise value
        return value

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        self._drain_dropped_refs()
        assert num_returns <= len(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: List[ObjectRef] = []
        while len(ready) < num_returns:
            still, futs = [], []
            for ref in pending:
                oid = ref.binary()
                with self._mem_lock:
                    # A completed task pops its result future, so a plasma
                    # result's only completion evidence is its recorded
                    # location — without this check wait() never reports a
                    # remote plasma result ready even though get() works.
                    in_mem = (oid in self.memory_store
                              or oid in self._object_locations)
                    fut = self.result_futures.get(oid)
                if in_mem or (fut is not None and fut.done()) or \
                        (self.store is not None and self.store.contains(oid)):
                    ready.append(ref)
                else:
                    still.append(ref)
                    if fut is not None:
                        futs.append(fut)
            pending = still
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if len(futs) == len(pending):
                # Every pending ref has a local result future: block until
                # ANY completes (event-driven, no busy-poll).
                block = remaining if remaining is not None else 60.0
            else:
                # Some refs can only appear by being sealed into plasma by
                # another process (no completion signal): re-check coarsely.
                block = 0.02 if remaining is None else min(0.02, remaining)
            first = pending[0]
            with self._blocked_get_ctx(first.binary(), first,
                                       num_pending=len(pending)):
                if futs:
                    concurrent.futures.wait(
                        futs, timeout=block,
                        return_when=concurrent.futures.FIRST_COMPLETED)
                else:
                    time.sleep(block)
        return ready, pending

    # ------------------------------------------------------------- functions

    def register_function(self, fn) -> bytes:
        pickled = cloudpickle.dumps(fn)
        fn_id = hashlib.sha1(pickled).digest()
        if fn_id not in self._registered_fns:
            self.io.run(self.gcs.call("kv_put", key=b"fn:" + fn_id, value=pickled,
                                      overwrite=False))
            self._registered_fns.add(fn_id)
        return fn_id

    def register_class(self, cls) -> bytes:
        pickled = cloudpickle.dumps(cls)
        class_id = hashlib.sha1(pickled).digest()
        if class_id not in self._registered_fns:
            self.io.run(self.gcs.call("kv_put", key=b"cls:" + class_id, value=pickled,
                                      overwrite=False))
            self._registered_fns.add(class_id)
        return class_id

    # ------------------------------------------------------------ serialization

    def serialize_args(self, args, kwargs) -> Tuple[List, List, List]:
        """Build TaskSpec args: small values inline; ObjectRefs stay refs;
        large values spill to plasma (DependencyResolver analog). Also
        returns the oids to pin for the task's lifetime (ref args + refs
        nested inside inline values)."""
        out, names, pins = [], [], []
        for name, value in [(None, a) for a in args] + list(kwargs.items()):
            if isinstance(value, ObjectRef):
                oid = value.binary()
                # Prefer the tracked result location over the ref's recorded
                # owner: task returns live on the node that executed the task.
                owner = self._object_locations.get(oid) or value.owner or self.node_id
                out.append(("r", oid, owner))
                pins.append(oid)
            else:
                segments, total, contained = serialization.serialize_with_refs(
                    value)
                pins.extend(r.binary() for r in contained)
                if total > cfg().inline_result_max and self.store is not None:
                    oid = ObjectID.generate().binary()
                    self._write_segments_to_plasma(oid, segments, total)
                    self._put_refs.add(oid)
                    self._new_owned(oid, location=self.node_id)
                    out.append(("r", oid, self.node_id))
                else:
                    out.append(("v", serialization.join_segments(segments)))
            names.append(name)
        return out, names, pins

    def resolve_args(self, spec: TaskSpec) -> Tuple[list, dict]:
        """Worker-side: materialize TaskSpec args."""
        args, kwargs = [], {}
        for arg, name in zip(spec.args, spec.kwarg_names):
            kind, payload = arg[0], arg[1]
            if kind == "v":
                value = serialization.deserialize(payload)
            else:
                owner = arg[2] if len(arg) > 2 else None
                value = self._get_plasma_value(payload, owner, timeout=60)
            if name is None:
                args.append(value)
            else:
                kwargs[name] = value
        return args, kwargs

    # ------------------------------------------------------- streaming items

    async def _on_worker_push(self, method: str, data: dict):
        """Pushes from executor workers back to this (submitting) process.
        Currently: streaming-generator item reports (the
        ReportGeneratorItemReturns analog, core_worker.proto:462)."""
        if method != "gen_item":
            logger.warning("unexpected worker push %r", method)
            return
        task_id = data["task_id"]
        index = data["index"]
        oid = ObjectID.for_task_return(TaskID(task_id), index).binary()
        node_id = data.get("node_id")
        if "payload" in data:
            # Deserialize outside the lock (nested refs re-enter it); also
            # destroy any displaced value outside it (see _maybe_free).
            value = serialization.deserialize(data["payload"])
            with self._mem_lock:
                displaced = self.memory_store.pop(oid, None)
                self.memory_store[oid] = value
            del displaced
        elif node_id is not None:
            self._object_locations[oid] = node_id
        gen = self._generators.get(task_id)
        if gen is not None:
            gen.push(index, ObjectRef(oid, owner=node_id))

    def _make_generator(self, task_id: bytes) -> ObjectRefGenerator:
        state = _GeneratorState()
        self._generators[task_id] = state
        return ObjectRefGenerator(task_id, state)

    async def _on_raylet_push(self, method: str, data: dict):
        """Pushes from raylets: deferred lease-batch resolutions. A
        `lease_grant` carries the encoded LeaseReplyMsg for a req_id whose
        batch entry came back pending=True (see handle_lease_batch2)."""
        if method != "lease_grant":
            logger.warning("unexpected raylet push %r", method)
            return
        fut = self._lease_grant_waiters.pop(data.get("req_id"), None)
        if fut is not None and not fut.done():
            from ray_tpu_torch.runtime import wire

            fut.set_result(wire.LeaseReplyMsg.decode(data["m"]).to_reply())

    async def _drain_dropped_refs_loop(self):
        while True:
            await asyncio.sleep(1.0)
            self._drain_dropped_refs()

    # --------------------------------------------- ownership & refcounting
    #
    # Reference analog: src/ray/core_worker/reference_count.h:418-615. The
    # process that creates an object (put / task submission) OWNS it: it
    # tracks where copies live, which processes borrow it, and which stored
    # objects contain it. Data is freed everywhere on zero (delete-on-zero);
    # pins keep in-flight task args alive across the submit/execute window.

    def _new_owned(self, oid: bytes, location: Optional[bytes] = None,
                   inline: bool = False, children=None) -> dict:
        rec = self._owned.get(oid)
        if rec is None:
            rec = self._owned[oid] = {
                "locations": set(), "borrowers": set(), "containers": set(),
                "children": [], "inline": inline}
        if location is not None:
            rec["locations"].add(location)
        if children:
            rec["children"].extend(children)
        return rec

    def register_ref(self, ref: ObjectRef, arrived: bool = False):
        """Count a live ObjectRef pyobject; on first arrival from another
        process, register this process as a borrower with the owner. The
        borrow RPC is async; executors drain pending borrows BEFORE replying
        to a task (take_pending_borrows), closing the window where the
        submitter unpins args while our borrow is still in flight."""
        self._drain_dropped_refs()
        oid = ref.binary()
        ref._registered = True
        with self._mem_lock:
            self._local_refs[oid] = self._local_refs.get(oid, 0) + 1
            needs_borrow = (arrived and oid not in self._owned
                            and oid not in self._borrowed
                            and ref.owner_addr is not None
                            and tuple(ref.owner_addr) != tuple(self.owner_addr))
            if needs_borrow:
                self._borrowed[oid] = tuple(ref.owner_addr)
        if needs_borrow:
            fut = self.io.spawn(self._owner_call(
                tuple(ref.owner_addr), "borrow", oid=oid,
                borrower=self.worker_ident))
            with self._mem_lock:
                # Prune completed futures so drivers (which never drain via
                # take_pending_borrows) don't leak one entry per borrow.
                self._pending_borrows = [
                    f for f in self._pending_borrows if not f.done()]
                self._pending_borrows.append(fut)

    def take_pending_borrows(self) -> list:
        with self._mem_lock:
            futs, self._pending_borrows = self._pending_borrows, []
        return futs

    def ref_dropped(self, oid: bytes):
        """Called from ObjectRef.__del__ — possibly by the CYCLIC GC at an
        arbitrary allocation point, including inside a _mem_lock-held
        section of THIS thread. Taking _mem_lock here could self-deadlock,
        so __del__ only enqueues (deque.append is atomic and allocation-
        free) and pokes the io loop; the drop is processed by
        _drain_dropped_refs on the io thread (plus opportunistically from
        normal call sites), always outside GC context."""
        self._dropped_refs.append(oid)
        try:
            self.io.loop.call_soon_threadsafe(self._drain_dropped_refs)
        except RuntimeError:
            pass  # loop already closed (shutdown): nothing left to free

    def _drain_dropped_refs(self):
        while True:
            try:
                oid = self._dropped_refs.popleft()
            except IndexError:
                return
            self._ref_dropped_now(oid)

    def _ref_dropped_now(self, oid: bytes):
        with self._mem_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n > 0:
                self._local_refs[oid] = n
                return
            self._local_refs.pop(oid, None)
            owner_addr = self._borrowed.get(oid)
            if owner_addr is not None and self._arg_pins.get(oid):
                # Still pinned by an in-flight task: unborrow when unpinned.
                self._deferred_unborrow.add(oid)
                return
            if owner_addr is not None:
                self._borrowed.pop(oid, None)
        if owner_addr is not None:
            self.io.spawn(self._owner_call(
                owner_addr, "unborrow", oid=oid, borrower=self.worker_ident))
        elif oid in self._owned:
            self._maybe_free(oid)

    def pin_args(self, oids):
        with self._mem_lock:
            for oid in oids:
                self._arg_pins[oid] = self._arg_pins.get(oid, 0) + 1

    def unpin_args(self, oids):
        to_unborrow, to_free = [], []
        with self._mem_lock:
            for oid in oids:
                n = self._arg_pins.get(oid, 0) - 1
                if n > 0:
                    self._arg_pins[oid] = n
                    continue
                self._arg_pins.pop(oid, None)
                if oid in self._deferred_unborrow:
                    self._deferred_unborrow.discard(oid)
                    addr = self._borrowed.pop(oid, None)
                    if addr is not None:
                        to_unborrow.append((addr, oid))
                elif oid in self._owned and not self._local_refs.get(oid):
                    to_free.append(oid)
        for addr, oid in to_unborrow:
            self.io.spawn(self._owner_call(
                addr, "unborrow", oid=oid, borrower=self.worker_ident))
        for oid in to_free:
            self._maybe_free(oid)

    def _maybe_free(self, oid: bytes):
        """Owner-side delete-on-zero: free the object's data everywhere once
        nothing holds it (local refs, borrowers, containing objects, pins)."""
        # Values popped under the lock are destroyed AFTER it is released:
        # a value containing registered ObjectRefs runs ref_dropped from its
        # __del__, which re-acquires this (non-reentrant) lock.
        displaced = []
        with self._mem_lock:
            rec = self._owned.get(oid)
            if rec is None:
                return
            if (self._local_refs.get(oid) or rec["borrowers"]
                    or rec["containers"] or self._arg_pins.get(oid)):
                return
            del self._owned[oid]
            displaced.append(self.memory_store.pop(oid, None))
            self._lineage.pop(oid, None)
            children = rec["children"]
            locations = set(rec["locations"])
        del displaced
        self._put_refs.discard(oid)
        self._object_locations.pop(oid, None)
        # Drop the data copies.
        if self.store is not None and self.store.contains(oid):
            try:
                self.store.delete(oid)
            except Exception:
                pass
            if self.spill is not None:
                self.spill.delete(oid)
            locations.discard(self.node_id)
        for node in locations:
            self.io.spawn(self._free_on_node(node, oid))
        # Release our containment pins on nested refs.
        for child_oid, child_addr in children:
            self._unpin_child(child_oid, child_addr, oid)

    def _unpin_child(self, child_oid: bytes, child_addr, container_oid: bytes):
        if child_addr is None or tuple(child_addr) == tuple(self.owner_addr):
            with self._mem_lock:
                rec = self._owned.get(child_oid)
                if rec is not None:
                    rec["containers"].discard(container_oid)
            if rec is not None:
                self._maybe_free(child_oid)
        else:
            self.io.spawn(self._owner_call(
                tuple(child_addr), "unpin_container", oid=child_oid,
                container=container_oid))

    def _pin_children(self, container_oid: bytes, refs) -> list:
        """Record that `container_oid`'s serialized bytes contain `refs`;
        pin each inner object with its owner so it outlives the container.
        Returns the children list for the container's owner record."""
        children = []
        for ref in refs:
            child = ref.binary()
            addr = ref.owner_addr
            children.append((child, addr))
            if addr is None or tuple(addr) == tuple(self.owner_addr):
                with self._mem_lock:
                    rec = self._owned.get(child)
                    if rec is not None:
                        rec["containers"].add(container_oid)
            else:
                self.io.spawn(self._owner_call(
                    tuple(addr), "pin_container", oid=child,
                    container=container_oid))
        return children

    def free(self, refs, force: bool = True):
        """Eagerly delete objects' data (ray.internal.free analog)."""
        for ref in refs if isinstance(refs, (list, tuple)) else [refs]:
            oid = ref.binary()
            if oid in self._owned:
                with self._mem_lock:
                    rec = self._owned.get(oid)
                    if rec is not None:
                        rec["borrowers"].clear()
                        rec["containers"].clear()
                        self._local_refs.pop(oid, None)
                self._maybe_free(oid)
            elif ref.owner_addr is not None:
                self.io.spawn(self._owner_call(
                    tuple(ref.owner_addr), "force_free", oid=oid))

    async def _free_on_node(self, node_id: bytes, oid: bytes):
        addr = self._node_address(node_id)
        if addr is None:
            return
        try:
            client = await self._raylet_for(addr)
            await client.call("free_object", oid=oid)
        except Exception:
            pass

    async def _owner_call(self, addr: Tuple, method: str, **kw):
        """Ordered, best-effort RPC to an object owner (per-address lock so
        borrow/unborrow sequences never reorder)."""
        try:
            lock = self._owner_locks.setdefault(addr, asyncio.Lock())
            async with lock:
                client = self._owner_clients.get(addr)
                if client is None or client._dead:
                    client = RpcClient(*addr)
                    await client.connect(timeout=10)
                    self._owner_clients[addr] = client
                return await client.call(method, timeout=30, **kw)
        except Exception:
            return None  # owner gone: object is orphaned, nothing to do

    # -- owner-side protocol handlers (served by core_server) --------------

    async def _h_borrow(self, conn, oid: bytes, borrower: str):
        with self._mem_lock:
            rec = self._owned.get(oid)
            if rec is None:
                return {"found": False}
            rec["borrowers"].add(borrower)
        self._ensure_death_subscription()
        return {"found": True}

    async def _h_unborrow(self, conn, oid: bytes, borrower: str):
        with self._mem_lock:
            rec = self._owned.get(oid)
            if rec is not None:
                rec["borrowers"].discard(borrower)
        if rec is not None:
            self._maybe_free(oid)
        return {"ok": True}

    async def _h_pin_container(self, conn, oid: bytes, container: bytes):
        with self._mem_lock:
            rec = self._owned.get(oid)
            if rec is None:
                return {"found": False}
            rec["containers"].add(container)
        return {"found": True}

    async def _h_unpin_container(self, conn, oid: bytes, container: bytes):
        with self._mem_lock:
            rec = self._owned.get(oid)
            if rec is not None:
                rec["containers"].discard(container)
        if rec is not None:
            self._maybe_free(oid)
        return {"ok": True}

    async def _h_get_object(self, conn, oid: bytes):
        """Owner-side fetch: lets borrowers resolve refs whose value lives
        only in this process's memory store (nested refs, small results)."""
        with self._mem_lock:
            value = self.memory_store.get(oid, _MISSING)
        if value is not _MISSING and not isinstance(value, RayTpuError):
            segments, _ = serialization.serialize(value)
            return {"found": True, "payload": serialization.join_segments(segments)}
        rec = self._owned.get(oid)
        if rec is not None and rec["locations"]:
            return {"found": True, "location": next(iter(rec["locations"]))}
        if self.store is not None and self.store.contains(oid):
            return {"found": True, "location": self.node_id}
        return {"found": False}

    async def _h_force_free(self, conn, oid: bytes):
        with self._mem_lock:
            rec = self._owned.get(oid)
            if rec is not None:
                rec["borrowers"].clear()
                rec["containers"].clear()
                self._local_refs.pop(oid, None)
        self._maybe_free(oid)
        return {"ok": True}

    def _ensure_death_subscription(self):
        """Prune borrowers when their worker process dies (borrower-crash
        leg of the borrower protocol). Raylets report worker deaths to the
        GCS, which republishes on the 'worker_death' channel."""
        if self._death_sub_client is not None:
            return
        self._death_sub_client = True  # claim before the async connect

        async def on_push(method, data):
            if method != "pubsub" or data.get("channel") != "worker_death":
                return
            dead = data["message"].get("worker_id")
            if not dead:
                return
            affected = []
            with self._mem_lock:
                for oid, rec in list(self._owned.items()):
                    if dead in rec["borrowers"]:
                        rec["borrowers"].discard(dead)
                        affected.append(oid)
            for oid in affected:
                self._maybe_free(oid)

        async def _resub(client):
            await client._call_once("subscribe", 30,
                                    dict(channels=["worker_death"]))

        async def _connect():
            client = RpcClient(self.gcs.host, self.gcs.port, on_push=on_push,
                               auto_reconnect=True, on_reconnect=_resub)
            await client.connect(timeout=30)
            await client.call("subscribe", channels=["worker_death"])
            self._death_sub_client = client

        self.io.spawn(_connect())

    STREAMING = -1  # num_returns sentinel on the wire

    @classmethod
    def _normalize_num_returns(cls, num_returns) -> int:
        if num_returns == "streaming":
            return cls.STREAMING
        n = int(num_returns)
        if n < 0 and n != cls.STREAMING:
            raise ValueError(f"invalid num_returns {num_returns!r}")
        return n

    # ------------------------------------------------------------ normal tasks

    def submit_task(self, fn, args, kwargs, *, name: str, num_returns: int,
                    resources: Dict[str, float], max_retries: int,
                    scheduling_strategy=None, placement_group_id=None,
                    bundle_index=-1) -> List[ObjectRef]:
        self._drain_dropped_refs()
        fn_id = self.register_function(fn)
        num_returns = self._normalize_num_returns(num_returns)
        ser_args, names, pins = self.serialize_args(args, kwargs)
        task_id = TaskID.generate().binary()
        spec = TaskSpec(
            task_id=task_id, fn_id=fn_id, name=name, args=ser_args,
            kwarg_names=names, num_returns=num_returns, resources=resources,
            max_retries=max_retries, scheduling_strategy=scheduling_strategy,
            placement_group_id=placement_group_id,
            placement_group_bundle_index=bundle_index,
            pinned_oids=pins,
            # Propagate the caller's trace context (if any): the executing
            # worker adopts it so its execute span parents under ours.
            trace_id=tracing.current_trace_id(),
            parent_span_id=tracing.current_span_id())
        self.pin_args(pins)
        if num_returns == self.STREAMING:
            gen = self._make_generator(task_id)
            self.io.spawn(self._submit_async(spec))
            return [gen]
        refs = []
        with self._mem_lock:
            for i in range(num_returns):
                oid = ObjectID.for_task_return(TaskID(task_id), i).binary()
                self.result_futures[oid] = SyncFuture()
                self._result_meta[oid] = {"task_id": task_id.hex(),
                                          "name": name}
                refs.append(ObjectRef(oid, owner=self.node_id,
                                      owner_addr=self.owner_addr))
        for ref in refs:
            self._new_owned(ref.binary(), inline=True)
            self.register_ref(ref)
        self._record_lineage(spec, [r.binary() for r in refs])
        self.io.spawn(self._submit_async(spec))
        return refs

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = False) -> bool:
        """Cancel the task producing `ref` (ray.cancel analog).

        Queued tasks are dequeued and fail immediately with
        TaskCancelledError. Running tasks get a best-effort interrupt
        injected into the executing thread (async tasks are cancelled on
        the loop); `force=True` additionally kills the worker process.
        Returns True if a cancellation was delivered, False if the task
        already finished (or is unknown — e.g. an actor method, which the
        reference also refuses to cancel this way). `recursive` is
        accepted for signature parity; child-task cancellation is not
        propagated.
        """
        from ray_tpu_torch.core.exceptions import TaskCancelledError

        if recursive:
            # Accepted for signature parity only — don't let callers rely
            # on child cancellation that never happens.
            logger.warning(
                "cancel(recursive=True): child-task cancellation is not "
                "propagated; only the task producing this ref is cancelled")
        oid = ref.binary() if hasattr(ref, "binary") else ref.id.binary()
        with self._mem_lock:
            rec = self._lineage.get(oid)
            fut = self.result_futures.get(oid)
            # Completed tasks pop their result future; the VALUE is the
            # evidence of completion. Returning False here must leave no
            # trace, or a no-op cancel would poison later reconstruction.
            finished = (fut.done() if fut is not None
                        else (oid in self.memory_store
                              or oid in self._object_locations))
        if rec is None or finished:
            return False
        spec = rec["spec"]
        task_id = spec.task_id
        self._cancelled_tasks.add(task_id)

        async def _do_cancel() -> bool:
            # 1. still queued? dequeue + fail (never reaches a worker).
            for state in self._keys.values():
                for queued in list(state.queue):
                    if queued.task_id == task_id:
                        state.queue.remove(queued)
                        self._complete_error(queued, TaskCancelledError(
                            f"task {queued.name} was cancelled"))
                        return True
            # 2. dispatched: interrupt the executing worker.
            lease = self._inflight_tasks.get(task_id)
            if lease is not None and lease.client is not None:
                try:
                    reply = await lease.client.call(
                        "cancel_task", task_id=task_id, force=force)
                    return bool(reply.get("ok"))
                except (ConnectionLost, OSError):
                    return True  # worker died with the cancel: cancelled
            # 3. neither queued nor on a worker but still pending: it is
            # awaiting dependency resolution — the post-resolve
            # _cancelled_tasks check in _run_on_lease will fail it before
            # it ever reaches a worker.
            with self._mem_lock:
                pending = (fut is not None and not fut.done())
            return pending
        try:
            delivered = bool(self.io.run(_do_cancel(), timeout=30))
        except Exception:
            logger.exception("cancel of %s failed", spec.name)
            delivered = False
        if not delivered:
            # No cancellation happened: leave no trace (the flag would
            # otherwise suppress legitimate retries/reconstruction).
            self._cancelled_tasks.discard(task_id)
        return delivered

    # ------------------------------------------------------------ lineage


    def _record_lineage(self, spec: TaskSpec, return_oids: List[bytes]):
        """Owner-side lineage for plasma-result reconstruction
        (TaskManager lineage analog, task_manager.h:219,577; recovery
        object_recovery_manager.h:38). Stateless tasks only — actor method
        results are never re-executed out of band."""
        if spec.actor_id is not None:
            return
        import copy

        pristine = copy.deepcopy(spec)
        pristine.pinned_oids = None  # pins belong to the original attempt
        rec = {"spec": pristine, "oids": list(return_oids),
               "attempts": cfg().reconstruction_attempts}
        with self._mem_lock:
            for oid in return_oids:
                self._lineage[oid] = rec
            # Bound lineage memory: drop oldest entries beyond the cap
            # (lineage bytes cap analog).
            while len(self._lineage) > cfg().lineage_max_entries:
                self._lineage.pop(next(iter(self._lineage)))

    def _reconstruct_start(self, oid: bytes,
                           preempted: bool = False) -> Optional[SyncFuture]:
        """Kick off re-execution of the task whose lineage produced `oid`;
        returns the result future (None if no lineage/attempts remain).
        If a (re-)execution producing `oid` is already in flight, piggyback
        on its future instead of double-executing the producer.
        `preempted=True` (the copy was lost to an announced node
        retirement) re-executes WITHOUT consuming the attempt budget."""
        with self._mem_lock:
            existing = self.result_futures.get(oid)
            if existing is not None and not existing.done():
                return existing
            rec = self._lineage.get(oid)
            if rec is None or rec["attempts"] <= 0:
                return None
            if rec["spec"].task_id in self._cancelled_tasks:
                return None  # cancelled tasks never re-execute
            if not preempted:
                rec["attempts"] -= 1
            import copy

            spec = copy.deepcopy(rec["spec"])
            out = None
            for roid in rec["oids"]:
                self.memory_store.pop(roid, None)
                self._object_locations.pop(roid, None)
                fut = SyncFuture()
                self.result_futures[roid] = fut
                if roid == oid:
                    out = fut
        logger.warning("reconstructing lost object %s by re-executing %s",
                       oid.hex()[:12], spec.name)
        self.io.spawn(self._submit_async(spec))
        return out

    def _reconstruct(self, oid: bytes, timeout: Optional[float],
                     preempted: bool = False) -> bool:
        """Re-execute the task whose lineage produced `oid` (the object's
        primary copy was lost with its node). Returns True if a new attempt
        was submitted and completed."""
        fut = self._reconstruct_start(oid, preempted=preempted)
        if fut is None:
            return False
        try:
            fut.result(timeout if timeout is not None else 600)
        except Exception:
            return False
        return True

    def _scheduling_key(self, spec: TaskSpec) -> Tuple:
        res = tuple(sorted(spec.resources.items()))
        pg = (spec.placement_group_id, spec.placement_group_bundle_index)
        return (spec.fn_id, res, pg)

    async def _submit_async(self, spec: TaskSpec):
        # Resolve dependencies BEFORE the task can enter a queue or occupy a
        # lease (the reference's DependencyResolver runs before
        # RequestNewWorkerLease, normal_task_submitter.cc:117): a queued task
        # is always runnable. Resolving after lease assignment deadlocks the
        # pool — downstream tasks hold every worker awaiting upstream outputs
        # while the upstream tasks sit queued with no worker to run on.
        try:
            dep_err = await self._resolve_dependencies(spec)
        except Exception as e:
            # A failed resolve must surface on the result future, not kill
            # this (unobserved) coroutine — else get() hangs with no error.
            dep_err = e if isinstance(e, RayTpuError) else RayTpuError(
                f"dependency resolution for {spec.name} failed: {e!r}")
        if dep_err is not None:
            self._complete_error(spec, dep_err)
            return
        if spec.task_id in self._cancelled_tasks:
            # Cancelled while parked on a pending dependency: fail it here
            # rather than requesting (possibly forking) a worker just so
            # _run_on_lease can fail it.
            from ray_tpu_torch.core.exceptions import TaskCancelledError

            self._complete_error(
                spec, TaskCancelledError(f"task {spec.name} was cancelled"))
            return
        key = self._scheduling_key(spec)
        state = self._keys.setdefault(key, _KeyState())
        state.queue.append(spec)
        await self._pump(key, state)

    async def _pump(self, key, state: _KeyState):
        # Assign queued tasks to idle leases.
        for lease in state.leases:
            if not state.queue:
                break
            if not lease.busy:
                spec = state.queue.pop(0)
                self._cancel_return(lease)
                lease.busy = True
                asyncio.ensure_future(self._run_on_lease(key, state, lease, spec))
        # Transfer idle leases from compatible keys (same resources/pg/env,
        # different function): workers are function-agnostic — they load any
        # function from the GCS table — so a warm worker leased for f can run
        # g without a raylet round-trip. The reference keys leases strictly
        # per-SchedulingKey (normal_task_submitter.h:52) and pays only a
        # PopWorker on a miss; here a pool miss forks a ~1s Python process,
        # so cross-key reuse is this build's warm-dispatch path.
        while state.queue:
            stolen = self._steal_idle_lease(key)
            if stolen is None:
                break
            spec = state.queue.pop(0)
            state.leases.append(stolen)
            stolen.busy = True
            asyncio.ensure_future(self._run_on_lease(key, state, stolen, spec))
        # Match outstanding lease requests to unassigned work: request more if
        # short, cancel extras if the queue drained (the raylet would otherwise
        # grant stale speculative leases and starve other scheduling keys).
        want = min(len(state.queue), cfg().lease_max_inflight_requests)
        if want > len(state.inflight_reqs):
            for _ in range(want - len(state.inflight_reqs)):
                req_id = os.urandom(8)
                state.inflight_reqs.add(req_id)
                asyncio.ensure_future(self._request_lease(key, state, req_id))
        elif want < len(state.inflight_reqs):
            extra = len(state.inflight_reqs) - want
            extras = list(state.inflight_reqs)[:extra]
            # The requests may have spilled; cancel everywhere we talk to,
            # one batched frame per raylet instead of reqs x raylets calls.
            for target in [self.raylet, *self._raylet_clients.values()]:
                asyncio.ensure_future(self._cancel_lease_reqs(target, extras))

    def _steal_idle_lease(self, key) -> Optional[_LeasedWorker]:
        """Pop an idle leased worker from a scheduling key that differs only
        in fn_id (identical resources / placement-group slot —
        any worker satisfying those can execute this key's tasks too).
        Fully-drained key states are pruned on the way so the scan stays
        bounded by LIVE keys, not every function ever submitted."""
        dead_keys = []
        found = None
        for other_key, other in self._keys.items():
            if other_key == key:
                continue
            if not other.leases and not other.queue and not other.inflight_reqs:
                dead_keys.append(other_key)
                continue
            if found is not None or other_key[1:] != key[1:]:
                continue
            if other.queue:
                continue  # its own work would just re-fork; don't starve it
            for lease in other.leases:
                if not lease.busy:
                    self._cancel_return(lease)
                    other.leases.remove(lease)
                    found = lease
                    break
        for dk in dead_keys:
            del self._keys[dk]
        return found

    async def _lease_idle(self, key, state: _KeyState, lease: _LeasedWorker):
        """A lease just went idle: feed its own queue first, else hand the
        warm worker to a compatible key with waiting work (the push half of
        cross-key reuse — without it, work queued while this lease was busy
        would wait out lease_idle_timeout_s and then fork anyway), else arm
        the idle-return timer."""
        lease.busy = False
        if state.queue:
            await self._pump(key, state)
            return
        for t_key, t_state in self._keys.items():
            if t_key == key or t_key[1:] != key[1:] or not t_state.queue:
                continue
            state.leases.remove(lease)
            t_state.leases.append(lease)
            lease.busy = True
            spec = t_state.queue.pop(0)
            asyncio.ensure_future(self._run_on_lease(t_key, t_state, lease, spec))
            return
        self._schedule_return(key, state, lease)

    async def _cancel_lease_reqs(self, target, req_ids):
        """Cancel a set of lease requests on one raylet in one
        cancel_lease_batch call; a dead raylet has nothing left to
        cancel."""
        try:
            await target.call("cancel_lease_batch", req_ids=list(req_ids))
        except Exception:
            pass

    async def _raylet_for(self, address: Tuple[str, int]) -> RpcClient:
        client = self._raylet_clients.get(address)
        if client is None or client._dead:
            client = RpcClient(*address, on_push=self._on_raylet_push)
            await client.connect(timeout=15)
            self._raylet_clients[address] = client
        return client

    async def _lease_call(self, target, resources, req_id, pg_id,
                          bundle_index) -> dict:
        """One lease RPC, coalesced into a LeaseBatchRequestMsg frame (one
        scheduling pass on the raylet grants the whole batch)."""
        from ray_tpu_torch.runtime import wire

        msg = wire.LeaseRequestMsg(
            resources=resources, for_actor=False,
            placement_group_id=pg_id or b"", bundle_index=bundle_index,
            req_id=req_id or os.urandom(8), holder=self.worker_ident)
        return await self._lease_call_batched(target, msg)

    async def _lease_call_batched(self, target, msg) -> dict:
        """Enqueue one lease request on the per-raylet micro-batch buffer
        and await its resolution. Requests landing on the same event-loop
        tick coalesce into one LeaseBatchRequestMsg (the buffer flushes on
        the next tick, or eagerly at lease_batch_max); replies arrive
        either inline in the LeaseBatchReplyMsg or later via a
        `lease_grant` push (see raylet.handle_lease_batch2)."""
        fut = asyncio.get_event_loop().create_future()
        buf = self._lease_batch_buf.setdefault(target, [])
        buf.append((msg, fut))
        if len(buf) >= cfg().lease_batch_max:
            self._lease_batch_buf.pop(target, None)
            asyncio.ensure_future(self._send_lease_batch(target, buf))
        elif len(buf) == 1:
            asyncio.ensure_future(self._flush_lease_batch(target))
        try:
            # The reply for a pending entry rides a push on the raylet
            # connection; if that connection dies the push never comes, so
            # poll connection liveness rather than waiting forever.
            while True:
                try:
                    return await asyncio.wait_for(asyncio.shield(fut), 1.0)
                except asyncio.TimeoutError:
                    if target._dead or target._closed:
                        raise ConnectionLost(
                            "raylet connection lost awaiting lease grant")
        finally:
            self._lease_grant_waiters.pop(msg.req_id, None)

    async def _flush_lease_batch(self, target):
        await asyncio.sleep(0)  # let same-tick requests pile on
        buf = self._lease_batch_buf.pop(target, None)
        if buf:
            await self._send_lease_batch(target, buf)

    async def _send_lease_batch(self, target, buf):
        from ray_tpu_torch.runtime import wire

        by_id = {msg.req_id: fut for msg, fut in buf}
        # Register waiters BEFORE the call: a pending entry's lease_grant
        # push can arrive while we're still decoding the batch reply.
        self._lease_grant_waiters.update(by_id)
        try:
            encoded = await target.call(
                "lease_batch2",
                m=wire.LeaseBatchRequestMsg(
                    entries=[msg for msg, _ in buf]).encode())
            reply = wire.LeaseBatchReplyMsg.decode(encoded)
        except Exception as e:
            for msg, _ in buf:
                self._lease_grant_waiters.pop(msg.req_id, None)
            for _, fut in buf:
                if not fut.done():
                    fut.set_exception(
                        e if isinstance(e, Exception) else RpcError(repr(e)))
            return
        for entry in reply.entries:
            fut = by_id.get(entry.req_id)
            if fut is not None and not fut.done():
                self._lease_grant_waiters.pop(entry.req_id, None)
                fut.set_result(entry.to_reply())
        # Entries in reply.pending resolve later via the lease_grant push
        # (_on_raylet_push); their waiters stay registered.

    async def _request_lease(self, key, state: _KeyState, req_id: bytes):
        spec_resources = dict(key[1])
        pg_id, bundle_index = key[2]
        reply = None
        last_err = None
        # A spillback target can die between the routing decision (possibly
        # made from a stale gossip view) and our connect: restart the chain
        # from the local raylet, whose view self-corrects within a heartbeat.
        for attempt in range(4):
            target = self.raylet
            try:
                for _hop in range(4):  # bounded spillback chain
                    reply = await self._lease_call(
                        target, spec_resources, req_id, pg_id, bundle_index)
                    if reply.get("spillback"):
                        target = await self._raylet_for(tuple(reply["spillback"]))
                        continue
                    break
                break
            except Exception as e:
                last_err = e
                reply = None
                await asyncio.sleep(0.5 * (attempt + 1))
        if reply is None:
            state.inflight_reqs.discard(req_id)
            self._fail_queued(
                state, RayTpuError(f"lease request failed: {last_err!r}"))
            return
        state.inflight_reqs.discard(req_id)
        if not reply.get("ok"):
            if reply.get("canceled"):
                # The cancel raced new work: the queue may have refilled
                # while this request was dying, and with it gone nothing
                # else would re-pump this key — a silent stall.
                if state.queue:
                    await self._pump(key, state)
                return
            if state.queue:
                self._fail_queued(state, RayTpuError(reply.get("error", "lease refused")))
            return
        lease = _LeasedWorker(reply["lease_id"], reply["worker_id"],
                              tuple(reply["worker_address"]), reply["node_id"],
                              target)
        try:
            lease.client = RpcClient(*lease.address,
                                     on_push=self._on_worker_push)
            await lease.client.connect(timeout=15)
        except Exception:
            await self._return_lease(state, lease, dead=True)
            return
        state.leases.append(lease)
        await self._pump(key, state)
        if not lease.busy:
            # Granted after the queue drained (speculative grant): give the
            # worker back promptly so it doesn't pin resources.
            self._schedule_return(key, state, lease)

    def _fail_queued(self, state: _KeyState, err: RayTpuError):
        while state.queue:
            spec = state.queue.pop(0)
            self._complete_error(spec, err)

    async def _resolve_dependencies(self, spec: TaskSpec) -> Optional[RayTpuError]:
        """DependencyResolver analog (normal_task_submitter.cc): before a
        spec may enter a key queue, wait for pending ObjectRef args; inline
        values that live only in this process's memory store (workers can't
        see it), keep plasma refs as-is. Returns an error to propagate if a
        dependency failed."""
        for i, arg in enumerate(spec.args):
            kind, payload = arg[0], arg[1]
            if kind != "r":
                continue
            oid = payload
            with self._mem_lock:
                fut = self.result_futures.get(oid)
            if fut is not None:
                try:
                    await asyncio.wrap_future(fut)
                except Exception:
                    pass
            with self._mem_lock:
                value = self.memory_store.get(oid, _MISSING)
            if value is not _MISSING:
                if isinstance(value, RayTpuError):
                    return value
                segments, _ = serialization.serialize(value)
                spec.args[i] = ("v", serialization.join_segments(segments))
            else:
                # Plasma-resident dependency: the owner recorded at
                # serialize_args time predates task completion — refresh it
                # now that the location of the result is known.
                location = self._object_locations.get(oid)
                if location is not None:
                    spec.args[i] = ("r", oid, location)
        return None

    async def _run_on_lease(self, key, state: _KeyState, lease: _LeasedWorker,
                            spec: TaskSpec):
        from ray_tpu_torch.core.exceptions import TaskCancelledError

        if spec.task_id in self._cancelled_tasks:
            # Cancelled while queued but popped before the cancel scan saw
            # it: fail it here instead of dispatching.
            self._complete_error(
                spec, TaskCancelledError(f"task {spec.name} was cancelled"))
            await self._lease_idle(key, state, lease)
            return
        # Dependencies were resolved BEFORE the spec entered the queue
        # (_submit_async) — a queued task is always runnable, so nothing may
        # await here while holding the lease.
        self._inflight_tasks[spec.task_id] = lease
        try:
            reply = await self._push_call(lease.client, "push_task", spec)
        except (ConnectionLost, OSError):
            self._inflight_tasks.pop(spec.task_id, None)
            state.leases.remove(lease)
            await self._return_lease(state, lease, dead=True)
            if spec.task_id in self._cancelled_tasks:
                # force-cancel kills the worker mid-push: that death is
                # the cancellation, never a retryable crash.
                self._complete_error(spec, TaskCancelledError(
                    f"task {spec.name} was cancelled (force)"))
                return
            # Streaming tasks never retry transparently: items already
            # consumed by the caller cannot be un-yielded, so a re-execution
            # would duplicate them (the reference checkpoints the consumed
            # index; we surface the failure instead).
            if spec.max_retries > 0 and spec.num_returns != self.STREAMING:
                # A death caused by an announced drain/preemption does not
                # consume the retry budget (the node was retired on
                # schedule — retrying is the designed recovery, not a
                # symptom worth rationing).
                if not await self._node_was_preempted_async(lease.node_id):
                    spec.max_retries -= 1
                logger.warning("task %s worker died; retrying", spec.name)
                # Through _submit_async, not the queue directly: the resolve
                # pass refreshes plasma arg locations that may have died
                # with the worker's node (near-instant — deps are done).
                await self._submit_async(spec)
            else:
                self._complete_error(spec, WorkerCrashedError(
                    f"worker running {spec.name} died"))
            return
        except Exception as e:
            # Non-connection failure (e.g. worker couldn't load the function):
            # surface it on the result futures and free the lease.
            self._inflight_tasks.pop(spec.task_id, None)
            self._complete_error(spec, e if isinstance(e, RayTpuError)
                                 else RayTpuError(f"task push failed: {e!r}"))
            await self._lease_idle(key, state, lease)
            return
        self._inflight_tasks.pop(spec.task_id, None)
        lost_oid = self._lost_arg_oid(spec, reply)
        if lost_oid is not None:
            # Recursive object recovery (object_recovery_manager.h:38):
            # the task failed because one of its ARGS was lost. Release the
            # lease FIRST — the reconstruction may need the very resources
            # this lease holds (holding it while awaiting would deadlock a
            # fully-subscribed cluster) — then recover + resubmit aside.
            await self._lease_idle(key, state, lease)
            asyncio.ensure_future(
                self._recover_and_resubmit(spec, reply, lost_oid))
            return
        self._complete_task(spec, reply)
        await self._lease_idle(key, state, lease)

    async def _push_call(self, client, method: str, spec: TaskSpec) -> dict:
        """One task/actor push in the typed TaskSpecMsg/TaskReplyMsg
        envelope."""
        from ray_tpu_torch.runtime import wire

        encoded = await client.call(method + "2", m=spec.to_wire())
        return wire.TaskReplyMsg.decode(encoded).to_reply()

    def _lost_arg_oid(self, spec: TaskSpec, reply: dict) -> Optional[bytes]:
        """The oid of a reconstructible lost dependency, or None."""
        if reply.get("status") != "error" or spec.num_returns == self.STREAMING:
            return None
        cause = getattr(reply.get("error"), "cause", None)
        oid = getattr(cause, "oid", None)
        if oid is None:
            return None
        # Only an ARG-resolution loss is safe to recover by re-running: the
        # body never executed. An ObjectLostError raised from inside the
        # body (a get() on some unrelated ref) means the body DID run —
        # re-executing would duplicate side effects against max_retries.
        if oid not in {a[1] for a in spec.args if a[0] == "r"}:
            return None
        if getattr(spec, "_recon_retries", 0) >= \
                cfg().max_dependency_reconstructions:
            return None
        with self._mem_lock:
            rec = self._lineage.get(oid)
            if rec is None or rec["attempts"] <= 0:
                return None
        return oid

    async def _recover_and_resubmit(self, spec: TaskSpec, reply: dict,
                                    oid: bytes):
        """Reconstruct a lost arg, then resubmit the failed task (user
        retries are NOT consumed; bounded by max_dependency_reconstructions
        and the arg's own lineage attempts)."""
        try:
            spec._recon_retries = getattr(spec, "_recon_retries", 0) + 1
            fut = self._reconstruct_start(oid)
            if fut is not None:
                await asyncio.wait_for(asyncio.wrap_future(fut), 600)
                with self._mem_lock:
                    err = self.memory_store.get(oid)
                if not isinstance(err, RayTpuError):
                    # (_resolve_dependencies refreshes the arg's embedded
                    # location from _object_locations on resubmit.)
                    logger.warning("recovered lost dependency %s; re-running "
                                   "%s", oid.hex()[:12], spec.name)
                    await self._submit_async(spec)
                    return
        except Exception:
            logger.exception("lost-arg recovery for %s failed", spec.name)
        self._complete_task(spec, reply)

    def _schedule_return(self, key, state: _KeyState, lease: _LeasedWorker):
        loop = asyncio.get_event_loop()
        self._cancel_return(lease)
        lease.return_timer = loop.call_later(
            cfg().lease_idle_timeout_s,
            lambda: asyncio.ensure_future(self._maybe_return(key, state, lease)))

    def _cancel_return(self, lease: _LeasedWorker):
        if lease.return_timer is not None:
            lease.return_timer.cancel()
            lease.return_timer = None

    async def _maybe_return(self, key, state: _KeyState, lease: _LeasedWorker):
        if lease.busy or state.queue:
            return
        if lease in state.leases:
            state.leases.remove(lease)
        await self._return_lease(state, lease, dead=False)

    async def _return_lease(self, state, lease: _LeasedWorker, dead: bool):
        try:
            await lease.raylet.call("return_worker", lease_id=lease.lease_id,
                                    worker_dead=dead)
        except Exception:
            pass
        if lease.client is not None:
            await lease.client.close()

    def _complete_task(self, spec: TaskSpec, reply: dict):
        # A successfully-completed task is beyond cancellation: drop the
        # flag so the set stays bounded and future reconstruction of this
        # task's objects is never suppressed by a raced/no-op cancel.
        self._cancelled_tasks.discard(spec.task_id)
        if spec.pinned_oids:
            self.unpin_args(spec.pinned_oids)
            spec.pinned_oids = None
        if spec.num_returns == self.STREAMING:
            gen = self._generators.pop(spec.task_id, None)
            if gen is None:
                return
            if reply["status"] == "ok":
                gen.finish(reply["streamed"])
            else:
                gen.fail(reply["error"], reply.get("streamed"))
            return
        if reply["status"] == "ok":
            returns = reply["returns"]
            node_id = reply.get("node_id")
            # Deserialize OUTSIDE the lock: payloads may contain ObjectRefs
            # whose unpickling re-enters register_ref (same lock).
            values = {}
            for i, ret in enumerate(returns):
                if ret[0] == "v":
                    values[i] = serialization.deserialize(ret[1])
            displaced = []  # destroy evicted values outside the lock
            with self._mem_lock:
                for i, ret in enumerate(returns):
                    kind = ret[0]
                    children = ret[2] if len(ret) > 2 else None
                    oid = ObjectID.for_task_return(TaskID(spec.task_id), i).binary()
                    if kind == "v":
                        displaced.append(self.memory_store.pop(oid, None))
                        self.memory_store[oid] = values[i]
                    elif node_id is not None:
                        # Sealed in the executing node's plasma store.
                        self._object_locations[oid] = node_id
                    rec = self._owned.get(oid)
                    if rec is not None:
                        if kind != "v" and node_id is not None:
                            rec["locations"].add(node_id)
                            rec["inline"] = False
                        # The executor already pinned these children with
                        # their owners; we unpin when this return is freed.
                        if children:
                            rec["children"].extend(children)
                    fut = self.result_futures.pop(oid, None)
                    self._result_meta.pop(oid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(True)
            del displaced
        else:
            err = reply["error"]
            self._complete_error(spec, err)

    def _complete_error(self, spec: TaskSpec, err: RayTpuError):
        if spec.pinned_oids:
            self.unpin_args(spec.pinned_oids)
            spec.pinned_oids = None
        if spec.num_returns == self.STREAMING:
            gen = self._generators.pop(spec.task_id, None)
            if gen is not None:
                gen.fail(err)
            return
        displaced = []  # destroy evicted values outside the lock (see
        with self._mem_lock:  # _maybe_free for why)
            for i in range(spec.num_returns):
                oid = ObjectID.for_task_return(TaskID(spec.task_id), i).binary()
                displaced.append(self.memory_store.pop(oid, None))
                self.memory_store[oid] = err
                fut = self.result_futures.pop(oid, None)
                self._result_meta.pop(oid, None)
                if fut is not None and not fut.done():
                    fut.set_result(True)
        del displaced

    # ------------------------------------------------------------ actor tasks

    def create_actor(self, spec: ActorSpec, timeout: float = 300.0) -> dict:
        return self.io.run(self.gcs.call("create_actor", spec=spec, timeout=timeout))

    def submit_actor_task(self, actor_id: bytes, method_name: str, args, kwargs,
                          *, num_returns: int, name: str,
                          max_task_retries: int = 0) -> List[ObjectRef]:
        num_returns = self._normalize_num_returns(num_returns)
        ser_args, names, pins = self.serialize_args(args, kwargs)
        task_id = TaskID.generate().binary()
        spec = TaskSpec(task_id=task_id, fn_id=b"", name=name, args=ser_args,
                        kwarg_names=names, num_returns=num_returns,
                        max_retries=max_task_retries, actor_id=actor_id,
                        method_name=method_name, pinned_oids=pins,
                        trace_id=tracing.current_trace_id(),
                        parent_span_id=tracing.current_span_id())
        self.pin_args(pins)
        client = self._actor_clients.get(actor_id)
        if client is None:
            client = self._actor_clients.setdefault(actor_id, _ActorClient(self, actor_id))
        if num_returns == self.STREAMING:
            gen = self._make_generator(task_id)
            self.io.spawn(client.enqueue(spec))
            return [gen]
        refs = []
        with self._mem_lock:
            for i in range(num_returns):
                oid = ObjectID.for_task_return(TaskID(task_id), i).binary()
                self.result_futures[oid] = SyncFuture()
                self._result_meta[oid] = {"task_id": task_id.hex(),
                                          "name": name,
                                          "actor_id": actor_id.hex()}
                refs.append(ObjectRef(oid, owner_addr=self.owner_addr))
        for ref in refs:
            self._new_owned(ref.binary(), inline=True)
            self.register_ref(ref)
        self.io.spawn(client.enqueue(spec))
        return refs

    def actor_stats(self, actor_id: bytes, timeout: float = 5.0) -> dict:
        """Query an actor worker's execution stats (queued + ongoing actor
        tasks) over a direct RPC served on the worker's IO loop — never
        queued behind user code (used by serve autoscaling)."""
        return self.actor_stats_many([actor_id], timeout=timeout)[0]

    def actor_stats_many(self, actor_ids: Sequence[bytes],
                         timeout: float = 5.0) -> List[Optional[dict]]:
        """Concurrent actor_stats over many actors; one wall-clock timeout
        budget for the whole batch. Unreachable actors yield None (their
        query coroutine is cancelled, not leaked)."""
        clients = []
        for actor_id in actor_ids:
            client = self._actor_clients.get(actor_id)
            if client is None:
                client = self._actor_clients.setdefault(
                    actor_id, _ActorClient(self, actor_id))
            clients.append(client)

        async def _one(client):
            try:
                await client._ensure_connected()
                return await client.client.call("actor_stats", timeout=timeout)
            except Exception:
                return None

        async def _all():
            return await asyncio.gather(
                *(asyncio.wait_for(_one(c), timeout) for c in clients),
                return_exceptions=True)

        results = self.io.run(_all(), timeout=timeout + 5)
        return [r if isinstance(r, dict) else None for r in results]

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        self.io.run(self.gcs.call("kill_actor", actor_id=actor_id,
                                  no_restart=no_restart))

    def get_actor_info(self, actor_id=None, name=None, namespace="default") -> dict:
        return self.io.run(self.gcs.call("get_actor", actor_id=actor_id, name=name,
                                         namespace=namespace))

    # ------------------------------------------------------------ shutdown

    def shutdown(self, kill_cluster: bool):
        try:
            if kill_cluster:
                self.io.run(self.gcs.call("shutdown_cluster", timeout=5), timeout=10)
        except Exception:
            pass
        try:
            for client in self._actor_clients.values():
                if client.client is not None:
                    self.io.run(client.client.close(), timeout=2)
            for client in self._owner_clients.values():
                self.io.run(client.close(), timeout=2)
            if self._death_sub_client not in (None, True):
                self.io.run(self._death_sub_client.close(), timeout=2)
            self.io.run(self.core_server.close(), timeout=2)
            self.io.run(self.gcs.close(), timeout=2)
            if self.raylet is not None:
                self.io.run(self.raylet.close(), timeout=2)
        except Exception:
            pass
        self.io.stop()
        if self.store is not None:
            self.store.close()


class _ActorClient:
    """Direct submission channel to one actor (actor_task_submitter.h:75):
    sequence numbers, ordered delivery, reconnect-on-restart.

    Submission is PIPELINED: up to MAX_INFLIGHT calls are outstanding at
    once, so a concurrent actor (max_concurrency > 1, or async methods)
    actually executes concurrently. Wire order is GUARANTEED to be seq_no
    order because the pump itself performs every send (call_send) before
    spawning the reply-waiter task — task-per-call sending would let late
    calls overtake early ones parked on the connection-setup lock. After a
    reconnect (actor restart), retried calls may re-arrive out of order
    relative to each other — matching the reference's at-most-once,
    retry-opt-in semantics."""

    def __init__(self, core: CoreWorker, actor_id: bytes):
        self.core = core
        self.actor_id = actor_id
        self.client: Optional[RpcClient] = None
        self.seq_no = 0
        self.connect_lock = asyncio.Lock()
        self._queue: asyncio.Queue = asyncio.Queue()
        self._pump_task: Optional[asyncio.Task] = None
        self._sem = asyncio.Semaphore(cfg().actor_max_inflight_calls)

    async def enqueue(self, spec: TaskSpec):
        """Per-caller FIFO: one pump drains the queue so wire order ==
        submission order (ActorSchedulingQueue sequencing analog)."""
        await self._queue.put(spec)
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.ensure_future(self._pump())

    async def _pump(self):
        while not self._queue.empty():
            spec = self._queue.get_nowait()
            try:
                dep_err = await self.core._resolve_dependencies(spec)
            except Exception as e:
                # A failed dependency resolve must not kill the pump (that
                # would strand every queued spec with hung result futures).
                self.core._complete_error(spec, ActorDiedError(
                    self.actor_id.hex(), f"dependency resolution failed: {e!r}"))
                continue
            if dep_err is not None:
                self.core._complete_error(spec, dep_err)
                continue
            spec.seq_no = self.seq_no
            self.seq_no += 1
            await self._sem.acquire()
            # SEND from the pump itself (strictly ordered), then hand the
            # reply future to a concurrent waiter task. Spawning whole
            # call coroutines instead would let late specs overtake early
            # ones still parked on the connection-setup lock: tasks wake
            # from a lock one loop-iteration at a time while fresh tasks
            # run straight through the connected fast path — observed as
            # a contiguous run of early calls executing AFTER later ones
            # (the test_actor_ordering flake).
            fut = client = None
            try:
                await self._ensure_connected()
                client = self.client
                fut = await client.call_send("push_actor_task2",
                                             m=spec.to_wire())
            except ActorDiedError as e:
                self.core._complete_error(spec, e)
                self._sem.release()
                continue
            except Exception:
                # Transient send/connect failure: _call_one's retry loop
                # redials and re-sends (documented: retried calls may
                # re-arrive out of order, matching reference at-most-once
                # + opt-in-retry semantics).
                fut = None
            asyncio.ensure_future(self._call_one(spec, client, fut))

    async def _ensure_connected(self):
        if self.client is not None:
            return
        async with self.connect_lock:
            if self.client is not None:
                return
            # Creation is asynchronous: a call waits out PENDING_CREATION
            # (a lease waiting for a card, a long __init__) and RESTARTING.
            deadline = time.monotonic() + 900
            while True:
                info = await self.core.gcs.call("get_actor", actor_id=self.actor_id)
                if not info.get("found"):
                    raise ActorDiedError(self.actor_id.hex(), "unknown actor")
                state = info["state"]
                if state == "ALIVE":
                    client = RpcClient(*info["address"],
                                       on_push=self.core._on_worker_push)
                    await client.connect(timeout=15)
                    self.client = client
                    return
                if state == "DEAD":
                    raise actor_death_error(self.actor_id.hex(),
                                            info.get("death_reason", ""))
                if time.monotonic() > deadline:
                    raise ActorDiedError(self.actor_id.hex(),
                                         f"stuck in state {state}")
                await asyncio.sleep(0.1)

    async def _drop_client(self, client: Optional[RpcClient]):
        """Close-once under concurrent failures: only the task whose client
        reference is still current tears it down."""
        if client is not None and self.client is client:
            self.client = None
            await client.close()

    async def _call_one(self, spec: TaskSpec,
                        sent_client: Optional[RpcClient] = None,
                        sent_fut: Optional[asyncio.Future] = None):
        """Await the pump-sent reply (sent_fut); on connection loss, retry
        the full call per spec.max_retries (re-sends happen here, out of
        the ordered pump — acceptable: retry reordering is documented)."""
        try:
            # Streaming methods never retry transparently (items already
            # consumed cannot be un-yielded; see _run_on_lease).
            attempts = (1 if spec.num_returns == CoreWorker.STREAMING
                        else spec.max_retries + 1)
            last_err: Optional[BaseException] = None
            client = sent_client
            while attempts > 0:
                attempts -= 1
                try:
                    if sent_fut is not None:
                        fut, sent_fut = sent_fut, None
                        reply = await fut
                        if isinstance(reply, (bytes, bytearray, memoryview)):
                            from ray_tpu_torch.runtime import wire

                            reply = wire.TaskReplyMsg.decode(reply).to_reply()
                    else:
                        await self._ensure_connected()
                        client = self.client
                        reply = await self.core._push_call(
                            client, "push_actor_task", spec)
                    self.core._complete_task(spec, reply)
                    return
                except (ConnectionLost, OSError) as e:
                    # Connection died: drop the client; next attempt
                    # re-resolves the address (actor may be restarting).
                    await self._drop_client(client)
                    last_err = e
                except ActorDiedError as e:
                    self.core._complete_error(spec, e)
                    return
            # Retry budget exhausted on connection loss. Ask the GCS whether
            # the actor is in fact dead — its death_reason carries failure-
            # domain typing (TpuSliceLost) that a bare socket error loses.
            try:
                info = await self.core.gcs.call("get_actor",
                                                actor_id=self.actor_id)
                if info.get("found") and info.get("state") == "DEAD":
                    self.core._complete_error(spec, actor_death_error(
                        self.actor_id.hex(), info.get("death_reason", "")))
                    return
            except Exception:
                pass
            self.core._complete_error(spec, ActorDiedError(
                self.actor_id.hex(), f"connection lost: {last_err!r}"))
        except Exception as e:
            self.core._complete_error(spec, ActorDiedError(
                self.actor_id.hex(), f"submit failed: {e!r}"))
        finally:
            self._sem.release()


# ---------------------------------------------------------------- globals

_global_worker: Optional[CoreWorker] = None
_global_lock = threading.Lock()


def global_worker() -> CoreWorker:
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _global_worker


def set_global_worker(worker: Optional[CoreWorker]):
    global _global_worker
    with _global_lock:
        _global_worker = worker


def is_initialized() -> bool:
    return _global_worker is not None
