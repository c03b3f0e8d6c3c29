"""Raylet: the per-node manager.

Reference analog: src/ray/raylet/ — NodeManager (node_manager.h:118; lease
handler node_manager.cc:1915), WorkerPool (worker_pool.h:127 PopWorker,
prestart :234), LocalTaskManager (local_task_manager.cc:57), and the node's
plasma store which it creates and owns (object_manager/plasma/store_runner).

One process per node. Grants worker leases to drivers (normal tasks) and to
the GCS (actor creation); owns local resource accounting including
placement-group bundle reservations (PlacementGroupResourceManager analog).

The port's copy of ray_tpu/runtime/raylet/raylet.py, cut to leases and
batch leases, the worker pool, bundles (prepare, commit, cancel, return),
object put, pull, free and relay, and node_stats. GPUs are isolated per
lease: a lease holding cards gets a worker started with the GPU manager's
visibility env (CUDA_VISIBLE_DEVICES set to the lease's card ids), and a
pooled worker is reused only for the same ids; a worker whose lease holds
no card sees none. The JAX raylet's runtime-env agent, memory and log
monitors, drain, slice fate-sharing and span/stack/object fan-ins are
registered as refusals (UNPORTED_HANDLERS).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.runtime import accelerators, scheduling
from ray_tpu_torch.runtime.object_store import ObjectStore
from ray_tpu_torch.runtime.rpc import RawReply, RpcClient, RpcServer
from ray_tpu_torch.utils.ids import NodeID, WorkerID

logger = logging.getLogger(__name__)

DEFAULT_OBJECT_STORE_MEMORY = 2 << 30

# Handlers of the JAX package's raylet not ported yet (ROADMAP.md queue 1
# item 6): the runtime-env agent, drain, slice fate-sharing, and the span,
# stack and object fan-ins.
UNPORTED_HANDLERS = ("env_hold", "env_release", "env_stats", "drain_self",
                     "slice_lost", "dump_spans", "dump_stacks",
                     "list_objects")


def _store_dir(session_dir: str) -> str:
    """Where the shared-memory arena file lives: /dev/shm (tmpfs) when
    available, like the reference's plasma store. A disk-backed session
    dir (e.g. /tmp on ext4) turns every fresh-page write into filesystem
    block allocation + writeback — measured 5-20x slower cold puts (the
    r3 microbench's 86x put/get asymmetry was exactly this). Override
    with RAY_TPU_TORCH_STORE_DIR."""
    override = os.environ.get("RAY_TPU_TORCH_STORE_DIR")
    if override:
        return override
    shm = "/dev/shm"
    if os.path.isdir(shm) and os.access(shm, os.W_OK):
        return shm
    return session_dir


class WorkerHandle:
    def __init__(self, worker_id: bytes, proc: subprocess.Popen):
        self.worker_id = worker_id
        self.proc = proc
        self.busy_since: Optional[float] = None  # leased-task start (OOM policy)
        self.address: Optional[Tuple[str, int]] = None
        self.ready = asyncio.Event()
        self.is_actor = False
        self.actor_id: Optional[bytes] = None
        self.lease_id: Optional[bytes] = None
        self.lease_resources: Dict[str, float] = {}
        self.pg_key: Optional[Tuple[bytes, int]] = None
        self.req_id: Optional[bytes] = None
        # Worker ident (hex) of the lease HOLDER (the submitter caching this
        # lease), so its death can reclaim the lease (_reclaim_holder_leases).
        self.leased_to: str = ""
        # The GPU ids this process was started to see (its
        # CUDA_VISIBLE_DEVICES); fixed for its life, so it is reused only
        # for a lease holding the same ids.
        self.gpu_ids: Tuple[int, ...] = ()


class PendingLease:
    def __init__(self, resources, for_actor, pg_key, fut, req_id=None,
                 holder=""):
        self.resources = resources
        self.for_actor = for_actor
        self.pg_key = pg_key
        self.fut = fut
        self.req_id = req_id
        self.holder = holder
        self.enqueued = time.monotonic()
        self.gpu_ids: Tuple[int, ...] = ()  # assigned at dispatch


class Raylet:
    def __init__(self, gcs_address: Tuple[str, int], session_dir: str,
                 resources: Dict[str, float], labels: Dict[str, str],
                 object_store_memory: int = DEFAULT_OBJECT_STORE_MEMORY,
                 is_head: bool = False, host: str = "127.0.0.1",
                 worker_env: Optional[Dict[str, str]] = None):
        self.node_id = NodeID.generate().binary()
        self.gcs_address = gcs_address
        self.session_dir = session_dir
        self.total_resources = dict(resources)
        self.available = dict(resources)
        self.labels = labels
        self.is_head = is_head
        self.worker_env = worker_env or {}
        self.server = RpcServer(host, 0)
        self.server.register_all(self)
        self.server.register_unported("raylet", UNPORTED_HANDLERS)
        self.store_path = os.path.join(
            _store_dir(session_dir),
            f"store_torch_{self.node_id.hex()[:12]}.shm")
        self.object_store_memory = object_store_memory
        self.store: Optional[ObjectStore] = None
        self.gcs: Optional[RpcClient] = None
        self._workers: Dict[bytes, WorkerHandle] = {}
        self._idle: List[WorkerHandle] = []
        # Per-scheduling-class lease queues (ClusterTaskManager analog,
        # cluster_task_manager.cc:49 QueueAndScheduleTask / :188
        # ScheduleAndDispatchTasks): a scheduling class = (resource shape,
        # bundle), one FIFO per class, round-robin dispatch across classes
        # so a backlogged shape can't head-of-line-block the others. All
        # members of a class share one shape and pool, so a non-fitting
        # head blocks only its class and dispatch is O(classes), not
        # O(pending). Cluster-wide-infeasible classes park in _infeasible
        # (they also feed autoscaler demand via heartbeat backlog) and are
        # retried whenever the cluster resource view changes.
        self._queues: "collections.OrderedDict[tuple, collections.deque]" = \
            collections.OrderedDict()
        self._infeasible: Dict[tuple, collections.deque] = {}
        # Placement-group bundle reservations: (pg_id, bundle_index) ->
        # {"resources": ..., "available": ..., "gpu_free": [...]};
        # prepared-but-uncommitted hold resources too (2PC).
        self._bundles: Dict[Tuple[bytes, int], Dict] = {}
        # Free GPU ids of the node (a bundle takes its ids out at prepare).
        self._gpu_free: List[int] = list(range(int(
            self.total_resources.get("GPU", 0))))
        self._shutdown = asyncio.Event()
        self._monitor_task = None
        self._heartbeat_task = None
        self._spill_task = None
        self._cluster_view: List[dict] = []
        # Incremental resource-view sync state (see _heartbeat_loop).
        self._view_version = 0
        self._view_epoch = None  # GCS instance id; mismatch -> full resync
        self._view_nodes: Dict[bytes, dict] = {}

    # ---- lifecycle -------------------------------------------------------

    async def start(self):
        os.makedirs(self.session_dir, exist_ok=True)
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self.store = ObjectStore(self.store_path, capacity=self.object_store_memory,
                                 create=True)
        from ray_tpu_torch.runtime.object_store.spill import SpillManager
        self.spill = SpillManager(
            self.store, os.path.join(self.session_dir, "spill"))
        await self.server.start()
        self.gcs = RpcClient(*self.gcs_address, auto_reconnect=True,
                             reconnect_timeout=120,
                             on_reconnect=self._on_gcs_reconnect)
        await self.gcs.connect(timeout=30)
        reply = await self.gcs.call(
            "register_node", node_id=self.node_id, address=self.server.address,
            resources=self.total_resources, object_store_path=self.store_path,
            is_head=self.is_head, labels=self.labels)
        assert reply["ok"]
        self._monitor_task = asyncio.ensure_future(self._monitor_workers())
        self._heartbeat_task = asyncio.ensure_future(self._heartbeat_loop())
        self._spill_task = asyncio.ensure_future(self._proactive_spill_loop())
        # Worker prestart (worker_pool.h:234 analog): warm idle workers so
        # the first lease skips process-spawn latency. Bounded by CPU count;
        # off by default (worker_prestart=0) — each prestart is a real
        # process.
        from ray_tpu_torch.config import cfg as _cfg

        prestart = min(int(self.total_resources.get("CPU", 0)),
                       _cfg().worker_prestart)
        self._prestart_tasks = [
            asyncio.ensure_future(self._prestart_one())
            for _ in range(max(0, prestart))]
        logger.info("raylet %s up at %s resources=%s", self.node_id.hex()[:12],
                    self.server.address, self.total_resources)
        return self

    async def _prestart_one(self):
        w = self._spawn_worker()
        try:
            await asyncio.wait_for(w.ready.wait(), timeout=120)
        except asyncio.TimeoutError:
            return
        if w.address is not None and w.lease_id is None:
            self._park_idle(w)

    async def _on_gcs_reconnect(self, client):
        """GCS restarted (NotifyGCSRestart analog): re-register so the new
        GCS (possibly without durable storage) learns this node again."""
        try:
            await client._call_once("register_node", 30, dict(
                node_id=self.node_id, address=self.server.address,
                resources=self.total_resources,
                object_store_path=self.store_path,
                is_head=self.is_head, labels=self.labels))
        except Exception:
            logger.warning("re-register after GCS reconnect failed")

    async def _heartbeat_loop(self):
        # Heartbeats push availability up to the GCS; the reply piggybacks
        # version-gated DELTAS of the cluster view — this raylet's spillback
        # routing table (ray_syncer resource gossip analog,
        # src/ray/common/ray_syncer/). An idle cluster exchanges no node
        # data at all; a full snapshot only flows on first sync or after
        # falling behind the GCS's capped change log.
        from ray_tpu_torch.runtime import wire

        while not self._shutdown.is_set():
            try:
                # Typed-schema heartbeat (wire.HeartbeatMsg/ViewDeltaMsg):
                # structure evolves per-field instead of all-or-nothing
                # pickled dicts.
                hb = wire.HeartbeatMsg(
                    node_id=self.node_id,
                    available=dict(self.available),
                    known_version=self._view_version,
                    known_epoch=self._view_epoch or "",
                    backlog=self._backlog())
                reply = await self.gcs.call("node_heartbeat2", m=hb.encode())
                if reply.get("unknown"):
                    # Restarted GCS lost us (no durable storage): re-register.
                    await self._on_gcs_reconnect(self.gcs)
                    self._view_version = 0
                    self._view_epoch = None
                    self._view_nodes.clear()
                else:
                    self._apply_view(self._decode_view(reply.get("view")))
            except Exception:
                pass
            from ray_tpu_torch.config import cfg
            await asyncio.sleep(cfg().heartbeat_interval_s)

    @staticmethod
    def _decode_view(encoded) -> Optional[dict]:
        if not encoded:
            return None
        from ray_tpu_torch.runtime import wire

        msg = wire.ViewDeltaMsg.decode(encoded)

        def node_dict(n):
            return {"node_id": n.node_id, "address": (n.host, n.port),
                    "resources": n.resources, "available": n.available,
                    "labels": n.labels, "is_head": n.is_head,
                    "alive": n.alive,
                    "object_store_path": n.object_store_path,
                    "draining": n.draining,
                    "drain_deadline": n.drain_deadline}

        view = {"version": msg.version, "epoch": msg.epoch or None}
        nodes = [node_dict(n) for n in (msg.full if msg.is_full
                                        else msg.deltas)]
        if msg.is_full:
            view["full"] = nodes
        else:
            view["deltas"] = nodes
        return view

    def _apply_view(self, view: Optional[dict]):
        if not view:
            return
        if "full" in view:
            self._view_nodes = {n["node_id"]: n for n in view["full"]}
        else:
            for n in view.get("deltas", ()):
                self._view_nodes[n["node_id"]] = n
        # Dead nodes delivered their final not-alive delta: drop them so
        # the table stays bounded by LIVE nodes under churn.
        for nid in [nid for nid, n in self._view_nodes.items()
                    if not n.get("alive", True)]:
            del self._view_nodes[nid]
        self._view_version = view["version"]
        self._view_epoch = view.get("epoch")
        self._cluster_view = list(self._view_nodes.values())
        if self._infeasible and (view.get("full") or view.get("deltas")):
            self._retry_infeasible()

    async def run_forever(self):
        await self._shutdown.wait()
        logger.info("raylet shutting down")
        await self._cleanup()
        logger.info("raylet cleanup complete")

    async def _cleanup(self):
        for task in (self._monitor_task, self._heartbeat_task,
                     self._spill_task):
            if task:
                task.cancel()
        for w in list(self._workers.values()):
            try:
                w.proc.terminate()
            except Exception:
                pass
        deadline = time.monotonic() + 3
        for w in list(self._workers.values()):
            try:
                w.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:
                try:
                    w.proc.kill()
                except Exception:
                    pass
        if self.store is not None:
            self.store.close()
            try:
                os.unlink(self.store_path)
            except OSError:
                pass
        await self.server.close()

    async def handle_shutdown_node(self, conn):
        logger.info("shutdown_node received")
        self._shutdown.set()
        return {"ok": True}

    # ---- worker pool (worker_pool.h) -------------------------------------

    def _park_idle(self, w: WorkerHandle):
        """Return a worker to the idle pool, bounded: with reuse keyed by
        card ids, distinct GPU sets would otherwise strand ever more
        mismatched idle processes (reference: idle-worker killing,
        worker_pool.cc). Oldest idle worker dies first when over the cap."""
        from ray_tpu_torch.config import cfg

        self._idle.append(w)
        cap = max(1, cfg().worker_pool_max_idle)
        while len(self._idle) > cap:
            victim = self._idle.pop(0)
            # Keep the handle in _workers: _monitor_workers polls, reaps,
            # and reports the death like every other kill path (popping it
            # here would leak an unreaped zombie if SIGTERM is ignored).
            try:
                victim.proc.terminate()
            except Exception:
                pass

    def _spawn_worker(self, gpu_ids: Tuple[int, ...] = ()) -> WorkerHandle:
        """Start a worker process that sees exactly the cards `gpu_ids`
        (none for a lease without GPUs)."""
        worker_id = WorkerID.generate().binary()
        env = dict(os.environ)
        env.update(self.worker_env)
        env.update(accelerators.visibility_env(gpu_ids))
        env["RAY_TPU_TORCH_WORKER_ID"] = worker_id.hex()
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_TORCH_RAYLET_ADDR"] = f"{self.server.host}:{self.server.port}"
        env["RAY_TPU_TORCH_GCS_ADDR"] = f"{self.gcs_address[0]}:{self.gcs_address[1]}"
        env["RAY_TPU_TORCH_STORE_PATH"] = self.store_path
        env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        log_path = os.path.join(self.session_dir, "logs",
                                f"worker_{worker_id.hex()[:12]}.log")
        log_file = open(log_path, "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.runtime.worker_main"],
            env=env, stdout=log_file, stderr=subprocess.STDOUT,
            start_new_session=True)
        log_file.close()
        handle = WorkerHandle(worker_id, proc)
        handle.gpu_ids = tuple(gpu_ids)
        self._workers[worker_id] = handle
        return handle

    async def handle_worker_ready(self, conn, worker_id: bytes, address):
        w = self._workers.get(worker_id)
        if w is None:
            return {"ok": False}
        w.address = tuple(address)
        w.ready.set()
        conn.meta["worker_id"] = worker_id
        return {"ok": True}

    async def _proactive_spill_loop(self):
        """Background spilling above a fill watermark: the raylet (not a
        task worker mid-put) absorbs the disk IO, so workers rarely hit
        StoreFullError's inline spill-before-evict path. The raylet IS the
        node's dedicated IO process in this serverless-store design
        (reference analog: worker_pool.h:381 dedicated spill I/O workers +
        local_object_manager spill triggers)."""
        from ray_tpu_torch.config import cfg

        high = cfg().spill_high_watermark
        low = cfg().spill_low_watermark
        if high <= 0:
            return
        while not self._shutdown.is_set():
            await asyncio.sleep(0.25)
            try:
                store = self.store
                if store is None or store.capacity == 0:
                    continue
                if store.used / store.capacity < high:
                    continue
                target = int(store.capacity * low)
                # Off-loop: file IO must not stall lease dispatch.
                await asyncio.get_event_loop().run_in_executor(
                    None, self._spill_down_to, target)
            except Exception:
                logger.exception("proactive spill pass failed")

    def _spill_down_to(self, target_bytes: int):
        need = self.store.used - target_bytes
        if need <= 0:
            return
        freed = self.spill.spill_until(need)
        if freed:
            logger.info("proactive spill: %d bytes -> disk (used %.0f%%)",
                        freed, 100 * self.store.used / self.store.capacity)

    # ---- runtime-env agent (per-node URI refcount + GC) ------------------

    async def _monitor_workers(self):
        """Child watcher: detect worker process exits (worker death path)."""
        while not self._shutdown.is_set():
            await asyncio.sleep(0.2)
            for w in list(self._workers.values()):
                if w.proc.poll() is not None:
                    del self._workers[w.worker_id]
                    if w in self._idle:
                        self._idle.remove(w)
                    reason = f"worker exited with code {w.proc.returncode}"
                    if w.lease_resources:
                        self._release(w.pg_key, w.lease_resources, w.gpu_ids)
                    if not w.ready.is_set():
                        w.ready.set()  # unblock lease waiters; address stays None
                    try:
                        # pid lets the GCS purge the dead reporter's
                        # metrics:<node>:<pid> snapshot + history rings.
                        await self.gcs.call("report_worker_death", node_id=self.node_id,
                                            worker_id=w.worker_id, actor_id=w.actor_id,
                                            reason=reason, pid=w.proc.pid)
                    except Exception:
                        pass
                    await self._reclaim_holder_leases(w.worker_id.hex())
                    await self._dispatch_pending()

    async def _reclaim_holder_leases(self, holder: str):
        """Reclaim every lease whose HOLDER just died.

        return_worker only ever arrives from the lease holder (submitters
        cache idle leases for lease_idle_timeout_s before returning them),
        so a client killed while holding cached leases — e.g. an actor
        running a task-submitting loop — would otherwise leak its granted
        resources forever: available CPUs pin at 0, every later lease
        request starves, and the still-alive leased workers idle unleasable.
        The leased worker itself keeps running; it just goes back in the
        idle pool."""
        if not holder:
            return
        freed = False
        for w in list(self._workers.values()):
            if w.lease_id is not None and w.leased_to == holder:
                logger.info("reclaiming lease %s (holder %s died)",
                            w.lease_id.hex()[:8], holder[:12])
                self._release(w.pg_key, w.lease_resources, w.gpu_ids)
                w.lease_id = None
                w.lease_resources = {}
                w.pg_key = None
                w.req_id = None
                w.busy_since = None
                w.leased_to = ""
                freed = True
                if not w.is_actor:
                    self._park_idle(w)
        if freed:
            await self._dispatch_pending()

    # ---- resource accounting ---------------------------------------------

    def _lease_pool(self, pg_key: Optional[Tuple[bytes, int]]) -> Dict[str, float]:
        """The resource pool a lease draws from: node-level, or a committed
        placement-group bundle."""
        if pg_key is None:
            return self.available
        bundle = self._bundles.get(pg_key)
        if bundle is None:
            raise RuntimeError(f"no bundle {pg_key[0].hex()[:12]}:{pg_key[1]} on this node")
        return bundle["available"]

    def _take_gpus(self, pg_key: Optional[Tuple[bytes, int]],
                   resources: Dict[str, float]) -> Tuple[int, ...]:
        """Card ids for a lease that was just granted `resources` from the
        node or a bundle: the lowest free ids of that pool."""
        n = int(resources.get("GPU", 0))
        if n <= 0:
            return ()
        free = (self._gpu_free if pg_key is None
                else self._bundles[pg_key]["gpu_free"])
        ids = tuple(free[:n])
        del free[:n]
        return ids

    def _release(self, pg_key: Optional[Tuple[bytes, int]],
                 resources: Dict[str, float], gpu_ids: Tuple[int, ...]):
        """Give a lease's resources and card ids back to its pool. A bundle
        already returned took its whole share back (handle_return_bundle)."""
        if pg_key is None:
            pool, free = self.available, self._gpu_free
        else:
            bundle = self._bundles.get(pg_key)
            if bundle is None:
                return
            pool, free = bundle["available"], bundle["gpu_free"]
        scheduling.add(pool, resources)
        free.extend(gpu_ids)
        free.sort()

    # ---- leases (node_manager.cc:1915 HandleRequestWorkerLease) ----------

    async def handle_lease_worker2(self, conn, m: bytes):
        """Typed-schema lease request (wire.LeaseRequestMsg in,
        LeaseReplyMsg out — node_manager.proto RequestWorkerLease analog).
        A newer submitter's extra fields skip on decode here; our reply's
        fields it doesn't know skip on its side."""
        from ray_tpu_torch.runtime import wire

        req = wire.LeaseRequestMsg.decode(m)
        reply = await self._lease(
            dict(req.resources), for_actor=req.for_actor,
            placement_group_id=req.placement_group_id or None,
            bundle_index=req.bundle_index,
            req_id=req.req_id or None, holder=req.holder or "")
        return wire.LeaseReplyMsg.from_reply(reply).encode()

    async def handle_lease_batch2(self, conn, m: bytes):
        """A pump's worth of lease requests granted in ONE scheduling pass
        (the amortized HandleRequestWorkerLease): N enqueues, one
        `_dispatch_pending()`, one reply frame. Entries that pass resolves
        synchronously (queue errors, immediate refusals) come back inline;
        everything else is listed as `pending` and resolves later via a
        `lease_grant` push on this connection. Waiting for all entries
        here would deadlock — a speculative lease queued behind a running
        task only grants after that task finishes, which needs this reply
        to have been delivered."""
        from ray_tpu_torch.runtime import wire

        batch = wire.LeaseBatchRequestMsg.decode(m)
        reply = wire.LeaseBatchReplyMsg()
        waiting = []
        for req in batch.entries:
            req_id = req.req_id or os.urandom(8)
            pg_key = None
            if req.placement_group_id:
                idx = (req.bundle_index if req.bundle_index >= 0
                       else self._any_bundle_index(req.placement_group_id))
                if idx is None:
                    r = wire.LeaseReplyMsg.from_reply({
                        "ok": False,
                        "error": "placement group bundle not on this node"})
                    r.req_id = req_id
                    reply.entries.append(r)
                    continue
                pg_key = (req.placement_group_id, idx)
            fut = asyncio.get_event_loop().create_future()
            pend = PendingLease(dict(req.resources), req.for_actor, pg_key,
                                fut, req_id, holder=req.holder or "")
            key = self._sched_class(pend.resources, pg_key)
            self._queues.setdefault(key, collections.deque()).append(pend)
            waiting.append((req_id, fut))
        await self._dispatch_pending()
        # A few cooperative yields let resolutions the pass scheduled via
        # ensure_future (errors, spillback verdicts, grants onto already-
        # warm workers) land inline in this reply instead of as per-entry
        # pushes. Bounded and non-blocking: sleep(0) only yields the loop,
        # so a grant stuck behind a real worker spawn can't stall the
        # reply — it just comes back `pending`.
        for _ in range(8):
            if all(f.done() for _, f in waiting):
                break
            await asyncio.sleep(0)
        for req_id, fut in waiting:
            if fut.done():
                r = wire.LeaseReplyMsg.from_reply(fut.result())
                r.req_id = req_id
                reply.entries.append(r)
            else:
                reply.pending.append(req_id)
                fut.add_done_callback(
                    lambda f, rid=req_id: asyncio.ensure_future(
                        self._push_lease_grant(conn, rid, f)))
        return reply.encode()

    async def _push_lease_grant(self, conn, req_id: bytes, fut):
        try:
            result = fut.result()
        except Exception as e:
            result = {"ok": False, "error": repr(e)}
        from ray_tpu_torch.runtime import wire

        r = wire.LeaseReplyMsg.from_reply(result)
        r.req_id = req_id
        try:
            await conn.push("lease_grant",
                            {"req_id": req_id, "m": r.encode()})
        except Exception:
            logger.debug("lease_grant push for %s failed (peer gone)",
                         req_id.hex())

    async def _lease(self, resources: Dict[str, float],
                     for_actor: bool = False,
                     placement_group_id: Optional[bytes] = None,
                     bundle_index: int = -1,
                     req_id: Optional[bytes] = None,
                     holder: str = ""):
        pg_key = None
        if placement_group_id is not None:
            idx = bundle_index if bundle_index >= 0 else self._any_bundle_index(placement_group_id)
            if idx is None:
                return {"ok": False, "error": "placement group bundle not on this node"}
            pg_key = (placement_group_id, idx)
        logger.debug("lease_worker: res=%s avail=%s pending=%d", resources,
                     self.available, self._pending_count())
        fut = asyncio.get_event_loop().create_future()
        req = PendingLease(resources, for_actor, pg_key, fut, req_id,
                           holder=holder)
        key = self._sched_class(resources, pg_key)
        self._queues.setdefault(key, collections.deque()).append(req)
        await self._dispatch_pending()
        return await fut

    @staticmethod
    def _sched_class(resources: Dict[str, float],
                     pg_key: Optional[Tuple[bytes, int]]) -> tuple:
        """Scheduling-class key: resource shape + bundle. All requests in a
        class draw the same amounts from the same pool, so feasibility is a
        property of the CLASS, not the request."""
        shape = tuple(sorted((k, float(v)) for k, v in resources.items()
                             if v > scheduling.EPS))
        return (shape, pg_key)

    def _pending_count(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + sum(len(q) for q in self._infeasible.values()))

    def _backlog(self) -> List[dict]:
        """Per-class backlog for heartbeats/stats (autoscaler demand feed;
        GcsAutoscalerStateManager analog)."""
        out = []
        for key, q in list(self._queues.items()) + \
                list(self._infeasible.items()):
            if q:
                out.append({"shape": dict(key[0]), "count": len(q),
                            "infeasible": key in self._infeasible})
        return out

    async def _cancel_lease(self, req_id: bytes):
        """Cancel a lease request: still-queued -> dequeue; already granted
        (grant raced the caller's timeout) -> reclaim the worker."""
        for table in (self._queues, self._infeasible):
            for key, q in list(table.items()):
                for req in q:
                    if req.req_id == req_id:
                        q.remove(req)
                        if not q:
                            del table[key]
                        if not req.fut.done():
                            req.fut.set_result({"ok": False, "canceled": True})
                        return {"ok": True}
        for w in self._workers.values():
            if w.req_id == req_id and w.lease_id is not None:
                self._release(w.pg_key, w.lease_resources, w.gpu_ids)
                w.lease_id = None
                w.lease_resources = {}
                w.pg_key = None
                w.req_id = None
                w.busy_since = None
                w.leased_to = ""
                if not w.is_actor:
                    self._park_idle(w)
                await self._dispatch_pending()
                return {"ok": True, "reclaimed": True}
        return {"ok": False}

    async def handle_cancel_lease_batch(self, conn, req_ids: List[bytes]):
        """Batched cancel fan-in: one frame retires a whole pump's worth of
        extra in-flight lease requests instead of one RPC per req_id."""
        canceled = 0
        for rid in req_ids:
            r = await self._cancel_lease(rid)
            if r.get("ok"):
                canceled += 1
        return {"ok": True, "canceled": canceled}

    def _any_bundle_index(self, pg_id: bytes) -> Optional[int]:
        for (gid, idx), b in self._bundles.items():
            if gid == pg_id and b["committed"]:
                return idx
        return None

    async def _dispatch_pending(self):
        """Per-class round-robin dispatch (ScheduleAndDispatchTasks analog,
        cluster_task_manager.cc:188 + local_task_manager.cc:57).

        Each pass walks the scheduling classes once; within a class, grants
        run strictly FIFO from the head while the class's pool fits the
        shape. A class whose head can't be placed locally either blocks
        (in-use resources will free up), spills its whole queue (another
        node's total capacity fits — the shape is identical for every
        member), or parks as infeasible. Classes that received a grant
        rotate to the back so a hot shape can't starve the rest."""
        progressed = True
        while progressed:
            progressed = False
            for key in list(self._queues.keys()):
                q = self._queues.get(key)
                if not q:
                    self._queues.pop(key, None)
                    continue
                granted_here = 0
                while q:
                    req = q[0]
                    if req.fut.done():  # canceled under us
                        q.popleft()
                        continue
                    try:
                        pool = self._lease_pool(req.pg_key)
                    except RuntimeError as e:
                        q.popleft()
                        if not req.fut.done():
                            req.fut.set_result({"ok": False, "error": str(e)})
                        continue
                    if not scheduling.fits(pool, req.resources):
                        cap = (self.total_resources if req.pg_key is None
                               else self._bundles[req.pg_key]["resources"])
                        if not scheduling.fits(cap, req.resources):
                            # Never placeable here: spill/park the whole
                            # class (identical shape -> identical verdict).
                            del self._queues[key]
                            asyncio.ensure_future(
                                self._resolve_spillback_class(key, q))
                        break  # class blocked locally; next class
                    scheduling.subtract(pool, req.resources)
                    req.gpu_ids = self._take_gpus(req.pg_key, req.resources)
                    q.popleft()
                    granted_here += 1
                    progressed = True
                    logger.debug("dispatch: granting lease res=%s avail=%s",
                                 req.resources, self.available)
                    asyncio.ensure_future(self._grant_lease(req))
                if not self._queues.get(key):
                    self._queues.pop(key, None)
                elif granted_here:
                    self._queues.move_to_end(key)

    async def _resolve_spillback_class(self, key: tuple, q: "collections.deque"):
        """A class that can never run locally: route every member to the
        best remote node, or park the class as infeasible until the cluster
        view changes (reference keeps infeasible tasks queued and feeds
        them to the autoscaler rather than erroring,
        cluster_task_manager.cc infeasible_tasks_)."""
        reply = self._spillback_for_shape(dict(key[0]))
        if reply is None:
            # The gossip view can lag a just-registered node; confirm against
            # the GCS before declaring the class infeasible cluster-wide.
            try:
                self._cluster_view = await self.gcs.call("get_nodes")
                reply = self._spillback_for_shape(dict(key[0]))
            except Exception:
                pass
        live = collections.deque(r for r in q if not r.fut.done())
        if reply is None:
            if live:
                logger.warning(
                    "lease class %s infeasible cluster-wide; parking %d "
                    "request(s) until resources appear", key[0], len(live))
                old = self._infeasible.get(key)
                if old:
                    old.extend(live)
                else:
                    self._infeasible[key] = live
            return
        for req in live:
            if not req.fut.done():
                req.fut.set_result(reply)

    def _spillback_for_shape(self, resources: Dict[str, float]) -> Optional[dict]:
        """Best remote node whose TOTAL capacity fits the shape
        (HandleRequestWorkerLease spillback reply,
        cluster_resource_scheduler.cc:149 GetBestSchedulableNode), or None."""
        candidates = [
            n for n in self._cluster_view
            if n.get("alive") and not n.get("draining")
            and n["node_id"] != self.node_id
            and scheduling.fits(n["resources"], resources)]
        if not candidates:
            return None
        best = min(candidates, key=lambda n: scheduling.utilization_score(
            n["resources"], n.get("available", n["resources"]), resources))
        return {"ok": False, "spillback": tuple(best["address"]),
                "spillback_node": best["node_id"]}

    def _retry_infeasible(self):
        """Cluster view changed: re-queue parked classes that some node's
        total capacity now satisfies (or that now fit locally)."""
        for key in list(self._infeasible.keys()):
            shape = dict(key[0])
            cap = self.total_resources if key[1] is None else \
                self._bundles.get(key[1], {}).get("resources", {})
            if (scheduling.fits(cap, shape)
                    or self._spillback_for_shape(shape) is not None):
                q = self._infeasible.pop(key)
                old = self._queues.get(key)
                if old:
                    old.extend(q)
                else:
                    self._queues[key] = q
                asyncio.ensure_future(self._dispatch_pending())

    async def _grant_lease(self, req: PendingLease):
        try:
            w = None
            if not req.for_actor:
                # Only a worker started to see the same cards is eligible:
                # its CUDA_VISIBLE_DEVICES is fixed for its life.
                for cand in reversed(self._idle):
                    if cand.gpu_ids == req.gpu_ids:
                        self._idle.remove(cand)
                        w = cand
                        break
            if w is None:
                w = self._spawn_worker(req.gpu_ids)
            if not w.ready.is_set():  # warm worker: skip the timer+task
                await asyncio.wait_for(w.ready.wait(), timeout=120)
            if w.address is None:
                raise RuntimeError("worker died during startup")
            w.lease_id = os.urandom(8)
            w.lease_resources = dict(req.resources)
            w.pg_key = req.pg_key
            w.is_actor = req.for_actor
            w.req_id = req.req_id
            w.leased_to = req.holder or ""
            w.busy_since = time.monotonic()
            if not req.fut.done():
                logger.debug("grant_lease: worker=%s addr=%s", w.worker_id.hex()[:8], w.address)
                req.fut.set_result({
                    "ok": True, "lease_id": w.lease_id, "worker_id": w.worker_id,
                    "worker_address": w.address, "node_id": self.node_id,
                })
        except Exception as e:
            self._release(req.pg_key, req.resources, req.gpu_ids)
            if not req.fut.done():
                req.fut.set_result({"ok": False, "error": repr(e)})

    async def handle_return_worker(self, conn, lease_id: bytes, worker_dead: bool = False):
        logger.debug("return_worker: lease=%s avail=%s", lease_id.hex()[:8], self.available)
        for w in self._workers.values():
            if w.lease_id == lease_id:
                self._release(w.pg_key, w.lease_resources, w.gpu_ids)
                w.lease_id = None
                w.lease_resources = {}
                w.pg_key = None
                w.busy_since = None
                w.leased_to = ""
                if worker_dead:
                    try:
                        w.proc.terminate()
                    except Exception:
                        pass
                elif not w.is_actor:
                    self._park_idle(w)
                await self._dispatch_pending()
                return {"ok": True}
        return {"ok": False}

    async def handle_mark_actor(self, conn, worker_id: bytes, actor_id: bytes):
        w = self._workers.get(worker_id)
        if w is None:
            return {"ok": False}
        w.is_actor = True
        w.actor_id = actor_id
        return {"ok": True}

    async def handle_kill_worker(self, conn, worker_id: bytes, force: bool = True):
        w = self._workers.get(worker_id)
        if w is None:
            return {"ok": False}
        try:
            w.proc.kill() if force else w.proc.terminate()
        except Exception:
            pass
        return {"ok": True}

    # ---- placement group bundles: 2PC target (Prepare/Commit) ------------

    async def handle_prepare_bundle(self, conn, pg_id: bytes, bundle_index: int,
                                    resources: Dict[str, float]):
        key = (pg_id, bundle_index)
        if key in self._bundles:
            return {"ok": True}  # idempotent retry
        if not scheduling.fits(self.available, resources):
            return {"ok": False, "error": "insufficient resources at prepare"}
        scheduling.subtract(self.available, resources)
        self._bundles[key] = {"resources": dict(resources),
                              "available": dict(resources), "committed": False,
                              "gpu_ids": self._take_gpus(None, resources)}
        self._bundles[key]["gpu_free"] = list(self._bundles[key]["gpu_ids"])
        return {"ok": True}

    async def handle_commit_bundle(self, conn, pg_id: bytes, bundle_index: int):
        b = self._bundles.get((pg_id, bundle_index))
        if b is None:
            return {"ok": False}
        b["committed"] = True
        self._retry_infeasible()
        await self._dispatch_pending()
        return {"ok": True}

    async def handle_cancel_bundle(self, conn, pg_id: bytes, bundle_index: int):
        b = self._bundles.pop((pg_id, bundle_index), None)
        if b is not None:
            self._release(None, b["resources"], b["gpu_ids"])
        return {"ok": True}

    async def handle_return_bundle(self, conn, pg_id: bytes, bundle_index: int):
        b = self._bundles.pop((pg_id, bundle_index), None)
        if b is not None:
            self._release(None, b["resources"], b["gpu_ids"])
            # Kill workers still leased inside the bundle.
            for w in list(self._workers.values()):
                if w.pg_key == (pg_id, bundle_index):
                    try:
                        w.proc.terminate()
                    except Exception:
                        pass
        await self._dispatch_pending()
        return {"ok": True}

    # ---- introspection ----------------------------------------------------

    @property
    def _pull_sem(self):
        """Admission control for serving cross-node reads: bound concurrent
        chunk reads so a broadcast storm cannot starve the raylet's loop
        (PullManager admission analog, pull_manager.h:51)."""
        sem = getattr(self, "_pull_sem_obj", None)
        if sem is None:
            from ray_tpu_torch.config import cfg

            sem = self._pull_sem_obj = asyncio.Semaphore(
                cfg().pull_admission_concurrency)
        return sem

    async def handle_pull_object_raw(self, conn, m, payload):
        """Chunked cross-node object read, shm store first, spill dir second
        (ObjectManager::HandlePull analog; push is pull-driven here — the
        requester re-calls until it has total bytes). ObjChunkRequestMsg
        in, the chunk rides OUT as the raw-frame payload — the object bytes
        are copied once out of the arena and hit the socket without ever
        entering a pickle buffer."""
        from ray_tpu_torch.runtime import wire

        req = wire.ObjChunkRequestMsg.decode(m)
        async with self._pull_sem:
            try:
                buf = self.store.get(req.oid, timeout=0)
            except Exception:
                rec = self.spill.read_chunk(req.oid, req.offset, req.length)
                if rec is None:
                    return RawReply(
                        wire.ObjChunkReplyMsg(found=False).encode())
                total, metadata, chunk = rec
                return RawReply(
                    wire.ObjChunkReplyMsg(
                        found=True, total=total,
                        metadata=bytes(metadata or b"")).encode(),
                    chunk)
            try:
                data = buf.data
                return RawReply(
                    wire.ObjChunkReplyMsg(
                        found=True, total=len(data),
                        metadata=bytes(buf.metadata)).encode(),
                    bytes(data[req.offset:req.offset + req.length]))
            finally:
                buf.release()

    async def handle_put_object_raw(self, conn, m, payload):
        """Remote-client write path: a store-less driver (Ray Client
        analog) materializes put() objects into this node's store in
        chunks; the final chunk seals. Each chunk arrives as the raw-frame
        payload (a memoryview over the receive buffer) and is copied
        exactly once, into the store arena."""
        from ray_tpu_torch.runtime import wire

        req = wire.ObjPutMsg.decode(m)
        r = await self._put_chunk(
            req.oid, payload, req.offset, req.total,
            metadata=req.metadata, seal=req.seal)
        return RawReply(wire.AckMsg(ok=bool(r.get("ok")),
                                    error=str(r.get("error") or ""),
                                    existed=bool(r.get("existed"))).encode())

    async def _pull_from(self, client: RpcClient, oid: bytes):
        """Whole-object pull from a peer raylet over raw frames. Returns
        (buf, metadata) or None if the peer lost the object."""
        from ray_tpu_torch.config import cfg
        from ray_tpu_torch.runtime import wire

        chunk_bytes = cfg().pull_chunk_bytes
        buf, off, total, metadata = None, 0, 0, b""
        while True:
            mrep, payload = await client.call_raw(
                "pull_object_raw",
                m=wire.ObjChunkRequestMsg(oid=oid, offset=off,
                                          length=chunk_bytes).encode())
            rep = wire.ObjChunkReplyMsg.decode(mrep)
            if not rep.found:
                return None
            if buf is None:
                total, metadata = rep.total, rep.metadata
                buf = bytearray(total)
            n = len(payload)
            buf[off:off + n] = payload
            off += n
            if off >= total:
                return buf, metadata
            if n == 0:
                raise RuntimeError("truncated pull")

    async def handle_fetch_and_relay(self, conn, oid: bytes,
                                     source: Tuple[str, int],
                                     targets: List[Tuple[str, int]],
                                     fanout: int = 2):
        """Broadcast leg: pull `oid` from `source` into the local store, then
        fan the remaining `targets` out as subtrees relaying from THIS node —
        O(log n) depth, no single-source bottleneck (PushManager/broadcast
        analog, push_manager.h:30; the 1 GiB x 50-node envelope case)."""
        if not self.store.contains(oid):
            client = RpcClient(*tuple(source))
            try:
                await client.connect(timeout=15)
                rec = await self._pull_from(client, oid)
                if rec is None:
                    return {"ok": False, "error": "source lost the object"}
                data, metadata = rec
                try:
                    view = self.store.create(oid, len(data), metadata)
                    view[:] = data
                    view.release()
                    self.store.seal(oid)
                except ValueError:
                    pass  # concurrent create: someone else sealed it
            finally:
                await client.close()
        if not targets:
            return {"ok": True, "relayed": 0}
        # Split targets into `fanout` subtrees, each led by its first node.
        groups = [targets[i::fanout] for i in range(fanout)]
        subcalls = []
        for g in groups:
            if not g:
                continue
            leader, rest = tuple(g[0]), [tuple(t) for t in g[1:]]
            subcalls.append(self._relay_to(oid, leader, rest, fanout))
        results = await asyncio.gather(*subcalls, return_exceptions=True)
        failed = [r for r in results
                  if isinstance(r, Exception) or not r.get("ok")]
        if failed:
            return {"ok": False, "error": f"{len(failed)} subtree(s) failed"}
        return {"ok": True, "relayed": len(targets)}

    async def _relay_to(self, oid, leader, rest, fanout):
        client = RpcClient(*leader)
        try:
            await client.connect(timeout=15)
            return await client.call(
                "fetch_and_relay", oid=oid, source=self.server.address,
                targets=rest, fanout=fanout, timeout=600)
        finally:
            await client.close()

    async def _put_chunk(self, oid: bytes, chunk, offset: int, total: int,
                         metadata: bytes = b"", seal: bool = False):
        if self.store.contains(oid):
            return {"ok": True, "existed": True}
        try:
            if offset == 0:
                self.store.abort(oid)  # reclaim a crashed partial create
                view = self.store.create(oid, total, metadata)
                self._client_puts = getattr(self, "_client_puts", {})
                self._client_puts[oid] = view
            view = self._client_puts[oid]
            view[offset:offset + len(chunk)] = chunk
            if seal:
                view.release()
                self.store.seal(oid)
                del self._client_puts[oid]
            return {"ok": True}
        except Exception as e:
            v = getattr(self, "_client_puts", {}).pop(oid, None)
            if v is not None:
                try:
                    v.release()
                except Exception:
                    pass
                self.store.abort(oid)
            return {"ok": False, "error": repr(e)}

    async def handle_free_object(self, conn, oid: bytes):
        """Owner-directed delete of a local copy (delete-on-zero leg of the
        ownership protocol; reference: plasma Delete + spilled-file cleanup
        in local_object_manager)."""
        try:
            self.store.delete(oid)
        except Exception:
            pass
        try:
            if self.spill is not None:
                self.spill.delete(oid)
        except Exception:
            pass
        return {"ok": True}

    async def handle_node_stats(self, conn):
        return {
            "node_id": self.node_id,
            "resources": self.total_resources,
            "available": self.available,
            "num_workers": len(self._workers),
            "num_idle": len(self._idle),
            "num_pending_leases": self._pending_count(),
            "backlog": self._backlog(),
            "object_store_used": self.store.used if self.store else 0,
            "object_store_capacity": self.store.capacity if self.store else 0,
            "spilled_bytes": (self.spill.spilled_bytes()
                              if self.spill else 0),
            "gpu_free": list(self._gpu_free),
            "bundles": [
                {"pg_id": k[0], "bundle_index": k[1], "committed": v["committed"],
                 "resources": v["resources"], "available": v["available"],
                 "gpu_ids": list(v["gpu_ids"])}
                for k, v in self._bundles.items()],
        }
