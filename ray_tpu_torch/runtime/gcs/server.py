"""GCS: the cluster-global control service.

The port's copy of ray_tpu/runtime/gcs/server.py, cut to the node table
and heartbeats (with the versioned resource view), KV, pubsub, jobs,
actors (create, get, kill, worker death, restart), placement groups,
object locations, the checkpoint shard registry, the cluster event ring,
the cluster prefix table and shutdown. The JAX GCS's other handlers are
registered as refusals (UNPORTED_HANDLERS).

Reference analog: src/ray/gcs/gcs_server/ (GcsServer gcs_server.h:89). One per
cluster. Owns: internal KV (function/class table lives here —
gcs_function_manager.h:32), node table (gcs_node_manager), actor directory +
lifecycle state machine (gcs_actor_manager.h:291), named actors, placement
groups (gcs_placement_group_manager, 2-phase Prepare/Commit), and cluster
pubsub (InternalPubSubHandler). Persistence is the in-memory store client
(in_memory_store_client.h); the StoreClient seam for a Redis-backed version
is `self._kv` + the table dicts.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.task_spec import ActorSpec
from ray_tpu_torch.runtime.rpc import (RawReply, RpcClient, RpcServer,
                                       ServerConnection)
from ray_tpu_torch.runtime import scheduling, wire

logger = logging.getLogger(__name__)

# Handlers of the JAX package's GCS not ported yet (ROADMAP.md queue 1
# item 6.4): metrics history, link utilization, alerts, task events and
# the timeline, the wait graph, autoscaler demand, and drain.
UNPORTED_HANDLERS = (
    "report_metrics2", "metrics_history", "metrics_history_stats",
    "link_utilization", "list_alerts", "report_task_events", "report_task_events2", "task_event_stats",
    "list_tasks", "get_task", "task_timeline", "wait_graph",
    "cluster_demand", "request_resources", "get_requested_resources",
    "drain_node")

# Actor lifecycle states (gcs_actor_manager.h state machine)
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"



class NodeRecord:
    def __init__(self, node_id: bytes, address: Tuple[str, int], resources: Dict[str, float],
                 object_store_path: str, is_head: bool, labels: Dict[str, str]):
        self.node_id = node_id
        self.address = address
        self.resources = dict(resources)
        self.available = dict(resources)  # updated by resource reports
        self.object_store_path = object_store_path
        self.is_head = is_head
        self.labels = dict(labels)
        self.alive = True
        self.last_heartbeat = time.monotonic()
        self.client: Optional[RpcClient] = None
        # Latest per-scheduling-class lease backlog reported by heartbeat.
        self.backlog: List[dict] = []
        # Two-phase drain (DrainNode analog, node_manager.proto): the node
        # is still ALIVE — running work finishes, objects stay readable —
        # but the scheduler/PGs route around it until drain_deadline
        # (wall-clock; drain_deadline_mono is the GCS-local enforcement
        # clock), when it is killed for real.
        self.draining = False
        self.drain_reason = ""
        self.drain_deadline = 0.0          # unix seconds (advisory, wire)
        self.drain_deadline_mono = 0.0     # monotonic (enforcement)
        # Why the node died (kept in the view so workers deciding whether a
        # death consumes retry budget can classify it — death_cause()).
        self.death_reason = ""

    def view(self) -> dict:
        return {
            "node_id": self.node_id,
            "address": self.address,
            "resources": dict(self.resources),
            "available": dict(self.available),
            "object_store_path": self.object_store_path,
            "is_head": self.is_head,
            "labels": dict(self.labels),
            "alive": self.alive,
            "draining": self.draining,
            "drain_reason": self.drain_reason,
            "drain_deadline": self.drain_deadline,
            "death_reason": self.death_reason,
        }


class ActorRecord:
    def __init__(self, spec: ActorSpec):
        self.spec = spec
        self.state = PENDING_CREATION
        self.address: Optional[Tuple[str, int]] = None
        self.node_id: Optional[bytes] = None
        self.worker_id: Optional[bytes] = None
        self.restarts_used = 0
        self.death_reason = ""
        # (node, req_id) of the lease this actor waits for, if any.
        self.pending_lease = None

    def view(self) -> dict:
        return {
            "actor_id": self.spec.actor_id,
            "name": self.spec.name,
            "class_name": self.spec.class_name,
            "state": self.state,
            "address": self.address,
            "node_id": self.node_id,
            "restarts_used": self.restarts_used,
            "max_restarts": self.spec.max_restarts,
            "death_reason": self.death_reason,
        }


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 storage_path: Optional[str] = None):
        from ray_tpu_torch.runtime.gcs.storage import (
            InMemoryStoreClient,
            SqliteStoreClient,
        )

        # StoreClient seam (store_client/: in-memory vs Redis-analog sqlite).
        self._store = (SqliteStoreClient(storage_path) if storage_path
                       else InMemoryStoreClient())
        self.server = RpcServer(host, port)
        self.server.register_all(self)
        self.server.register_unported("GCS", UNPORTED_HANDLERS)
        self.server.on_disconnect = self._on_disconnect
        self._kv: Dict[bytes, bytes] = {}
        self._nodes: Dict[bytes, NodeRecord] = {}
        self._actors: Dict[bytes, ActorRecord] = {}
        self._named_actors: Dict[Tuple[str, str], bytes] = {}  # (namespace, name) -> actor_id
        self._subscribers: Dict[str, Set[ServerConnection]] = {}
        self._actor_locks: Dict[bytes, asyncio.Lock] = {}
        self._pg_manager = None  # installed in M4 (placement groups)
        self._health_task = None
        self._shutdown = asyncio.Event()
        # Job/task event tables (state API)
        self._job_counter = 0
        self._jobs: Dict[int, dict] = {}
        # Strong refs to fire-and-forget tasks: asyncio holds only weak
        # refs, so an unpinned background task (e.g. the owner-death
        # shutdown) can be garbage-collected mid-await and silently vanish.
        self._bg_tasks: Set[asyncio.Task] = set()
        # Resource-view change log (ray_syncer analog; see _bump_view).
        import collections

        self._view_version = 0
        self._view_log: "collections.deque" = collections.deque(maxlen=1024)
        # Epoch/instance id: version numbers are meaningless across GCS
        # restarts (a restored raylet's old-epoch version can be <= the new
        # epoch's current version and silently skip restore-seeded entries),
        # so every view reply carries this id and a mismatch forces a full
        # snapshot.
        import uuid

        self._view_epoch = uuid.uuid4().hex

    def _spawn_bg(self, coro) -> "asyncio.Task":
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)
        return task

    async def start(self):
        await self.server.start()
        from ray_tpu_torch.runtime.gcs.placement_groups import PlacementGroupManager
        self._pg_manager = PlacementGroupManager(self)
        await self._restore()
        self._health_task = asyncio.ensure_future(self._health_check_loop())
        logger.info("GCS listening on %s:%d", self.server.host, self.server.port)
        return self

    @property
    def address(self):
        return self.server.address

    # ---- persistence (gcs FT: restart + reload, redis_store_client.h) ----

    def _persist_actor(self, rec: "ActorRecord"):
        import pickle

        try:
            self._store.put("actors", rec.spec.actor_id, pickle.dumps({
                "spec": rec.spec, "state": rec.state, "address": rec.address,
                "node_id": rec.node_id, "worker_id": rec.worker_id,
                "restarts_used": rec.restarts_used,
                "death_reason": rec.death_reason}))
        except Exception:
            logger.exception("actor persist failed")

    def _persist_node(self, rec: "NodeRecord"):
        import pickle

        try:
            self._store.put("nodes", rec.node_id, pickle.dumps({
                "node_id": rec.node_id, "address": rec.address,
                "resources": rec.resources, "available": rec.available,
                "object_store_path": rec.object_store_path,
                "is_head": rec.is_head, "labels": rec.labels,
                "alive": rec.alive, "draining": rec.draining,
                "drain_reason": rec.drain_reason,
                "drain_deadline": rec.drain_deadline}))
        except Exception:
            logger.exception("node persist failed")

    def persist_pg(self, rec):
        import pickle

        try:
            self._store.put("placement_groups", rec.pg_id, pickle.dumps({
                "pg_id": rec.pg_id, "bundles": rec.bundles,
                "strategy": rec.strategy, "name": rec.name,
                "state": rec.state, "locations": rec.locations}))
        except Exception:
            logger.exception("pg persist failed")

    async def _restore(self):
        """Reload tables after a GCS restart. Raylets and workers keep
        running while the GCS is down (only control-plane ops stall); their
        reconnecting clients re-register/resubscribe when we come back
        (NotifyGCSRestart analog, node_manager.proto:401)."""
        import pickle

        for key, value in self._store.load_all("kv"):
            self._kv[key] = value
        for _, blob in self._store.load_all("jobs"):
            job = pickle.loads(blob)
            self._jobs[job["job_id"]] = job
            self._job_counter = max(self._job_counter, job["job_id"])
        restored_nodes = 0
        for _, blob in self._store.load_all("nodes"):
            d = pickle.loads(blob)
            if not d["alive"]:
                continue
            rec = NodeRecord(d["node_id"], tuple(d["address"]), d["resources"],
                             d["object_store_path"], d["is_head"], d["labels"])
            rec.available = d["available"]
            if d.get("draining"):
                # Monotonic deadlines don't survive the restart: re-derive
                # remaining notice from the persisted wall-clock deadline.
                rec.draining = True
                rec.drain_reason = d.get("drain_reason", "")
                rec.drain_deadline = d.get("drain_deadline", 0.0)
                rec.drain_deadline_mono = (
                    time.monotonic()
                    + max(0.0, rec.drain_deadline - time.time()))
            self._nodes[d["node_id"]] = rec
            restored_nodes += 1
            # Seed the view log so delta-synced raylets learn restored
            # (possibly idle, never-bumping) nodes.
            self._bump_view(rec)
            # Reconnect to the raylet in the background; health checks reap
            # it if it's truly gone.
            asyncio.ensure_future(self._reconnect_node(rec))
        for _, blob in self._store.load_all("actors"):
            d = pickle.loads(blob)
            rec = ActorRecord(d["spec"])
            rec.state = d["state"]
            rec.address = tuple(d["address"]) if d["address"] else None
            rec.node_id = d["node_id"]
            rec.worker_id = d["worker_id"]
            rec.restarts_used = d["restarts_used"]
            rec.death_reason = d["death_reason"]
            self._actors[rec.spec.actor_id] = rec
            self._actor_locks[rec.spec.actor_id] = asyncio.Lock()
            if rec.spec.name and rec.state != DEAD:
                self._named_actors[(rec.spec.namespace, rec.spec.name)] = \
                    rec.spec.actor_id
        for _, blob in self._store.load_all("placement_groups"):
            d = pickle.loads(blob)
            self._pg_manager.restore_record(d)
        # Restored PENDING groups need the retry loop running again or
        # they would only re-place on the next unrelated create/remove.
        self._pg_manager.kick()
        if restored_nodes or self._actors or self._kv:
            logger.info("GCS restored: %d nodes, %d actors, %d kv keys",
                        restored_nodes, len(self._actors), len(self._kv))

    async def _reconnect_node(self, rec: "NodeRecord"):
        try:
            client = RpcClient(*rec.address)
            await client.connect(timeout=10)
            rec.client = client
            rec.last_heartbeat = time.monotonic()
        except Exception:
            await self._mark_node_dead(rec.node_id,
                                       "unreachable after GCS restart")

    # ---- node management -------------------------------------------------

    async def handle_register_node(self, conn, node_id, address, resources,
                                   object_store_path, is_head=False, labels=None):
        rec = NodeRecord(node_id, tuple(address), resources, object_store_path,
                         is_head, labels or {})
        client = RpcClient(*rec.address)
        await client.connect(timeout=10)
        rec.client = client
        self._nodes[node_id] = rec
        conn.meta["node_id"] = node_id
        self._persist_node(rec)
        self._bump_view(rec)
        await self.publish("node", {"event": "added", "node": rec.view()})
        logger.info("node %s registered at %s resources=%s",
                    node_id.hex()[:12], rec.address, resources)
        return {"ok": True, "nodes": [n.view() for n in self._nodes.values()]}

    # ---- resource-view sync (ray_syncer analog) --------------------------
    #
    # Reference: src/ray/common/ray_syncer/ — every raylet needs an
    # eventually-consistent view of cluster resources for spillback routing.
    # Instead of each raylet pulling the FULL node table every heartbeat
    # (O(N^2) bytes/sec cluster-wide), the GCS keeps a versioned change log
    # and piggybacks only the deltas since the raylet's known version on the
    # heartbeat reply; an idle cluster exchanges empty deltas.

    def _bump_view(self, rec: "NodeRecord"):
        self._view_version += 1
        self._view_log.append((self._view_version, rec.view()))

    def _view_deltas(self, known_version: int,
                     known_epoch: Optional[str] = None):
        if (known_epoch != self._view_epoch
                or known_version > self._view_version
                or (self._view_log
                    and known_version < self._view_log[0][0] - 1)):
            # Different GCS epoch (restart — raw version numbers don't
            # compare across epochs), behind the capped log, or AHEAD of us:
            # full snapshot either way — delta-matching would silently drop
            # changes.
            return {"version": self._view_version,
                    "epoch": self._view_epoch,
                    "full": [n.view() for n in self._nodes.values()]}
        latest: Dict[bytes, dict] = {}
        for ver, view in self._view_log:
            if ver > known_version:
                latest[view["node_id"]] = view
        return {"version": self._view_version,
                "epoch": self._view_epoch,
                "deltas": list(latest.values())}

    async def _heartbeat(self, node_id, available=None, backlog=None,
                         known_version: Optional[int] = None,
                         known_epoch: Optional[str] = None):
        rec = self._nodes.get(node_id)
        if rec is None:
            return {"ok": False, "unknown": True}
        rec.last_heartbeat = time.monotonic()
        if backlog is not None:
            # Per-scheduling-class lease backlog (autoscaler demand feed,
            # gcs_autoscaler_state_manager.cc analog). Not part of the
            # versioned view — demand is advisory, not routing state.
            rec.backlog = backlog
        if available is not None and rec.available != available:
            rec.available = dict(available)
            self._bump_view(rec)
        reply = {"ok": True}
        if known_version is not None:
            reply["view"] = self._view_deltas(known_version, known_epoch)
        return reply

    async def handle_node_heartbeat2(self, conn, m: bytes):
        """Typed-schema heartbeat (runtime/wire.py HeartbeatMsg in,
        ViewDeltaMsg out). New fields on either message are invisible to
        old peers (unknown field numbers skip on decode); removed ones
        decode to defaults — protobuf evolution rules without the
        compiler."""
        hb = wire.HeartbeatMsg.decode(m)
        reply = await self._heartbeat(
            hb.node_id, available=hb.available or None,
            backlog=hb.backlog,
            known_version=hb.known_version if hb.known_version >= 0 else None,
            known_epoch=hb.known_epoch or None)
        view = reply.pop("view", None)
        if view is not None:
            nodes_key = "full" if "full" in view else "deltas"
            msg = wire.ViewDeltaMsg(
                version=view["version"], epoch=view.get("epoch") or "",
                is_full=nodes_key == "full")
            encoded = [wire.NodeInfoMsg(
                node_id=n["node_id"], host=n["address"][0],
                port=int(n["address"][1]), resources=n["resources"],
                available=n["available"], labels=n["labels"],
                is_head=n["is_head"], alive=n["alive"],
                object_store_path=n["object_store_path"],
                draining=bool(n.get("draining")),
                drain_deadline=float(n.get("drain_deadline") or 0.0))
                for n in view[nodes_key]]
            if nodes_key == "full":
                msg.full = encoded
            else:
                msg.deltas = encoded
            reply["view"] = msg.encode()
        return reply

    async def handle_get_nodes(self, conn, only_alive=True):
        return [n.view() for n in self._nodes.values() if n.alive or not only_alive]

    # ---- object relocation (drain-time primary-copy migration) -----------
    #
    # While a node drains, its raylet pushes primary object copies to live
    # peers and reports the new homes here. Workers that later hit
    # ObjectLostError for an oid ask `locate_object` BEFORE falling back to
    # lineage reconstruction, so objects that had time to move survive the
    # preemption without re-execution.

    async def handle_report_object_locations(self, conn, node_id,
                                             oids) -> dict:
        table = getattr(self, "_object_relocations", None)
        if table is None:
            table = self._object_relocations = {}
        for oid in oids:
            table[bytes(oid)] = node_id
        return {"ok": True, "count": len(oids)}

    async def handle_locate_object(self, conn, oid: bytes) -> dict:
        table = getattr(self, "_object_relocations", None)
        holder = table.get(oid) if table else None
        if holder is None:
            return {"found": False}
        rec = self._nodes.get(holder)
        if rec is None or not rec.alive:
            return {"found": False}
        return {"found": True, "node_id": holder,
                "address": list(rec.address)}

    # ---- checkpoint shard registry (checkpoint/plane.py replication) -----
    #
    # A completed checkpoint shard that was broadcast to peer object stores
    # registers here: the shard row records where the durable file lives,
    # and each replica oid lands in the drain relocation table homed on a
    # live PEER of the reporting node (the broadcast placed a copy on every
    # node) — so when the writer's node drains and dies at its deadline,
    # `locate_object` already points somewhere that survives it.

    async def handle_register_checkpoint_shards(self, conn, path: str,
                                                name: str, shard: int,
                                                world: int, step=None,
                                                nbytes: int = 0,
                                                oids=(), node_id=None
                                                ) -> dict:
        shards = getattr(self, "_ckpt_shards", None)
        if shards is None:
            shards = self._ckpt_shards = {}
        shards[(path, name, int(shard), int(world))] = {
            "path": path, "name": name, "shard": int(shard),
            "world": int(world), "step": step, "nbytes": int(nbytes),
            "oids": [bytes(o) for o in oids],
            "node_id": node_id, "time": time.time()}
        table = getattr(self, "_object_relocations", None)
        if table is None:
            table = self._object_relocations = {}
        peer = None
        for nid, rec in self._nodes.items():
            if rec.alive and not rec.draining and nid != node_id:
                peer = nid
                break
        home = peer if peer is not None else node_id
        relocated = 0
        if home is not None:
            for oid in oids:
                table[bytes(oid)] = home
                relocated += 1
        return {"ok": True, "relocated": relocated,
                "home": home.hex() if isinstance(home, bytes) else home}

    async def handle_list_checkpoint_shards(self, conn,
                                            path: Optional[str] = None
                                            ) -> list:
        shards = getattr(self, "_ckpt_shards", None) or {}
        rows = [dict(v, oids=[o.hex() for o in v["oids"]],
                     node_id=(v["node_id"].hex()
                              if isinstance(v["node_id"], bytes)
                              else v["node_id"]))
                for v in shards.values()
                if path is None or v["path"] == path]
        rows.sort(key=lambda r: (r["path"], r["name"], r["shard"]))
        return rows

    async def _on_disconnect(self, conn: ServerConnection):
        for subs in self._subscribers.values():
            subs.discard(conn)
        node_id = conn.meta.get("node_id")
        if node_id is not None and node_id in self._nodes and self._nodes[node_id].alive:
            await self._mark_node_dead(node_id, "raylet disconnected")
        job_id = conn.meta.get("job_id")
        if job_id is not None and job_id in self._jobs:
            self._jobs[job_id]["alive"] = False
            self._persist_job(self._jobs[job_id])
        if conn.meta.get("owns_cluster") and not self._shutdown.is_set():
            self._spawn_bg(self._shutdown_if_owner_gone(job_id))

    async def _shutdown_if_owner_gone(self, job_id, grace_s: float = 10.0):
        """Tear the cluster down unless the owning driver reconnects and
        re-claims its job within the grace period (a transient socket drop
        of an auto_reconnect client must not kill the cluster — the driver
        heartbeats its job every couple of seconds, so a live driver always
        re-claims well inside the grace)."""
        await asyncio.sleep(grace_s)
        job = self._jobs.get(job_id)
        if job is not None and job.get("alive"):
            return
        if self._shutdown.is_set():
            return
        logger.warning("cluster-owning driver (job %s) disconnected; "
                       "shutting the cluster down", job_id)
        await self._do_shutdown()

    async def handle_claim_job(self, conn, job_id, owns_cluster: bool = False):
        """Re-attach a driver connection to its job (register_job docstring).
        Doubles as the driver's job heartbeat: called periodically so even
        an otherwise-idle driver re-claims after a transparent reconnect."""
        conn.meta["job_id"] = job_id
        if owns_cluster:
            conn.meta["owns_cluster"] = True
        job = self._jobs.get(job_id)
        if job is not None and not job.get("alive"):
            job["alive"] = True
            self._persist_job(job)
        return {"ok": True}

    async def _mark_node_dead(self, node_id: bytes, reason: str):
        rec = self._nodes.get(node_id)
        if rec is None or not rec.alive:
            return
        rec.alive = False
        rec.death_reason = reason
        self._persist_node(rec)
        self._bump_view(rec)
        logger.warning("node %s marked dead: %s", node_id.hex()[:12], reason)
        from ray_tpu_torch.runtime import events as events_mod

        self._record_event(events_mod.make_event(
            events_mod.NODE_DEAD, f"node {node_id.hex()[:12]} dead: {reason}",
            severity=events_mod.ERROR, source="gcs", node_id=node_id))
        # Relocation entries pointing AT the dead node are stale.
        table = getattr(self, "_object_relocations", None)
        if table:
            for oid in [o for o, holder in table.items()
                        if holder == node_id]:
                table.pop(oid, None)
        # The prefix table's owner hints, in the same tick: the dead
        # node's replicas never touch their published prefixes again, so
        # no router may be sent to them by a hint. The GCS-homed pages
        # stay adoptable by any survivor.
        self._purge_prefix_entries(node_id=node_id, clear_owner_only=True)
        await self.publish("node", {"event": "removed", "node": rec.view(), "reason": reason})
        # Fail/restart actors that lived on that node.
        for actor in list(self._actors.values()):
            if actor.node_id == node_id and actor.state in (ALIVE, PENDING_CREATION):
                asyncio.ensure_future(
                    self._handle_actor_failure(actor.spec.actor_id, f"node died: {reason}"))
        if self._pg_manager is not None:
            await self._pg_manager.on_node_dead(node_id)

    async def _health_check_loop(self):
        # gcs_health_check_manager analog: periodic liveness by heartbeat age.
        while not self._shutdown.is_set():
            await asyncio.sleep(1.0)
            now = time.monotonic()
            for rec in list(self._nodes.values()):
                if rec.alive and now - rec.last_heartbeat > 30.0:
                    await self._mark_node_dead(rec.node_id, "heartbeat timeout")

    # ---- KV (function/class table, runtime metadata) ---------------------

    async def handle_kv_put(self, conn, key: bytes, value: bytes, overwrite=True):
        if not overwrite and key in self._kv:
            return {"ok": False, "exists": True}
        self._kv[key] = value
        try:
            self._store.put("kv", key, value)
        except Exception:
            logger.exception("kv persist failed")
        return {"ok": True}

    async def handle_kv_get(self, conn, key: bytes):
        return {"value": self._kv.get(key)}

    async def handle_kv_del(self, conn, key: bytes):
        self._store.delete("kv", key)
        return {"ok": self._kv.pop(key, None) is not None}

    async def handle_kv_keys(self, conn, prefix: bytes = b""):
        return {"keys": [k for k in self._kv if k.startswith(prefix)]}

    # ---- cluster event bus (runtime/events.py) ---------------------------

    def _record_event(self, ev: dict):
        """Append one typed cluster event to the bounded ring (see
        runtime/events.py for the record shape)."""
        from collections import deque

        from ray_tpu_torch.config import cfg

        store = getattr(self, "_cluster_events", None)
        if store is None:
            store = self._cluster_events = deque(
                maxlen=cfg().cluster_events_max)
        store.append(ev)

    async def handle_report_events(self, conn, events):
        """Batched typed cluster events from any component (best-effort
        emitters)."""
        for ev in events:
            if isinstance(ev, dict):
                self._record_event(dict(ev))
        return {"ok": True}

    async def handle_list_events(self, conn, event_type=None, severity=None,
                                 source=None, limit: int = 100):
        """Newest-first filtered view of the cluster event ring."""
        store = getattr(self, "_cluster_events", None) or ()
        out = []
        for ev in reversed(store):
            if event_type is not None and ev.get("type") != event_type:
                continue
            if severity is not None and ev.get("severity") != severity:
                continue
            if source is not None and ev.get("source") != source:
                continue
            out.append(ev)
            if len(out) >= limit:
                break
        return out

    # ---- pubsub ----------------------------------------------------------

    # ---- cluster prefix store (llm/prefix_store.py) -----------------------
    #
    # digest -> published KV prefix pages + adoption metadata. The page
    # bytes live HERE, not in a worker's object store: a worker's objects
    # are reaped when their owner dies, the event a published prefix must
    # survive. Traffic is raw-frame RPC both ways (rpc.py call_raw), so no
    # page byte is pickled. A byte-capacity LRU keeps replicas from
    # flooding the head node's RAM.

    PREFIX_STORE_CAPACITY = 256 << 20

    def _prefix_table(self):
        tbl = getattr(self, "_prefix_entries", None)
        if tbl is None:
            from collections import OrderedDict

            tbl = self._prefix_entries = OrderedDict()
            self._prefix_bytes = 0
        return tbl

    @staticmethod
    def _prefix_row_msg(key: bytes, row: dict):
        return wire.PrefixEntryMsg(
            digest=key, lora_id=row["lora_id"],
            weights_version=row["weights_version"],
            block_size=row["block_size"], n_tokens=row["n_tokens"],
            token_ids=row["token_ids"], nbytes=len(row["payload"]),
            owner_replica=row["owner_replica"], node_id=row["node_id"],
            deployment=row["deployment"])

    async def handle_prefix_upsert(self, conn, m, payload):
        ent = wire.PrefixEntryMsg.decode(bytes(m))
        buf = bytes(payload)
        if not ent.digest or not buf or not ent.token_ids:
            return RawReply(wire.AckMsg(
                ok=False, error="empty prefix upsert").encode())
        tbl = self._prefix_table()
        key = bytes(ent.digest)
        old = tbl.pop(key, None)
        if old is not None:
            self._prefix_bytes -= len(old["payload"])
        tbl[key] = {
            "lora_id": ent.lora_id, "weights_version": ent.weights_version,
            "block_size": ent.block_size, "n_tokens": ent.n_tokens,
            "token_ids": list(ent.token_ids),
            "owner_replica": ent.owner_replica,
            "node_id": bytes(ent.node_id), "deployment": ent.deployment,
            "payload": buf, "time": time.time()}
        self._prefix_bytes += len(buf)
        while tbl and self._prefix_bytes > self.PREFIX_STORE_CAPACITY:
            _, victim = tbl.popitem(last=False)
            self._prefix_bytes -= len(victim["payload"])
        return RawReply(wire.AckMsg(ok=True,
                                    existed=old is not None).encode())

    async def handle_prefix_lookup(self, conn, m, payload):
        """Answer with the CONTIGUOUS run of rows held from digests[0] on
        (the caller lists its missing chain, longest last); the reply
        payload is their page buffers concatenated (self-delimiting
        frames, so the adopter splits them apart)."""
        q = wire.PrefixLookupMsg.decode(bytes(m))
        tbl = self._prefix_table()
        entries, bufs = [], []
        for d in (q.digests or ()):
            key = bytes(d)
            row = tbl.get(key)
            # weights_version <= 0 means "any": the router's owner probe
            # does not know the fleet's version. Adopters pass theirs and
            # check it again per row, so a relaxed probe never brings
            # stale KV into an engine.
            if (row is None or row["lora_id"] != q.lora_id
                    or (q.weights_version > 0
                        and row["weights_version"] != q.weights_version)
                    or row["block_size"] != q.block_size):
                break
            tbl.move_to_end(key)
            if q.replica:
                # The adopter is about to hold these pages hot: it becomes
                # the live-owner hint the router's fallback routes to.
                row["owner_replica"] = q.replica
            entries.append(self._prefix_row_msg(key, row))
            if q.want_payload:
                bufs.append(row["payload"])
        reply = wire.PrefixLookupReplyMsg(found=bool(entries),
                                          entries=entries)
        return RawReply(reply.encode(), payload=b"".join(bufs))

    async def handle_prefix_purge(self, conn, m, payload):
        q = wire.PrefixPurgeMsg.decode(bytes(m))
        purged, cleared = self._purge_prefix_entries(
            owner_replica=q.owner_replica, node_id=bytes(q.node_id),
            deployment=q.deployment,
            digests=[bytes(d) for d in (q.digests or ())],
            below_weights_version=q.below_weights_version,
            clear_owner_only=q.clear_owner_only)
        return RawReply(wire.PrefixPurgeReplyMsg(
            ok=True, purged=purged, owners_cleared=cleared).encode())

    def _purge_prefix_entries(self, *, owner_replica: str = "",
                              node_id: bytes = b"", deployment: str = "",
                              digests=(), below_weights_version: int = 0,
                              clear_owner_only: bool = False):
        """Prune the prefix table (any selector matches; none matches
        nothing). clear_owner_only blanks the live-owner hint but keeps
        the row adoptable: the replica-death path, where the pages are
        still valid but a hint naming a dead replica would misroute."""
        tbl = getattr(self, "_prefix_entries", None)
        if not tbl:
            return 0, 0
        digest_set = set(digests)

        def match(key, row):
            if key in digest_set:
                return True
            if owner_replica and row["owner_replica"] == owner_replica:
                return True
            if node_id and row["node_id"] == node_id:
                return True
            if deployment and row["deployment"] == deployment:
                return True
            return bool(below_weights_version
                        and row["weights_version"] < below_weights_version)

        purged = cleared = 0
        for key in [k for k, r in tbl.items() if match(k, r)]:
            if clear_owner_only:
                tbl[key]["owner_replica"] = ""
                tbl[key]["node_id"] = b""
                cleared += 1
            else:
                row = tbl.pop(key)
                self._prefix_bytes -= len(row["payload"])
                purged += 1
        return purged, cleared

    async def handle_subscribe(self, conn, channels: List[str]):
        for ch in channels:
            self._subscribers.setdefault(ch, set()).add(conn)
        return {"ok": True}

    async def handle_publish(self, conn, channel: str, message: Any):
        await self.publish(channel, message)
        return {"ok": True}

    async def publish(self, channel: str, message: Any):
        dead = []
        for conn in self._subscribers.get(channel, ()):  # long-poll-free push
            try:
                await conn.push("pubsub", {"channel": channel, "message": message})
            except Exception:
                dead.append(conn)
        for conn in dead:
            self._subscribers.get(channel, set()).discard(conn)

    # ---- job table --------------------------------------------------------

    async def handle_register_job(self, conn, metadata=None,
                                  owns_cluster: bool = False,
                                  token: Optional[str] = None):
        """`owns_cluster=True` marks this driver connection as the owner of
        an auto-started cluster: if the driver dies (connection drops
        without a graceful shutdown), the whole cluster is torn down —
        otherwise a SIGKILLed driver leaks GCS/raylet/worker processes
        forever (reference: ray.init()-owned clusters die with the driver).

        `token` makes registration idempotent under the client's
        auto_reconnect retry: a lost reply must not create a second job
        whose orphaned owner connection would later tear the cluster down
        under a live driver."""
        if token:
            for job in self._jobs.values():
                if job.get("token") == token:
                    conn.meta["job_id"] = job["job_id"]
                    if owns_cluster:
                        conn.meta["owns_cluster"] = True
                    job["alive"] = True
                    self._persist_job(job)
                    return {"job_id": job["job_id"]}
        self._job_counter += 1
        job_id = self._job_counter
        conn.meta["job_id"] = job_id
        if owns_cluster:
            conn.meta["owns_cluster"] = True
        self._jobs[job_id] = {"job_id": job_id, "start_time": time.time(),
                              "metadata": metadata or {}, "alive": True,
                              "token": token}
        self._persist_job(self._jobs[job_id])
        return {"job_id": job_id}

    def _persist_job(self, job: dict):
        import pickle

        try:
            self._store.put("jobs", str(job["job_id"]).encode(),
                            pickle.dumps(job))
        except Exception:
            logger.exception("job persist failed")

    async def handle_get_jobs(self, conn):
        return list(self._jobs.values())

    # ---- actor management (gcs_actor_manager.h:291 state machine) --------

    async def handle_create_actor(self, conn, spec: ActorSpec):
        if spec.name:
            key = (spec.namespace, spec.name)
            if key in self._named_actors:
                existing = self._actors[self._named_actors[key]]
                if existing.state != DEAD:
                    return {"ok": False, "error": f"actor name {spec.name!r} already taken"}
            self._named_actors[key] = spec.actor_id
        record = ActorRecord(spec)
        self._actors[spec.actor_id] = record
        self._actor_locks[spec.actor_id] = asyncio.Lock()
        self._persist_actor(record)
        # Creation is asynchronous, as in the reference (the JAX package's
        # GCS replies only once the actor is up): the actor stays
        # PENDING_CREATION while its lease waits for resources, callers'
        # method calls queue until it is ALIVE, and a failed creation
        # leaves it DEAD with the reason.
        self._spawn_bg(self._create_in_background(record))
        return {"ok": True, "actor_id": spec.actor_id}

    async def _create_in_background(self, record: ActorRecord):
        try:
            await self._schedule_and_create(record)
        except Exception as e:
            if record.state != DEAD:
                record.state = DEAD
                record.death_reason = f"creation failed: {e!r}"
                self._persist_actor(record)
                await self.publish("actor",
                                   {"event": "dead", "actor": record.view()})

    async def _schedule_and_create(self, record: ActorRecord):
        """GcsActorScheduler analog (gcs_actor_scheduler.h:111): lease a worker
        from a raylet, push the creation task to it, record the address."""
        spec = record.spec
        last_err = None
        import os as _os
        # Failed leases still need their req_ids canceled at the raylet (a
        # pending lease, or a grant that raced the timeout, must not leak
        # worker resources) — but a dead node's cancel must not stall the
        # scheduling loop, so cancels accumulate per node and fire batched
        # in the background at exit.
        pending_cancels: Dict[bytes, list] = {}

        def _flush_cancels():
            for nid, req_ids in pending_cancels.items():
                node_rec = self._nodes.get(nid)
                if node_rec is None or not node_rec.alive:
                    continue
                asyncio.ensure_future(
                    self._cancel_leases_at(node_rec, req_ids))

        try:
            for node in scheduling.rank_nodes_for_actor(self._nodes, spec,
                                                        self._pg_manager):
                req_id = _os.urandom(8)
                # The node's total capacity fits (rank_nodes_for_actor), so
                # the lease waits at the raylet until resources free up: no
                # deadline. Killing the pending actor cancels it.
                record.pending_lease = (node, req_id)
                try:
                    lease = wire.LeaseReplyMsg.decode(await node.client.call(
                        "lease_worker2", m=wire.LeaseRequestMsg(
                            resources=spec.resources, for_actor=True,
                            placement_group_id=spec.placement_group_id or b"",
                            bundle_index=spec.placement_group_bundle_index,
                            req_id=req_id).encode())).to_reply()
                except Exception as e:
                    last_err = e
                    pending_cancels.setdefault(node.node_id, []).append(req_id)
                    continue
                finally:
                    record.pending_lease = None
                if not lease.get("ok"):
                    last_err = RuntimeError(lease.get("error", "lease refused"))
                    continue
                if record.state == DEAD:
                    # Killed while its lease waited: give the worker back.
                    await node.client.call(
                        "return_worker", lease_id=lease["lease_id"],
                        worker_dead=True)
                    return
                worker_addr = tuple(lease["worker_address"])
                logger.debug("pushing create_actor %s to worker %s at %s",
                             spec.actor_id.hex()[:12],
                             lease["worker_id"].hex()[:12], worker_addr)
                worker_client = RpcClient(*worker_addr)
                try:
                    await worker_client.connect(timeout=15)
                    reply = await worker_client.call("create_actor", spec=spec,
                                                     timeout=300)
                    if not reply.get("ok"):
                        raise RuntimeError(
                            reply.get("error", "actor __init__ failed"))
                except Exception as e:
                    last_err = e
                    try:
                        await node.client.call(
                            "return_worker", lease_id=lease["lease_id"],
                            worker_dead=True)
                    except Exception:
                        pass
                    # __init__ raising is terminal, not a scheduling failure.
                    if isinstance(e, RuntimeError):
                        raise
                    continue
                finally:
                    await worker_client.close()
                record.state = ALIVE
                record.address = worker_addr
                record.node_id = node.node_id
                record.worker_id = lease["worker_id"]
                self._persist_actor(record)
                await self.publish("actor",
                                   {"event": "alive", "actor": record.view()})
                return
        finally:
            _flush_cancels()
        raise RuntimeError(f"no feasible node for actor {spec.class_name} "
                           f"(resources={spec.resources}): {last_err!r}")

    @staticmethod
    async def _cancel_leases_at(node: NodeRecord, req_ids: list):
        """Best-effort batched lease cancel at one raylet in a single
        cancel_lease_batch frame; a node that died in the meantime is
        tolerated silently."""
        try:
            await node.client.call("cancel_lease_batch",
                                   req_ids=list(req_ids), timeout=10)
        except Exception:
            pass  # dead/unreachable node: nothing left to cancel

    async def handle_get_actor(self, conn, actor_id: Optional[bytes] = None,
                               name: Optional[str] = None, namespace: str = "default"):
        if actor_id is None and name is not None:
            actor_id = self._named_actors.get((namespace, name))
        rec = self._actors.get(actor_id) if actor_id else None
        if rec is None:
            return {"found": False}
        return {"found": True, **rec.view()}

    async def handle_list_actors(self, conn):
        return [r.view() for r in self._actors.values()]

    async def handle_kill_actor(self, conn, actor_id: bytes, no_restart=True):
        rec = self._actors.get(actor_id)
        if rec is None:
            return {"ok": False}
        if no_restart:
            rec.spec.max_restarts = 0
        if rec.state == PENDING_CREATION:
            # Not up yet: it dies here, and its waiting lease is cancelled.
            rec.state = DEAD
            rec.death_reason = "killed before creation"
            self._persist_actor(rec)
            if rec.pending_lease is not None:
                node, req_id = rec.pending_lease
                await self._cancel_leases_at(node, [req_id])
            await self.publish("actor", {"event": "dead", "actor": rec.view()})
            return {"ok": True}
        node = self._nodes.get(rec.node_id) if rec.node_id else None
        if node is not None and node.alive and rec.worker_id is not None:
            try:
                await node.client.call("kill_worker", worker_id=rec.worker_id)
            except Exception:
                pass
        return {"ok": True}

    async def handle_report_worker_death(self, conn, node_id, worker_id, actor_id=None,
                                         reason="", pid=None):
        """Raylet tells us a worker process exited (node_manager death path).
        Republished on the 'worker_death' channel so object owners can prune
        dead borrowers (reference_count.h borrower-failure handling)."""
        if actor_id is not None:
            await self._handle_actor_failure(actor_id, reason or "worker died")
        await self.publish("worker_death", {
            "worker_id": worker_id.hex() if isinstance(worker_id, bytes)
            else worker_id, "reason": reason})
        return {"ok": True}

    async def _handle_actor_failure(self, actor_id: bytes, reason: str):
        rec = self._actors.get(actor_id)
        if rec is None or rec.state == DEAD:
            return
        lock = self._actor_locks.setdefault(actor_id, asyncio.Lock())
        async with lock:
            if rec.state == DEAD:
                return
            if rec.restarts_used < rec.spec.max_restarts:
                rec.restarts_used += 1
                rec.state = RESTARTING
                rec.address = None
                await self.publish("actor", {"event": "restarting", "actor": rec.view()})
                try:
                    await self._schedule_and_create(rec)
                except Exception as e:
                    rec.state = DEAD
                    rec.death_reason = f"restart failed: {e!r}"
                    self._persist_actor(rec)
                    await self.publish("actor", {"event": "dead", "actor": rec.view()})
            else:
                rec.state = DEAD
                rec.death_reason = reason
                self._persist_actor(rec)
                await self.publish("actor", {"event": "dead", "actor": rec.view()})

    # ---- placement groups (delegated, see gcs/placement_groups.py) -------

    async def handle_create_placement_group(self, conn, **kw):
        return await self._pg_manager.create(**kw)

    async def handle_remove_placement_group(self, conn, **kw):
        return await self._pg_manager.remove(**kw)

    async def handle_get_placement_group(self, conn, **kw):
        return await self._pg_manager.get(**kw)

    async def handle_list_placement_groups(self, conn):
        return await self._pg_manager.list()

    # ---- shutdown ---------------------------------------------------------

    async def handle_shutdown_cluster(self, conn):
        self._spawn_bg(self._do_shutdown())
        return {"ok": True}

    async def _do_shutdown(self):
        logger.info("cluster shutdown: notifying %d nodes", len(self._nodes))
        await asyncio.sleep(0.05)  # let the reply flush
        for rec in self._nodes.values():
            if rec.alive and rec.client is not None:
                try:
                    await rec.client.call("shutdown_node", timeout=5)
                except Exception as e:
                    logger.warning("shutdown_node to %s failed: %r",
                                   rec.node_id.hex()[:12], e)
        logger.info("cluster shutdown: nodes notified; stopping GCS")
        self._shutdown.set()

    async def wait_for_shutdown(self):
        await self._shutdown.wait()
        if self._health_task:
            self._health_task.cancel()
        await self.server.close()
