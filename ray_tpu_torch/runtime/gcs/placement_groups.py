"""Placement group manager: 2-phase bundle reservation across raylets.

Reference analog: src/ray/gcs/gcs_server/gcs_placement_group_manager.* and
gcs_placement_group_scheduler.h:453 (Prepare/Commit two-phase protocol),
strategies from src/ray/protobuf/common.proto:978-985 (PACK, SPREAD,
STRICT_PACK, STRICT_SPREAD).

The port's copy of ray_tpu/runtime/gcs/placement_groups.py. The JAX
package's TPU additions (STRICT_PACK preferring nodes labelled with an
intact slice, and its contiguous multi-host slice path) do not apply to
GPU bundles and are not ported: a STRICT_PACK group lands on one node or
not at all.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.runtime import scheduling

logger = logging.getLogger(__name__)

PACK = "PACK"
SPREAD = "SPREAD"
STRICT_PACK = "STRICT_PACK"
STRICT_SPREAD = "STRICT_SPREAD"

PENDING = "PENDING"
CREATED = "CREATED"
REMOVED = "REMOVED"
RESCHEDULING = "RESCHEDULING"


class PlacementGroupRecord:
    def __init__(self, pg_id: bytes, bundles: List[Dict[str, float]], strategy: str,
                 name: str = ""):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = PENDING
        # bundle index -> node_id
        self.locations: List[Optional[bytes]] = [None] * len(bundles)

    def view(self) -> dict:
        return {
            "placement_group_id": self.pg_id,
            "name": self.name,
            "strategy": self.strategy,
            "bundles": self.bundles,
            "state": self.state,
            "locations": list(self.locations),
        }


class PlacementGroupManager:
    def __init__(self, gcs):
        self.gcs = gcs
        self._groups: Dict[bytes, PlacementGroupRecord] = {}
        self._lock = asyncio.Lock()
        self._retry_task: Optional[asyncio.Task] = None

    def restore_record(self, d: dict):
        """Rebuild a record after a GCS restart (raylets still hold the
        committed bundles, so CREATED groups stay valid)."""
        rec = PlacementGroupRecord(d["pg_id"], d["bundles"], d["strategy"],
                                   d["name"])
        rec.state = d["state"]
        rec.locations = list(d["locations"])
        self._groups[d["pg_id"]] = rec

    # ---- queries ----------------------------------------------------------

    def bundle_location(self, pg_id: bytes, bundle_index: int) -> Optional[bytes]:
        rec = self._groups.get(pg_id)
        if rec is None or rec.state != CREATED:
            return None
        if bundle_index < 0:
            for loc in rec.locations:
                if loc is not None:
                    return loc
            return None
        return rec.locations[bundle_index]

    async def get(self, pg_id: bytes):
        rec = self._groups.get(pg_id)
        return {"found": rec is not None, **(rec.view() if rec else {})}

    async def list(self):
        return [r.view() for r in self._groups.values()]

    # ---- creation: plan, then 2PC prepare/commit --------------------------

    async def create(self, pg_id: bytes, bundles: List[Dict[str, float]],
                     strategy: str = PACK, name: str = ""):
        """Two infeasibility classes (reference: pending PGs queue in
        GcsPlacementGroupManager and retry as the cluster changes):

        * capacity-infeasible — no assignment exists even against TOTAL
          node resources (e.g. STRICT_PACK across fragmented slices): fail
          the create loudly, the group can never be satisfied as-is.
        * currently-infeasible — an assignment exists by capacity but not
          by current availability (resources still draining from a group
          torn down moments ago, workers mid-exit): the group stays
          PENDING and a retry loop re-places it as the resource view
          changes; pg.wait() observes CREATED when it lands. This is the
          elastic-restart path: shrink-after-failure re-requests its PG
          before the failed group's reservations finish releasing.
        """
        rec = PlacementGroupRecord(pg_id, bundles, strategy, name)
        self._groups[pg_id] = rec
        async with self._lock:
            # State transition under the SAME lock as placement: the retry
            # loop must never observe a successfully-placed record still
            # PENDING (it would place it a second time, leaking the first
            # set of bundle reservations).
            ok, err = await self._try_place(rec)
            if ok:
                rec.state = CREATED
        if not ok:
            if self._plan(rec, by_capacity=True) is None:
                self._groups.pop(pg_id, None)
                return {"ok": False, "error": err,
                        "placement_group_id": pg_id}
            # Persist the PENDING record: a GCS restart must restore it
            # (restore_record + kick) or pg.wait() would hang forever.
            self.gcs.persist_pg(rec)
            self._ensure_retry_loop()
            return {"ok": True, "placement_group_id": pg_id,
                    "state": PENDING}
        self.gcs.persist_pg(rec)
        await self.gcs.publish("placement_group", {"event": "created", "pg": rec.view()})
        return {"ok": True, "placement_group_id": pg_id}

    def _ensure_retry_loop(self):
        if self._retry_task is None or self._retry_task.done():
            self._retry_task = asyncio.ensure_future(self._retry_pending_loop())

    async def _retry_pending_loop(self):
        """Re-place PENDING groups until none remain. Cheap (a plan against
        the in-memory view) and self-terminating; woken again by create()/
        remove()/node events."""
        from ray_tpu_torch.config import cfg

        interval = getattr(cfg(), "pg_retry_interval_s", 0.2)
        while True:
            await asyncio.sleep(interval)
            pending = [r for r in self._groups.values() if r.state == PENDING]
            if not pending:
                return
            for rec in pending:
                async with self._lock:
                    if rec.state != PENDING:
                        continue
                    ok, _err = await self._try_place(rec)
                    if ok:
                        rec.state = CREATED  # same-lock transition (above)
                if ok:
                    self.gcs.persist_pg(rec)
                    await self.gcs.publish(
                        "placement_group",
                        {"event": "created", "pg": rec.view()})

    def kick(self):
        """Resources may have freed (PG removed, node joined/recovered):
        wake the pending retry loop."""
        if any(r.state == PENDING for r in self._groups.values()):
            self._ensure_retry_loop()

    def _plan(self, rec: PlacementGroupRecord,
              by_capacity: bool = False) -> Optional[List[Tuple[int, bytes]]]:
        """Pick a node per bundle against a snapshot of available resources
        (or TOTAL resources with by_capacity=True — the can-this-ever-fit
        check). Returns [(bundle_index, node_id)] or None if infeasible.
        """
        # Draining nodes take no NEW bundles: a gang placed there would be
        # killed at the drain deadline moments later.
        nodes = [n for n in self.gcs._nodes.values()
                 if n.alive and not getattr(n, "draining", False)]
        snapshot = {n.node_id: dict(n.resources if by_capacity
                                    else n.available) for n in nodes}
        totals = {n.node_id: n.resources for n in nodes}
        plan: List[Tuple[int, bytes]] = []

        def fits_on(nid, bundle):
            return scheduling.fits(snapshot[nid], bundle)

        idxs = list(range(len(rec.bundles)))
        if rec.strategy in (STRICT_PACK, PACK):
            # Try to land everything on one node.
            candidates = sorted(
                snapshot.keys(),
                key=lambda nid: scheduling.utilization_score(
                    totals[nid], snapshot[nid], {}))
            for nid in candidates:
                snap = dict(snapshot[nid])
                ok = True
                for b in rec.bundles:
                    if scheduling.fits(snap, b):
                        scheduling.subtract(snap, b)
                    else:
                        ok = False
                        break
                if ok:
                    return [(i, nid) for i in idxs]
            if rec.strategy == STRICT_PACK:
                return None
            # PACK falls back to spreading while preferring fewer nodes.
        if rec.strategy == STRICT_SPREAD:
            used_nodes = set()
            for i in idxs:
                placed = False
                for nid in sorted(snapshot, key=lambda nid: scheduling.utilization_score(
                        totals[nid], snapshot[nid], rec.bundles[i])):
                    if nid in used_nodes or not fits_on(nid, rec.bundles[i]):
                        continue
                    scheduling.subtract(snapshot[nid], rec.bundles[i])
                    used_nodes.add(nid)
                    plan.append((i, nid))
                    placed = True
                    break
                if not placed:
                    return None
            return plan
        # PACK fallback / SPREAD: greedy per-bundle.
        prefer_few = rec.strategy == PACK
        for i in idxs:
            order = sorted(
                snapshot,
                key=lambda nid: scheduling.utilization_score(
                    totals[nid], snapshot[nid], rec.bundles[i]) * (-1 if prefer_few else 1))
            placed = False
            for nid in order:
                if fits_on(nid, rec.bundles[i]):
                    scheduling.subtract(snapshot[nid], rec.bundles[i])
                    plan.append((i, nid))
                    placed = True
                    break
            if not placed:
                return None
        return plan

    async def _try_place(self, rec: PlacementGroupRecord) -> Tuple[bool, str]:
        plan = self._plan(rec)
        if plan is None:
            return False, "infeasible: no node assignment satisfies the bundles"
        # Phase 1: prepare every bundle reservation.
        prepared: List[Tuple[int, bytes]] = []
        for i, nid in plan:
            node = self.gcs._nodes.get(nid)
            try:
                r = await node.client.call("prepare_bundle", pg_id=rec.pg_id,
                                           bundle_index=i, resources=rec.bundles[i],
                                           timeout=30)
            except Exception as e:
                r = {"ok": False, "error": repr(e)}
            if not r.get("ok"):
                for j, njd in prepared:
                    try:
                        await self.gcs._nodes[njd].client.call(
                            "cancel_bundle", pg_id=rec.pg_id, bundle_index=j, timeout=30)
                    except Exception:
                        pass
                return False, r.get("error", "prepare failed")
            prepared.append((i, nid))
        # Phase 2: commit.
        for i, nid in prepared:
            await self.gcs._nodes[nid].client.call(
                "commit_bundle", pg_id=rec.pg_id, bundle_index=i, timeout=30)
            rec.locations[i] = nid
        return True, ""

    async def remove(self, pg_id: bytes):
        rec = self._groups.get(pg_id)
        if rec is None:
            return {"ok": False}
        for i, nid in enumerate(rec.locations):
            if nid is None:
                continue
            node = self.gcs._nodes.get(nid)
            if node is not None and node.alive:
                try:
                    await node.client.call("return_bundle", pg_id=pg_id, bundle_index=i,
                                           timeout=30)
                except Exception:
                    pass
        rec.state = REMOVED
        self.gcs.persist_pg(rec)
        rec.locations = [None] * len(rec.bundles)
        await self.gcs.publish("placement_group", {"event": "removed", "pg": rec.view()})
        self.kick()  # freed bundles may unblock a pending group
        return {"ok": True}

    async def on_node_dead(self, node_id: bytes):
        """Reschedule groups that had bundles on a dead node."""
        for rec in self._groups.values():
            if rec.state == CREATED and node_id in rec.locations:
                rec.state = RESCHEDULING
                for i, nid in enumerate(rec.locations):
                    if nid is not None and nid != node_id:
                        node = self.gcs._nodes.get(nid)
                        if node is not None and node.alive:
                            try:
                                await node.client.call("return_bundle", pg_id=rec.pg_id,
                                                       bundle_index=i, timeout=30)
                            except Exception:
                                pass
                rec.locations = [None] * len(rec.bundles)
                async with self._lock:
                    ok, _ = await self._try_place(rec)
                    rec.state = CREATED if ok else PENDING
                if not ok:
                    self._ensure_retry_loop()
                self.gcs.persist_pg(rec)
                await self.gcs.publish("placement_group",
                                       {"event": "rescheduled" if ok else "pending",
                                        "pg": rec.view()})
