"""Proactive object broadcast: replicate a store object to every node
(port of ray_tpu/util/broadcast.py).

Reference analog: src/ray/object_manager/push_manager.h:30 (chunked
pushes) and the release-benchmark envelope case "1 GiB object broadcast,
50+ nodes" (release/benchmarks/README.md:18). The object relays through a
fanout tree of raylets (runtime/raylet `handle_fetch_and_relay`): depth
O(log_f n), and no node uploads more than f copies. After a broadcast,
tasks on any node read the object from their local store instead of
pulling it on demand.

Each relay hop moves the object over the raw-frame object plane
(raylet `_pull_from` -> `pull_object_raw`): chunks ride as framed payload
bytes from the store arena into a preallocated receive buffer. Nothing
here imports torch.
"""

from __future__ import annotations

from typing import List, Optional


def broadcast_object(ref, node_ids: Optional[List[bytes]] = None,
                     timeout: float = 600.0) -> int:
    """Replicate `ref`'s object to `node_ids` (default: every alive node).
    Returns the number of nodes newly covered. Blocking."""
    from ray_tpu_torch.config import cfg
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.worker import global_worker

    core = global_worker()
    oid = ref.binary()
    nodes = {bytes.fromhex(n["node_id"]) if isinstance(n["node_id"], str)
             else n["node_id"]: tuple(n["address"])
             for n in api.nodes() if n.get("alive", True)}
    # Root: a node that already holds the object.
    if core.store is not None and core.store.contains(oid):
        root = core.node_id
    else:
        root = core._object_locations.get(oid) or ref.owner
    if root not in nodes:
        raise ValueError(f"object {oid.hex()[:12]} location unknown")
    wanted = node_ids if node_ids is not None else list(nodes)
    targets = [nodes[nid] for nid in wanted
               if nid != root and nid in nodes]
    if not targets:
        return 0

    async def _run():
        client = await core._raylet_for(nodes[root])
        return await client.call(
            "fetch_and_relay", oid=oid, source=nodes[root], targets=targets,
            fanout=cfg().broadcast_fanout, timeout=timeout)

    reply = core.io.run(_run(), timeout=timeout + 10)
    if not reply.get("ok"):
        raise RuntimeError(f"broadcast failed: {reply.get('error')}")
    return len(targets)
