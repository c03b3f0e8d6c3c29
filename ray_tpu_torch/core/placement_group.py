"""Placement group public API.

Reference analog: python/ray/util/placement_group.py (placement_group(),
PlacementGroup.ready/wait, placement_group_table) and
python/ray/util/scheduling_strategies.py:15 PlacementGroupSchedulingStrategy.
The port's copy of ray_tpu/core/placement_group.py.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.core.exceptions import PlacementGroupError
from ray_tpu_torch.runtime.resources import whole_gpus
from ray_tpu_torch.utils.ids import PlacementGroupID

PACK = "PACK"
SPREAD = "SPREAD"
STRICT_PACK = "STRICT_PACK"
STRICT_SPREAD = "STRICT_SPREAD"


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundles = bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def table(self) -> dict:
        core = worker_mod.global_worker()
        return core.io.run(core.gcs.call("get_placement_group", pg_id=self.id.binary()))

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            info = self.table()
            if info.get("state") == "CREATED":
                return True
            if info.get("state") == "REMOVED":
                return False
            time.sleep(0.05)
        return False

    def ready(self):
        """Returns an ObjectRef-like blocking helper: `pg.wait()` preferred."""
        return self

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles))


def placement_group(bundles: List[Dict[str, float]], strategy: str = PACK,
                    name: str = "") -> PlacementGroup:
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b}")
        whole_gpus(b.get("GPU", 0), "a bundle's GPU")
    core = worker_mod.global_worker()
    pg_id = PlacementGroupID.generate()
    reply = core.io.run(core.gcs.call(
        "create_placement_group", pg_id=pg_id.binary(),
        bundles=[{k: float(v) for k, v in b.items()} for b in bundles],
        strategy=strategy, name=name))
    if not reply.get("ok"):
        raise PlacementGroupError(reply.get("error", "creation failed"))
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup):
    core = worker_mod.global_worker()
    core.io.run(core.gcs.call("remove_placement_group", pg_id=pg.id.binary()))


def placement_group_table() -> List[dict]:
    core = worker_mod.global_worker()
    return core.io.run(core.gcs.call("list_placement_groups"))
