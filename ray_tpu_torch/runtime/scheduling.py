"""Resource math and scheduling policies (the port's copy of
ray_tpu/runtime/scheduling.py).

Reference analog: src/ray/common/scheduling/ (cluster_resource_data.h fixed-
point resource vectors — we use floats with an epsilon) and
src/ray/raylet/scheduling/policy/ (hybrid_scheduling_policy.h:50 top-k
local-first, spread, node-affinity). Bundle (placement-group) policies live in
gcs/placement_groups.py.
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional

EPS = 1e-9


def fits(available: Dict[str, float], demand: Dict[str, float]) -> bool:
    for k, v in demand.items():
        if v > EPS and available.get(k, 0.0) + EPS < v:
            return False
    return True


def subtract(available: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        if v > EPS:
            available[k] = available.get(k, 0.0) - v


def add(available: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        if v > EPS:
            available[k] = available.get(k, 0.0) + v


def utilization_score(total: Dict[str, float], available: Dict[str, float],
                      demand: Dict[str, float]) -> float:
    """Lower is better: prefer nodes that stay least utilized after placement
    (the hybrid policy's critical-resource utilization measure)."""
    score = 0.0
    for k, v in total.items():
        if v <= EPS:
            continue
        would_use = v - available.get(k, 0.0) + demand.get(k, 0.0)
        score = max(score, would_use / v)
    return score


class SchedulingStrategy:
    pass


class DefaultStrategy(SchedulingStrategy):
    pass


class SpreadStrategy(SchedulingStrategy):
    """Round-robin across feasible nodes (spread_scheduling_policy)."""


class NodeAffinityStrategy(SchedulingStrategy):
    def __init__(self, node_id: bytes, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelStrategy(SchedulingStrategy):
    """Hard label constraints: {key: [allowed values...]}."""

    def __init__(self, hard: Dict[str, List[str]]):
        self.hard = dict(hard)


class PlacementGroupStrategy(SchedulingStrategy):
    def __init__(self, placement_group, bundle_index: int = -1,
                 capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.bundle_index = bundle_index
        self.capture_child_tasks = capture_child_tasks


def _labels_match(labels: Dict[str, str], hard: Dict[str, List[str]]) -> bool:
    return all(labels.get(k) in vals for k, vals in hard.items())


def rank_nodes_for_actor(nodes: Dict[bytes, "NodeRecord"], spec, pg_manager) -> List:
    """Order live nodes to try for actor placement (GcsActorScheduler policy).

    Placement-group constrained actors must go to the bundle's node; otherwise
    hybrid: feasible nodes sorted by post-placement utilization, ties randomized
    so uniform actors spread.
    """
    # Draining nodes are alive but retiring: never START anything there
    # (existing work runs to the drain deadline; PG-pinned placement below
    # still honors an already-committed bundle location).
    alive = [n for n in nodes.values()
             if n.alive and not getattr(n, "draining", False)]
    strategy = spec.scheduling_strategy
    if spec.placement_group_id is not None and pg_manager is not None:
        alive = [n for n in nodes.values() if n.alive]
        node_id = pg_manager.bundle_location(spec.placement_group_id,
                                             spec.placement_group_bundle_index)
        return [n for n in alive if node_id is not None and n.node_id == node_id]
    if isinstance(strategy, NodeAffinityStrategy):
        pinned = [n for n in alive if n.node_id == strategy.node_id]
        if pinned or not strategy.soft:
            return pinned
    if isinstance(strategy, NodeLabelStrategy):
        alive = [n for n in alive if _labels_match(n.labels, strategy.hard)]
    feasible = [n for n in alive if fits(n.available, spec.resources)
                and fits(n.resources, spec.resources)]
    infeasible_capacity = [n for n in alive if not fits(n.available, spec.resources)
                           and fits(n.resources, spec.resources)]
    random.shuffle(feasible)
    if isinstance(strategy, SpreadStrategy):
        feasible.sort(key=lambda n: utilization_score(n.resources, n.available, {}))
    else:
        feasible.sort(key=lambda n: utilization_score(n.resources, n.available,
                                                      spec.resources))
    # Nodes whose *total* capacity fits but currently busy go last: the lease
    # request will queue at that raylet until resources free up.
    random.shuffle(infeasible_capacity)
    return feasible + infeasible_capacity
