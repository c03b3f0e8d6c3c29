"""Structured cluster event bus: typed records for life-or-death decisions.

The port's copy of ray_tpu/runtime/events.py. An event is a plain
JSON-able dict; the GCS keeps a bounded ring of them
(`cluster_events_max`) behind its `report_events`/`list_events`
handlers, and emission is always best-effort: losing an event must never
take down the component that noticed the problem.

Emitters in the port: the LLM router's fleet supervisor (llm/router.py)
— LLM_REQUEST_SHED, LLM_REQUEST_FAILOVER, LLM_SESSION_MIGRATED,
LLM_REPLICA_EJECTED, LLM_REPLICAS_SCALED — and the cluster prefix store
(llm/prefix_store.py) — LLM_PREFIX_SPILLED, LLM_PREFIX_ADOPTED. The
other types are the JAX package's closed set, kept so records and
filters read the same in both packages; their emitters (drain, the
memory monitor, the autoscaler, Train, the stall detector, alerts) are
not ported yet.

Read back through `state.list_cluster_events()`.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

# Severities (a deliberate subset of syslog: INFO = normal but notable
# control decisions, WARNING = degraded/retrying, ERROR = something died).
INFO = "INFO"
WARNING = "WARNING"
ERROR = "ERROR"
SEVERITIES = (INFO, WARNING, ERROR)

# Event types. Closed set so dashboards/tests can switch on them; add new
# types here rather than inventing strings at the call site.
NODE_DEAD = "NODE_DEAD"
NODE_DRAINING = "NODE_DRAINING"
NODE_PREEMPTED = "NODE_PREEMPTED"
SLICE_LOST = "SLICE_LOST"
OOM_KILL = "OOM_KILL"
COLLECTIVE_ABORT = "COLLECTIVE_ABORT"
AUTOSCALER_SCALE = "AUTOSCALER_SCALE"
TRAIN_GANG_RESTART = "TRAIN_GANG_RESTART"
TASK_STALLED = "TASK_STALLED"
DEADLOCK_DETECTED = "DEADLOCK_DETECTED"
LLM_REQUEST_SHED = "LLM_REQUEST_SHED"
LLM_REQUEST_FAILOVER = "LLM_REQUEST_FAILOVER"
LLM_SESSION_MIGRATED = "LLM_SESSION_MIGRATED"
LLM_REPLICA_EJECTED = "LLM_REPLICA_EJECTED"
LLM_REPLICAS_SCALED = "LLM_REPLICAS_SCALED"
LLM_PREFIX_SPILLED = "LLM_PREFIX_SPILLED"
LLM_PREFIX_ADOPTED = "LLM_PREFIX_ADOPTED"
RLHF_PLACEMENT_SWITCH = "RLHF_PLACEMENT_SWITCH"
CHECKPOINT_SAVED = "CHECKPOINT_SAVED"
ALERT_FIRING = "ALERT_FIRING"
ALERT_RESOLVED = "ALERT_RESOLVED"
EVENT_TYPES = (NODE_DEAD, NODE_DRAINING, NODE_PREEMPTED, SLICE_LOST,
               OOM_KILL, COLLECTIVE_ABORT,
               AUTOSCALER_SCALE, TRAIN_GANG_RESTART, TASK_STALLED,
               DEADLOCK_DETECTED, LLM_REQUEST_SHED, LLM_REQUEST_FAILOVER,
               LLM_SESSION_MIGRATED, LLM_REPLICA_EJECTED,
               LLM_REPLICAS_SCALED, LLM_PREFIX_SPILLED, LLM_PREFIX_ADOPTED,
               RLHF_PLACEMENT_SWITCH, CHECKPOINT_SAVED,
               ALERT_FIRING, ALERT_RESOLVED)


def make_event(event_type: str, message: str, *,
               severity: str = INFO, source: str = "",
               node_id=None, slice_name: Optional[str] = None,
               actor_id=None,
               labels: Optional[Dict[str, str]] = None) -> dict:
    """Build a typed event record.

    `node_id`/`actor_id` accept raw bytes ids or hex strings; they are
    stored as hex so the record stays JSON-able end to end.
    """
    if event_type not in EVENT_TYPES:
        raise ValueError(f"unknown event type {event_type!r} "
                         f"(known: {EVENT_TYPES})")
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r} "
                         f"(known: {SEVERITIES})")
    return {
        "time": time.time(),
        "severity": severity,
        "type": event_type,
        "source": source,
        "message": str(message),
        "node_id": _hex(node_id),
        "slice_name": slice_name,
        "actor_id": _hex(actor_id),
        "labels": dict(labels) if labels else {},
    }


def _hex(id_or_none) -> Optional[str]:
    if id_or_none is None:
        return None
    if isinstance(id_or_none, (bytes, bytearray)):
        return bytes(id_or_none).hex()
    return str(id_or_none)


def emit(event_type: str, message: str, **kwargs) -> Optional[dict]:
    """Build an event and ship it to the GCS ring, best-effort.

    Usable from any process holding an initialized core worker (the
    program that called init, task and actor workers). The send is
    fire-and-forget on the core IO loop (the metrics flush's path), so it
    is thread-safe and adds no latency to the failure path that called
    it. Without a core worker the record is only returned.

    Never raises: observability must not add failure modes.
    """
    try:
        ev = make_event(event_type, message, **kwargs)
    except Exception:
        return None
    try:
        from ray_tpu_torch.core import worker as worker_mod

        if not worker_mod.is_initialized():
            return ev
        core = worker_mod.global_worker()
        core.io.spawn(core.gcs.call("report_events", events=[ev]))
    except Exception:
        pass
    return ev
