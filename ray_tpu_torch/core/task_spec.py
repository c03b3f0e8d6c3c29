"""Task and actor specifications passed over the wire.

Reference analog: src/ray/common/task/task_spec.h:257 TaskSpecification (ours
is a plain dataclass pickled by the RPC layer rather than a protobuf).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# An argument is ("v", payload_bytes) for pass-by-value or
# ("r", object_id_bytes) for a shared-memory store reference.
Arg = Tuple[str, bytes]


@dataclass
class TaskSpec:
    task_id: bytes
    fn_id: bytes              # key of pickled function in GCS KV
    name: str                 # human-readable, for errors/metrics
    args: List[Arg] = field(default_factory=list)
    kwarg_names: List[Optional[str]] = field(default_factory=list)  # parallel to args; None = positional
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 3
    # Actor fields (None for normal tasks)
    actor_id: Optional[bytes] = None
    method_name: Optional[str] = None
    seq_no: int = 0
    # Scheduling
    scheduling_strategy: Any = None
    placement_group_id: Optional[bytes] = None
    placement_group_bundle_index: int = -1
    runtime_env: Optional[dict] = None
    # Submitter-side bookkeeping: object ids pinned until this task
    # completes (args must survive the submit->execute window even if the
    # caller drops its refs; reference: task_manager.h holds arg refs).
    pinned_oids: Optional[List[bytes]] = None
    # Trace propagation: the caller's trace id and the span it submitted
    # from (util.tracing). The executing worker adopts these so its
    # execute span parents under the driver's submit span.
    trace_id: Optional[bytes] = None
    parent_span_id: Optional[bytes] = None

    def to_wire(self) -> bytes:
        """Encode the envelope as a wire.TaskSpecMsg (core_worker.proto:441
        PushTaskRequest analog): fields evolve per-number across versions
        instead of all-or-nothing pickled dataclasses."""
        from ray_tpu_torch.runtime import wire

        return wire.TaskSpecMsg(
            task_id=self.task_id, fn_id=self.fn_id, name=self.name,
            payload=(self.args, self.kwarg_names,
                     self.scheduling_strategy, self.runtime_env,
                     self.pinned_oids),
            num_returns=self.num_returns, resources=self.resources,
            max_retries=self.max_retries, actor_id=self.actor_id or b"",
            method_name=self.method_name or "", seq_no=self.seq_no,
            placement_group_id=self.placement_group_id or b"",
            placement_group_bundle_index=self.placement_group_bundle_index,
            trace_id=self.trace_id or b"",
            parent_span_id=self.parent_span_id or b"",
            ).encode()

    @classmethod
    def from_wire(cls, data: bytes) -> "TaskSpec":
        from ray_tpu_torch.runtime import wire

        m = wire.TaskSpecMsg.decode(data)
        p = m.payload
        if isinstance(p, tuple) and len(p) == 5:
            args, kwarg_names, strategy, runtime_env, pinned = p
        else:
            # First-cut writer: field 4 carried the args list alone and
            # the rest rode the retired 5/12/15/16 fields.
            args = p or []
            kwarg_names = m.kwarg_names_v1 or []
            strategy = m.scheduling_strategy_v1
            runtime_env = m.runtime_env_v1
            pinned = list(m.pinned_oids_v1) or None
        return cls(
            task_id=m.task_id, fn_id=m.fn_id, name=m.name,
            args=args or [], kwarg_names=kwarg_names or [],
            num_returns=m.num_returns, resources=m.resources,
            max_retries=m.max_retries, actor_id=m.actor_id or None,
            method_name=m.method_name or None, seq_no=m.seq_no,
            scheduling_strategy=strategy,
            placement_group_id=m.placement_group_id or None,
            placement_group_bundle_index=m.placement_group_bundle_index,
            runtime_env=runtime_env,
            pinned_oids=list(pinned) if pinned else None,
            trace_id=m.trace_id or None,
            parent_span_id=m.parent_span_id or None)


@dataclass
class ActorSpec:
    actor_id: bytes
    class_id: bytes           # key of pickled class in GCS KV
    name: Optional[str]       # named actor (GCS registry) or None
    class_name: str
    args: List[Arg] = field(default_factory=list)
    kwarg_names: List[Optional[str]] = field(default_factory=list)
    resources: Dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    scheduling_strategy: Any = None
    placement_group_id: Optional[bytes] = None
    placement_group_bundle_index: int = -1
    namespace: str = "default"
    runtime_env: Optional[dict] = None
