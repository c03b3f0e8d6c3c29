"""Exception types surfaced by the public API.

The port's copy of ray_tpu/core/exceptions.py (reference analog:
python/ray/exceptions.py), without the JAX package's TPU slice failure
domain and its weight-sync error, plus `_unported`, the port's refusal
of a feature it has not ported yet.
"""

from __future__ import annotations


def _unported(feature: str) -> ValueError:
    return ValueError(f"{feature} is not ported to ray_tpu_torch yet "
                      "(ROADMAP.md lists it as a later slice)")


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at `get` with remote traceback."""

    def __init__(self, function_name: str, traceback_str: str,
                 cause: BaseException | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"task {function_name} failed:\n{traceback_str}")

    def __reduce__(self):
        # Exceptions with non-(args)-shaped __init__ need explicit reduce to
        # survive the RPC pickle path.
        return (type(self), (self.function_name, self.traceback_str, self.cause))


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    def __init__(self, actor_id_hex: str, reason: str = ""):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(f"actor {actor_id_hex[:12]} died: {reason}")

    @property
    def cause(self) -> str:
        """Typed death cause (CAUSE_PREEMPTION when the hosting node was
        drained/preempted with notice, CAUSE_CRASH otherwise)."""
        return death_cause(self.reason)

    def __reduce__(self):
        return (type(self), (self.actor_id_hex, self.reason))


class ActorUnavailableError(ActorError):
    pass


# Marker embedded in GCS death reasons for nodes that died at the end of a
# drain window (spot/preemptible retirement with advance notice). Callers
# use it — via `death_cause` — to distinguish a *planned* capacity loss
# (retry freely, do not consume retry budgets) from a surprise crash.
NODE_PREEMPTED_MARKER = "NodePreempted"

# Typed death causes derivable from a string-shaped death reason.
CAUSE_PREEMPTION = "preemption"
CAUSE_CRASH = "crash"


def death_cause(reason: "str | None") -> str:
    """Classify a death reason string into a typed cause. The markers ride
    inside the reason (the reason plumbing through GCS pubsub, actor death
    records, and wire messages is string-shaped)."""
    if NODE_PREEMPTED_MARKER in (reason or ""):
        return CAUSE_PREEMPTION
    return CAUSE_CRASH


class NodeDiedError(RayTpuError):
    """A node left the cluster. `cause` distinguishes a graceful
    drain/preemption (CAUSE_PREEMPTION — the death was announced in
    advance and is infinitely retryable) from a crash (CAUSE_CRASH)."""

    def __init__(self, node_id_hex: str, reason: str = ""):
        self.node_id_hex = node_id_hex
        self.reason = reason
        super().__init__(f"node {node_id_hex[:12]} died: {reason}")

    @property
    def cause(self) -> str:
        return death_cause(self.reason)

    def __reduce__(self):
        return (type(self), (self.node_id_hex, self.reason))


def actor_death_error(actor_id_hex: str, reason: str) -> ActorDiedError:
    """Typed error for an actor death reason reported by the GCS."""
    return ActorDiedError(actor_id_hex, reason)


class TaskCancelledError(RayTpuError):
    """The task producing this object was cancelled via ray_tpu_torch.cancel()
    (reference analog: ray.exceptions.TaskCancelledError). Raised by
    get() on the task's return refs."""


class WorkerCrashedError(RayTpuError):
    """The worker executing a task died (e.g. OOM-killed, segfault)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    """An object's data is gone everywhere. `oid` (when known) lets the
    owner's submitter reconstruct the exact lost dependency recursively
    (object_recovery_manager.h:38 analog)."""

    def __init__(self, message: str, oid: "bytes | None" = None,
                 cause: "str | None" = None):
        super().__init__(message)
        self.oid = oid
        # Explicit cause wins; otherwise derive from the message (drain
        # paths embed NODE_PREEMPTED_MARKER in it).
        self.cause = cause or death_cause(message)

    def __reduce__(self):
        # Default Exception pickling drops kwargs; keep oid and cause across
        # the wire (the recovery path reads them on the submitting side).
        return (type(self),
                (self.args[0] if self.args else "", self.oid, self.cause))


class PlacementGroupError(RayTpuError):
    pass


class CollectiveAbortError(RayTpuError):
    """A blocking collective op was aborted — the group's abort flag was
    set (locally, through the GCS KV, or by the peer-liveness watchdog
    after a rank stopped heartbeating) — instead of hanging to the socket
    or NCCL timeout."""

    def __init__(self, group_name: str, reason: str = ""):
        self.group_name = group_name
        self.reason = reason
        super().__init__(
            f"collective group {group_name!r} aborted: {reason}")

    def __reduce__(self):
        return (type(self), (self.group_name, self.reason))
