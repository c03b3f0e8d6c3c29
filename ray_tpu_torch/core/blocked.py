"""Process-local blocked-on registry: what is each thread waiting for?

Reference analog: Ray's core worker tracks the task it is blocked on so
`ray stack` can say "waiting on ObjectRef(...) owned by ..." instead of
printing a bare `fut.result()` frame (core_worker.cc task-state bookkeeping
+ python/ray/util/check_open_ports-style stack annotation). Here the
registry is deliberately tiny: blocking call sites wrap themselves in
`blocked_on(...)`, which records a {kind, detail, since} entry keyed by
thread ident in a plain dict under a lock. Two consumers read it:

  * `dump_stacks` (utils/debug.render_stacks) — annotates each rendered
    thread with its live blocked-on record, so a cluster-wide stack dump
    explains *why* a frame is parked, not just where;
  * the wait-edge reporter (core/worker.py task-event flush loop) — turns
    `object_get` / `collective_op` records into graph edges the GCS
    assembles into the cluster wait-graph for stall/deadlock detection.

Kinds (closed set, mirrors the detector's edge schema):
  * "object_get"    — blocked in get()/wait(); detail: oid (hex), owner
                      (node hex or addr), target_task / target_actor /
                      target_name when the object is a known task return
  * "collective_op" — blocked inside a collective op or Work.wait();
                      detail: group, rank, world_size, op_id
  * "channel_read"  — blocked on a compiled-DAG channel read; detail:
                      channel (hex), version

Everything is best-effort and allocation-light: registering is one dict
store, deregistering one pop. Never raises into the blocking path.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

OBJECT_GET = "object_get"
COLLECTIVE_OP = "collective_op"
CHANNEL_READ = "channel_read"
KINDS = (OBJECT_GET, COLLECTIVE_OP, CHANNEL_READ)

_lock = threading.Lock()
# thread ident -> list of records (a stack: get() inside a collective
# callback etc. nests; the innermost record is the live one).
_blocked: Dict[int, List[dict]] = {}

# thread ident -> task context dict ({task_id, name, actor_id}) set by the
# worker executor so blocked-on records (and stack dumps) can attribute a
# thread to the task/actor it is running. Drivers have no entry.
_task_ctx: Dict[int, dict] = {}


def set_task_context(thread_ident: int, ctx: Optional[dict]) -> None:
    """Associate (or with ctx=None, clear) the task running on a thread."""
    with _lock:
        if ctx is None:
            _task_ctx.pop(thread_ident, None)
        else:
            _task_ctx[thread_ident] = ctx


def task_context(thread_ident: Optional[int] = None) -> Optional[dict]:
    ident = thread_ident if thread_ident is not None \
        else threading.get_ident()
    with _lock:
        ctx = _task_ctx.get(ident)
        return dict(ctx) if ctx else None


@contextlib.contextmanager
def blocked_on(kind: str, **detail: Any):
    """Mark the current thread blocked on `kind` for the `with` body.

    The record is visible to concurrent `snapshot()` / `current_edges()`
    callers the moment the body starts blocking. Exceptions propagate
    unchanged; the record is always removed.
    """
    ident = threading.get_ident()
    rec = {"kind": kind, "since": time.time(), "detail": detail}
    with _lock:
        _blocked.setdefault(ident, []).append(rec)
    try:
        yield rec
    finally:
        with _lock:
            stack = _blocked.get(ident)
            if stack is not None:
                try:
                    stack.remove(rec)
                except ValueError:
                    pass
                if not stack:
                    _blocked.pop(ident, None)


def snapshot() -> Dict[int, dict]:
    """thread ident -> innermost live blocked-on record (copies)."""
    with _lock:
        return {ident: dict(stack[-1])
                for ident, stack in _blocked.items() if stack}


def current_edges() -> List[dict]:
    """Flatten live records into wait-graph edges for the GCS.

    Each edge carries the waiter's task context (when known) so the
    detector can build task->task cycles, plus the raw detail so events
    can name object ids, owners, and collective groups.
    """
    edges = []
    with _lock:
        items = [(ident, dict(rec))
                 for ident, stack in _blocked.items()
                 for rec in stack]
        ctxs = {ident: dict(ctx) for ident, ctx in _task_ctx.items()}
    for ident, rec in items:
        edge = {
            "kind": rec["kind"],
            "since": rec["since"],
            "thread": ident,
        }
        edge.update(rec["detail"])
        ctx = ctxs.get(ident)
        if ctx:
            edge["waiter_task"] = ctx.get("task_id")
            edge["waiter_name"] = ctx.get("name")
            if ctx.get("actor_id"):
                edge["waiter_actor"] = ctx.get("actor_id")
        edges.append(edge)
    return edges
