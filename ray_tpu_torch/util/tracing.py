"""Request trace identity: the ids the KV handoff's head frame carries.

The port's copy of the trace-context half of ray_tpu/util/tracing.py.
Every process that handles a serving request derives the same 16-byte
trace id from its request id (`request_trace_id`); a thread-local
context holds the current (trace id, span id) pair, and the handoff
wire copies it into `KVHandoffMsg.trace_id`/`parent_span_id`, so the
frame's bytes equal the JAX package's.

`span` and `record_span` behave as the JAX package's do with tracing
off: they neither record nor mint ids, so the context they run in is
the caller's. Span recording and export are not ported.

`profile_range` names a stretch of the train path (a sub-layer, the
loss, the optimizer) for `torch.profiler`, while one records. It imports
torch when called, so the runtime's processes (which propagate the trace
identity on every task) start without torch.
"""

from __future__ import annotations

import threading
import zlib
from contextlib import contextmanager, nullcontext
from typing import Optional

_ctx = threading.local()


def request_trace_id(request_id: str) -> bytes:
    """Deterministic 16-byte trace id of one serving request: four
    crc32s of the request id, each with one more byte, so every process
    that handles the request computes the same id from the id alone."""
    rid = request_id.encode()
    return b"".join(
        zlib.crc32(rid + bytes([i])).to_bytes(4, "big") for i in range(4))


def current_trace_id() -> Optional[bytes]:
    return getattr(_ctx, "trace_id", None)


def current_span_id() -> Optional[bytes]:
    return getattr(_ctx, "span_id", None)


@contextmanager
def trace_context(trace_id: Optional[bytes],
                  parent_span_id: Optional[bytes]):
    """Adopt a propagated (trace_id, parent_span_id) pair; the previous
    thread context is restored on exit."""
    prev = (getattr(_ctx, "trace_id", None), getattr(_ctx, "span_id", None))
    _ctx.trace_id = trace_id
    _ctx.span_id = parent_span_id
    try:
        yield
    finally:
        _ctx.trace_id, _ctx.span_id = prev


@contextmanager
def span(name: str, kind: str, **attrs):
    """A span as the JAX package runs it with tracing off: nothing is
    recorded and the thread's context is left as it is."""
    yield


def record_span(name: str, kind: str, start: float, end: float, **attrs):
    """A retroactive span with tracing off: nothing is recorded."""


def profile_range(name: str):
    """`record_function(name)` while a profiler records, else nothing:
    inside a layer under non-reentrant activation checkpointing a
    `record_function` costs ~0.7 ms of host time even with no profiler
    (~10 us outside one), which the bench step cannot afford."""
    import torch
    from torch.profiler import record_function

    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return nullcontext()
