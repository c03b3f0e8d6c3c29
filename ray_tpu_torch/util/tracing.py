"""Tracing: spans in an in-process ring, and the request trace identity.

The port's copy of ray_tpu/util/tracing.py. Spans record into a ring buffer
of the newest 10000 while tracing is on (the default; `set_enabled`);
`get_spans` reads it, `dump_chrome_trace` writes it as a chrome://tracing
file and `merge_spans` lays several processes' rings side by side. Each
span carries its trace id, its own 8-byte span id and its parent's, in
`args`, as the JAX package's do. The JAX package's optional
OpenTelemetry mirror is not ported.

Every process that handles a serving request derives the same 16-byte
trace id from its request id (`request_trace_id`); a thread-local
context holds the current (trace id, span id) pair, and the handoff
wire copies it into `KVHandoffMsg.trace_id`/`parent_span_id`, so the
frame's bytes equal the JAX package's under the same context.

`profile_range` names a stretch of the train path (a sub-layer, the
loss, the optimizer) for `torch.profiler`, while one records. It imports
torch when called, so the runtime's processes (which propagate the trace
identity on every task) start without torch.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import zlib
from contextlib import contextmanager, nullcontext
from typing import Optional

_spans = collections.deque(maxlen=10000)
_lock = threading.Lock()
_enabled = True

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


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool):
    global _enabled
    _enabled = value


def _append(name, kind, start, end, ids, attrs):
    with _lock:
        _spans.append({"name": name, "cat": kind, "ts": start * 1e6,
                       "dur": max(0.0, end - start) * 1e6, "ph": "X",
                       "pid": os.getpid(),
                       "tid": threading.get_ident() % 100000,
                       "args": {**ids, **attrs}})


@contextmanager
def span(name: str, kind: str, **attrs):
    """Record one span. It joins the thread's current trace (a fresh
    16-byte trace id at a root), mints its own 8-byte span id, and is the
    parent of the spans opened inside it. With tracing off nothing is
    recorded and the thread's context is left as it is."""
    if not _enabled:
        yield
        return
    trace_id = getattr(_ctx, "trace_id", None) or os.urandom(16)
    parent = getattr(_ctx, "span_id", None)
    span_id = os.urandom(8)
    prev = (getattr(_ctx, "trace_id", None), getattr(_ctx, "span_id", None))
    _ctx.trace_id, _ctx.span_id = trace_id, span_id
    start = time.time()
    try:
        yield
    finally:
        _ctx.trace_id, _ctx.span_id = prev
        ids = {"trace_id": trace_id.hex(), "span_id": span_id.hex()}
        if parent is not None:
            ids["parent_span_id"] = parent.hex()
        _append(name, kind, start, time.time(), ids, attrs)


def record_span(name: str, kind: str, start: float, end: float, **attrs):
    """Append a span retroactively from measured wall-clock bounds (for
    code that times its phases itself). It joins the thread's current
    trace context as `span()` would."""
    if not _enabled:
        return
    trace_id = getattr(_ctx, "trace_id", None) or os.urandom(16)
    parent = getattr(_ctx, "span_id", None)
    ids = {"trace_id": trace_id.hex(), "span_id": os.urandom(8).hex()}
    if parent is not None:
        ids["parent_span_id"] = parent.hex()
    _append(name, kind, start, end, ids, attrs)


def get_spans() -> list:
    with _lock:
        return list(_spans)


def dump_chrome_trace(path: str):
    """Write the span ring in chrome://tracing 'traceEvents' format."""
    with open(path, "w") as f:
        json.dump({"traceEvents": get_spans()}, f)


def merge_spans(groups) -> list:
    """Merge per-process span rings into one chrome traceEvents list.

    `groups` is an iterable of (label, spans), one entry per process.
    os.getpid() collides across hosts, so every (label, original pid)
    pair is remapped to a lane of its own and announced with a
    process_name metadata event; the trace/span ids in each span's `args`
    are untouched: they are what stitches the spans across lanes."""
    events, lanes = [], {}
    for label, spans in groups:
        for s in spans:
            key = (label, s.get("pid"))
            lane = lanes.get(key)
            if lane is None:
                lane = lanes[key] = len(lanes) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": lane,
                               "args": {"name": f"{label} (pid {s.get('pid')})"}})
            ev = dict(s)
            ev["pid"] = lane
            events.append(ev)
    return events


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
