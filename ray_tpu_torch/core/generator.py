"""Streaming generator returns (num_returns="streaming").

Reference analog: python/ray/_raylet.pyx:289 ObjectRefGenerator and the
ReportGeneratorItemReturns RPC (src/ray/protobuf/core_worker.proto:462).
Ours: the executing worker pushes each yielded item back over the same
connection the task was pushed on (small values inline, large values sealed
to the executor's plasma store with only the location pushed); the final
reply carries the item count. The caller-side CoreWorker records each item
and wakes this iterator.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ray_tpu_torch.core.object_ref import ObjectRef


class _GeneratorState:
    """Caller-side state for one streaming task; written by the IO loop
    (item pushes + completion reply), read by user threads via next()."""

    def __init__(self):
        self.cond = threading.Condition()
        self.items: Dict[int, ObjectRef] = {}   # index -> ref, not yet consumed
        self.next_read = 0
        self.total: Optional[int] = None        # set on completion
        self.error: Optional[BaseException] = None

    def push(self, index: int, ref: ObjectRef):
        with self.cond:
            self.items[index] = ref
            self.cond.notify_all()

    def finish(self, total: int):
        with self.cond:
            self.total = total
            self.cond.notify_all()

    def fail(self, error: BaseException, streamed: Optional[int] = None):
        """Deliver buffered items through `streamed` (if known), then raise."""
        with self.cond:
            self.error = error
            if streamed is not None:
                self.total = streamed
            self.cond.notify_all()

    def next_blocking(self, timeout: Optional[float]) -> ObjectRef:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cond:
            while True:
                ref = self.items.pop(self.next_read, None)
                if ref is not None:
                    self.next_read += 1
                    return ref
                if self.total is not None and self.next_read >= self.total:
                    if self.error is not None:
                        raise self.error
                    raise StopIteration
                if self.error is not None and not self.items:
                    # Error with unknown item count: buffered items drained.
                    raise self.error
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("timed out waiting for generator item")
                self.cond.wait(remaining)


class ObjectRefGenerator:
    """Iterator over the ObjectRefs of a streaming task's yielded items.

    Each next() blocks until the executor reports the next item (possibly
    before the task finishes), then returns an ObjectRef whose value is
    already local (inline) or pullable (plasma on the executor's node).
    """

    def __init__(self, task_id: bytes, state: _GeneratorState):
        self._task_id = task_id
        self._state = state

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self._state.next_blocking(None)

    def next(self, timeout: Optional[float] = None) -> ObjectRef:
        return self._state.next_blocking(timeout)

    def completed(self) -> bool:
        s = self._state
        with s.cond:
            return (s.total is not None or s.error is not None)

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()[:12]})"
