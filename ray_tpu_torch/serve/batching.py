"""@serve.batch: coalesce concurrent calls into one batched invocation.

The port's copy of ray_tpu/serve/batching.py (reference analog:
python/ray/serve/batching.py, _BatchQueue + @serve.batch). A card wants
one [B, ...] matmul, not B sequential [1, ...] calls, so the replica
accumulates requests for up to ``batch_wait_timeout_s`` (or until
``max_batch_size``) and runs the underlying function once on the list.

Works on methods and free functions. The wrapped callable must accept a
LIST of requests and return a LIST of responses of the same length.

    class Model:
        @serve_batch(max_batch_size=8, batch_wait_timeout_s=0.01)
        def predict(self, inputs: List[np.ndarray]) -> List[np.ndarray]:
            return list(model(np.stack(inputs)))

Each individual call `model.predict(x)` (threaded, e.g. one per in-flight
request in a replica with max_concurrency > 1) returns its own single
response.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, List, Optional

__all__ = ["serve_batch"]


class _Pending:
    __slots__ = ("value", "event", "result", "error")

    def __init__(self, value):
        self.value = value
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._leader_running = False

    def submit(self, instance, value) -> Any:
        item = _Pending(value)
        lead = False
        with self._lock:
            self._queue.append(item)
            if not self._leader_running:
                self._leader_running = True
                lead = True
        if lead:
            self._run_batches(instance)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def _run_batches(self, instance):
        """The first caller becomes the batch leader: it waits out the batch
        window, drains the queue, and executes; followers just block on
        their event. Repeats while more requests arrived during execution."""
        while True:
            deadline = time.monotonic() + self.batch_wait_timeout_s
            while time.monotonic() < deadline:
                with self._lock:
                    if len(self._queue) >= self.max_batch_size:
                        break
                time.sleep(min(0.001, self.batch_wait_timeout_s / 4 or 0.001))
            with self._lock:
                batch = self._queue[:self.max_batch_size]
                self._queue = self._queue[self.max_batch_size:]
                if not batch:
                    self._leader_running = False
                    return
            try:
                args = ([p.value for p in batch],)
                results = (self.fn(instance, *args) if instance is not None
                           else self.fn(*args))
                if len(results) != len(batch):
                    raise ValueError(
                        f"batched function returned {len(results)} results "
                        f"for {len(batch)} requests")
                for p, r in zip(batch, results):
                    p.result = r
                    p.event.set()
            except BaseException as e:  # noqa: BLE001 — propagate to callers
                for p in batch:
                    p.error = e
                    p.event.set()
            with self._lock:
                if not self._queue:
                    self._leader_running = False
                    return


def serve_batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
                batch_wait_timeout_s: float = 0.01):
    """Decorator; use bare or with arguments."""

    def decorate(fn: Callable):
        queue = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if kwargs:
                raise TypeError("@serve_batch calls must be positional")
            if len(args) == 2:       # bound method: (self, value)
                return queue.submit(args[0], args[1])
            if len(args) == 1:       # free function: (value,)
                return queue.submit(None, args[0])
            raise TypeError("@serve_batch functions take exactly one request")

        wrapper._batch_queue = queue
        return wrapper

    if _fn is not None:
        return decorate(_fn)
    return decorate
