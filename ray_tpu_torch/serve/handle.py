"""DeploymentHandle: request routing to replicas.

The port's copy of ray_tpu/serve/handle.py (reference analog:
python/ray/serve/handle.py:625 DeploymentHandle +
router.py:578/pow_2_scheduler.py:52, power-of-two-choices on queue
length). Client-side: the handle tracks its own in-flight count per
replica and picks the lighter of two random replicas — the same
load-balancing rule without a probe round-trip. Each `remote` call counts
in the SERVE_REQUESTS metric (runtime/metric_defs.py), tagged with the
deployment.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import ray_tpu_torch as rt


class DeploymentResponse:
    """Future-like wrapper over the underlying ObjectRef."""

    def __init__(self, ref, on_done):
        self._ref = ref
        self._on_done = on_done
        self._done = False

    def result(self, timeout: Optional[float] = 60.0,
               timeout_s: Optional[float] = None):
        """`timeout_s` is the reference's spelling (DeploymentResponse
        .result(timeout_s=...)); both names are accepted."""
        if timeout_s is not None:
            timeout = timeout_s
        try:
            return rt.get(self._ref, timeout=timeout)
        finally:
            if not self._done:
                self._done = True
                self._on_done()


class _StreamingResponse:
    """Iterator over a streaming call's item refs; keeps the handle's
    power-of-two load accounting honest for long-lived streams."""

    def __init__(self, gen, on_done):
        self._gen = gen
        self._on_done = on_done
        self._done = False

    def _finish(self):
        if not self._done:
            self._done = True
            self._on_done()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._gen)
        except BaseException:
            self._finish()
            raise

    def next(self, timeout=None):
        try:
            return self._gen.next(timeout)
        except TimeoutError:
            raise  # transient poll timeout: the stream is still live
        except BaseException:
            self._finish()
            raise

    def __del__(self):
        self._finish()


class DeploymentHandle:
    @property
    def REFRESH_INTERVAL_S(self):
        from ray_tpu_torch.config import cfg

        return cfg().serve_handle_refresh_s

    def __init__(self, deployment_name: str, method_name: str = "__call__"):
        self.deployment_name = deployment_name
        self.method_name = method_name
        self._replicas: List = []
        self._version = -1
        self._inflight: Dict[int, int] = {}
        self._last_refresh = 0.0

    def options(self, method_name: str) -> "DeploymentHandle":
        h = DeploymentHandle(self.deployment_name, method_name)
        h._replicas = self._replicas
        h._version = self._version
        h._inflight = self._inflight
        return h

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return self.options(item)

    def _refresh(self):
        from ray_tpu_torch.serve.api import _get_controller
        from ray_tpu_torch.serve.config_watcher import ConfigWatcher

        info = rt.get(_get_controller().get_replicas.remote(
            self.deployment_name), timeout=60)
        if not info["found"]:
            # Acknowledge the deletion push so _needs_refresh does not pay
            # a blocking controller round-trip on EVERY later call of a
            # surviving handle.
            pushed = ConfigWatcher.get().version(self.deployment_name)
            if pushed is not None:
                self._version = pushed
            self._last_refresh = time.monotonic()
            raise ValueError(f"no deployment named {self.deployment_name!r}")
        if info["version"] != self._version:
            self._replicas = info["replicas"]
            self._version = info["version"]
            self._inflight = {i: 0 for i in range(len(self._replicas))}
        self._last_refresh = time.monotonic()

    def _needs_refresh(self) -> bool:
        """Push-first (LongPollHost analog): the shared ConfigWatcher gets
        controller pushes on every deploy/scale/delete, so a handle only
        talks to the controller when its routing set is actually stale.
        Time-based refresh remains ONLY as the degraded mode (watcher
        not yet started / subscription down / no event seen yet)."""
        if not self._replicas:
            return True
        from ray_tpu_torch.serve.config_watcher import ConfigWatcher

        watcher = ConfigWatcher.get()
        watcher.ensure_started()
        pushed = watcher.version(self.deployment_name)
        if pushed is not None and watcher.healthy:
            return pushed != self._version
        return (time.monotonic() - self._last_refresh
                > self.REFRESH_INTERVAL_S)

    def _refresh_if_stale(self):
        if self._needs_refresh():
            try:
                self._refresh()
            except Exception:
                if not self._replicas:
                    raise

    def replica_handles(self) -> List:
        """The current replica actor handles (refresh-if-stale). For
        routers that do their own replica selection instead of this
        handle's blind power-of-two: call
        `replica.handle_request.remote(method, args, kwargs)` directly."""
        self._refresh_if_stale()
        return list(self._replicas)

    def _pick_replica(self) -> int:
        n = len(self._replicas)
        if n == 0:
            raise RuntimeError(
                f"deployment {self.deployment_name!r} has no replicas")
        if n == 1:
            return 0
        a, b = random.sample(range(n), 2)
        return a if self._inflight.get(a, 0) <= self._inflight.get(b, 0) else b

    def remote_stream(self, *args, **kwargs):
        """Streaming call: the replica method must return a generator; items
        stream back as they are yielded (ObjectRefGenerator of item refs).
        Reference analog: serve streaming responses over
        ReportGeneratorItemReturns (core_worker.proto:462)."""
        self._refresh_if_stale()
        idx = self._pick_replica()
        replica = self._replicas[idx]
        self._inflight[idx] = self._inflight.get(idx, 0) + 1
        gen = replica.handle_request.options(
            num_returns="streaming").remote(self.method_name, args, kwargs)
        return _StreamingResponse(gen, lambda i=idx: self._on_done(i))

    def _on_done(self, idx: int):
        self._inflight[idx] = max(0, self._inflight.get(idx, 0) - 1)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        # Push-triggered refresh (controller pubsub via ConfigWatcher);
        # time-based re-poll only as the degraded fallback.
        self._refresh_if_stale()
        idx = self._pick_replica()
        replica = self._replicas[idx]
        self._inflight[idx] = self._inflight.get(idx, 0) + 1
        from ray_tpu_torch.runtime import metric_defs

        metric_defs.SERVE_REQUESTS.inc(
            tags={"deployment": self.deployment_name})
        ref = replica.handle_request.remote(self.method_name, args, kwargs)
        return DeploymentResponse(ref, lambda i=idx: self._on_done(i))
