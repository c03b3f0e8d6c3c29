"""Push-based serve config propagation.

The port's copy of ray_tpu/serve/config_watcher.py (reference analog:
python/ray/serve/_private/long_poll.py:204 LongPollHost): the controller
PUSHES config changes to proxies and handles instead of being polled. It
rides the port GCS's pubsub channel (`subscribe`/`publish`, one-way
KIND_PUSH frames, runtime/rpc.py): the ServeController publishes
{deployment, version, event} on every deploy/scale/delete, and every
process holding handles runs one shared ConfigWatcher subscription that
records the freshest version per deployment. DeploymentHandle and the HTTP
proxy consult the watcher before each request: a version newer than what
they routed with triggers an immediate refresh; no polling loop runs while
the subscription is healthy. If the subscription is down or has no entry
yet (subscribed after the event), callers fall back to the time-based
refresh interval (config entry serve_handle_refresh_s).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

CHANNEL = "serve_config"


class ConfigWatcher:
    """Per-process singleton subscription to the serve_config channel."""

    _instance: Optional["ConfigWatcher"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.versions: Dict[str, int] = {}
        self._client = None
        self._starting = False
        self._connected = False
        self._retry_at = 0.0
        self._start_lock = threading.Lock()

    @classmethod
    def get(cls) -> "ConfigWatcher":
        with cls._lock:
            if cls._instance is None:
                cls._instance = ConfigWatcher()
            return cls._instance

    @classmethod
    def reset(cls):
        """Drop the singleton (serve.shutdown, and across cluster
        restarts): the next get() subscribes anew."""
        with cls._lock:
            inst, cls._instance = cls._instance, None
        if inst is not None and inst._client is not None:
            try:
                from ray_tpu_torch.core.worker import global_worker

                global_worker().io.spawn(inst._client.close())
            except Exception:
                pass

    # ---- subscription ----------------------------------------------------

    def ensure_started(self):
        """NON-BLOCKING: kick the subscription machinery and return. The
        caller (a handle on the request path) never waits on the GCS;
        while the stream is not healthy it uses the time-based refresh."""
        if self._client is not None:
            if self._client._dead and not self._client._closed:
                # A push-only connection issues no calls, so a dead GCS
                # link would stay dead: a cheap call kicks the client's
                # auto-reconnect (redial + resubscribe via on_reconnect).
                try:
                    from ray_tpu_torch.core.worker import global_worker

                    global_worker().io.spawn(
                        self._client.call("subscribe", channels=[CHANNEL]))
                except Exception:
                    pass
            return
        with self._start_lock:
            if self._starting or time.monotonic() < self._retry_at:
                return
            self._starting = True
        try:
            from ray_tpu_torch.core.worker import global_worker
            from ray_tpu_torch.runtime.rpc import RpcClient

            core = global_worker()

            async def on_push(method, data):
                if method != "pubsub" or data.get("channel") != CHANNEL:
                    return
                msg = data.get("message") or {}
                name, version = msg.get("deployment"), msg.get("version")
                if name is None or version is None:
                    return
                if version > self.versions.get(name, -1):
                    self.versions[name] = version

            async def resub(client):
                await client._call_once("subscribe", 30,
                                        dict(channels=[CHANNEL]))

            async def connect():
                try:
                    client = RpcClient(core.gcs.host, core.gcs.port,
                                       on_push=on_push, auto_reconnect=True,
                                       on_reconnect=resub)
                    await client.connect(timeout=30)
                    await client.call("subscribe", channels=[CHANNEL])
                    self._client = client
                    self._connected = True
                except Exception:
                    logger.warning(
                        "serve config watcher failed to start; handles "
                        "fall back to periodic refresh", exc_info=True)
                    # Back off: a GCS outage must not spawn a connect per
                    # request.
                    self._retry_at = time.monotonic() + 5.0
                finally:
                    self._starting = False

            core.io.spawn(connect())
        except Exception:
            logger.exception("serve config watcher spawn failed")
            self._starting = False

    @property
    def healthy(self) -> bool:
        return (self._connected and self._client is not None
                and not self._client._dead)

    def version(self, deployment: str) -> Optional[int]:
        """Freshest pushed version, or None if no event seen yet."""
        return self.versions.get(deployment)


def publish_change(deployment: str, version: int, event: str):
    """Controller side: fire-and-forget push to every subscriber."""
    try:
        from ray_tpu_torch.core.worker import global_worker

        core = global_worker()
        core.io.spawn(core.gcs.call(
            "publish", channel=CHANNEL,
            message={"deployment": deployment, "version": version,
                     "event": event, "ts": time.time()}))
    except Exception:
        logger.exception("serve config publish failed (%s %s)",
                         deployment, event)
