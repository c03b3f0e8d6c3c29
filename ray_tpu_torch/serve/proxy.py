"""HTTP proxy: the ingress actor.

The port's copy of ray_tpu/serve/proxy.py (reference analog:
python/ray/serve/_private/proxy.py:752 HTTPProxy), on the standard
library's ThreadingHTTPServer where the JAX proxy runs aiohttp (which the
card's machine does not have), with the JAX proxy's routes, bodies and
status codes. POST /<deployment> with a JSON body calls the deployment's
__call__ with the parsed payload (or, when the deployment declares an
http_adapter, with the adapter's conversion of the request); `?method=`
selects another method; `?stream=1` switches to a streaming response — the
replica method must return a generator, and its items flow back as
server-sent events (`data: <json>` frames, `data: [DONE]` terminator).
GET /-/healthz answers {"status": "ok"}. Each connection is served on a
thread of its own and closed after its response (HTTP/1.0 framing: a
stream ends when the connection does).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple
from urllib.parse import parse_qsl, urlsplit

import ray_tpu_torch as rt

# Bounded waits on a replica, as in the JAX proxy: a stalled replica must
# not pin a proxy thread forever.
CALL_TIMEOUT_S = 300


class _Router:
    """The proxy's per-process state: one DeploymentHandle per (name,
    method), and the http_adapter lookup with its push-keyed cache."""

    def __init__(self):
        self._lock = threading.Lock()
        self.handles: Dict[Tuple[str, str], object] = {}
        # name -> (config_version, expires, fn|None). Validity is
        # PUSH-KEYED: while the ConfigWatcher subscription is healthy, an
        # entry is fresh iff its version matches the controller's latest
        # pushed version — a redeploy invalidates in one push, no TTL
        # wait. The TTL only governs the degraded mode (watcher down / no
        # event seen for this deployment yet).
        self.adapter_cache: Dict[str, tuple] = {}
        # Controller-outage throttle: after a failed lookup the stale entry
        # serves unconditionally until the deadline, even when a push says
        # it is outdated — otherwise every request during an outage pays a
        # blocking controller round-trip before serving stale.
        self.lookup_backoff: Dict[str, float] = {}

    def handle(self, name: str, method: str):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        with self._lock:
            key = (name, method)
            if key not in self.handles:
                self.handles[key] = DeploymentHandle(name, method)
            return self.handles[key]

    def cache_hit(self, name: str):
        from ray_tpu_torch.serve.config_watcher import ConfigWatcher

        hit = self.adapter_cache.get(name)
        if hit is None:
            return None
        now = time.monotonic()
        if self.lookup_backoff.get(name, 0.0) > now:
            return hit
        watcher = ConfigWatcher.get()
        pushed = watcher.version(name)
        if watcher.healthy and pushed is not None:
            return hit if hit[0] == pushed else None
        return hit if hit[1] > now else None

    def adapter_for(self, name: str):
        """The deployment's declared http_adapter. An unknown adapter NAME
        raises ValueError (a misconfiguration must surface, not fall back
        to raw JSON); a transient controller RPC failure reuses the stale
        cache entry when one exists."""
        from ray_tpu_torch.serve import http_adapters
        from ray_tpu_torch.serve.api import _get_controller
        from ray_tpu_torch.serve.config_watcher import ConfigWatcher

        ConfigWatcher.get().ensure_started()
        hit = self.cache_hit(name)
        if hit is not None:
            return hit[2]
        now = time.monotonic()
        stale = self.adapter_cache.get(name)
        try:
            adapter_name, version = None, -1
            for d in rt.get(_get_controller().list_deployments.remote(),
                            timeout=30):
                if d["name"] == name:
                    adapter_name = d["config"].get("http_adapter")
                    version = d.get("version", -1)
                    break
        except Exception:
            if stale is not None:
                # Stale beats changing request semantics; arm the outage
                # backoff so the outage costs one probe per second.
                self.lookup_backoff[name] = now + 1.0
                return stale[2]
            raise
        self.lookup_backoff.pop(name, None)
        fn = http_adapters.get(adapter_name) if adapter_name else None
        self.adapter_cache[name] = (version, now + 5.0, fn)
        return fn


class _Handler(BaseHTTPRequestHandler):
    """One request; `self.server.router` is the proxy's _Router."""

    def log_message(self, format, *args):  # noqa: A002 — stdlib name
        pass   # no line per request in the worker's log

    def _send_json(self, status: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlsplit(self.path).path
        if path == "/-/healthz":
            self._send_json(200, {"status": "ok"})
        else:
            self._send_json(405 if path.count("/") == 1 else 404,
                            {"error": f"no GET route {path!r}"})

    def do_POST(self):
        from ray_tpu_torch.serve.http_adapters import HTTPRequest

        url = urlsplit(self.path)
        name = url.path[1:]
        if not name or "/" in name:
            self._send_json(404, {"error": f"no route {url.path!r}"})
            return
        query = dict(parse_qsl(url.query, keep_blank_values=True))
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        router = self.server.router
        handle = router.handle(name, query.get("method", "__call__"))
        hit = router.cache_hit(name)
        if hit is not None:
            adapter = hit[2]
        else:
            try:
                adapter = router.adapter_for(name)
            except ValueError as e:  # unknown adapter name: config bug
                self._send_json(500, {"error": str(e)})
                return
            except Exception as e:
                self._send_json(503, {
                    "error": f"adapter lookup failed: {e!r}"})
                return
        if adapter is not None:
            content_type = (self.headers.get("Content-Type")
                            or "application/octet-stream").split(";")[0]
            try:
                payload = adapter(HTTPRequest(body, content_type.strip(),
                                              query))
            except Exception as e:
                self._send_json(400, {
                    "error": f"http_adapter failed: {e!r}"})
                return
        else:
            try:
                payload = json.loads(body)
            except ValueError:   # not JSON: the body as text
                payload = body.decode(errors="replace") or None
        if query.get("stream") in ("1", "true"):
            self._stream(handle, payload)
            return
        try:
            result = handle.remote(payload).result(timeout=CALL_TIMEOUT_S)
        except ValueError as e:
            self._send_json(404, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001
            self._send_json(500, {"error": repr(e)})
            return
        if isinstance(result, (dict, list, str, int, float)) or result is None:
            try:
                self._send_json(200, {"result": result})
            except TypeError as e:  # not JSON-serializable inside
                self._send_json(500, {"error": repr(e)})
            return
        raw = bytes(result)
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _event(self, data: bytes) -> None:
        self.wfile.write(b"data: " + data + b"\n\n")
        self.wfile.flush()

    def _stream(self, handle, payload) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            gen = handle.remote_stream(payload)
            while True:
                try:
                    ref = gen.next(timeout=CALL_TIMEOUT_S)
                except StopIteration:
                    break
                item = rt.get(ref, timeout=CALL_TIMEOUT_S)
                self._event(json.dumps(item, default=repr).encode())
        except Exception as e:  # noqa: BLE001
            self._event(json.dumps({"error": repr(e)}).encode())
        self._event(b"[DONE]")


class HTTPProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._server.router = _Router()
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="serve-http-proxy")
        self._thread.start()

    def address(self):
        return (self.host, self.port)
