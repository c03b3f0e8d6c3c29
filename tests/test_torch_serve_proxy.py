"""The port's HTTP proxy against the JAX package's, in process, with no
cluster: both proxies serve the same requests for the same fake
deployments (handles and controller replaced by fakes in each package),
and must answer with the same status, content type and body — the routes
(`POST /{deployment}`, `?method=`, `?stream=1`, `GET /-/healthz`), the
`{"result": ...}` and error bodies, raw bytes, the http_adapter lookup
(adapted, failing, unknown) and the SSE framing (`data: <json>` frames,
`data: [DONE]`). The JAX proxy runs aiohttp; the port's the standard
library's ThreadingHTTPServer. Where aiohttp answers an unrouted request
with its own text page, only the status is compared.
"""

import json
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.serve import api as japi
from ray_tpu.serve import config_watcher as jwatch
from ray_tpu.serve import handle as jhandle
from ray_tpu.serve.proxy import HTTPProxyActor as JProxy
from ray_tpu_torch.serve import api as tapi
from ray_tpu_torch.serve import config_watcher as twatch
from ray_tpu_torch.serve import handle as thandle
from ray_tpu_torch.serve.proxy import HTTPProxyActor as TProxy

# name -> the deployment's http_adapter
DEPLOYMENTS = {"echo": None, "boom": None, "raw": None,
               "nd": "json_to_ndarray", "typo": "json_to_ndarry"}


def _behave(name, method, payload):
    if name not in DEPLOYMENTS:
        raise ValueError(f"no deployment named {name!r}")
    if name == "boom":
        raise RuntimeError("kaput")
    if name == "raw":
        return b"raw-bytes"
    if name == "nd":
        return {"sum": float(payload.sum()), "dtype": str(payload.dtype)}
    return {"method": method, "payload": payload}


class _Response:
    def __init__(self, fn):
        self._fn = fn

    def result(self, timeout=None, timeout_s=None):
        return self._fn()


class _Stream:
    """The item "refs" of a streaming call (the fake get returns them as
    they are); the "boom" deployment fails after its first item."""

    def __init__(self, name, payload):
        self._items = iter([{"i": i} for i in range(
            int((payload or {}).get("n", 2)))])
        self._name = name

    def next(self, timeout=None):
        item = next(self._items)   # StopIteration ends the stream
        if self._name == "boom" and item["i"] == 1:
            raise RuntimeError("stream broke")
        return item


class _FakeHandle:
    def __init__(self, deployment_name, method_name="__call__"):
        self.name = deployment_name
        self.method = method_name

    def remote(self, payload):
        return _Response(lambda: _behave(self.name, self.method, payload))

    def remote_stream(self, payload):
        if self.name not in DEPLOYMENTS:
            raise ValueError(f"no deployment named {self.name!r}")
        return _Stream(self.name, payload)


class _Listing:
    """What the fake controller's list_deployments.remote() returns."""


class _FakeController:
    class list_deployments:  # noqa: N801 — an actor method's shape
        @staticmethod
        def remote():
            return _Listing()


def _fake_get(ref, timeout=None):
    if isinstance(ref, _Listing):
        return [{"name": n, "config": {"http_adapter": a}, "version": 1}
                for n, a in DEPLOYMENTS.items()]
    return ref


@pytest.fixture(scope="module")
def proxies():
    """(JAX proxy address, port proxy address), each on the fakes of its
    own package."""
    with pytest.MonkeyPatch.context() as mp:
        for handle_mod, api_mod, watch_mod, pkg in (
                (jhandle, japi, jwatch, ray_tpu),
                (thandle, tapi, twatch, ray_tpu_torch)):
            mp.setattr(handle_mod, "DeploymentHandle", _FakeHandle)
            mp.setattr(api_mod, "_get_controller", _FakeController)
            mp.setattr(watch_mod.ConfigWatcher, "ensure_started",
                       lambda self: None)
            mp.setattr(pkg, "get", _fake_get)
        jproxy, tproxy = JProxy(), TProxy()
        try:
            yield jproxy.address(), tproxy.address()
        finally:
            tproxy._server.shutdown()
            tproxy._server.server_close()


def _request(address, method, path, body=None, content_type=None):
    host, port = address
    headers = {"Content-Type": content_type} if content_type else {}
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, headers, data = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        status, headers, data = e.code, e.headers, e.read()
    return status, (headers.get("Content-Type") or "").split(";")[0], data


JSON = "application/json"
CASES = {
    "json": ("POST", "/echo", json.dumps({"a": [1, 2]}).encode(), JSON),
    "text_body": ("POST", "/echo", b"plain words", "text/plain"),
    "empty_body": ("POST", "/echo", b"", None),
    "method": ("POST", "/echo?method=shout", b'"x"', JSON),
    "missing_404": ("POST", "/nope", b"{}", JSON),
    "raises_500": ("POST", "/boom", b"{}", JSON),
    "raw_bytes": ("POST", "/raw", b"{}", JSON),
    "adapter": ("POST", "/nd?dtype=float32", b"[[1, 2], [3, 4]]", JSON),
    "adapter_fails_400": ("POST", "/nd", b'{"data": [1]}', JSON),
    "unknown_adapter_500": ("POST", "/typo", b"[1]", JSON),
    "sse": ("POST", "/echo?stream=1", b'{"n": 3}', JSON),
    "sse_error_frame": ("POST", "/boom?stream=1", b'{"n": 3}', JSON),
    "sse_missing": ("POST", "/nope?stream=true", b"{}", JSON),
    "healthz": ("GET", "/-/healthz", None, None),
    "nested_path_404": ("POST", "/a/b", b"{}", JSON),
    "get_on_deployment_405": ("GET", "/echo", None, None),
}
STATUS_ONLY = {"nested_path_404", "get_on_deployment_405"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_proxy_answers_as_jax(proxies, case):
    method, path, body, content_type = CASES[case]
    jax_reply, port_reply = (_request(a, method, path, body, content_type)
                             for a in proxies)
    if case in STATUS_ONLY:
        assert port_reply[0] == jax_reply[0]
        return
    assert port_reply == jax_reply
    status, ctype, data = port_reply
    if case.startswith("sse"):
        assert ctype == "text/event-stream"
        assert data.endswith(b"data: [DONE]\n\n")
    elif case == "raw_bytes":
        assert (status, data) == (200, b"raw-bytes")
    else:
        assert ctype == JSON and status == {
            "missing_404": 404, "raises_500": 500, "adapter_fails_400": 400,
            "unknown_adapter_500": 500}.get(case, 200)
