"""HTTP adapters: declarative request -> model-input conversion.

The port's copy of ray_tpu/serve/http_adapters.py (reference analog:
python/ray/serve/http_adapters.py: json_request, json_to_ndarray,
pandas_read_json, image_to_ndarray), applied at the ingress. A
deployment declares `http_adapter="json_to_ndarray"` and its callable
receives the converted value instead of raw JSON; non-HTTP
callers (DeploymentHandle.remote) are unaffected. Adapters are looked up
by REGISTRY NAME so the config stays a plain serializable dataclass;
custom adapters register via `register()`.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional


class HTTPRequest:
    """What the proxy hands an adapter: the raw request essentials."""

    __slots__ = ("body", "content_type", "query")

    def __init__(self, body: bytes, content_type: str = "",
                 query: Optional[Dict[str, str]] = None):
        self.body = body
        self.content_type = content_type
        self.query = dict(query or {})

    def json(self) -> Any:
        return json.loads(self.body) if self.body else None

    def text(self) -> str:
        return self.body.decode("utf-8", "replace")


def json_request(request: HTTPRequest) -> Any:
    """Parsed JSON body (the default behavior, made explicit)."""
    return request.json()


def bytes_request(request: HTTPRequest) -> bytes:
    """Raw body bytes."""
    return request.body


def json_to_ndarray(request: HTTPRequest):
    """{"array": [...]} (or a bare JSON list) -> np.ndarray; optional
    "dtype" key / query param."""
    import numpy as np

    payload = request.json()
    dtype = request.query.get("dtype")
    if isinstance(payload, dict):
        dtype = payload.get("dtype", dtype)
        if "array" not in payload:
            # np.asarray(dict) would "succeed" as a 0-d object array and
            # crash the replica downstream; tell the client instead.
            raise ValueError(
                'json_to_ndarray expects {"array": [...]} or a bare JSON '
                f"list; got keys {sorted(payload)}")
        payload = payload["array"]
    arr = np.asarray(payload)
    return arr.astype(dtype) if dtype else arr


def pandas_read_json(request: HTTPRequest):
    """JSON body -> pandas DataFrame (records or column-dict orient)."""
    import pandas as pd

    payload = request.json()
    return pd.DataFrame(payload)


def image_to_ndarray(request: HTTPRequest):
    """Image bytes (png/jpeg) -> RGB ndarray (needs Pillow)."""
    import io

    import numpy as np

    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("image_to_ndarray requires Pillow") from e
    with Image.open(io.BytesIO(request.body)) as im:
        return np.asarray(im.convert("RGB"))


_REGISTRY: Dict[str, Callable[[HTTPRequest], Any]] = {
    "json_request": json_request,
    "bytes_request": bytes_request,
    "json_to_ndarray": json_to_ndarray,
    "pandas_read_json": pandas_read_json,
    "image_to_ndarray": image_to_ndarray,
}


def register(name: str, fn: Callable[[HTTPRequest], Any]) -> None:
    _REGISTRY[name] = fn


def get(name: str) -> Callable[[HTTPRequest], Any]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown http_adapter {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
