"""Application metrics: Counter / Gauge / Histogram.

The port's copy of ray_tpu/util/metrics.py (reference analog:
python/ray/util/metrics.py, exported to Prometheus by
_private/metrics_agent.py / _private/prometheus_exporter.py). Each
process keeps an in-process registry; a flush at most once a second
pushes the process's snapshot to the GCS KV under
``metrics:<node>:<pid>``, where `state.llm_serving_summary` aggregates
them; `prometheus_text` renders snapshots in the Prometheus text
exposition format.

The JAX package's typed flush (`report_metrics2`, which feeds the GCS
metrics history) is not ported: the port's GCS refuses that handler, so
every flush takes the `kv_put` path (ROADMAP.md queue 1 item 6.4).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_REGISTRY: Dict[str, "Metric"] = {}
_REGISTRY_LOCK = threading.Lock()
_FLUSH_INTERVAL_S = 1.0
_last_flush = 0.0


def _tag_key(tags: Optional[Dict[str, str]]) -> str:
    if not tags:
        return "[]"  # hot path: untagged metrics skip json entirely
    return json.dumps(sorted(tags.items()))


class Metric:
    """Base class; subclasses define how observations fold into the value."""

    TYPE = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Tuple[str, ...]] = None):
        if not name:
            raise ValueError("metric name is required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[str, float] = {}
        self._lock = threading.Lock()
        with _REGISTRY_LOCK:
            _REGISTRY[name] = self

    @property
    def info(self) -> Dict:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys, "default_tags": self._default_tags}

    def set_default_tags(self, tags: Dict[str, str]):
        for k in tags:
            if k not in self._tag_keys:
                raise ValueError(f"unknown tag key {k!r} (declared: {self._tag_keys})")
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        if tags:
            for k in tags:
                if k not in self._tag_keys:
                    raise ValueError(
                        f"unknown tag key {k!r} for metric {self._name!r} "
                        f"(declared: {self._tag_keys})")
            merged.update(tags)
        return merged

    def snapshot(self) -> Dict:
        with self._lock:
            return {"name": self._name, "type": self.TYPE,
                    "description": self._description,
                    "values": dict(self._values)}


class Counter(Metric):
    TYPE = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc requires a positive value")
        self._inc_key(_tag_key(self._merged(tags)), value)

    def _inc_key(self, key: str, value: float):
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value
        _maybe_flush()

    def bind(self, tags: Dict[str, str]) -> "BoundCounter":
        """Pre-resolve a tag set once; the returned handle increments with
        no per-call dict merge or json encode."""
        return BoundCounter(self, _tag_key(self._merged(tags)))


class BoundCounter:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Counter, key: str):
        self._metric = metric
        self._key = key

    def inc(self, value: float = 1.0):
        if value <= 0:
            raise ValueError("Counter.inc requires a positive value")
        self._metric._inc_key(self._key, value)


class Gauge(Metric):
    TYPE = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._set_key(_tag_key(self._merged(tags)), value)

    def _set_key(self, key: str, value: float):
        with self._lock:
            self._values[key] = float(value)
        _maybe_flush()

    def bind(self, tags: Optional[Dict[str, str]] = None) -> "BoundGauge":
        """Counter.bind/Histogram.bind symmetry: the tag key computed once."""
        return BoundGauge(self, _tag_key(self._merged(tags)))


class BoundGauge:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Gauge, key: str):
        self._metric = metric
        self._key = key

    def set(self, value: float):
        self._metric._set_key(self._key, value)


class Histogram(Metric):
    TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Optional[Tuple[str, ...]] = None):
        super().__init__(name, description, tag_keys)
        self._boundaries = sorted(boundaries or [0.1, 1.0, 10.0])
        # per tag-set: [bucket counts..., +Inf count], sum, count
        self._hist: Dict[str, Dict] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self._observe_key(_tag_key(self._merged(tags)), value)

    def bind(self, tags: Dict[str, str]) -> "BoundHistogram":
        """Counter.bind analog: precomputed tag key, no per-observe merge."""
        return BoundHistogram(self, _tag_key(self._merged(tags)))

    def _observe_key(self, key: str, value: float):
        with self._lock:
            h = self._hist.setdefault(
                key, {"buckets": [0] * (len(self._boundaries) + 1),
                      "sum": 0.0, "count": 0})
            idx = len(self._boundaries)
            for i, b in enumerate(self._boundaries):
                if value <= b:
                    idx = i
                    break
            h["buckets"][idx] += 1
            h["sum"] += value
            h["count"] += 1
            self._values[key] = h["sum"] / max(h["count"], 1)
        _maybe_flush()

    def snapshot(self) -> Dict:
        snap = super().snapshot()
        with self._lock:
            snap["boundaries"] = list(self._boundaries)
            snap["histograms"] = {k: dict(v) for k, v in self._hist.items()}
        return snap


class BoundHistogram:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Histogram, key: str):
        self._metric = metric
        self._key = key

    def observe(self, value: float):
        self._metric._observe_key(self._key, value)


def histogram_quantile(boundaries: List[float], buckets: List[float],
                       q: float) -> Optional[float]:
    """Estimate the q-quantile (0..1) from histogram bucket counts.

    ``buckets`` has ``len(boundaries) + 1`` entries — one count per
    boundary plus the +Inf overflow bucket — the shape
    ``Histogram.snapshot()`` stores. Linear interpolation inside the
    target bucket (the PromQL ``histogram_quantile`` convention);
    observations in the overflow bucket clamp to the highest finite
    boundary, and the first bucket interpolates from 0. Returns None on
    empty input so callers can leave the key out instead of reporting a
    fake 0.
    """
    total = sum(buckets)
    if total <= 0 or not boundaries:
        return None
    q = min(max(q, 0.0), 1.0)
    rank = q * total
    cumulative = 0.0
    for i, count in enumerate(buckets):
        if count <= 0:
            continue
        if cumulative + count >= rank:
            if i >= len(boundaries):     # +Inf bucket: no upper edge
                return float(boundaries[-1])
            lo = boundaries[i - 1] if i > 0 else 0.0
            hi = boundaries[i]
            frac = (rank - cumulative) / count
            return float(lo + (hi - lo) * frac)
        cumulative += count
    return float(boundaries[-1])


def snapshot_all() -> List[Dict]:
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    return [m.snapshot() for m in metrics]


def _maybe_flush():
    """Throttled push of this process's metrics to the GCS KV."""
    global _last_flush
    now = time.monotonic()
    if now - _last_flush < _FLUSH_INTERVAL_S:
        return
    _last_flush = now
    try:
        flush()
    except Exception:
        pass  # metrics must never break the application


def flush():
    """Push this process's snapshot to GCS KV `metrics:<node>:<pid>`,
    fire-and-forget on the core IO loop (a no-op outside a cluster):
    inc()/set() run on any thread, the IO loop's own included, so waiting
    for the put here could deadlock the loop against its own flush."""
    from ray_tpu_torch.core import worker as worker_mod

    if not worker_mod.is_initialized():
        return
    core = worker_mod.global_worker()
    node = core.node_id.hex() if getattr(core, "node_id", None) else "unknown"
    key = f"metrics:{node}:{os.getpid()}".encode()
    payload = json.dumps(snapshot_all()).encode()
    core.io.spawn(core.gcs.call("kv_put", key=key, value=payload))


def prometheus_text(snapshots: List[Dict]) -> str:
    """Render metric snapshots in Prometheus text exposition format
    (the _private/prometheus_exporter.py analog)."""
    lines = []
    for snap in snapshots:
        name = snap["name"].replace(".", "_").replace("-", "_")
        if snap.get("description"):
            lines.append(f"# HELP {name} {snap['description']}")
        lines.append(f"# TYPE {name} {snap['type']}")
        if snap["type"] == "histogram":
            for key, h in snap.get("histograms", {}).items():
                labels = dict(json.loads(key))
                cumulative = 0
                for b, c in zip(snap["boundaries"], h["buckets"]):
                    cumulative += c
                    lab = _fmt_labels({**labels, "le": str(b)})
                    lines.append(f"{name}_bucket{lab} {cumulative}")
                cumulative += h["buckets"][-1]
                lab = _fmt_labels({**labels, "le": "+Inf"})
                lines.append(f"{name}_bucket{lab} {cumulative}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {h['sum']}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {h['count']}")
        else:
            for key, v in snap["values"].items():
                labels = dict(json.loads(key))
                lines.append(f"{name}{_fmt_labels(labels)} {v}")
    return "\n".join(lines) + "\n"


def _escape_label_value(value) -> str:
    """Prometheus text exposition escaping for label values: backslash,
    double-quote, and newline must be escaped (in that order — escaping
    the backslash last would corrupt the other two)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"
