"""State API: cluster introspection.

The port's copy of the serving part of ray_tpu/state/api.py (reference
analog: python/ray/util/state/): the cluster event ring
(`list_cluster_events`), a serving request's stitched trace from this
process's span ring (`request_trace`), and the fleet's LLM rollup from
the metric snapshots every process pushes to the GCS KV
(`llm_serving_summary`, `_aggregate_llm_metrics`).

Pulling every process's span ring (`dump_cluster_spans`, and with it
`request_trace(cluster=True)`) needs the raylet's and workers'
`dump_spans` handlers, which the port refuses (ROADMAP.md queue 1 item
6.4). The rest of the JAX state API (nodes, actors, tasks, objects,
metrics history, alerts, the wait graph) waits for the same item.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.core.exceptions import _unported

# Seconds a state query waits for the GCS.
_GCS_TIMEOUT_S = 60.0


def _gcs_call(method: str, **kw):
    core = worker_mod.global_worker()
    return core.io.run(core.gcs.call(method, **kw), timeout=_GCS_TIMEOUT_S)


def list_cluster_events(event_type: Optional[str] = None,
                        severity: Optional[str] = None,
                        source: Optional[str] = None,
                        limit: int = 100) -> List[dict]:
    """Typed cluster events from the GCS ring (runtime/events.py), newest
    first. Filters are exact matches on the record's type/severity/source
    fields (e.g. event_type="LLM_SESSION_MIGRATED", severity="ERROR")."""
    return _gcs_call("list_events", event_type=event_type, severity=severity,
                     source=source, limit=limit)


def dump_cluster_spans() -> List[tuple]:
    """Every per-process span ring of the cluster: refused (the raylet's
    and workers' `dump_spans` handlers are not ported)."""
    raise _unported("dump_cluster_spans (the raylet's and workers' "
                    "dump_spans; ROADMAP.md queue 1 item 6.4)")


def request_trace(request_id: str, cluster: bool = False) -> Dict:
    """Stitched end-to-end trace for one LLM serving request.

    The trace id derives from the request id (`tracing.request_trace_id`),
    so spans recorded by any code that touched the request (router,
    prefill server, decode server, migration target) are matched by id
    alone. This process's ring is searched (the in-process serving path
    records everything locally); `cluster=True` refuses, as
    `dump_cluster_spans` does. Spans come back sorted by start time, each
    annotated with the recording process's label."""
    from ray_tpu_torch.util import tracing

    if cluster:
        dump_cluster_spans()
    want = tracing.request_trace_id(request_id).hex()
    label = f"pid:{os.getpid()}"
    spans, seen = [], set()
    for s in tracing.get_spans():
        args = s.get("args") or {}
        if args.get("trace_id") != want:
            continue
        sid = args.get("span_id")
        if sid and sid in seen:
            continue
        seen.add(sid)
        ev = dict(s)
        ev["process"] = label
        spans.append(ev)
    spans.sort(key=lambda s: s.get("ts", 0.0))
    return {"request_id": request_id, "trace_id": want, "spans": spans}


def llm_serving_summary() -> Dict:
    """Fleet-wide LLM serving rollup from each process's pushed metrics
    (the replicas' gauges are the engine_stats() numbers the router
    reads)."""
    snapshots = []
    for key in _gcs_call("kv_keys", prefix=b"metrics:")["keys"]:
        reply = _gcs_call("kv_get", key=key)
        if reply.get("value"):
            snapshots.append(json.loads(reply["value"]))
    return _aggregate_llm_metrics(snapshots)


_BREAKDOWN_METRICS = {
    "ray_tpu_llm_ttft_breakdown_ms": "ttft_breakdown_ms",
    "ray_tpu_llm_itl_breakdown_ms": "itl_breakdown_ms",
}


def _aggregate_llm_metrics(snapshots: List[List[dict]]) -> Dict:
    """Pure rollup over per-process metric snapshots (util/metrics.py
    snapshot_all() lists): sums every ray_tpu_llm_* gauge and counter
    series across processes and counts the distinct replica tags seen.
    The latency-breakdown histograms roll up per phase instead (their
    `values` are per-phase running means, which do not sum): {phase:
    mean_ms} maps weighted by observation count, and a p99 map from the
    merged bucket counts (`util.metrics.histogram_quantile`)."""
    from ray_tpu_torch.util.metrics import histogram_quantile

    sums: Dict[str, float] = {}
    breakdown: Dict[str, Dict[str, list]] = {}
    replicas = set()
    for snap in snapshots:
        for metric in snap:
            name = metric.get("name", "")
            if not name.startswith("ray_tpu_llm_"):
                continue
            if name in _BREAKDOWN_METRICS:
                dest = breakdown.setdefault(_BREAKDOWN_METRICS[name], {})
                boundaries = metric.get("boundaries") or []
                for tag_key, h in metric.get("histograms", {}).items():
                    phase = "?"
                    try:
                        phase = dict(json.loads(tag_key)).get("phase", "?")
                    except Exception:
                        pass
                    acc = dest.setdefault(phase, [0.0, 0, [], boundaries])
                    acc[0] += h.get("sum", 0.0)
                    acc[1] += int(h.get("count", 0))
                    buckets = h.get("buckets") or []
                    if not acc[2]:
                        acc[2] = [0] * len(buckets)
                    if len(buckets) == len(acc[2]):
                        acc[2] = [a + b for a, b in zip(acc[2], buckets)]
                continue
            short = name[len("ray_tpu_llm_"):]
            for tag_key, value in metric.get("values", {}).items():
                if "replica" in tag_key:
                    replicas.add(tag_key)
                sums[short] = sums.get(short, 0.0) + value
    if not sums and not breakdown:
        return {}
    out = {k: round(v, 1) for k, v in sums.items()}
    for key, phases in breakdown.items():
        rolled = {p: round(s / c, 3)
                  for p, (s, c, _b, _bd) in phases.items() if c}
        if rolled:
            out[key] = rolled
        p99 = {}
        for p, (_s, c, buckets, boundaries) in phases.items():
            if not c:
                continue
            q = histogram_quantile(boundaries, buckets, 0.99)
            if q is not None:
                p99[p] = round(q, 3)
        if p99:
            out[key.replace("_ms", "_p99_ms")] = p99
    out["replicas_reporting"] = len(replicas)
    return out
