"""Runtime metric definitions: the central table of what the port measures.

The port's copy of the Serve and LLM entries of
ray_tpu/runtime/metric_defs.py (reference analog:
src/ray/stats/metric_defs.cc): components import these and bump them,
and every process's metrics ride the snapshot path of util/metrics.py.
The names are the JAX package's, so a rollup or a dashboard reads both
packages' snapshots alike.

The collective plane's series are here too. The runtime's own metrics
(tasks, leases, workers, the object store and plane, data) and the
checkpoint plane's wait for the runtime's metrics history (ROADMAP.md
queue 1 item 6.4).
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

# -- collectives -----------------------------------------------------------
# Per-(op, algo) traffic and latency of the out-of-program collective
# plane. `algo` is "ring" or "hub" for the tcp backend, "nccl" or "gloo"
# for the torch backend; components bind() a tag set once and bump the
# bound handles, so the per-chunk accounting stays off the hot path.

COLLECTIVE_OPS = Counter(
    "ray_tpu_collective_ops_total",
    "out-of-graph collective operations completed",
    tag_keys=("op", "algo"))
COLLECTIVE_BYTES_SENT = Counter(
    "ray_tpu_collective_bytes_sent_total",
    "bytes sent on collective data-plane links",
    tag_keys=("op", "algo"))
COLLECTIVE_BYTES_RECV = Counter(
    "ray_tpu_collective_bytes_recv_total",
    "bytes received on collective data-plane links",
    tag_keys=("op", "algo"))
COLLECTIVE_OP_LATENCY = Histogram(
    "ray_tpu_collective_op_seconds",
    "end-to-end latency of out-of-graph collective ops",
    boundaries=[0.001, 0.01, 0.05, 0.25, 1.0, 5.0, 30.0],
    tag_keys=("op", "algo"))

# -- serve / llm -----------------------------------------------------------

SERVE_REQUESTS = Counter(
    "ray_tpu_serve_requests_total", "requests routed through handles",
    tag_keys=("deployment",))
LLM_TOKENS_GENERATED = Counter(
    "ray_tpu_llm_tokens_generated_total", "tokens sampled by LLM engines")
LLM_STEP_COMPILES = Counter(
    "ray_tpu_llm_step_compiles_total",
    "new step-shape signatures (CUDA graph captures or first eager runs; "
    "warmup pays these, any growth in the steady-state loop is a stall "
    "worth chasing)")

# Speculative decoding (engine n-gram drafts + unified-tick acceptance
# sampling): the accepted/proposed ratio is the speculation win.
LLM_SPEC_PROPOSED = Counter(
    "ray_tpu_llm_spec_proposed_total",
    "draft tokens submitted to speculative verification")
LLM_SPEC_ACCEPTED = Counter(
    "ray_tpu_llm_spec_accepted_total",
    "draft tokens accepted by speculative verification")

# Per-replica engine depth + KV occupancy: the numbers
# LLMServer.engine_stats() feeds the router, pushed as gauges.
LLM_RUNNING = Gauge(
    "ray_tpu_llm_running", "requests in decode on this replica",
    tag_keys=("replica",))
LLM_WAITING = Gauge(
    "ray_tpu_llm_waiting", "requests queued before prefill on this replica",
    tag_keys=("replica",))
LLM_PREFILLING = Gauge(
    "ray_tpu_llm_prefilling", "requests mid-chunked-prefill on this replica",
    tag_keys=("replica",))
LLM_KV_FREE_BLOCKS = Gauge(
    "ray_tpu_llm_kv_free_blocks", "free KV cache pages on this replica",
    tag_keys=("replica",))
LLM_KV_TOTAL_BLOCKS = Gauge(
    "ray_tpu_llm_kv_total_blocks", "total KV cache pages on this replica",
    tag_keys=("replica",))
LLM_PREFIX_HITS = Gauge(
    "ray_tpu_llm_prefix_hits", "prefix-cache block hits (cumulative)",
    tag_keys=("replica",))
LLM_PREFIX_TOKENS_SAVED = Gauge(
    "ray_tpu_llm_prefix_tokens_saved",
    "prompt tokens skipped via prefix cache (cumulative)",
    tag_keys=("replica",))
LLM_TOKENS_PER_S = Gauge(
    "ray_tpu_llm_tokens_per_s", "decode throughput EWMA on this replica",
    tag_keys=("replica",))

# Router plane (llm/router.py) + disaggregated KV handoffs (llm/disagg.py).
LLM_ROUTER_SHED = Counter(
    "ray_tpu_llm_router_shed_total",
    "requests shed by SLO admission (projected TTFT over the SLO)",
    tag_keys=("deployment",))
LLM_ROUTER_AFFINITY = Counter(
    "ray_tpu_llm_router_affinity_total",
    "router picks by prefix/session-affinity outcome",
    tag_keys=("outcome",))                       # hit | miss
LLM_KV_HANDOFFS = Counter(
    "ray_tpu_llm_kv_handoffs_total",
    "prefill->decode KV page handoffs adopted")

# Per-request latency attribution (llm/engine.py _finish_trace): TTFT by
# queue/prefill/handoff and the mean inter-token gap by decode/stall.
LLM_TTFT_BREAKDOWN_MS = Histogram(
    "ray_tpu_llm_ttft_breakdown_ms",
    "per-request time-to-first-token by phase: queue (submit->admit), "
    "prefill (admit->first token), handoff (disagg KV stream gaps)",
    boundaries=[0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000, 5000],
    tag_keys=("phase",))                         # queue | prefill | handoff
LLM_ITL_BREAKDOWN_MS = Histogram(
    "ray_tpu_llm_itl_breakdown_ms",
    "per-request MEAN inter-token gap by phase: decode (engine ticks) and "
    "stall (migration pauses amortized over the request's gaps)",
    boundaries=[0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000],
    tag_keys=("phase",))                         # decode | stall

# Fleet resilience (llm/router.py FleetSupervisor).
LLM_FAILOVERS = Counter(
    "ray_tpu_llm_failovers_total",
    "in-flight requests replayed on a surviving replica after a failure",
    tag_keys=("deployment",))
LLM_SESSIONS_MIGRATED = Counter(
    "ray_tpu_llm_sessions_migrated_total",
    "live sessions moved replica->replica (KV pages over the drain plane)",
    tag_keys=("deployment",))
LLM_REPLICAS_HEALTHY = Gauge(
    "ray_tpu_llm_replicas_healthy",
    "replicas the router currently considers live and routable",
    tag_keys=("deployment",))

# Tiered KV prefix store (llm/prefix_store.py): tier="host" is the
# server-local RAM spill pool, tier="store" the GCS-homed cluster table
# that outlives a replica's death and restarts.
LLM_PREFIX_SPILLS = Counter(
    "ray_tpu_llm_prefix_spills_total",
    "prefix KV pages demoted into a store tier instead of being dropped",
    tag_keys=("tier",))                          # host | store
LLM_PREFIX_ADOPTIONS = Counter(
    "ray_tpu_llm_prefix_adoptions_total",
    "spilled prefix blocks re-adopted into an engine (re-prefill avoided)",
    tag_keys=("tier",))                          # host | store
LLM_PREFIX_STORE_BYTES = Gauge(
    "ray_tpu_llm_prefix_store_bytes",
    "bytes currently held in this replica's host prefix tier")
LLM_PREFIX_STALE_REJECTED = Counter(
    "ray_tpu_llm_prefix_stale_rejected_total",
    "spilled prefix entries refused at adoption (weights version mismatch)")


ALL_METRICS = [v for v in list(globals().values())
               if isinstance(v, (Counter, Gauge, Histogram))]
