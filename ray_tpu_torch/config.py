"""Central runtime config table: typed tunables, env-overridable.

The port's copy of ray_tpu/config.py, cut to the runtime's, Serve's,
the collective plane's and checkpoint replication's entries, with
the environment prefix RAY_TPU_TORCH_ (so the JAX package's own settings
never reach the port's runtime).

Reference analog: src/ray/common/ray_config_def.h (223 RAY_CONFIG macros,
overridable via RAY_* env vars and the _system_config dict passed at init,
serialized to components). Ours: one table; override precedence is
    _system_config (init kwarg)  >  RAY_TPU_TORCH_<NAME> env var  >  default.
Components read `cfg().<name>` at use time, so test fixtures and
_system_config can retune without import-order games.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Tuple

# name -> (type, default, doc)
_DEFS: Dict[str, Tuple[type, Any, str]] = {
    "inline_result_max": (int, 100 * 1024,
                          "max bytes for inline (non-plasma) task results"),
    "lease_idle_timeout_s": (float, 1.0,
                             "idle worker lease kept warm before return"),
    "lease_max_inflight_requests": (int, 64,
                                    "outstanding worker-lease requests per "
                                    "scheduling key"),
    "actor_max_inflight_calls": (int, 128,
                                 "pipelined in-flight calls per actor client"),
    "pull_chunk_bytes": (int, 4 << 20, "chunk size for remote object pulls"),
    "lineage_max_entries": (int, 100_000, "owner-side lineage cap"),
    "max_dependency_reconstructions": (int, 3,
                                       "per-task cap on recursive lost-arg "
                                       "recoveries before the error surfaces"),
    "reconstruction_attempts": (int, 3,
                                "re-executions before an object is lost"),
    "heartbeat_interval_s": (float, 2.0, "raylet resource heartbeat period"),
    "lease_batch_max": (int, 64,
                        "lease requests coalesced into one "
                        "LeaseBatchRequestMsg frame per raylet per pump "
                        "(the raylet grants the batch in one scheduling "
                        "pass)"),
    "worker_prestart": (int, 0,
                        "idle workers spawned at raylet start (0 = spawn on "
                        "first lease; capped by the node's CPU count)"),
    "job_keepalive_interval_s": (float, 2.0,
                                 "driver job-heartbeat period (owner-death "
                                 "detection for auto-started clusters)"),
    "worker_pool_max_idle": (int, 8,
                             "idle workers kept per raylet; beyond this the "
                             "oldest idle worker is terminated (bounds pool "
                             "growth across distinct GPU sets)"),
    "pg_retry_interval_s": (float, 0.2,
                            "GCS retry period for PENDING placement groups"),
    "object_store_memory_default": (int, 2 << 30,
                                    "default shm store capacity bytes"),
    "spill_high_watermark": (float, 0.85,
                             "store fill fraction where the raylet starts "
                             "proactive background spilling (0 disables)"),
    "spill_low_watermark": (float, 0.70,
                            "proactive spilling stops below this fill "
                            "fraction"),
    "pull_admission_concurrency": (int, 16,
                                   "concurrent cross-node chunk reads a "
                                   "raylet serves (admission control)"),
    "broadcast_fanout": (int, 2, "relay-tree fanout for object broadcast"),
    "cluster_events_max": (int, 10_000,
                           "structured cluster events retained by the GCS "
                           "event ring (see runtime/events.py)"),
    # -- collectives -------------------------------------------------------
    "collective_watchdog_interval_s": (float, 1.0,
                                       "peer-liveness/abort poll period of "
                                       "the collective watchdog during "
                                       "blocking ops"),
    "collective_peer_miss_threshold": (int, 3,
                                       "consecutive stale watchdog "
                                       "heartbeats before a collective peer "
                                       "is declared lost and the group "
                                       "aborts"),
    "collective_op_timeout_s": (float, 120.0,
                                "per-op deadline for blocking out-of-graph "
                                "collective ops (the torch backend's "
                                "process-group timeout)"),
    "collective_topology": (str, "ring",
                            "tcp collective data plane: 'ring' (chunked "
                            "ring algorithms over p2p links, zero-pickle "
                            "raw frames) or 'hub' (rank-0 star, pickled "
                            "payloads)"),
    "collective_chunk_bytes": (int, 1 << 20,
                               "chunk size for ring collective transfers; "
                               "large tensors pipeline across hops in "
                               "chunks of this size and per-op scratch "
                               "memory stays bounded at one chunk"),
    "ddp_bucket_bytes": (int, 4 << 20,
                         "gradient-coalescing bucket size for "
                         "reduce_gradients; each per-dtype bucket launches "
                         "its allreduce as it fills so reduction overlaps "
                         "the remaining flatten work"),
    # -- checkpoint ----------------------------------------------------------
    "ckpt_replicate": (bool, False,
                       "replicate completed checkpoint shards to peer "
                       "object stores via the broadcast fanout tree and "
                       "register them in the GCS relocation table"),
    "ckpt_replicate_timeout_s": (float, 60.0,
                                 "per-shard timeout for the replication "
                                 "fanout"),
    # -- serve -------------------------------------------------------------
    "serve_autoscale_interval_s": (float, 1.0, "controller autoscale tick"),
    "serve_handle_refresh_s": (float, 1.0,
                               "handle replica-set re-poll period"),
    "serve_replica_health_timeout_s": (float, 300.0,
                                       "replica construction deadline"),
}


class RayTpuConfig:
    def __init__(self):
        self._values: Dict[str, Any] = {}
        for name, (typ, default, _doc) in _DEFS.items():
            env = os.environ.get(f"RAY_TPU_TORCH_{name.upper()}")
            if env is not None:
                try:
                    self._values[name] = (typ(env) if typ is not bool
                                          else env not in ("0", "false", ""))
                except ValueError:
                    raise ValueError(
                        f"bad value for RAY_TPU_TORCH_{name.upper()}: {env!r}")
            else:
                self._values[name] = default

    def __getattr__(self, name: str):
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(f"unknown config {name!r}") from None

    def apply_overrides(self, overrides: Dict[str, Any]):
        """init(_system_config=...) path; unknown keys are an error (typos
        must not silently no-op)."""
        for k, v in overrides.items():
            if k not in _DEFS:
                raise ValueError(f"unknown system config key {k!r}")
            self._values[k] = _DEFS[k][0](v)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._values)


_instance = None
_lock = threading.Lock()


def cfg() -> RayTpuConfig:
    global _instance
    if _instance is None:
        with _lock:
            if _instance is None:
                _instance = RayTpuConfig()
    return _instance


def reset_for_testing():
    global _instance
    _instance = None
