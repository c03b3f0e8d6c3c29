"""ServeController: deployment/replica lifecycle.

The port's copy of ray_tpu/serve/controller.py (reference analog:
python/ray/serve/_private/controller.py:84 ServeController +
deployment_state.py:1248 (replica state machine) + long_poll.py:204 config
propagation): a named actor owning the replica actors per deployment;
every config change (deploy/scale/delete) is PUSHED to proxies and handles
over the GCS pubsub channel (serve/config_watcher.py); the version number
doubles as the fallback refresh key when a subscriber's push stream is
down. Replicas take `num_gpus` whole cards where the JAX package's take
`num_tpus`.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Dict, List

import ray_tpu_torch as rt

logger = logging.getLogger(__name__)


def _replica_class(config: dict):
    from ray_tpu_torch.serve.deployment import ReplicaActor

    return rt.remote(ReplicaActor).options(
        num_cpus=config.get("num_cpus", 0),
        num_gpus=config.get("num_gpus", 0),
        max_concurrency=config.get("max_ongoing_requests", 16),
        resources=config.get("resources") or {})


def _kill_all(replicas) -> None:
    for r in replicas:
        try:
            rt.kill(r)
        except Exception:
            pass


class ServeController:
    CONTROLLER_NAME = "SERVE_CONTROLLER"

    def __init__(self):
        import threading

        # deployment name -> {"replicas": [handles], "config", "version"}
        self.deployments: Dict[str, Dict] = {}
        self.version = 0
        self._lock = threading.Lock()
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop, daemon=True,
            name="serve-autoscale")
        self._autoscale_thread.start()

    def deploy(self, name: str, target_payload: bytes, config: dict,
               init_args_payload: bytes) -> bool:
        import cloudpickle

        from ray_tpu_torch.config import cfg

        # The init args are unpickled here as in the JAX controller; for an
        # LLM deployment that imports torch into this process (an LLMConfig
        # holds a torch dtype), timed apart in deploy_s.
        had_torch = "torch" in sys.modules
        t0 = time.perf_counter()
        init_args, init_kwargs = cloudpickle.loads(init_args_payload)
        unpickle_s = time.perf_counter() - t0
        existing = self.deployments.get(name)
        if existing is not None:
            _kill_all(existing["replicas"])
        ac = config.get("autoscaling")
        n = (max(int(ac.get("min_replicas", 1)), 1) if ac
             else config["num_replicas"])
        Replica = _replica_class(config)
        t0 = time.perf_counter()
        replicas = [Replica.remote(target_payload, init_args, init_kwargs)
                    for _ in range(n)]
        # Wait until replicas construct successfully.
        rt.get([r.health_check.remote() for r in replicas],
               timeout=cfg().serve_replica_health_timeout_s)
        deploy_s = {"init_args_unpickle": unpickle_s,
                    "unpickle_imported_torch": (not had_torch
                                                and "torch" in sys.modules),
                    "replicas_up": time.perf_counter() - t0}
        with self._lock:
            self.version += 1
            version = self.version
            self.deployments[name] = {
                "replicas": replicas, "config": config,
                "version": version, "target_payload": target_payload,
                "init_args": init_args, "init_kwargs": init_kwargs,
                "deploy_s": deploy_s}
        self._publish(name, version, "deployed")
        self._snapshot_to_kv()
        return True

    @staticmethod
    def _publish(name: str, version: int, event: str):
        """Push the change to proxies/handles (LongPollHost analog)."""
        from ray_tpu_torch.serve.config_watcher import publish_change

        publish_change(name, version, event)

    def _snapshot_to_kv(self):
        """Deployment status snapshot in the GCS KV (the JAX package's
        dashboard reads it; the port keeps the key for its later one)."""
        import json as json_mod

        try:
            from ray_tpu_torch.core.worker import global_worker

            with self._lock:  # autoscaler thread mutates concurrently
                snap = [{"name": k, "num_replicas": len(v["replicas"]),
                         "version": v["version"],
                         "autoscaling": bool(v["config"].get("autoscaling")),
                         "max_ongoing_requests":
                             v["config"].get("max_ongoing_requests", 16)}
                        for k, v in self.deployments.items()]
            core = global_worker()
            core.io.spawn(core.gcs.call(
                "kv_put", key=b"serve:deployments",
                value=json_mod.dumps(snap).encode(), overwrite=True))
        except Exception:
            pass

    # ---- autoscaling (autoscaling_policy.py analog) ----------------------

    def _autoscale_loop(self):
        import logging

        from ray_tpu_torch.config import cfg

        log = logging.getLogger(__name__)
        while True:
            time.sleep(cfg().serve_autoscale_interval_s)
            try:
                self._autoscale_once()
            except Exception:
                log.exception("serve autoscale tick failed")

    def _autoscale_once(self):
        import math

        from ray_tpu_torch.core.worker import global_worker

        for name in list(self.deployments):
            with self._lock:
                d = self.deployments.get(name)
                if d is None:
                    continue
                ac = d["config"].get("autoscaling")
                replicas = list(d["replicas"])
            if not ac or not replicas:
                continue
            # Queue depth via the worker's direct actor_stats RPC (served
            # on its IO loop): it counts tasks queued behind busy exec
            # threads and never blocks behind user code as an actor-method
            # probe (queue_len) would.
            try:
                stats = global_worker().actor_stats_many(
                    [r._actor_id for r in replicas], timeout=3)
            except Exception:
                continue
            queues = [int(s.get("pending", 0)) for s in stats if s is not None]
            if not queues:
                continue  # every replica unreachable (restarting/dead)
            target = max(float(ac.get("target_ongoing_requests", 2)), 0.1)
            desired = math.ceil(sum(queues) / target) or 0
            desired = max(int(ac.get("min_replicas", 1)),
                          min(int(ac.get("max_replicas", len(replicas))),
                              desired))
            now = time.monotonic()
            if desired > len(replicas):
                self._scale_to(name, desired)
                d["last_scale"] = now
            elif desired < len(replicas):
                # Downscale only after a quiet delay (thrash guard).
                delay = float(ac.get("downscale_delay_s", 5.0))
                pending_since = d.setdefault("downscale_since", now)
                if now - pending_since >= delay:
                    self._scale_to(name, desired)
                    d.pop("downscale_since", None)
                continue
            d.pop("downscale_since", None)

    def _scale_to(self, name: str, desired: int):
        from ray_tpu_torch.config import cfg

        # Snapshot under the lock; start replicas and wait for health checks
        # OUTSIDE it (a hung constructor must not block deploy()/routing of
        # every other deployment); re-acquire to commit, re-validating that
        # the deployment still exists at the same version.
        with self._lock:
            d = self.deployments.get(name)
            if d is None:
                return
            current = len(d["replicas"])
            version = d["version"]
            config = d["config"]
            payload = d["target_payload"]
            init_args, init_kwargs = d["init_args"], d["init_kwargs"]
        if desired == current:
            return
        if desired > current:
            Replica = _replica_class(config)
            new = [Replica.remote(payload, init_args, init_kwargs)
                   for _ in range(desired - current)]
            try:
                rt.get([r.health_check.remote() for r in new],
                       timeout=cfg().serve_replica_health_timeout_s)
            except Exception:
                _kill_all(new)
                raise
            with self._lock:
                d = self.deployments.get(name)
                if d is None or d["version"] != version:
                    # Deployment replaced/deleted while we were starting.
                    _kill_all(new)
                    return
                d["replicas"].extend(new)
                self.version += 1
                d["version"] = self.version
                new_version = self.version
            self._publish(name, new_version, "scaled_up")
            self._snapshot_to_kv()
        else:
            with self._lock:
                d = self.deployments.get(name)
                if d is None or d["version"] != version:
                    return
                victims = d["replicas"][desired:]
                d["replicas"] = d["replicas"][:desired]
                self.version += 1
                d["version"] = self.version
                new_version = self.version
            self._publish(name, new_version, "scaled_down")
            self._snapshot_to_kv()
            _kill_all(victims)

    def scale_replicas(self, name: str, desired: int) -> bool:
        """External scaling entry point (the LLM router's replica policy
        drives this): set the replica count directly, bypassing the
        queue-depth autoscaler — which skips deployments without an
        `autoscaling` config, so the two never fight over one fleet."""
        if desired < 1:
            return False
        if name not in self.deployments:
            return False
        self._scale_to(name, int(desired))
        return True

    def remove_replica(self, name: str, actor_id_hex: str) -> bool:
        """Retire one SPECIFIC replica by actor id (hex).

        _scale_to's downscale always trims the tail of the replica list;
        drain-based scale-down needs to kill the replica whose sessions
        were just migrated out, whichever slot it holds. The caller has
        drained it first."""
        with self._lock:
            d = self.deployments.get(name)
            if d is None:
                return False
            victim = next((r for r in d["replicas"]
                           if bytes(r._actor_id).hex() == actor_id_hex), None)
            if victim is None:
                return False
            d["replicas"] = [r for r in d["replicas"] if r is not victim]
            self.version += 1
            d["version"] = self.version
            new_version = self.version
        self._publish(name, new_version, "scaled_down")
        self._snapshot_to_kv()
        _kill_all([victim])
        return True

    def get_replicas(self, name: str) -> dict:
        d = self.deployments.get(name)
        if d is None:
            return {"found": False, "version": self.version}
        return {"found": True, "replicas": d["replicas"],
                "version": d["version"]}

    def list_deployments(self) -> List[dict]:
        return [{"name": k, "num_replicas": len(v["replicas"]),
                 "config": v["config"], "version": v["version"],
                 "deploy_s": v["deploy_s"]}
                for k, v in self.deployments.items()]

    def delete_deployment(self, name: str) -> bool:
        d = self.deployments.pop(name, None)
        if d is None:
            return False
        _kill_all(d["replicas"])
        self.version += 1
        self._publish(name, self.version, "deleted")
        self._snapshot_to_kv()
        self._purge_prefix_entries(name)
        return True

    @staticmethod
    def _purge_prefix_entries(name: str):
        """Drop the deployment's rows from the GCS cluster prefix table
        (llm/prefix_store.py): a replica's death only blanks its owner
        hints so survivors still adopt the pages, but deleting the
        deployment retires the whole fleet, so its published KV is freed
        outright. Fire-and-forget, as the JAX controller's."""
        try:
            from ray_tpu_torch.core.worker import global_worker
            from ray_tpu_torch.runtime import wire

            m = wire.PrefixPurgeMsg(deployment=name).encode()
            core = global_worker()
            core.io.spawn(core.gcs.call_raw("prefix_purge", m=m))
        except Exception:
            logger.exception("prefix table purge of %s failed", name)

    def global_version(self) -> int:
        return self.version
