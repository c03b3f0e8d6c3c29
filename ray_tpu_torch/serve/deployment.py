"""Deployment definition + replica actor.

The port's copy of ray_tpu/serve/deployment.py (reference analog:
python/ray/serve/deployment.py (@serve.deployment) and replica.py, the
user-code runner), with `num_gpus` (whole cards) where the JAX package
has `num_tpus`. A deployment wraps a class (or function); replicas are
actors created by the controller; requests arrive as ordinary actor calls
(`handle_request`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    num_cpus: float = 0.0
    num_gpus: int = 0
    resources: Optional[Dict[str, float]] = None
    # Reference analog: serve autoscaling_policy.py — replica-queue-driven
    # target tracking. Keys: min_replicas, max_replicas,
    # target_ongoing_requests, downscale_delay_s (the tick is the config
    # entry serve_autoscale_interval_s).
    autoscaling_config: Optional[Dict] = None
    # Registry name of an ingress adapter (serve/http_adapters.py): the
    # HTTP proxy converts the request before dispatch; handle callers are
    # unaffected (reference: serve http_adapters).
    http_adapter: Optional[str] = None


class Deployment:
    def __init__(self, func_or_class: Any, name: str, config: DeploymentConfig,
                 init_args: tuple = (), init_kwargs: Optional[dict] = None):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config
        self.init_args = init_args
        self.init_kwargs = init_kwargs or {}

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                num_cpus: Optional[float] = None,
                num_gpus: Optional[int] = None,
                resources: Optional[Dict[str, float]] = None,
                autoscaling_config: Optional[Dict] = None,
                http_adapter: Optional[str] = None) -> "Deployment":
        given = dict(num_replicas=num_replicas,
                     max_ongoing_requests=max_ongoing_requests,
                     num_cpus=num_cpus, num_gpus=num_gpus,
                     resources=resources,
                     autoscaling_config=autoscaling_config,
                     http_adapter=http_adapter)
        cfg = dataclasses.replace(
            self.config, **{k: v for k, v in given.items() if v is not None})
        return Deployment(self.func_or_class, name or self.name, cfg,
                          self.init_args, self.init_kwargs)

    def bind(self, *args, **kwargs) -> "Deployment":
        """Bind init args (the graph-building API)."""
        return Deployment(self.func_or_class, self.name, self.config, args,
                          kwargs)


def deployment(func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 16,
               num_cpus: float = 0.0, num_gpus: int = 0,
               resources: Optional[Dict[str, float]] = None,
               autoscaling_config: Optional[Dict] = None,
               http_adapter: Optional[str] = None):
    def wrap(target):
        return Deployment(
            target, name or target.__name__,
            DeploymentConfig(num_replicas, max_ongoing_requests, num_cpus,
                             num_gpus, resources, autoscaling_config,
                             http_adapter))

    if func_or_class is not None:
        return wrap(func_or_class)
    return wrap


class ReplicaActor:
    """Hosts the user callable. One per replica."""

    def __init__(self, target_payload: bytes, init_args, init_kwargs):
        import cloudpickle

        target = cloudpickle.loads(target_payload)
        if isinstance(target, type):
            self.callable = target(*init_args, **init_kwargs)
        else:
            self.callable = target
        self._ongoing = 0

    def handle_request(self, method: str, args: tuple, kwargs: dict):
        self._ongoing += 1
        try:
            if method == "__call__":
                if not callable(self.callable):
                    raise AttributeError("deployment target is not callable")
                fn = self.callable
            else:
                fn = getattr(self.callable, method)
            return fn(*args, **kwargs)
        finally:
            self._ongoing -= 1

    def queue_len(self) -> int:
        return self._ongoing

    def health_check(self) -> bool:
        check = getattr(self.callable, "check_health", None)
        if check is not None:
            check()
        return True
