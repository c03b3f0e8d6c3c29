"""Local testing mode: run deployments in-process, no cluster.

The port's copy of ray_tpu/serve/local_testing.py (reference analog:
python/ray/serve/_private/local_testing_mode.py:1):
`serve.run(app, local_testing_mode=True)` executes user callables directly
in the calling process, so deployment logic (composition, method routing,
streaming, errors) is testable with no actor, no RPC and sub-second
start-up. The handle surface mirrors DeploymentHandle:
`.remote(...)` -> response with `.result(timeout=...)`,
`.remote_stream(...)` -> iterator, `.options(method)` / attribute access
for method routing.
"""

from __future__ import annotations

import inspect
import queue
import threading
from typing import Dict, List, Optional

_local_deployments: Dict[str, "_LocalReplica"] = {}


class LocalDeploymentResponse:
    """Synchronous DeploymentResponse stand-in. The call runs on a worker
    thread so `.result(timeout=...)` has real timeout semantics (a hung
    user callable fails the caller instead of wedging it)."""

    def __init__(self, fn, args, kwargs):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)

        def run():
            try:
                out = fn(*args, **kwargs)
                if inspect.iscoroutine(out):
                    import asyncio

                    out = asyncio.run(out)
                self._q.put((True, out))
            except BaseException as e:  # delivered to .result()
                self._q.put((False, e))

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serve-local-call")
        self._thread.start()

    def result(self, timeout: Optional[float] = 60.0,
               timeout_s: Optional[float] = None):
        if timeout_s is not None:
            timeout = timeout_s
        # Cache the outcome: result() is repeatable, as on the real
        # DeploymentResponse.
        if not hasattr(self, "_outcome"):
            try:
                self._outcome = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("local deployment call timed out")
        ok, value = self._outcome
        if not ok:
            raise value
        return value


class _LocalReplica:
    def __init__(self, name: str, func_or_class, init_args, init_kwargs):
        self.name = name
        if inspect.isclass(func_or_class):
            self.callable = func_or_class(*init_args, **init_kwargs)
        else:
            self.callable = func_or_class

    def method(self, method_name: str):
        if method_name == "__call__":
            if callable(self.callable):
                return self.callable
            raise AttributeError(
                f"deployment {self.name!r} object is not callable")
        return getattr(self.callable, method_name)


class LocalDeploymentHandle:
    """In-process DeploymentHandle twin (same call surface)."""

    def __init__(self, deployment_name: str, method_name: str = "__call__"):
        self.deployment_name = deployment_name
        self.method_name = method_name

    def options(self, method_name: str) -> "LocalDeploymentHandle":
        return LocalDeploymentHandle(self.deployment_name, method_name)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return self.options(item)

    def _target(self):
        replica = _local_deployments.get(self.deployment_name)
        if replica is None:
            raise ValueError(
                f"no local deployment named {self.deployment_name!r}")
        return replica.method(self.method_name)

    def remote(self, *args, **kwargs) -> LocalDeploymentResponse:
        return LocalDeploymentResponse(self._target(), args, kwargs)

    def remote_stream(self, *args, **kwargs):
        gen = self._target()(*args, **kwargs)
        if not inspect.isgenerator(gen):
            raise TypeError(
                f"{self.deployment_name}.{self.method_name} did not return "
                "a generator (required for remote_stream)")
        return gen


def run_local(deployments: List) -> LocalDeploymentHandle:
    """serve.run(..., local_testing_mode=True): deploy each Deployment
    in-process, resolving bound child Deployments to local handles (the
    same composition as the cluster path)."""
    from ray_tpu_torch.serve.deployment import Deployment

    deployed: set = set()

    def resolve(obj):
        if isinstance(obj, Deployment):
            deploy(obj)
            return LocalDeploymentHandle(obj.name)
        if isinstance(obj, (list, tuple)):
            return type(obj)(resolve(x) for x in obj)
        if isinstance(obj, dict):
            return {k: resolve(v) for k, v in obj.items()}
        return obj

    def deploy(dep):
        if dep.name in deployed:
            return
        deployed.add(dep.name)
        init_args = tuple(resolve(a) for a in dep.init_args)
        init_kwargs = {k: resolve(v) for k, v in dep.init_kwargs.items()}
        _local_deployments[dep.name] = _LocalReplica(
            dep.name, dep.func_or_class, init_args, init_kwargs)

    for dep in deployments:
        deploy(dep)
    return LocalDeploymentHandle(deployments[0].name)


def get_local_handle(name: str) -> Optional[LocalDeploymentHandle]:
    return (LocalDeploymentHandle(name)
            if name in _local_deployments else None)


def local_status() -> List[dict]:
    return [{"name": n, "num_replicas": 1, "status": "RUNNING",
             "local_testing_mode": True} for n in _local_deployments]


def delete_local(name: str) -> bool:
    return _local_deployments.pop(name, None) is not None


def shutdown_local() -> None:
    _local_deployments.clear()
