"""Serve public API.

The port's copy of ray_tpu/serve/api.py (reference analog:
python/ray/serve/api.py: serve.run:591, get_deployment_handle, delete,
status). The gRPC ingress (ray_tpu/serve/grpc_proxy.py) needs grpcio and
is not ported: start_grpc_proxy refuses.
"""

from __future__ import annotations

from typing import List, Union

import ray_tpu_torch as rt
from ray_tpu_torch.core.exceptions import _unported
from ray_tpu_torch.serve.controller import ServeController
from ray_tpu_torch.serve.deployment import Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle

_controller = None
_proxy = None


def _get_controller():
    global _controller
    if _controller is None:
        try:
            _controller = rt.get_actor(ServeController.CONTROLLER_NAME)
        except ValueError:
            Controller = rt.remote(ServeController)
            _controller = Controller.options(
                name=ServeController.CONTROLLER_NAME).remote()
    return _controller


def run(target: Union[Deployment, List[Deployment]], *,
        http: bool = False, http_port: int = 0,
        local_testing_mode: bool = False) -> DeploymentHandle:
    """Deploy one or more deployments; returns a handle to the first.

    Model composition (reference: serve deployment graphs — api.py:591 with
    bound child deployments): a Deployment appearing anywhere in another's
    bound init args is deployed first and replaced by a DeploymentHandle,
    so the parent replica calls children through ordinary handles.

    local_testing_mode=True (reference:
    serve/_private/local_testing_mode.py) runs everything in-process — no
    cluster, no actors — with the same handle surface. The wait for a
    deploy is twice the config entry serve_replica_health_timeout_s (600 s
    by default, as in the JAX package)."""
    import cloudpickle

    from ray_tpu_torch.config import cfg

    deployments = [target] if isinstance(target, Deployment) else list(target)
    if local_testing_mode:
        from ray_tpu_torch.serve.local_testing import run_local

        return run_local(deployments)

    controller = _get_controller()
    deployed: set = set()

    def resolve(obj):
        if isinstance(obj, Deployment):
            deploy(obj)
            return DeploymentHandle(obj.name)
        if isinstance(obj, (list, tuple)):
            return type(obj)(resolve(x) for x in obj)
        if isinstance(obj, dict):
            return {k: resolve(v) for k, v in obj.items()}
        return obj

    def deploy(dep: Deployment):
        if dep.name in deployed:
            return
        deployed.add(dep.name)  # before recursing: breaks bind cycles
        init_args = tuple(resolve(a) for a in dep.init_args)
        init_kwargs = {k: resolve(v) for k, v in dep.init_kwargs.items()}
        config = {
            "num_replicas": dep.config.num_replicas,
            "max_ongoing_requests": dep.config.max_ongoing_requests,
            "num_cpus": dep.config.num_cpus,
            "num_gpus": dep.config.num_gpus,
            "resources": dep.config.resources,
            "autoscaling": dep.config.autoscaling_config,
            "http_adapter": dep.config.http_adapter,
        }
        rt.get(controller.deploy.remote(
            dep.name, cloudpickle.dumps(dep.func_or_class), config,
            cloudpickle.dumps((init_args, init_kwargs))),
            timeout=2 * cfg().serve_replica_health_timeout_s)

    for dep in deployments:
        deploy(dep)
    if http:
        start_http_proxy(port=http_port)
    return DeploymentHandle(deployments[0].name)


def get_deployment_handle(name: str) -> DeploymentHandle:
    from ray_tpu_torch.serve.local_testing import get_local_handle

    local = get_local_handle(name)
    if local is not None:
        return local
    return DeploymentHandle(name)


def status() -> List[dict]:
    from ray_tpu_torch.serve.local_testing import (_local_deployments,
                                                   local_status)

    if _local_deployments:
        return local_status()
    return rt.get(_get_controller().list_deployments.remote(), timeout=60)


def delete(name: str) -> bool:
    from ray_tpu_torch.serve.local_testing import delete_local

    if delete_local(name):
        return True
    return rt.get(_get_controller().delete_deployment.remote(name),
                  timeout=60)


def start_http_proxy(port: int = 0):
    """Start (or return) the HTTP ingress; returns (host, port)."""
    global _proxy
    if _proxy is None:
        from ray_tpu_torch.serve.proxy import HTTPProxyActor

        Proxy = rt.remote(HTTPProxyActor)
        _proxy = Proxy.options(name="SERVE_HTTP_PROXY").remote(port=port)
    return tuple(rt.get(_proxy.address.remote(), timeout=60))


def start_grpc_proxy(port: int = 0):
    """The JAX package's gRPC ingress (ray_tpu/serve/grpc_proxy.py) needs
    grpcio, which the card's machine does not have: refused."""
    raise _unported("the gRPC ingress (serve.start_grpc_proxy; ROADMAP.md "
                    "queue 1 item 6.4)")


def shutdown():
    global _controller, _proxy
    from ray_tpu_torch.serve.config_watcher import ConfigWatcher
    from ray_tpu_torch.serve.local_testing import shutdown_local

    ConfigWatcher.reset()
    shutdown_local()
    if _controller is None:
        return  # local-only session: nothing cluster-side to tear down
    for name in [d["name"] for d in status()]:
        delete(name)
    for actor in (_proxy, _controller):
        if actor is not None:
            try:
                rt.kill(actor)
            except Exception:
                pass
    _controller = None
    _proxy = None
