"""Serve on the port's runtime: deployments, handles, the controller and
the HTTP ingress (the port's copy of ray_tpu/serve/). No module here
imports torch, so the controller and proxy actors start without it."""

from ray_tpu_torch.serve.api import (  # noqa: F401
    delete,
    get_deployment_handle,
    run,
    shutdown,
    start_grpc_proxy,
    start_http_proxy,
    status,
)
from ray_tpu_torch.serve.batching import serve_batch as batch  # noqa: F401
from ray_tpu_torch.serve.deployment import Deployment, deployment  # noqa: F401
from ray_tpu_torch.serve.handle import DeploymentHandle  # noqa: F401
from ray_tpu_torch.serve import http_adapters  # noqa: F401
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    Multiplexer,
    get_multiplexed_model_id,
    multiplexed,
)
