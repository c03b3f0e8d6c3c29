"""Cluster state introspection (`ray_tpu_torch.state.*`): the port's part
of the JAX package's `ray_tpu.state` (state/api.py)."""

from ray_tpu_torch.state.api import (  # noqa: F401
    dump_cluster_spans,
    list_cluster_events,
    llm_serving_summary,
    request_trace,
)
