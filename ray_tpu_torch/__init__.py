"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, beside the JAX package.

The port imports torch, numpy and the standard library only — never jax
and never a `ray_tpu.` module; it keeps its own copy of what it needs.
It serves Llama-3 through the unified ragged tick and the split path
(`ray_tpu_torch.llm`), with ragged paged attention as CUDA kernels
written for Hopper (`ray_tpu_torch.ops.csrc.paged_attention`), and trains
a Llama on one card (`ray_tpu_torch.train`) through flash attention's
forward, dQ and dK/dV kernels (`ray_tpu_torch.ops.csrc.flash_attention`),
or a Llama or the MoE model (`ray_tpu_torch.models.moe`) sharded over a
mesh of ranks with DP/FSDP/TP/SP/EP (`ray_tpu_torch.parallel`).

The actor runtime (tasks, actors, objects, placement groups, with the GPU
as the scheduled accelerator) is the port's own copy under
`ray_tpu_torch.core` and `ray_tpu_torch.runtime`; its API is exported
here. Serve (deployments, handles, the controller, the HTTP ingress)
runs on it: `ray_tpu_torch.serve`. Every export is resolved lazily (module `__getattr__`), so the
runtime's processes (GCS, raylet, workers) start without importing torch.
"""

import importlib

# export name -> module that defines it
_EXPORTS = {
    "is_cuda_backend": "ray_tpu_torch.ops",
    "resolve_device": "ray_tpu_torch.ops",
    **{name: "ray_tpu_torch.core.api" for name in (
        "available_resources", "cancel", "cluster_resources", "free", "get",
        "get_actor", "get_runtime_context", "init", "is_initialized", "kill",
        "nodes", "put", "remote", "shutdown", "wait")},
    **{name: "ray_tpu_torch.core.exceptions" for name in (
        "ActorDiedError", "ActorError", "ActorUnavailableError",
        "GetTimeoutError", "ObjectLostError", "RayTpuError",
        "TaskCancelledError", "TaskError", "WorkerCrashedError")},
    **{name: "ray_tpu_torch.core.placement_group" for name in (
        "placement_group", "placement_group_table",
        "remove_placement_group")},
    "ObjectRefGenerator": "ray_tpu_torch.core.generator",
    "ObjectRef": "ray_tpu_torch.core.object_ref",
}

__all__ = sorted(_EXPORTS)
__version__ = "0.1.0"


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
