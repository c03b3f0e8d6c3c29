"""Serving stack of the port: sampling, model runner, engine, server, and
the serve deployment around the server.

Exports what ray_tpu/llm/__init__.py exports, resolved lazily (module
`__getattr__`) so that importing the package loads no torch.
"""

import importlib

# export name -> module that defines it
_EXPORTS = {
    **{name: "ray_tpu_torch.llm.engine" for name in (
        "LLMEngine", "RequestOutput", "WeightSyncError",
        "prefix_digest_chain")},
    "SamplingParams": "ray_tpu_torch.llm.sampling",
    **{name: "ray_tpu_torch.llm.serving" for name in (
        "LLMConfig", "LLMServer", "RequestTimeoutError", "build_engine",
        "build_llm_deployment", "build_openai_app", "build_routed_app")},
    **{name: "ray_tpu_torch.llm.router" for name in (
        "RouterCore", "FleetSupervisor", "LLMRouter", "LocalReplica",
        "ActorReplica", "prefill_with_retry")},
    **{name: "ray_tpu_torch.llm.disagg" for name in (
        "PrefillServer", "KVStreamServer", "HandoffError", "send_handoff")},
    **{name: "ray_tpu_torch.llm.openai_router" for name in (
        "ChatTemplate", "OpenAIRouter", "build_router_app")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'ray_tpu_torch.llm' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
