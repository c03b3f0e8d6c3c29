"""OpenAI-compatible API router over the port's LLM engine deployments.

The port's copy of ray_tpu/llm/openai_router.py (reference analog:
python/ray/llm/_internal/serve/deployments/routers/, the OpenAI-compatible
ingress in front of the engine deployment). A serve deployment that
composes with the engine deployment through a DeploymentHandle, adding:

  * /v1/chat/completions semantics: a chat template renders messages to
    prompt tokens; usage accounting and OpenAI-shaped responses.
  * /v1/completions passthrough.
  * /v1/models listing (one entry per registered model id).
  * `model` routing: requests name a model id; "base:adapter" ids route
    to the base engine with lora_name=adapter (llm/lora.py); unknown ids
    get a 404-shaped error dict.

The router is stateless (templates + handle cache only), so it scales with
num_replicas independently of the engine replicas. It imports no torch.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch import serve


class ChatTemplate:
    """Minimal llama-3-style chat template over a token-level tokenizer.

    render(messages) -> token ids. The tokenizer needs encode(str)->[int];
    special role markers are encoded inline (a real deployment would use
    reserved special tokens; token-level fidelity is not required for
    routing correctness, which is what this layer owns)."""

    def __init__(self, tokenizer, *, system_default: Optional[str] = None):
        self.tokenizer = tokenizer
        self.system_default = system_default

    def render(self, messages: List[Dict[str, str]]) -> List[int]:
        parts = []
        if self.system_default and not any(
                m.get("role") == "system" for m in messages):
            parts.append(("system", self.system_default))
        for m in messages:
            parts.append((m.get("role", "user"), m.get("content", "")))
        text = ""
        for role, content in parts:
            text += f"<|{role}|>\n{content}\n<|end|>\n"
        text += "<|assistant|>\n"
        return self.tokenizer.encode(text)


class OpenAIRouter:
    """The router replica. Init args: engine deployment name -> model id map
    and an optional tokenizer/template for chat rendering."""

    def __init__(self, models: Dict[str, str], tokenizer=None,
                 chat_template: Optional[ChatTemplate] = None):
        """models: model_id -> engine deployment name. Adapter ids use
        "base_id:adapter_name" and route to the base engine with
        lora_name=adapter_name."""
        self.models = dict(models)
        self.tokenizer = tokenizer
        self.template = chat_template or (
            ChatTemplate(tokenizer) if tokenizer is not None else None)
        self._handles: Dict[str, Any] = {}
        self.created = int(time.time())

    def _resolve(self, model_id: Optional[str]):
        """-> (engine handle, lora_name | None) or an error dict."""
        if model_id is None and len(self.models) == 1:
            model_id = next(iter(self.models))
        lora = None
        target = self.models.get(model_id)
        if target is None and model_id and ":" in model_id:
            base, lora = model_id.split(":", 1)
            target = self.models.get(base)
        if target is None:
            return None, None, {
                "error": {"message": f"model {model_id!r} not found",
                          "type": "invalid_request_error", "code": 404}}
        if target not in self._handles:
            self._handles[target] = serve.get_deployment_handle(target)
        return self._handles[target], lora, None

    # ---- endpoints -------------------------------------------------------

    def models_list(self, _request=None) -> Dict:
        """GET /v1/models."""
        return {"object": "list", "data": [
            {"id": mid, "object": "model", "created": self.created,
             "owned_by": "ray_tpu_torch"} for mid in sorted(self.models)]}

    def completions(self, request: Dict) -> Dict:
        handle, lora, err = self._resolve(request.get("model"))
        if err:
            return err
        req = dict(request)
        if lora:
            req["lora_name"] = lora
        out = handle.options("completions").remote(req).result(timeout=600)
        out["model"] = request.get("model")
        return out

    def chat_completions(self, request: Dict) -> Dict:
        """POST /v1/chat/completions: renders messages through the chat
        template, generates, wraps in chat shape."""
        handle, lora, err = self._resolve(request.get("model"))
        if err:
            return err
        messages = request.get("messages", [])
        if self.template is None:
            return {"error": {"message": "no chat template configured",
                              "type": "invalid_request_error", "code": 400}}
        prompt = self.template.render(messages)
        req = {k: v for k, v in request.items()
               if k in ("max_tokens", "temperature", "top_k", "top_p",
                        "stop_token_ids", "seed")}
        req["prompt"] = prompt
        if lora:
            req["lora_name"] = lora
        out = handle.options("completions").remote(req).result(timeout=600)
        if "error" in out:
            return out
        choice = out["choices"][0]
        text = choice.get("text")
        if text is None and self.tokenizer is not None:
            try:
                text = self.tokenizer.decode(choice.get("token_ids", []))
            except Exception:
                text = None
        return {
            "id": "chatcmpl-" + uuid.uuid4().hex[:12],
            "object": "chat.completion",
            "created": int(time.time()),
            "model": request.get("model"),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text,
                            "token_ids": choice.get("token_ids")},
                "finish_reason": choice.get("finish_reason"),
            }],
            "usage": out.get("usage", {}),
        }

    def chat_completions_stream(self, request: Dict):
        """Streaming chat: a generator of chat.completion.chunk events
        (consumed via handle.options(...).remote_stream or the HTTP proxy's
        SSE path)."""
        handle, lora, err = self._resolve(request.get("model"))
        if err:
            yield err
            return
        if self.template is None:
            yield {"error": {"message": "no chat template configured",
                             "type": "invalid_request_error", "code": 400}}
            return
        prompt = self.template.render(request.get("messages", []))
        req = {k: v for k, v in request.items()
               if k in ("max_tokens", "temperature", "top_k", "top_p",
                        "stop_token_ids", "seed")}
        req["prompt"] = prompt
        if lora:
            req["lora_name"] = lora
        cid = "chatcmpl-" + uuid.uuid4().hex[:12]
        for ref in handle.options("completions_stream").remote_stream(req):
            chunk = rt.get(ref, timeout=600)
            if chunk.get("finished"):
                text = chunk.get("text")
                if text is None and self.tokenizer is not None:
                    try:
                        text = self.tokenizer.decode(
                            chunk.get("token_ids", []))
                    except Exception:
                        text = None
                yield {"id": cid, "object": "chat.completion.chunk",
                       "choices": [{"index": 0, "delta": {},
                                    "finish_reason":
                                        chunk.get("finish_reason")}],
                       "text": text}
                return
            delta: Dict[str, Any] = {"token": chunk.get("token")}
            if self.tokenizer is not None and chunk.get("token") is not None:
                try:
                    delta["content"] = self.tokenizer.decode(
                        [chunk["token"]])
                except Exception:
                    pass
            yield {"id": cid, "object": "chat.completion.chunk",
                   "choices": [{"index": 0, "delta": delta,
                                "finish_reason": None}]}

    def __call__(self, request: Dict) -> Dict:
        """Default POST target: dispatch on an `endpoint` field (the HTTP
        proxy posts the parsed JSON body)."""
        endpoint = (request or {}).get("endpoint", "chat/completions")
        if endpoint == "models":
            return self.models_list()
        if endpoint == "completions":
            return self.completions(request)
        return self.chat_completions(request)


def build_router_app(models: Dict[str, str], *, tokenizer=None,
                     name: str = "openai", num_replicas: int = 1):
    """Deploy an OpenAIRouter in front of already-deployed engine
    deployments. Returns the router handle."""
    dep = serve.deployment(OpenAIRouter).options(
        name=name, num_replicas=num_replicas)
    return serve.run(dep.bind(models, tokenizer))
