"""In-process LLM serving: OpenAI-style completions over the port's engine.

Port of the replica side of ray_tpu/llm/serving.py: a background thread
drives the engine's step loop while request threads enqueue prompts and
consume per-request queues, so many requests stream concurrently through
one continuously-batched engine. The cluster deployment, router, disagg
tiers, prefix-store tiers, LoRA and migration are later slices; the
engine refuses their options with a ValueError.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
import uuid
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.ops import resolve_device

log = logging.getLogger(__name__)


class RequestTimeoutError(TimeoutError):
    """No engine output arrived within LLMConfig.stream_timeout_s. The
    request has been aborted and its KV pages released."""


@dataclasses.dataclass
class LLMConfig:
    model_config: Any = None            # llama.LlamaConfig
    seed: int = 0
    num_kv_blocks: int = 256
    block_size: int = 16
    max_batch_size: int = 8
    prefill_chunk: int = 128
    tokenizer: Any = None
    enable_prefix_caching: bool = True
    # Engine paths, as in the JAX package: speculative_ngram > 0 runs on
    # the split path only (the engine refuses it with unified_ticks=True
    # and decode_multi_step=1).
    speculative_ngram: int = 0
    decode_multi_step: int = 1
    unified_ticks: bool = True
    token_budget: Optional[int] = None
    # Step buckets run once at build, so no request pays a first use:
    # "full" = the whole batch x chunk grid incl. the host-logits step,
    # "light" = the sequential-traffic set, "off" = none.
    warmup_buckets: str = "full"
    stream_timeout_s: float = 300.0
    device: Any = "cuda"


def build_engine(llm_config: LLMConfig, params: Optional[Dict] = None):
    """Construct an LLMEngine per config on llm_config.device (raises
    without CUDA unless device="cpu"), warmed per
    llm_config.warmup_buckets. `params` (the port's parameter dict)
    defaults to random weights from llm_config.seed."""
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.llm.model_runner import ModelRunner
    from ray_tpu_torch.models import llama

    warm = llm_config.warmup_buckets
    if warm not in ("off", "light", "full"):
        raise ValueError(f"warmup_buckets: {warm!r} not off/light/full")
    device = resolve_device(llm_config.device)
    config = llm_config.model_config or llama.LlamaConfig.tiny()
    if params is None:
        gen = torch.Generator(device=device).manual_seed(llm_config.seed)
        params = llama.init_params(config, gen, device)
    runner = ModelRunner(config, params,
                         num_blocks=llm_config.num_kv_blocks,
                         block_size=llm_config.block_size,
                         chunk_size=llm_config.prefill_chunk,
                         device=device)
    engine = LLMEngine(
        runner, max_batch_size=llm_config.max_batch_size,
        tokenizer=llm_config.tokenizer,
        prefill_chunk=llm_config.prefill_chunk,
        enable_prefix_caching=llm_config.enable_prefix_caching,
        speculative_ngram=llm_config.speculative_ngram,
        decode_multi_step=llm_config.decode_multi_step,
        unified_ticks=llm_config.unified_ticks,
        token_budget=llm_config.token_budget)
    if warm != "off":
        engine.warmup(full=warm == "full")
    return engine


def _completion_response(out) -> Dict:
    """OpenAI-ish completion body from a finished RequestOutput."""
    return {
        "id": out.request_id,
        "object": "text_completion",
        "choices": [{
            "text": out.text,
            "token_ids": out.output_token_ids,
            "finish_reason": out.finish_reason,
        }],
        "usage": {
            "prompt_tokens": len(out.prompt_token_ids),
            "completion_tokens": len(out.output_token_ids),
        },
    }


class LLMServer:
    """Owns one engine and its step loop thread; `close()` stops it."""

    def __init__(self, llm_config: LLMConfig, params: Optional[Dict] = None):
        self.engine = build_engine(llm_config, params)
        self.config = llm_config
        self.tokenizer = llm_config.tokenizer
        self._timeout_s = llm_config.stream_timeout_s
        self._lock = threading.Lock()
        # request_id -> per-request queue; the loop fans outputs out here.
        self._streams: Dict[str, queue.Queue] = {}
        self._stop = threading.Event()
        self._loop = threading.Thread(
            target=self._engine_loop, daemon=True,
            name=f"llm-engine-{uuid.uuid4().hex[:6]}")
        self._loop.start()

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._loop.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- engine loop -----------------------------------------------------

    def _engine_loop(self):
        while not self._stop.is_set():
            try:
                with self._lock:
                    busy = self.engine.has_unfinished()
                    outs = self.engine.step() if busy else []
            except Exception as e:
                # A failed step must not strand every request: fail all
                # waiters and reset the scheduler to a clean state.
                log.exception("engine step failed; failing active requests")
                with self._lock:
                    self.engine.reset()
                for q in list(self._streams.values()):
                    q.put(e)
                continue
            for out in outs:
                q = self._streams.get(out.request_id)
                if q is not None:
                    q.put(out)
            if not busy:
                time.sleep(0.002)

    def _submit(self, prompt, params, request_id: Optional[str]) -> str:
        # A caller-assigned id seeds sampling (crc32 of the id when no
        # explicit seed is set): a replay under the same id redraws the
        # same tokens.
        rid = request_id or uuid.uuid4().hex[:12]
        q: queue.Queue = queue.Queue()
        self._streams[rid] = q
        try:
            with self._lock:
                self.engine.add_request(prompt, params, request_id=rid)
        except Exception:
            self._streams.pop(rid, None)
            raise
        return rid

    def _parse(self, request: Dict):
        prompt = request.get("prompt", [])
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompts require a tokenizer")
            prompt = self.tokenizer.encode(prompt)
        if request.get("lora_name"):
            raise ValueError("LoRA is not ported to ray_tpu_torch yet")
        params = SamplingParams(
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 1.0)),
            max_tokens=int(request.get("max_tokens", 32)),
            stop_token_ids=request.get("stop_token_ids"),
            repetition_penalty=float(request.get("repetition_penalty", 1.0)),
            seed=request.get("seed"))
        return prompt, params, request.get("request_id")

    def _next(self, rid: str, q: queue.Queue):
        try:
            out = q.get(timeout=self._timeout_s)
        except queue.Empty:
            self.abort(rid)
            raise RequestTimeoutError(
                f"request {rid}: no engine output within "
                f"{self._timeout_s}s; request aborted") from None
        if isinstance(out, Exception):
            raise out
        return out

    def abort(self, rid: str) -> bool:
        """Stop decoding for a dead consumer and free its KV pages."""
        with self._lock:
            aborted = self.engine.abort_request(rid)
        self._streams.pop(rid, None)
        return aborted

    def engine_stats(self) -> Dict:
        with self._lock:
            return self.engine.stats()

    # ---- API -------------------------------------------------------------

    def completions(self, request: Dict) -> Dict:
        """OpenAI-ish /v1/completions: {"prompt": str|[int], "max_tokens",
        "temperature", "top_k", "top_p", "stop_token_ids",
        "repetition_penalty", "seed", "request_id"}."""
        prompt, params, rid = self._parse(request)
        rid = self._submit(prompt, params, rid)
        q = self._streams[rid]
        try:
            while True:
                out = self._next(rid, q)
                if out.finished:
                    return _completion_response(out)
        finally:
            self._streams.pop(rid, None)

    def completions_stream(self, request: Dict):
        """Streaming completions: a generator of OpenAI-style chunk events,
        one per sampled token, then a final event with the whole output."""
        prompt, params, rid = self._parse(request)
        rid = self._submit(prompt, params, rid)
        q = self._streams[rid]
        finished = False
        try:
            while True:
                out = self._next(rid, q)
                for t in out.new_token_ids:
                    yield {"id": rid, "object": "text_completion.chunk",
                           "token": int(t), "finished": False}
                if out.finished:
                    finished = True
                    yield {"id": rid, "object": "text_completion.chunk",
                           "token": None, "finished": True,
                           "finish_reason": out.finish_reason,
                           "text": out.text,
                           "token_ids": out.output_token_ids}
                    return
        finally:
            # Timeout, engine error or a consumer that went away: an
            # unfinished request must not keep decoding for nobody.
            if not finished:
                self.abort(rid)
            self._streams.pop(rid, None)
