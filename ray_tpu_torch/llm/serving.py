"""In-process LLM serving: OpenAI-style completions over the port's engine.

Port of the replica side of ray_tpu/llm/serving.py: a background thread
drives the engine's step loop while request threads enqueue prompts and
consume per-request queues, so many requests stream concurrently through
one continuously-batched engine. Requests may name a LoRA adapter
(`lora_name`); adapters load at build (`LLMConfig.lora_adapters`) or at
run time (`load_lora_adapter`), and the slot pool may scale itself
(`lora_autoscale`). Evicted prefix blocks spill to a host tier
(`host_prefix_mb`). Weights come from `params`, from a manifest-format
checkpoint (`params_checkpoint`) or from `seed`; `tensor_parallel=N`
serves them on N cards as rank 0 of a world whose other ranks hold their
shards (llm/tp.py), and `close()` stops those ranks. The cluster
deployment, router, disagg tiers, the cluster prefix tier and migration
are later slices.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch.llm.engine import _unported
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.ops import resolve_device

log = logging.getLogger(__name__)


class RequestTimeoutError(TimeoutError):
    """No engine output arrived within LLMConfig.stream_timeout_s. The
    request has been aborted and its KV pages released."""


@dataclasses.dataclass
class LLMConfig:
    model_config: Any = None            # llama.LlamaConfig
    # Directory of a manifest-format checkpoint (ray_tpu_torch/checkpoint,
    # or the JAX package's): a parameter tree, or a train state whose
    # "params" it holds. None: random weights from `seed`.
    params_checkpoint: Optional[str] = None
    seed: int = 0
    # Cards of the in-replica tensor-parallel world (llm/tp.py); more than
    # the machine has raises.
    tensor_parallel: int = 1
    num_kv_blocks: int = 256
    block_size: int = 16
    max_batch_size: int = 8
    prefill_chunk: int = 128
    tokenizer: Any = None
    # Multi-LoRA (llm/lora.py): preloaded adapters and the slot table's
    # size; the pool scales itself off engine stats with lora_autoscale.
    lora_adapters: Any = None           # list[LoRAAdapter] | None
    max_loras: int = 8
    lora_rank: int = 8
    lora_autoscale: bool = False
    lora_min_slots: int = 1
    lora_max_slots: int = 32
    enable_prefix_caching: bool = True
    speculative_ngram: int = 0
    decode_multi_step: int = 1
    unified_ticks: bool = True
    token_budget: Optional[int] = None
    # Step buckets run once at build, so no request pays a first use:
    # "full" = the whole batch x chunk grid incl. the host-logits step,
    # "light" = the sequential-traffic set, "off" = none.
    warmup_buckets: str = "full"
    stream_timeout_s: float = 300.0
    # Host prefix tier (llm/prefix_store.py): evicted prefix blocks spill
    # to host RAM and are promoted back at admission; 0 disables it. The
    # cluster tier needs an actor runtime: outside a cluster the JAX
    # server leaves it off too, and here it stays off.
    host_prefix_mb: float = 32.0
    host_prefix_low_watermark: float = 0.8
    cluster_prefix_store: bool = True
    device: Any = "cuda"


def _runner(llm_config: LLMConfig, config, device, params, cuda_graphs):
    """The engine's ModelRunner: on this device alone, or as rank 0 of a
    new tensor-parallel world of llm_config.tensor_parallel ranks, which
    the runner's close() stops."""
    from ray_tpu_torch.llm import tp as tp_mod
    from ray_tpu_torch.llm.lora import TARGETS
    from ray_tpu_torch.llm.model_runner import ModelRunner
    from ray_tpu_torch.models import llama

    n = llm_config.tensor_parallel
    lora = ((llm_config.max_loras, llm_config.lora_rank, TARGETS)
            if llm_config.lora_adapters else None)
    if params is not None:
        source = ("broadcast",)
    elif llm_config.params_checkpoint:
        source = ("checkpoint", llm_config.params_checkpoint)
    else:
        source = ("seed", llm_config.seed)
    if n > 1:
        from ray_tpu_torch.llm.model_runner import check_tensor_parallel

        check_tensor_parallel(config, n)
        spec = dict(config=config, num_blocks=llm_config.num_kv_blocks,
                    block_size=llm_config.block_size,
                    chunk_size=llm_config.prefill_chunk,
                    cuda_graphs=cuda_graphs, lora=lora, source=source)
        world = tp_mod.start_world(n, device)
        try:
            runner = tp_mod.build_runner(spec, world, device, params)
        except BaseException:
            tp_mod.stop_world(world)
            raise
        runner.on_close = lambda: tp_mod.stop_world(world)
        return runner
    if source[0] == "checkpoint":
        params = tp_mod.local_params(source, config, None, device)
    elif source[0] == "seed":
        gen = torch.Generator(device=device).manual_seed(llm_config.seed)
        params = llama.init_params(config, gen, device)
    lora_manager = None
    if lora is not None:
        from ray_tpu_torch.llm.lora import LoRAManager

        lora_manager = LoRAManager(config, n_slots=lora[0], rank=lora[1],
                                   device=device)
    return ModelRunner(config, params, num_blocks=llm_config.num_kv_blocks,
                       block_size=llm_config.block_size,
                       chunk_size=llm_config.prefill_chunk, device=device,
                       cuda_graphs=cuda_graphs, lora_manager=lora_manager)


def build_engine(llm_config: LLMConfig, params: Optional[Dict] = None,
                 cuda_graphs: Optional[bool] = None):
    """Construct an LLMEngine per config on llm_config.device (raises
    without CUDA unless device="cpu"), warmed per
    llm_config.warmup_buckets. `params` (the port's parameter dict)
    defaults to the checkpoint at llm_config.params_checkpoint, else to
    random weights from llm_config.seed. `cuda_graphs` goes to the
    ModelRunner: None replays the unified step's CUDA graphs (two per
    token bucket) on the card, False runs the step eagerly there (to
    compare the two). With tensor_parallel > 1 the engine's runner is
    rank 0 of a new world of that many ranks: `engine.runner.close()`
    stops them."""
    from ray_tpu_torch.llm.engine import LLMEngine
    from ray_tpu_torch.models import llama

    warm = llm_config.warmup_buckets
    if warm not in ("off", "light", "full"):
        raise ValueError(f"warmup_buckets: {warm!r} not off/light/full")
    device = resolve_device(llm_config.device)
    config = llm_config.model_config or llama.LlamaConfig.tiny()
    runner = _runner(llm_config, config, device, params, cuda_graphs)
    try:
        for adapter in llm_config.lora_adapters or ():
            runner.lora.load_adapter(adapter)
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
    except BaseException:
        runner.close()
        raise
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

    def __init__(self, llm_config: LLMConfig, params: Optional[Dict] = None,
                 cuda_graphs: Optional[bool] = None):
        self.engine = build_engine(llm_config, params, cuda_graphs)
        dev = self.engine.runner.device
        self._cuda_index = (None if dev.type != "cuda" else dev.index
                            if dev.index is not None
                            else torch.cuda.current_device())
        self.config = llm_config
        self.tokenizer = llm_config.tokenizer
        self._timeout_s = llm_config.stream_timeout_s
        self._lock = threading.Lock()
        if llm_config.host_prefix_mb > 0:
            from ray_tpu_torch.llm.prefix_store import HostPrefixTier

            self.engine.attach_prefix_store(host_tier=HostPrefixTier(
                int(llm_config.host_prefix_mb * (1 << 20)),
                low_watermark=llm_config.host_prefix_low_watermark))
        # LoRA pool autoscaling: ticked at 1 Hz from the engine loop.
        self._lora_policy = None
        if llm_config.lora_autoscale and self.engine.runner.lora is not None:
            from ray_tpu_torch.llm.lora import (LoRAPoolPolicy,
                                                LoRAPoolPolicyConfig)

            self._lora_policy = LoRAPoolPolicy(LoRAPoolPolicyConfig(
                min_slots=llm_config.lora_min_slots,
                max_slots=llm_config.lora_max_slots))
        self._policy_t0 = time.monotonic()
        # request_id -> per-request queue; the loop fans outputs out here.
        self._streams: Dict[str, queue.Queue] = {}
        self._stop = threading.Event()
        self._loop = threading.Thread(
            target=self._engine_loop, daemon=True,
            name=f"llm-engine-{uuid.uuid4().hex[:6]}")
        self._loop.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the engine loop, then the other ranks of a tensor-parallel
        world (none is left behind)."""
        self._stop.set()
        self._loop.join(timeout)
        self.engine.runner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- engine loop -----------------------------------------------------

    def _engine_loop(self):
        # The current CUDA device is per thread: the loop takes the one
        # the server was built on.
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while not self._stop.is_set():
            now = time.monotonic()
            if self._lora_policy is not None and now - self._policy_t0 >= 1:
                self._policy_t0 = now
                try:
                    self._lora_pool_tick(now)
                except Exception:
                    log.exception("LoRA pool tick failed")
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

    def _lora_pool_tick(self, now: float) -> None:
        """LoRA pool autoscale: LoRAPoolPolicy reads the engine stats and,
        when the watermarks say so, resizes the slot table under the
        engine lock (between ticks; the next tick recaptures)."""
        mgr = self.engine.runner.lora
        with self._lock:
            target = self._lora_policy.desired(self.engine.stats(), now)
            if target is not None and target != mgr.n_slots - 1:
                mgr.resize(target)

    def load_lora_adapter(self, adapter) -> Dict:
        """Install a LoRAAdapter at run time (LRU-evicting when full),
        under the engine lock: between ticks, on the stream the replays
        use, so the next tick reads it with no recapture."""
        if self.engine.runner.lora is None:
            raise ValueError("server built without LoRA support "
                             "(set LLMConfig.lora_adapters)")
        with self._lock:
            slot = self.engine.runner.lora.load_adapter(adapter)
        return {"name": adapter.name, "slot": slot}

    def list_lora_adapters(self) -> Dict:
        mgr = self.engine.runner.lora
        return {"adapters": mgr.loaded if mgr is not None else []}

    def completions_collect(self, request_id: str) -> Dict:
        """The decode side of disaggregated serving: needs the KV stream
        wire between replicas (an actor runtime), a later slice."""
        raise _unported("disaggregated serving (completions_collect)")

    def migrate_sessions(self, *args, **kwargs) -> Dict:
        """Live session migration to another replica: needs the KV stream
        wire between replicas (an actor runtime), a later slice."""
        raise _unported("live session migration (migrate_sessions)")

    def _submit(self, prompt, params, request_id: Optional[str],
                lora_name: Optional[str] = None) -> str:
        # A caller-assigned id seeds sampling (crc32 of the id when no
        # explicit seed is set): a replay under the same id redraws the
        # same tokens.
        rid = request_id or uuid.uuid4().hex[:12]
        q: queue.Queue = queue.Queue()
        self._streams[rid] = q
        try:
            with self._lock:
                self.engine.add_request(prompt, params, request_id=rid,
                                        lora_name=lora_name)
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
        params = SamplingParams(
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 1.0)),
            max_tokens=int(request.get("max_tokens", 32)),
            stop_token_ids=request.get("stop_token_ids"),
            repetition_penalty=float(request.get("repetition_penalty", 1.0)),
            seed=request.get("seed"))
        return (prompt, params, request.get("request_id"),
                request.get("lora_name"))

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

    def flight_records(self, limit: Optional[int] = None,
                       request_id: Optional[str] = None) -> List[Dict]:
        """The engine's tick flight recorder (`LLMEngine.tick_records`):
        per tick its kind, batch composition, token budget used, bucket,
        recompile flag and tokens emitted per request, newest last.
        `request_id` keeps the ticks that emitted tokens for it."""
        with self._lock:
            return self.engine.tick_records(limit=limit,
                                            request_id=request_id)

    # ---- API -------------------------------------------------------------

    def completions(self, request: Dict) -> Dict:
        """OpenAI-ish /v1/completions: {"prompt": str|[int], "max_tokens",
        "temperature", "top_k", "top_p", "stop_token_ids",
        "repetition_penalty", "seed", "request_id", "lora_name"}."""
        prompt, params, rid, lora_name = self._parse(request)
        rid = self._submit(prompt, params, rid, lora_name)
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
        prompt, params, rid, lora_name = self._parse(request)
        rid = self._submit(prompt, params, rid, lora_name)
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
