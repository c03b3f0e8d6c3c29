"""LLM serving: OpenAI-style completions over the port's engine, and the
serve deployment around it.

Port of ray_tpu/llm/serving.py: a background thread drives the engine's
step loop while request threads enqueue prompts and consume per-request
queues, so many requests stream concurrently through one continuously-
batched engine. Requests may name a LoRA adapter (`lora_name`); adapters
load at build (`LLMConfig.lora_adapters`) or at run time
(`load_lora_adapter`), and the slot pool may scale itself
(`lora_autoscale`). Evicted prefix blocks spill to a host tier
(`host_prefix_mb`) whose overflow is published to the cluster prefix
table in the GCS when the port's runtime is up in the server's process
(`cluster_prefix_store`); any server of the cluster adopts from it.
Weights come from `params`, from a manifest-format
checkpoint (`params_checkpoint`) or from `seed`; `tensor_parallel=N`
serves them on N cards as rank 0 of a world whose other ranks hold their
shards (llm/tp.py), and `close()` stops those ranks.

Every server listens for KV handoffs (llm/disagg.py `KVStreamServer`,
on `LLMConfig.handoff_host`): a prefill tier (`disagg.PrefillServer`)
streams prefilled requests to it, and a draining peer migrates its live
sessions to it (`migrate_sessions`) or pushes its hot prefixes
(`push_prefixes`).

Each server publishes its engine_stats() numbers as gauges
(runtime/metric_defs.py, once a second from its loop and on every
engine_stats() call), which `state.llm_serving_summary` rolls up.

`build_llm_deployment` wraps the server in a serve deployment of the
port's runtime (ray_tpu_torch/serve) whose replicas take
`num_gpus_per_replica` cards each, and `build_openai_app` deploys it
behind the HTTP ingress. With routing="affinity" or disaggregate > 0,
`build_routed_app` puts the LLM router deployment (llm/router.py) in
front of the engine tier and, for disaggregate > 0, a tier of
`PrefillServer` replicas.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch import serve
from ray_tpu_torch.llm.disagg import (KVStreamServer, _completion_response,
                                      migrate_session, send_handoff)
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.ops import resolve_device
from ray_tpu_torch.util import tracing

log = logging.getLogger(__name__)


class RequestTimeoutError(TimeoutError):
    """No engine output arrived within LLMConfig.stream_timeout_s. The
    request has been aborted and its KV pages released."""


class ReplicaDrainingError(RuntimeError):
    """This server has stopped admitting (its sessions are being migrated
    out). The request was NOT submitted; route it to a healthy server.
    The message embeds "REPLICA_DRAINING" so routers can classify it
    across boundaries that re-wrap exception types."""

    def __init__(self, tag: str = ""):
        super().__init__(f"REPLICA_DRAINING {tag}: replica is draining; "
                         "resubmit on a healthy replica")


class SessionMigratedError(RuntimeError):
    """The server exported this in-flight request to another server while
    a consumer was collecting it.

    mode "kv": the adopting server already holds the live stream; the
    consumer re-collects there with completions_collect(request_id), zero
    re-prefill. mode "replay": re-submit the same request (same
    request_id) anywhere healthy; seeded sampling reproduces the same
    tokens from the prompt. The message embeds
    "SESSION_MIGRATED <mode> <rid>" so routers can classify the error."""

    def __init__(self, rid: str, mode: str):
        super().__init__(f"SESSION_MIGRATED {mode} {rid}")
        self.rid = rid
        self.mode = mode


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
    # Serve deployment (build_llm_deployment): replicas, and the whole
    # cards each replica's actor takes (the JAX num_tpus_per_replica).
    num_replicas: int = 1
    num_gpus_per_replica: int = 0
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
    # Serving-plane knobs (llm/router.py, llm/disagg.py): routing=
    # "affinity" fronts the replica fleet with the LLM router deployment;
    # slo_ttft_s > 0 arms its admission gate (projected TTFT above the SLO
    # sheds with a 429-shaped error); disaggregate=N runs N prefill
    # replicas that stream populated KV pages to the engine tier.
    routing: str = "pow2"               # "pow2" | "affinity"
    slo_ttft_s: float = 0.0
    disaggregate: int = 0
    stream_timeout_s: float = 300.0
    # Tiered prefix store (llm/prefix_store.py): evicted prefix blocks
    # spill to host RAM and are promoted back at admission (0 MB disables
    # it); past the host tier's watermark they are published to the GCS
    # prefix table, from which any server adopts them. The cluster tier is
    # kept only where the port's runtime is initialized in the server's
    # process; elsewhere it degrades to none, as the JAX server's does.
    host_prefix_mb: float = 32.0
    host_prefix_low_watermark: float = 0.8
    cluster_prefix_store: bool = True
    # Address the server's KV stream listener binds (llm/disagg.py).
    handoff_host: str = "127.0.0.1"
    # Deployment name, stamped by build_llm_deployment (the JAX package
    # keys the fleet's cluster prefix rows with it).
    deployment_name: str = ""
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


def _node_hex() -> Optional[str]:
    """This process's cluster node id (hex) when the port's runtime is
    initialized in it: the key the router maps NODE_DRAINING/NODE_DEAD
    events to replicas with. None outside a cluster."""
    try:
        from ray_tpu_torch.core import worker as worker_mod

        if worker_mod.is_initialized():
            nid = worker_mod.global_worker().node_id
            if isinstance(nid, (bytes, bytearray)):
                return bytes(nid).hex()
            return str(nid) if nid is not None else None
    except Exception:
        pass
    return None


def _cuda_scope(device: torch.device):
    """A factory of contexts that make `device` the calling thread's
    current CUDA device (the current device is per thread); a no-op off
    CUDA."""
    if device.type != "cuda":
        return contextlib.nullcontext
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return lambda: torch.cuda.device(index)


def build_engine(llm_config: LLMConfig, params: Optional[Dict] = None,
                 cuda_graphs: Optional[bool] = None,
                 prefill_only: bool = False):
    """Construct an LLMEngine per config on llm_config.device (raises
    without CUDA unless device="cpu"), warmed per
    llm_config.warmup_buckets. `params` (the port's parameter dict)
    defaults to the checkpoint at llm_config.params_checkpoint, else to
    random weights from llm_config.seed. `cuda_graphs` goes to the
    ModelRunner: None replays the unified step's CUDA graphs (two per
    token bucket) on the card, False runs the step eagerly there (to
    compare the two). With tensor_parallel > 1 the engine's runner is
    rank 0 of a new world of that many ranks: `engine.runner.close()`
    stops them. `prefill_only` builds the prefill tier's engine
    (llm/disagg.py), which captures no unified-tick graph."""
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
            token_budget=llm_config.token_budget,
            prefill_only=prefill_only)
        if warm != "off":
            engine.warmup(full=warm == "full")
    except BaseException:
        runner.close()
        raise
    return engine


class LLMServer:
    """Owns one engine, its step loop thread and its KV stream listener;
    `close()` stops them."""

    def __init__(self, llm_config: LLMConfig, params: Optional[Dict] = None,
                 cuda_graphs: Optional[bool] = None):
        self.engine = build_engine(llm_config, params, cuda_graphs)
        self._scope = _cuda_scope(self.engine.runner.device)
        self._replica_tag = f"{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self.config = llm_config
        self.tokenizer = llm_config.tokenizer
        self._timeout_s = llm_config.stream_timeout_s
        self._lock = threading.Lock()
        # Tiered prefix store: the host spill tier and the cluster table,
        # each optional per config; the cluster tier degrades to None
        # outside a cluster (in-process servers, tests).
        from ray_tpu_torch.llm.prefix_store import (ClusterPrefixStore,
                                                    HostPrefixTier)

        host_tier = cluster_store = None
        if llm_config.host_prefix_mb > 0:
            host_tier = HostPrefixTier(
                int(llm_config.host_prefix_mb * (1 << 20)),
                low_watermark=llm_config.host_prefix_low_watermark)
        if llm_config.cluster_prefix_store:
            store = ClusterPrefixStore(
                llm_config.block_size, replica=self._replica_tag,
                deployment=llm_config.deployment_name)
            if store.available():
                cluster_store = store
        if host_tier is not None or cluster_store is not None:
            self.engine.attach_prefix_store(host_tier=host_tier,
                                            cluster_store=cluster_store)
        # LoRA pool autoscaling: ticked at 1 Hz from the engine loop.
        self._lora_policy = None
        if llm_config.lora_autoscale and self.engine.runner.lora is not None:
            from ray_tpu_torch.llm.lora import (LoRAPoolPolicy,
                                                LoRAPoolPolicyConfig)

            self._lora_policy = LoRAPoolPolicy(LoRAPoolPolicyConfig(
                min_slots=llm_config.lora_min_slots,
                max_slots=llm_config.lora_max_slots))
        self._policy_t0 = time.monotonic()
        # Decode-throughput EWMA published through engine_stats()/gauges.
        self._tokens_per_s = 0.0
        self._tok_count = 0
        self._tok_t0 = time.monotonic()
        self._gauges = self._bind_gauges()
        # request_id -> per-request queue; the loop fans outputs out here.
        self._streams: Dict[str, queue.Queue] = {}
        # KV stream listener, always on: prefill servers stream populated
        # pages here, and draining peers migrate live sessions here (under
        # tensor parallelism this rank-0 server holds it).
        self._handoff = KVStreamServer(self._adopt_handoff,
                                       host=llm_config.handoff_host)
        # Set while this server's sessions are moved out: new submissions
        # raise ReplicaDrainingError until resume_admission.
        self._draining = False
        self._sessions_migrated_out = 0
        self._stop = threading.Event()
        self._loop = threading.Thread(
            target=self._engine_loop, daemon=True,
            name=f"llm-engine-{self._replica_tag}")
        self._loop.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the listener and the engine loop, then the other ranks of
        a tensor-parallel world (none is left behind)."""
        self._handoff.close()
        self._stop.set()
        self._loop.join(timeout)
        self.engine.runner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- engine loop -----------------------------------------------------

    def _bind_gauges(self):
        from ray_tpu_torch.runtime import metric_defs as md

        tags = {"replica": self._replica_tag}
        return {
            "running": md.LLM_RUNNING.bind(tags),
            "waiting": md.LLM_WAITING.bind(tags),
            "prefilling": md.LLM_PREFILLING.bind(tags),
            "free_kv_blocks": md.LLM_KV_FREE_BLOCKS.bind(tags),
            "total_kv_blocks": md.LLM_KV_TOTAL_BLOCKS.bind(tags),
            "prefix_hits": md.LLM_PREFIX_HITS.bind(tags),
            "prefix_tokens_saved": md.LLM_PREFIX_TOKENS_SAVED.bind(tags),
            "tokens_per_s": md.LLM_TOKENS_PER_S.bind(tags),
        }

    def _publish_gauges(self, s: Optional[Dict] = None):
        if s is None:
            with self._lock:
                s = self.engine.stats()
            s["tokens_per_s"] = round(self._tokens_per_s, 1)
        for key, gauge in self._gauges.items():
            gauge.set(s[key])

    def _engine_loop(self):
        with self._scope():
            self._run_loop()

    def _run_loop(self):
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
                self._tok_count += len(out.new_token_ids)
                q = self._streams.get(out.request_id)
                if q is not None:
                    q.put(out)
            now = time.monotonic()
            if now - self._tok_t0 >= 1.0:
                rate = self._tok_count / (now - self._tok_t0)
                self._tokens_per_s = (rate if self._tokens_per_s == 0.0
                                      else 0.7 * self._tokens_per_s
                                      + 0.3 * rate)
                self._tok_count = 0
                self._tok_t0 = now
                try:
                    self._publish_gauges()
                except Exception:
                    log.exception("publishing the server's gauges failed")
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

    def _submit(self, prompt, params, request_id: Optional[str],
                lora_name: Optional[str] = None) -> str:
        # A caller-assigned id seeds sampling (crc32 of the id when no
        # explicit seed is set): a replay under the same id redraws the
        # same tokens.
        if self._draining:
            raise ReplicaDrainingError(self._replica_tag)
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
        """The engine's load signal (what RouterCore and ReplicaPolicy
        read), with the server's decode rate, node, drain and handoff
        counts; the same numbers go to the bound gauges."""
        with self._lock:
            s = self.engine.stats()
        s["tokens_per_s"] = round(self._tokens_per_s, 1)
        s["replica"] = self._replica_tag
        s["draining"] = self._draining
        s["node_id"] = _node_hex()
        s["sessions_migrated_out"] = self._sessions_migrated_out
        s["handoff_address"] = list(self._handoff.address)
        s["handoffs_adopted"] = self._handoff.handoffs_adopted
        s["handoffs_rejected"] = self._handoff.handoffs_rejected
        try:
            self._publish_gauges(s)
        except Exception:
            log.exception("publishing the server's gauges failed")
        return s

    def flight_records(self, limit: Optional[int] = None,
                       request_id: Optional[str] = None) -> List[Dict]:
        """The engine's tick flight recorder (`LLMEngine.tick_records`):
        per tick its kind, batch composition, token budget used, bucket,
        recompile flag and tokens emitted per request, newest last.
        `request_id` keeps the ticks that emitted tokens for it."""
        with self._lock:
            return self.engine.tick_records(limit=limit,
                                            request_id=request_id)

    # ---- KV handoff and live migration (llm/disagg.py wire) -------------

    def handoff_address(self) -> List:
        return list(self._handoff.address)

    def resume_admission(self) -> None:
        """Cancel a drain: admit again. Sessions already migrated out stay
        migrated (their KV lives on the adopting server now)."""
        self._draining = False

    def migrate_sessions(self, target_address, *,
                         timeout: float = 60.0) -> Dict:
        """Live migration: stop admitting, then move every live request to
        `target_address` (another server's KV stream listener).

        Decoding requests travel with their KV pages over the raw-frame
        wire, whole-stream-or-discard, so a target dying mid-adopt leaves
        nothing torn and the request falls back to seeded replay from the
        prompt. Requests still queued or mid-prefill always take the
        replay path. The in-flight split-path steps are harvested first
        (`drain_flights`): their tokens commit, requests that finish there
        complete normally (never delivered twice), and no device write
        can land in an exported page; the gather then runs on this
        thread's current stream, the one the unified tick's replays run
        on, after them. Consumers blocked in completions or
        completions_collect get a SessionMigratedError naming the mode,
        so they re-collect on the target (kv) or re-submit (replay).
        Returns per-mode rid lists."""
        self._draining = True
        migrated: List[str] = []
        replayed: List[str] = []
        finished: List[str] = []
        exports: List[tuple] = []
        with self._lock, self._scope():
            for out in self.engine.drain_flights():
                q = self._streams.get(out.request_id)
                if q is not None:
                    q.put(out)
                if out.finished:
                    finished.append(out.request_id)
            live = ([r.id for r in self.engine.running]
                    + [r.id for r in self.engine.prefilling]
                    + [r.id for r in self.engine.waiting])
            for rid in live:
                state, mode = self.engine.export_session(rid)
                if state is None:
                    continue
                if mode == "kv":
                    blocks = state.pop("blocks")
                    k, v = self.engine.runner.gather_pages(blocks)
                    self.engine.block_manager.release_blocks(blocks)
                    exports.append((rid, state, k, v))
                else:
                    replayed.append(rid)
        # Stream outside the lock: socket time must never hold the engine.
        send_failed: List[str] = []
        kv_dtype = self.engine.runner.kv_dtype_name
        for rid, state, k, v in exports:
            # The pause runs from the export (decode stopped for this
            # request then) to the target's ack.
            t_pause0 = (state.get("timing") or {}).get("t_handoff",
                                                       time.time())
            try:
                with tracing.trace_context(tracing.request_trace_id(rid),
                                           None):
                    migrate_session(target_address, state, k, v,
                                    kv_dtype=kv_dtype, timeout=timeout)
                    tracing.record_span(
                        "llm:migration_pause", "llm", t_pause0, time.time(),
                        request_id=rid, source=self._replica_tag, mode="kv")
                migrated.append(rid)
                self.engine.flight_records.append({
                    "t": t_pause0, "kind": "migration_pause",
                    "dur_ms": round((time.time() - t_pause0) * 1e3, 3),
                    "emitted": {}, "request_id": rid})
            except Exception:
                # Nothing is half-adopted; but a timeout with a LOST ack may
                # leave the session adopted on the target while it replays
                # here: reported, so the caller can abort it there.
                send_failed.append(rid)
                replayed.append(rid)
        for rid in migrated:
            q = self._streams.get(rid)
            if q is not None:
                q.put(SessionMigratedError(rid, "kv"))
        for rid in replayed:
            q = self._streams.get(rid)
            if q is not None:
                q.put(SessionMigratedError(rid, "replay"))
        self._sessions_migrated_out += len(migrated)
        return {"migrated": migrated, "replayed": replayed,
                "send_failed": send_failed, "finished": finished,
                "replica": self._replica_tag}

    def push_prefixes(self, target_address, *, limit: int = 16,
                      timeout: float = 60.0) -> Dict:
        """Stream the hottest reusable prefix pages (parked device blocks
        first, then the host tier) to `target_address`, another server's
        KV stream listener, so a drain's successor starts warm. A failed
        send costs nothing (the pages were spill candidates anyway)."""
        with self._lock, self._scope():
            export = self.engine.export_prefixes(limit=limit)
        if export is None:
            return {"pushed": 0, "replica": self._replica_tag}
        state, k, v = export
        try:
            send_handoff(target_address, state, k, v,
                         kv_dtype=self.engine.runner.kv_dtype_name,
                         timeout=timeout)
        except Exception:
            return {"pushed": 0, "replica": self._replica_tag,
                    "error": "send_failed"}
        return {"pushed": len(state["entries"]),
                "replica": self._replica_tag}

    def _adopt_handoff(self, state: Dict, k_pages, v_pages) -> bool:
        """The listener's adopt function, on its connection thread, under
        the engine lock: the pages are scattered on this thread's current
        stream, the one the unified tick's replays run on, so the next
        replay reads them; nothing is captured."""
        if state.get("prefix"):
            # A prefix push: cached pages, no live session, no consumer.
            with self._lock, self._scope():
                return self.engine.adopt_prefix(state, k_pages, v_pages) > 0
        # The stream queue exists BEFORE the request can decode (the loop
        # drops outputs with no queue), and the ack goes back only after
        # adopt_request returns, so completions_collect finds both.
        rid = state["id"]
        self._streams[rid] = queue.Queue()
        with self._lock, self._scope():
            ok = self.engine.adopt_request(state, k_pages, v_pages)
        if not ok:
            self._streams.pop(rid, None)
        return ok

    # ---- API -------------------------------------------------------------

    def __call__(self, request: Dict) -> Dict:
        return self.completions(request)

    def completions(self, request: Dict) -> Dict:
        """OpenAI-ish /v1/completions: {"prompt": str|[int], "max_tokens",
        "temperature", "top_k", "top_p", "stop_token_ids",
        "repetition_penalty", "seed", "request_id", "lora_name"}."""
        prompt, params, rid, lora_name = self._parse(request)
        rid = self._submit(prompt, params, rid, lora_name)
        return self._collect(rid)

    def completions_collect(self, request_id: str) -> Dict:
        """Wait out a request this server adopted (a prefill tier's
        handoff, or a migrated session) and return its completion."""
        self._known(request_id)
        return self._collect(request_id)

    def completions_collect_stream(self, request_id: str):
        """completions_collect as completions_stream's events: one per
        token decoded here after the adoption, then the final event with
        every token (those decoded before the handoff included)."""
        self._known(request_id)
        return self._events(request_id)

    def _known(self, request_id: str) -> None:
        if request_id not in self._streams:
            raise KeyError(f"unknown request {request_id!r} "
                           "(handoff not adopted here?)")

    def _collect(self, rid: str) -> Dict:
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
        return self._events(rid)

    def _events(self, rid: str):
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


def build_llm_deployment(llm_config: LLMConfig, name: str = "llm") -> Any:
    """A serve deployment of LLMServer bound to `llm_config`: its
    num_replicas replicas each take num_gpus_per_replica cards and up to
    max_batch_size concurrent requests."""
    if llm_config.deployment_name != name:
        llm_config = dataclasses.replace(llm_config, deployment_name=name)
    dep = serve.deployment(LLMServer).options(
        name=name, num_replicas=llm_config.num_replicas,
        num_gpus=llm_config.num_gpus_per_replica,
        max_ongoing_requests=llm_config.max_batch_size)
    return dep.bind(llm_config)


def build_routed_app(llm_config: LLMConfig, name: str = "v1-completions",
                     *, http: bool = True):
    """Deploys the whole serving plane: `{name}-engine` (decode or
    colocated replicas), `{name}-prefill` when disaggregate > 0 (that many
    PrefillServer replicas of num_gpus_per_replica cards each), and the
    `{name}` router deployment (llm/router.py LLMRouter) in front of them.
    Returns the router's handle."""
    from ray_tpu_torch.llm.disagg import PrefillServer
    from ray_tpu_torch.llm.router import LLMRouter

    tiers = [build_llm_deployment(llm_config, f"{name}-engine")]
    prefill_name = None
    if llm_config.disaggregate > 0:
        prefill_name = f"{name}-prefill"
        tiers.append(serve.deployment(PrefillServer).options(
            name=prefill_name, num_replicas=llm_config.disaggregate,
            num_gpus=llm_config.num_gpus_per_replica,
            max_ongoing_requests=llm_config.max_batch_size,
        ).bind(llm_config))
    # Tiers first: the router resolves their replica handles lazily on the
    # first request, and they must already be deployed by then.
    serve.run(tiers)
    router = serve.deployment(LLMRouter).options(
        name=name, num_replicas=1,
        max_ongoing_requests=8 * llm_config.max_batch_size,
    ).bind(llm_config, f"{name}-engine", prefill_name)
    return serve.run(router, http=http)


def build_openai_app(llm_config: LLMConfig, name: str = "v1-completions"):
    """Deploys the engine and the HTTP ingress; POST /{name} serves
    completions. With routing="affinity" or disaggregate > 0 the app gets
    the router front (build_routed_app) instead of a bare replica fleet."""
    if llm_config.routing == "affinity" or llm_config.disaggregate > 0:
        return build_routed_app(llm_config, name)
    return serve.run(build_llm_deployment(llm_config, name), http=True)
