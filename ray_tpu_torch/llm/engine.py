"""LLM engine: continuous batching over a paged KV cache.

Port of ray_tpu/llm/engine.py:

  * BlockManager — host-side page allocator for the KV pool (free list,
    per-sequence block tables, automatic prefix caching).
  * LLMEngine — add_request / step / generate / stream / abort_request.
    A step() is either ONE unified mixed batch (decode rows first, then
    prefill chunk slices from the remaining token budget, through
    ModelRunner.step_mixed), or the split phases: a rectangular prefill
    chunk step, then a decode tick. The split decode is an async pipeline
    of up to `pipeline_depth` steps in flight, each chaining its input
    tokens from the previous one on the device; it runs k tokens per
    dispatch with `decode_multi_step`, greedy n-gram speculation with
    `speculative_ngram`, and host sampling from full logits for requests
    with a repetition penalty. `_use_unified` picks the path per step, as
    in the JAX engine. Preemption (pages exhausted) evicts the newest
    sequence and re-admits it later by recomputing prompt + generated
    tokens.

Speculation on the unified tick, prefill-only tiers, LoRA, the
prefix-store tiers, weight updates and export/adopt/migration are later
slices: the engine refuses them with a ValueError instead of computing
something else.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import uuid
import zlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.llm.model_runner import HostCopy, _bucket, token_buckets
from ray_tpu_torch.llm.sampling import SamplingParams, sample

# Per-process key for the prefix-cache digest chain: unpredictable to
# clients, so cache addresses can't be forged across tenants.
_PREFIX_CACHE_SALT = os.urandom(16)

# Split decode steps kept in flight (the JAX package's llm_pipeline_depth).
PIPELINE_DEPTH = 4


def _unported(feature: str) -> ValueError:
    return ValueError(f"{feature} is not ported to ray_tpu_torch yet "
                      "(ROADMAP.md lists it as a later slice)")


def prefix_digest_chain(prompt: Sequence[int], block_size: int, *,
                        salt: Optional[bytes] = None,
                        seed: bytes = b"") -> List[bytes]:
    """Keyed rolling digest per FULL block of `prompt` (position-and-content
    chain, so identical blocks at different depths never collide). blake2b
    keyed with a random salt, not builtin hash(), so a client cannot forge
    a block whose digest collides with another user's cached block."""
    out: List[bytes] = []
    h = b"prefix-chain"
    key = _PREFIX_CACHE_SALT if salt is None else salt
    n_blocks = len(prompt) // block_size
    flat = np.asarray(prompt[:n_blocks * block_size], dtype="<i8")
    for i in range(n_blocks):
        m = hashlib.blake2b(key=key, digest_size=16)
        m.update(h)
        m.update(seed)
        m.update(flat[i * block_size:(i + 1) * block_size].tobytes())
        h = m.digest()
        out.append(h)
    return out


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    prompt_token_ids: List[int]
    output_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None
    text: Optional[str] = None
    new_token_ids: List[int] = dataclasses.field(default_factory=list)


class _Request:
    def __init__(self, request_id: str, prompt: List[int],
                 params: SamplingParams):
        self.id = request_id
        self.prompt = list(prompt)
        self.params = params
        self.output: List[int] = []
        self.blocks: List[int] = []
        self.prefilled = 0          # context tokens already run through
        self.dispatched = 0         # device-sampled tokens not yet fetched
        # Sampling seed: explicit, else derived from the request id, so a
        # replay under the same id redraws the same tokens.
        self.seed_val = (params.seed if params.seed is not None
                         else zlib.crc32(request_id.encode()) & 0x7FFFFFFF)
        self.finished_reason: Optional[str] = None
        self.prefix_hashes: Optional[List[bytes]] = None  # lazy, per prompt
        self.registered_blocks = 0  # prompt blocks made cache-addressable
        self.timing: Dict[str, Optional[float]] = {
            "t_submit": time.time(), "t_admit": None,
            "t_first_token": None, "t_last_token": None}

    @property
    def num_tokens(self) -> int:
        return len(self.prompt) + len(self.output)

    @property
    def last_token(self) -> int:
        return self.output[-1] if self.output else self.prompt[-1]

    @property
    def context(self) -> List[int]:
        """Tokens whose KV must exist before decode continues (prompt plus
        anything generated before a preemption)."""
        return self.prompt + self.output


class BlockManager:
    """Paged-KV allocator with automatic prefix caching: every FULL prompt
    block registers under its digest chain; a new request reuses the
    longest cached chain (refcounted, copy-free: cached blocks are
    immutable full blocks and writes only target a sequence's own tail).
    Freed cached blocks park in an LRU pool and are recycled only under
    allocation pressure."""

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True):
        self.block_size = block_size
        self.free: deque = deque(range(num_blocks))
        self.caching = enable_prefix_caching
        self.refcount: Dict[int, int] = {}       # live blocks
        self.cached: Dict[bytes, int] = {}       # digest -> block_id
        self.block_hash: Dict[int, bytes] = {}   # block_id -> digest
        self.reusable: "OrderedDict[int, None]" = OrderedDict()  # LRU
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0

    def blocks_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    def available(self) -> int:
        return len(self.free) + len(self.reusable)

    def can_allocate(self, num_tokens: int) -> bool:
        return self.available() >= self.blocks_needed(num_tokens)

    def _take_free_block(self) -> int:
        if self.free:
            return self.free.popleft()
        # Recycle the least-recently-used parked cached block.
        bid, _ = self.reusable.popitem(last=False)
        self.cached.pop(self.block_hash.pop(bid), None)
        return bid

    def allocate(self, req: _Request, num_tokens: int) -> bool:
        need = self.blocks_needed(num_tokens) - len(req.blocks)
        if need > self.available():
            return False
        for _ in range(max(0, need)):
            bid = self._take_free_block()
            self.refcount[bid] = self.refcount.get(bid, 0) + 1
            req.blocks.append(bid)
        return True

    def release(self, req: _Request):
        self.release_blocks(req.blocks)
        req.blocks = []

    def release_blocks(self, blocks: List[int]):
        for bid in blocks:
            n = self.refcount.get(bid, 1) - 1
            if n > 0:
                self.refcount[bid] = n
                continue
            self.refcount.pop(bid, None)
            if bid in self.block_hash:
                # Still addressable by content: park for reuse.
                self.reusable[bid] = None
                self.reusable.move_to_end(bid)
            else:
                self.free.append(bid)

    def prefix_hashes(self, prompt: Sequence[int]) -> List[bytes]:
        """Digest chain for this manager's cache addresses; the chain seed
        is the base-model slot (0) as in the JAX engine."""
        return prefix_digest_chain(prompt, self.block_size,
                                   seed=(0).to_bytes(8, "little"))

    def match_prefix(self, req: _Request, hashes: List[bytes]) -> int:
        """Attach the longest cached chain to req; returns tokens skipped.
        The prompt's final token is ALWAYS recomputed (its logits seed the
        first sampled token), capping reuse at (len(prompt)-1)//bs blocks."""
        if not self.caching:
            return 0
        limit = min(len(hashes), (len(req.prompt) - 1) // self.block_size)
        skipped = 0
        for i in range(limit):
            bid = self.cached.get(hashes[i])
            if bid is None:
                break
            if self.refcount.get(bid, 0) == 0:
                self.reusable.pop(bid, None)
            self.refcount[bid] = self.refcount.get(bid, 0) + 1
            req.blocks.append(bid)
            skipped += self.block_size
        if skipped:
            self.prefix_hits += 1
            self.prefix_tokens_saved += skipped
        return skipped

    def register_block(self, req: _Request, index: int, h: bytes):
        """A full prompt block finished prefilling: make it addressable.
        First writer wins; a duplicate stays private to its sequence."""
        if not self.caching:
            return
        bid = req.blocks[index]
        if bid in self.block_hash or h in self.cached:
            return
        self.cached[h] = bid
        self.block_hash[bid] = h


class LLMEngine:
    def __init__(self, model_runner, *, max_batch_size: int = 8,
                 max_blocks_per_seq: Optional[int] = None,
                 tokenizer=None, prefill_chunk: Optional[int] = None,
                 enable_prefix_caching: bool = True,
                 speculative_ngram: int = 0,
                 decode_multi_step: int = 1,
                 prefill_only: bool = False,
                 unified_ticks: bool = True,
                 token_budget: Optional[int] = None):
        if prefill_only:
            raise _unported("prefill-only (disaggregated) engines")
        if speculative_ngram and unified_ticks and decode_multi_step == 1:
            raise _unported("speculative decoding on the unified tick "
                            "(speculative_ngram > 0 with unified_ticks=True)")
        self.runner = model_runner
        self.block_size = model_runner.block_size
        self.block_manager = BlockManager(
            model_runner.num_blocks, model_runner.block_size,
            enable_prefix_caching=enable_prefix_caching)
        self.max_batch = max_batch_size
        self.max_blocks_per_seq = max_blocks_per_seq or min(
            model_runner.max_blocks_per_seq,
            model_runner.config.max_seq // model_runner.block_size)
        # Hard length cap: a sequence may never outgrow its block-table row.
        self._cap_tokens = min(model_runner.config.max_seq,
                               self.max_blocks_per_seq * self.block_size)
        self.tokenizer = tokenizer
        self.prefill_chunk = prefill_chunk or model_runner.chunk_size
        self.waiting: deque = deque()
        self.prefilling: List[_Request] = []
        self.running: List[_Request] = []
        self._rejected: List[RequestOutput] = []
        # Async decode pipeline of the split path: up to pipeline_depth
        # steps stay in flight, each chaining its input tokens from the
        # previous step ON THE DEVICE; the copy of a step's sampled ids to
        # pinned host memory starts at dispatch and is read pipeline_depth
        # ticks later, so no tick waits for the device.
        self.pipeline_depth = PIPELINE_DEPTH
        self._flights: deque = deque()
        # (req, detached_blocks): pages an in-flight step may still write.
        # Detached from req.blocks so a re-admitted (preempted) request's
        # fresh allocation is never confused with the stale pages.
        self._pending_release: List[tuple] = []
        # n-gram (prompt-lookup) speculative decoding on the split path:
        # propose up to k tokens per step from the sequence's own history
        # and verify them in one multi-position step. Engages only for
        # all-greedy batches (exact acceptance needs argmax determinism).
        self.spec_ngram = int(speculative_ngram)
        self.spec_tokens_accepted = 0
        self.spec_tokens_proposed = 0
        # Multi-step decode: one dispatch runs k decode steps on the device.
        # A batch uses k only when EVERY member has k tokens of page and
        # length headroom, else the single-step program.
        self.multi_step = max(1, int(decode_multi_step))
        self.unified_ticks = bool(unified_ticks)
        # Prefill tokens actually run through the model (cache hits
        # excluded).
        self.prefill_tokens_computed = 0
        self.preemptions = 0
        self.ticks = 0               # unified mixed steps dispatched
        # Token budget per unified tick: decode rows are admitted first,
        # the remainder fills from the prefill backlog. A multiple of 8
        # (the ragged kernel's q_block — token buckets inherit it).
        budget = (int(token_budget) if token_budget else
                  self.prefill_chunk + self.max_batch)
        budget = max(budget, self.max_batch, 8)
        self.token_budget = -(-budget // 8) * 8

    # ---- API -------------------------------------------------------------

    def add_request(self, prompt_token_ids: Sequence[int],
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    lora_name: Optional[str] = None) -> str:
        if lora_name:
            raise _unported("LoRA (lora_name)")
        rid = request_id or uuid.uuid4().hex[:12]
        self.waiting.append(_Request(rid, list(prompt_token_ids),
                                     params or SamplingParams()))
        return rid

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running
                    or self._flights)

    def step(self) -> List[RequestOutput]:
        """One engine iteration: admit, then one unified mixed tick or the
        split phases (chunked prefill, then a decode tick). Emits a
        RequestOutput for every request that gained tokens (split decode
        emissions trail dispatch by the pipeline depth)."""
        self._admit()
        outputs: List[RequestOutput] = []
        if self._rejected:
            outputs.extend(self._rejected)
            self._rejected.clear()
        if self._use_unified():
            outputs.extend(self._mixed_tick())
        else:
            if self.prefilling:
                outputs.extend(self._prefill_step())
            if self.running or self._flights:
                outputs.extend(self._decode_tick())
        return outputs

    def _use_unified(self) -> bool:
        """Route this iteration through the unified mixed launch. Falls back
        to the split phases when a feature needs them: the multi-step
        decode, requests needing host logits (repetition penalty), or
        async flights still draining from a split tick."""
        if not (self.unified_ticks and self.multi_step == 1):
            return False
        if self._flights:
            return False
        if not (self.prefilling or self.running):
            return False
        return not self._needs_logits(list(self.prefilling) + self.running)

    def generate(self, prompts: List[Sequence[int]],
                 params: Optional[SamplingParams] = None,
                 ) -> List[RequestOutput]:
        ids = [self.add_request(p, params) for p in prompts]
        done: Dict[str, RequestOutput] = {}
        while self.has_unfinished():
            for out in self.step():
                if out.finished:
                    done[out.request_id] = out
        return [done[i] for i in ids]

    def stream(self, prompt_token_ids: Sequence[int],
               params: Optional[SamplingParams] = None):
        """Single-request token stream: yields token ids as they are
        sampled (this helper drives step())."""
        rid = self.add_request(prompt_token_ids, params)
        while True:
            for out in self.step():
                if out.request_id != rid:
                    continue
                yield from out.new_token_ids
                if out.finished:
                    return
            if not self.has_unfinished():
                return

    def abort_request(self, request_id: str) -> bool:
        """Drop a request wherever it lives and free its pages; pages an
        in-flight device step may still write are released once those
        flights drain. Returns False when the id is unknown (already
        finished/aborted)."""
        for queue_ in (self.waiting, self.prefilling, self.running):
            for req in queue_:
                if req.id == request_id:
                    queue_.remove(req)
                    req.finished_reason = "abort"
                    self._defer_release(req)
                    return True
        return False

    def reset(self) -> None:
        """Drop every request, every flight and free every page (after a
        failed step)."""
        self._flights.clear()
        for _, blocks in self._pending_release:
            self.block_manager.release_blocks(blocks)
        self._pending_release = []
        for queue_ in (self.waiting, self.prefilling, self.running):
            for req in queue_:
                req.dispatched = 0
                self.block_manager.release(req)
            queue_.clear()

    def update_weights(self, *args, **kwargs):
        raise _unported("weight updates (update_weights)")

    def export_session(self, *args, **kwargs):
        raise _unported("session export / migration")

    def adopt_request(self, *args, **kwargs):
        raise _unported("KV handoff adoption")

    def stats(self) -> Dict:
        """Scheduler/cache load signal: queue depths, KV pool occupancy,
        prefix-cache effectiveness, speculation. Cheap (no device sync)."""
        bm = self.block_manager
        backlog = sum(len(r.context) - r.prefilled for r in self.prefilling)
        backlog += sum(len(r.context) for r in self.waiting)
        return {
            "waiting": len(self.waiting),
            "prefilling": len(self.prefilling),
            "running": len(self.running),
            "inflight_steps": len(self._flights),
            "free_kv_blocks": bm.available(),
            "total_kv_blocks": self.runner.num_blocks,
            "block_size": self.block_size,
            "prefix_hits": bm.prefix_hits,
            "prefix_tokens_saved": bm.prefix_tokens_saved,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "queued_prefill_tokens": backlog,
            "preemptions": self.preemptions,
            "spec_tokens_proposed": self.spec_tokens_proposed,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "ticks": self.ticks,
            "step_compiles": self.runner.step_compiles,
            "unified_ticks": self.unified_ticks,
            "token_budget": self.token_budget,
        }

    def drain_flights(self) -> List[RequestOutput]:
        """Harvest every in-flight decode step and release deferred pages.
        After this no device step can still write into any sequence's
        pages and every request's `dispatched` is 0. Tokens the drained
        steps sampled commit normally (some requests may finish here)."""
        outputs: List[RequestOutput] = []
        while self._flights:
            outputs.extend(self._process_inflight(self._flights.popleft()))
        self._drain_release()
        return outputs

    def warmup(self, *, full: bool = False) -> int:
        """Run the bucketed step grid once on padding inputs, so no request
        pays a first use (the kernel build, cuBLAS per-shape setup,
        allocator growth). Dummy rows carry q_lens = 0 and kv_lens = 0: no
        KV write, the pool and the scheduler untouched. The light set warms
        every prefill chunk bucket at batch 1, every decode batch bucket at
        Bq = 1 (and the multi-step decode), and with speculation the verify
        step at every reachable proposal width; full=True adds the whole
        batch x chunk grid and the host-logits step. A unified engine also
        warms every token bucket of the mixed tick. Returns the number of
        shapes warmed."""
        r = self.runner
        batch_buckets = sorted({r.batch_bucket(n)
                                for n in range(1, self.max_batch + 1)})
        cap = r.chunk_bucket(self.prefill_chunk)
        chunk_buckets = [cb for cb in r.chunk_buckets() if cb <= cap]
        spec_cap = (r.chunk_bucket(self.spec_ngram + 1)
                    if self.spec_ngram else 0)
        combos = {(batch_buckets[0], cb) for cb in chunk_buckets}
        combos |= {(sb, 1) for sb in batch_buckets}
        verify_widths = ({cb for cb in r.chunk_buckets() if cb <= spec_cap}
                         if spec_cap else set())
        combos |= {(sb, cb) for sb in batch_buckets for cb in verify_widths}
        if full:
            combos |= {(sb, cb) for sb in batch_buckets
                       for cb in chunk_buckets}
        for S, Bq in sorted(combos):
            args = self._rect_arrays(S, Bq, [])
            samp = (*self._sampling_arrays([], S), np.zeros(S, np.int64))
            r.step_sample(*args, *samp)
            if Bq == 1 and self.multi_step > 1:
                r.step_sample_multi(self.multi_step, *args, *samp)
            if Bq in verify_widths:
                r.step_verify(*args)
            if full:
                r.step(*args)
        warmed = len(combos)
        if self.unified_ticks and self.multi_step == 1:
            S = r.batch_bucket(self.max_batch)
            for Tb in token_buckets(self.token_budget):
                r.warm_mixed(Tb, S, 1)
                warmed += 1
        return warmed

    # ---- internals -------------------------------------------------------

    def _admit(self):
        """waiting -> prefilling while pages for (context + 1 token) and
        batch slots are available."""
        while (self.waiting
               and len(self.prefilling) + len(self.running) < self.max_batch):
            req = self.waiting[0]
            if req.dispatched:
                # Preempted with steps still in flight: wait until they
                # drain (their tokens reference KV in pages already
                # detached for release).
                break
            if len(req.context) + 1 > self._cap_tokens:
                self.waiting.popleft()
                req.finished_reason = "length"
                self._rejected.append(RequestOutput(
                    req.id, req.prompt, list(req.output), True, "length",
                    self._detok(req.output)))
                continue
            if not self.block_manager.can_allocate(len(req.context) + 1):
                break
            self.waiting.popleft()
            # Prefix cache: attach the longest cached chain of full prompt
            # blocks and skip their prefill (recompute admits after
            # preemption re-match too — their KV may still be resident).
            cached_tokens = 0
            if self.block_manager.caching:
                if req.prefix_hashes is None:
                    req.prefix_hashes = self.block_manager.prefix_hashes(
                        req.prompt)
                cached_tokens = self.block_manager.match_prefix(
                    req, req.prefix_hashes)
                req.registered_blocks = len(req.blocks)
            if not self.block_manager.allocate(req, len(req.context) + 1):
                raise RuntimeError("KV pool changed between check and "
                                   "allocation")
            req.prefilled = cached_tokens
            if req.timing["t_admit"] is None:
                req.timing["t_admit"] = time.time()
            self.prefilling.append(req)

    def _needs_logits(self, reqs) -> bool:
        """Host sampling (full logits fetch) is only needed for features the
        device sampler lacks (repetition penalty)."""
        return any(r.params.repetition_penalty != 1.0 for r in reqs)

    def _sampling_arrays(self, batch, S):
        temps = np.zeros(S, dtype=np.float32)
        top_ks = np.zeros(S, dtype=np.int32)
        top_ps = np.ones(S, dtype=np.float32)
        seeds = np.zeros(S, dtype=np.int64)
        for i, req in enumerate(batch):
            temps[i] = req.params.temperature
            top_ks[i] = req.params.top_k
            top_ps[i] = req.params.top_p
            seeds[i] = req.seed_val
        return temps, top_ks, top_ps, seeds

    def _rect_arrays(self, S: int, Bq: int, rows) -> tuple:
        """Padded inputs of a rectangular (S, Bq) step. `rows` holds one
        (req, tokens, q_position, kv_len) per real sequence; q_lens is the
        token count, and padding sequences stay all zero (no KV write).
        Returns (tokens, q_positions, kv_lens, q_lens, tables)."""
        tokens = np.zeros((S, Bq), dtype=np.int32)
        q_positions = np.zeros(S, dtype=np.int32)
        kv_lens = np.zeros(S, dtype=np.int32)
        q_lens = np.zeros(S, dtype=np.int32)
        tables = np.zeros((S, self.max_blocks_per_seq), dtype=np.int32)
        for i, (req, toks, q_pos, kv_len) in enumerate(rows):
            tokens[i, :len(toks)] = toks
            q_positions[i] = q_pos
            kv_lens[i] = kv_len
            q_lens[i] = len(toks)
            tables[i, :len(req.blocks)] = req.blocks
        return tokens, q_positions, kv_lens, q_lens, tables

    def _register_prefilled(self, req: _Request):
        """Newly completed FULL prompt blocks become cache-addressable
        (their KV is now written and immutable)."""
        if not self.block_manager.caching:
            return
        full = min(req.prefilled, len(req.prompt)) // self.block_size
        while req.registered_blocks < full:
            j = req.registered_blocks
            self.block_manager.register_block(req, j, req.prefix_hashes[j])
            req.registered_blocks += 1

    def _prefill_step(self) -> List[RequestOutput]:
        """One chunk for every prefilling sequence, batched and bucketed on
        (batch, chunk). Syncs once, for the sampled tokens."""
        batch = self.prefilling[:self.max_batch]
        chunks = [min(len(r.context) - r.prefilled, self.prefill_chunk)
                  for r in batch]
        Bq = self.runner.chunk_bucket(max(chunks))
        chunks = [min(c, Bq) for c in chunks]
        self.prefill_tokens_computed += sum(chunks)
        S = self.runner.batch_bucket(len(batch))
        args = self._rect_arrays(S, Bq, [
            (req, req.context[req.prefilled:req.prefilled + c],
             req.prefilled, req.prefilled + c)
            for req, c in zip(batch, chunks)])
        outputs: List[RequestOutput] = []
        if self._needs_logits(batch):
            logits = self.runner.step(*args).cpu().numpy()
            sampled = None
        else:
            # A chunk samples at counter kv_len, as the unified tick does.
            counters = args[2].astype(np.int64)
            sampled = self.runner.step_sample(
                *args, *self._sampling_arrays(batch, S),
                counters).cpu().numpy()
        for i, (req, c) in enumerate(zip(batch, chunks)):
            req.prefilled += c
            self._register_prefilled(req)
            if req.prefilled < len(req.context):
                continue  # mid-prompt: this chunk's sample is unused
            self.prefilling.remove(req)
            if req.output:
                # Recomputed after preemption: context already includes
                # generated tokens; resume decoding without re-sampling.
                self.running.append(req)
                continue
            if sampled is not None:
                token = int(sampled[i])
            else:
                token = sample(logits[i], req.params, np.asarray(req.context))
            req.output.append(token)
            outputs.append(self._emit(req, [token]))
            if req.finished_reason:
                self.block_manager.release(req)
            else:
                self.running.append(req)
        return outputs

    # ---- async decode pipeline ------------------------------------------

    def _decode_tick(self) -> List[RequestOutput]:
        """Dispatch one decode step chained off the newest in-flight step,
        then (only once the pipeline is full, or when nothing could be
        dispatched) process the OLDEST step's tokens, whose copy to the
        host has been in flight for pipeline_depth ticks."""
        if self._needs_logits(self.running):
            return self._decode_sync()
        if (self.spec_ngram > 0
                and all(r.params.temperature <= 0.0 for r in self.running)):
            if self._flights:
                # Drain the async pipeline one step per tick (a sampled
                # request may have primed it); spec engages once empty.
                outputs = self._process_inflight(self._flights.popleft())
                self._drain_release()
                return outputs
            return self._decode_spec()
        prev = self._flights[-1] if self._flights else None
        flight = self._dispatch_decode(prev) if self.running else None
        if flight is not None:
            self._flights.append(flight)
        outputs: List[RequestOutput] = []
        if self._flights and (len(self._flights) > self.pipeline_depth
                              or flight is None):
            outputs = self._process_inflight(self._flights.popleft())
        self._drain_release()
        return outputs

    def _ensure_pages(self) -> None:
        """Every running seq needs pages for committed + dispatched + the
        next dispatch's tokens (multi_step when active); preempt the newest
        otherwise (recompute preemption). Pages an in-flight step may still
        write are released only once it drained."""
        for req in list(self.running):
            if req not in self.running:
                continue
            while not self.block_manager.allocate(
                    req, min(req.num_tokens + req.dispatched
                             + self.multi_step, self._cap_tokens)):
                victim = self.running[-1]
                self.running.remove(victim)
                victim.prefilled = 0
                self.waiting.appendleft(victim)
                self._defer_release(victim)
                self.preemptions += 1
                if req is victim:
                    break

    def _dispatch_decode(self, prev: Optional[dict]) -> Optional[dict]:
        """Dispatch one decode step (k tokens with multi-step) for every
        eligible running sequence. A row whose last token is still on the
        device takes it from the previous flight there. Synchronises with
        nothing: the inputs upload without waiting and the sampled ids'
        copy to the host is only started."""
        self._ensure_pages()
        prev_reqs = set(prev["batch"]) if prev else set()

        def eligible(r):
            if self.block_manager.blocks_needed(
                    r.num_tokens + r.dispatched + 1) > len(r.blocks):
                return False
            # Don't run past max_tokens / the length cap (bounded
            # overshoot; keeps block tables within their static width).
            if (len(r.output) + r.dispatched >= r.params.max_tokens
                    or r.num_tokens + r.dispatched >= self._cap_tokens):
                return False
            # A req with device-resident tokens must chain from the newest
            # flight; if it is not there, wait until its flights are
            # processed.
            if r.dispatched and r not in prev_reqs:
                return False
            return True

        batch = [r for r in self.running if eligible(r)]
        if not batch:
            return None

        def kv_headroom(r):
            # Room for KV writes only: pages and the static table width are
            # hard bounds (an in-flight step writes k entries whatever the
            # harvest keeps). max_tokens is deliberately not here: a nearly
            # finished member overshoots within its pages and
            # _process_inflight discards tokens past the end.
            return min(
                self._cap_tokens - r.num_tokens - r.dispatched,
                len(r.blocks) * self.block_size - r.num_tokens
                - r.dispatched)

        # All-or-nothing k: every member needs full KV headroom or the
        # batch takes the single-step program.
        k = self.multi_step if (self.multi_step > 1 and
                                all(kv_headroom(r) >= self.multi_step
                                    for r in batch)) else 1
        S = self.runner.batch_bucket(len(batch))
        gather_idx = np.zeros(S, dtype=np.int64)
        from_prev = np.zeros(S, dtype=bool)
        prev_rows = ({req: i for i, req in enumerate(prev["batch"])}
                     if prev else {})
        rows = []
        for i, req in enumerate(batch):
            pos = req.num_tokens + req.dispatched - 1  # last token's position
            token = req.last_token
            if req.dispatched and req in prev_rows:
                from_prev[i] = True
                gather_idx[i] = prev_rows[req]
                token = 0      # still on the device, in the previous flight
            rows.append((req, [token], pos, pos + 1))
        tokens, q_positions, kv_lens, q_lens, tables = self._rect_arrays(
            S, 1, rows)
        toks = tokens
        if prev is not None and from_prev.any():
            up = self.runner.to_device
            toks = torch.where(up(from_prev, torch.bool),
                               prev["last"][up(gather_idx, torch.long)],
                               up(tokens[:, 0]))[:, None]
        # Each row samples at counter kv_len, as the unified tick does.
        samp = (*self._sampling_arrays(batch, S), kv_lens.astype(np.int64))
        if k > 1:
            dev_tokens = self.runner.step_sample_multi(
                k, toks, q_positions, kv_lens, q_lens, tables,
                *samp)                                       # (S, k)
            last = dev_tokens[:, -1]
        else:
            last = self.runner.step_sample(
                toks, q_positions, kv_lens, q_lens, tables,
                *samp)                                       # (S,)
            dev_tokens = last[:, None]
        for req in batch:
            req.dispatched += k
        return {"batch": batch, "tokens": HostCopy(dev_tokens),
                "last": last, "k": k}

    def _process_inflight(self, flight: dict) -> List[RequestOutput]:
        fetched = flight["tokens"].numpy()   # waits on this flight only
        k = flight["k"]
        outputs: List[RequestOutput] = []
        for i, req in enumerate(flight["batch"]):
            req.dispatched -= k
            if req not in self.running:
                continue  # preempted or aborted: recompute from context
            for j in range(k):
                if req.finished_reason is not None:
                    break  # tokens sampled past the end: discard
                token = int(fetched[i, j])
                req.output.append(token)
                outputs.append(self._emit(req, [token]))
                if req.finished_reason:
                    self.running.remove(req)
                    self._defer_release(req)
        return outputs

    def _defer_release(self, req: _Request):
        """Release a seq's pages now, or after in-flight writes drain."""
        if req.dispatched:
            blocks, req.blocks = req.blocks, []
            self._pending_release.append((req, blocks))
        else:
            self.block_manager.release(req)

    def _drain_release(self):
        """Free pages of finished/preempted seqs once no in-flight step can
        still write into them."""
        keep = []
        for req, blocks in self._pending_release:
            if req.dispatched == 0:
                self.block_manager.release_blocks(blocks)
            else:
                keep.append((req, blocks))
        self._pending_release = keep

    # ---- n-gram speculative decode (split path, greedy) ------------------

    @staticmethod
    def _ngram_propose(context: List[int], k: int, n: int = 3) -> List[int]:
        """Prompt-lookup proposal: find the most recent earlier occurrence
        of the trailing (n-1)-gram and propose the k tokens that followed
        it, falling back to shorter grams (down to the last token alone).
        A weak proposal costs only a wasted verify row, never a wrong
        token."""
        for nn in range(min(n, len(context)), 1, -1):
            key = tuple(context[-(nn - 1):])
            for i in range(len(context) - nn, -1, -1):
                if tuple(context[i:i + nn - 1]) == key:
                    prop = list(context[i + nn - 1:i + nn - 1 + k])
                    if prop:
                        return prop
        return []

    def _decode_spec(self) -> List[RequestOutput]:
        """Greedy speculative decode via prompt lookup: each sequence's
        step carries [last_token, proposal...]; the verify head returns the
        model's greedy token at every position, and the longest agreeing
        prefix plus the model's own next token is accepted. KV written for
        rejected positions is overwritten by the next step's scatter (the
        kv_len accounting only covers accepted tokens)."""
        outputs: List[RequestOutput] = []
        self._drain_release()
        batch = self.running[:self.max_batch]
        if not batch:
            return outputs
        k = self.spec_ngram
        # Proposals FIRST: pages are reserved for what will actually be
        # written (num_tokens + len(prop) + 1), not the worst-case k.
        proposals = []
        for r in batch:
            room = self._cap_tokens - (r.num_tokens + 1)
            budget = min(k, max(0, room),
                         r.params.max_tokens - len(r.output) - 1)
            proposals.append(
                self._ngram_propose(r.context, budget) if budget > 0 else [])
        for req, prop in zip(list(batch), list(proposals)):
            if not self.block_manager.allocate(
                    req, min(req.num_tokens + len(prop) + 1,
                             self._cap_tokens)):
                # Page pressure: plain 1-token verify this tick.
                self._ensure_pages()  # may preempt; re-filter the batch
                batch = [r for r in batch if r in self.running]
                if not batch:
                    return outputs
                proposals = [[] for _ in batch]
                break
        width = 1 + max((len(p) for p in proposals), default=1)
        Bq = self.runner.chunk_bucket(width)
        S = self.runner.batch_bucket(len(batch))
        got = self.runner.step_verify(*self._rect_arrays(S, Bq, [
            (req, [req.last_token] + prop, req.num_tokens - 1,
             req.num_tokens + len(prop))
            for req, prop in zip(batch, proposals)])).cpu().numpy()
        finished: List[_Request] = []
        for i, (req, prop) in enumerate(zip(batch, proposals)):
            accepted: List[int] = []
            for j, proposed_tok in enumerate(prop):
                if int(got[i, j]) != proposed_tok:
                    break
                accepted.append(proposed_tok)
            # The model's own next token after the agreed prefix.
            accepted.append(int(got[i, len(accepted)]))
            # Never exceed max_tokens mid-bonus.
            room = req.params.max_tokens - len(req.output)
            accepted = accepted[:max(1, room)]
            # Honor stop tokens inside the accepted run.
            stops = req.params.stop_token_ids or ()
            for j, t in enumerate(accepted):
                if t in stops:
                    accepted = accepted[:j + 1]
                    break
            req.output.extend(accepted)
            self.spec_tokens_accepted += len(accepted) - 1
            self.spec_tokens_proposed += len(prop)
            outputs.append(self._emit(req, accepted))
            if req.finished_reason:
                finished.append(req)
        for req in finished:
            self.running.remove(req)
            self.block_manager.release(req)
        return outputs

    def _decode_sync(self) -> List[RequestOutput]:
        """Synchronous decode with host sampling from full logits, for
        requests with a repetition penalty."""
        outputs = self.drain_flights()
        self._ensure_pages()
        batch = self.running
        if not batch:
            return outputs
        S = self.runner.batch_bucket(len(batch))
        logits = self.runner.step(*self._rect_arrays(S, 1, [
            (req, [req.last_token], req.num_tokens - 1, req.num_tokens)
            for req in batch])).cpu().numpy()
        finished: List[_Request] = []
        for i, req in enumerate(batch):
            token = sample(logits[i], req.params, np.asarray(req.context))
            req.output.append(token)
            outputs.append(self._emit(req, [token]))
            if req.finished_reason:
                finished.append(req)
        for req in finished:
            self.running.remove(req)
            self.block_manager.release(req)
        return outputs

    # ---- unified ragged tick --------------------------------------------

    def _mixed_tick(self) -> List[RequestOutput]:
        """ONE mixed batch per engine iteration: a token-budget composer
        admits decode rows FIRST (running sequences never stall behind a
        long prompt), fills the remaining budget from the prefill backlog,
        and dispatches the composition through ModelRunner.step_mixed,
        bucketed on total token count. Synchronous: the sampled ids are on
        the host when it returns."""
        outputs: List[RequestOutput] = []
        self._drain_release()
        budget = self.token_budget
        # The batch dimension is pinned to one bucket, and the composer
        # respects it as a ROW cap too (many near-finished prefills would
        # otherwise overflow cu/out_rows).
        S = self.runner.batch_bucket(self.max_batch)
        batch = self.running[:self.max_batch]
        for req in list(batch):
            if not self.block_manager.allocate(
                    req, min(req.num_tokens + 1, self._cap_tokens)):
                # Page pressure: preempt-newest until the tick fits.
                self._ensure_pages()
                batch = [r for r in batch if r in self.running]
                break
        entries: List[dict] = []
        used = 0
        for req in batch:
            entries.append({"req": req, "kind": "decode",
                            "tokens": [req.last_token],
                            "q_pos": req.num_tokens - 1,
                            "kv_len": req.num_tokens,
                            "counter": req.num_tokens})
            used += 1
        for req in list(self.prefilling):
            if len(entries) >= S:
                break
            c = min(len(req.context) - req.prefilled, self.prefill_chunk,
                    budget - used)
            if c <= 0:
                break
            entries.append({"req": req, "kind": "prefill", "chunk": c,
                            "tokens": req.context[req.prefilled:
                                                  req.prefilled + c],
                            "q_pos": req.prefilled,
                            "kv_len": req.prefilled + c,
                            "counter": req.prefilled + c})
            used += c
            self.prefill_tokens_computed += c
        if not entries:
            return outputs
        # -- assemble the token-major batch ---------------------------------
        Tb = _bucket(used, token_buckets(budget))
        flat = np.zeros(Tb, dtype=np.int32)
        cu = np.zeros(S + 1, dtype=np.int32)
        q_positions = np.zeros(S, dtype=np.int32)
        kv_lens = np.zeros(S, dtype=np.int32)
        tables = np.zeros((S, self.max_blocks_per_seq), dtype=np.int32)
        out_rows = np.zeros((S, 1), dtype=np.int32)
        counters = np.zeros(S, dtype=np.int64)
        pos = 0
        for i, e in enumerate(entries):
            n = len(e["tokens"])
            flat[pos:pos + n] = e["tokens"]
            cu[i] = pos
            cu[i + 1] = pos + n
            q_positions[i] = e["q_pos"]
            kv_lens[i] = e["kv_len"]
            req = e["req"]
            tables[i, :len(req.blocks)] = req.blocks
            out_rows[i] = pos + n - 1     # the span's last row's logits
            counters[i] = e["counter"]
            pos += n
        cu[len(entries) + 1:] = pos
        temps, top_ks, top_ps, seeds = self._sampling_arrays(
            [e["req"] for e in entries], S)
        _, samples = self.runner.step_mixed(
            flat, q_positions, kv_lens, cu, tables, out_rows,
            np.zeros((S, 1), np.int32), np.zeros(S, np.int32), temps,
            top_ks, top_ps, seeds, counters)
        self.ticks += 1
        # -- commit ---------------------------------------------------------
        for i, e in enumerate(entries):
            req = e["req"]
            token = int(samples[i, 0])
            if e["kind"] == "prefill":
                req.prefilled += e["chunk"]
                self._register_prefilled(req)
                if req.prefilled < len(req.context):
                    continue   # mid-prompt: this chunk's sample is unused
                self.prefilling.remove(req)
                if req.output:
                    # Recomputed after preemption: resume decoding without
                    # re-sampling already-emitted tokens.
                    self.running.append(req)
                    continue
                req.output.append(token)
                outputs.append(self._emit(req, [token]))
                if req.finished_reason:
                    self.block_manager.release(req)
                else:
                    self.running.append(req)
                continue
            if req not in self.running:
                continue   # preempted inside this tick: recompute path
            req.output.append(token)
            outputs.append(self._emit(req, [token]))
            if req.finished_reason:
                self.running.remove(req)
                self.block_manager.release(req)
        return outputs

    def _emit(self, req: _Request, new_tokens: List[int]) -> RequestOutput:
        now = time.time()
        if req.timing["t_first_token"] is None:
            req.timing["t_first_token"] = now
        req.timing["t_last_token"] = now
        self._check_finished(req)
        done = req.finished_reason is not None
        return RequestOutput(
            req.id, req.prompt, list(req.output), done, req.finished_reason,
            self._detok(req.output) if done else None, new_tokens)

    def _check_finished(self, req: _Request):
        p = req.params
        if p.stop_token_ids and req.output \
                and req.output[-1] in p.stop_token_ids:
            req.finished_reason = "stop"
        elif len(req.output) >= p.max_tokens:
            req.finished_reason = "length"
        elif req.num_tokens >= self._cap_tokens:
            req.finished_reason = "length"

    def _detok(self, token_ids: List[int]) -> Optional[str]:
        if self.tokenizer is None:
            return None
        try:
            return self.tokenizer.decode(token_ids)
        except Exception:
            return None
