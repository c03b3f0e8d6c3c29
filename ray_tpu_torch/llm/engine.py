"""LLM engine: continuous batching through unified ragged ticks.

Port of ray_tpu/llm/engine.py restricted to the unified tick (the default
serving path there):

  * BlockManager — host-side page allocator for the KV pool (free list,
    per-sequence block tables, automatic prefix caching).
  * LLMEngine — add_request / step / generate / stream / abort_request.
    Every step() is ONE mixed batch: decode rows first, then prefill
    chunk slices from the remaining token budget, dispatched through
    ModelRunner.step_mixed. Preemption (pages exhausted) evicts the newest
    sequence and re-admits it later by recomputing prompt + generated
    tokens.

The split prefill/decode path, speculative decoding, multi-step decode,
prefill-only tiers, LoRA, repetition penalty, the prefix-store tiers,
weight updates and export/adopt/migration are later slices: the engine
refuses them with a ValueError instead of computing something else.
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

from ray_tpu_torch.llm.model_runner import _bucket, token_buckets
from ray_tpu_torch.llm.sampling import SamplingParams

# Per-process key for the prefix-cache digest chain: unpredictable to
# clients, so cache addresses can't be forged across tenants.
_PREFIX_CACHE_SALT = os.urandom(16)


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
        for bid in req.blocks:
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
        req.blocks = []

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
        if not unified_ticks:
            raise _unported("the split prefill/decode path "
                            "(unified_ticks=False)")
        if speculative_ngram:
            raise _unported("speculative decoding (speculative_ngram > 0)")
        if decode_multi_step != 1:
            raise _unported("multi-step decode (decode_multi_step > 1)")
        if prefill_only:
            raise _unported("prefill-only (disaggregated) engines")
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
        # Prefill tokens actually run through the model (cache hits
        # excluded).
        self.prefill_tokens_computed = 0
        self.preemptions = 0
        self.ticks = 0               # mixed steps dispatched
        # Token budget per tick: decode rows are admitted first, the
        # remainder fills from the prefill backlog. A multiple of 8 (the
        # ragged kernel's q_block — token buckets inherit it).
        budget = (int(token_budget) if token_budget else
                  self.prefill_chunk + self.max_batch)
        budget = max(budget, self.max_batch, 8)
        self.token_budget = -(-budget // 8) * 8

    # ---- API -------------------------------------------------------------

    def add_request(self, prompt_token_ids: Sequence[int],
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    lora_name: Optional[str] = None) -> str:
        params = params or SamplingParams()
        if lora_name:
            raise _unported("LoRA (lora_name)")
        if params.repetition_penalty != 1.0:
            raise _unported("repetition_penalty != 1.0 (host-logits "
                            "sampling on the split path)")
        rid = request_id or uuid.uuid4().hex[:12]
        self.waiting.append(_Request(rid, list(prompt_token_ids), params))
        return rid

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    def step(self) -> List[RequestOutput]:
        """One engine iteration: admit, then one unified mixed tick. Emits
        a RequestOutput for every request that gained tokens."""
        self._admit()
        outputs: List[RequestOutput] = []
        if self._rejected:
            outputs.extend(self._rejected)
            self._rejected.clear()
        if self.prefilling or self.running:
            outputs.extend(self._mixed_tick())
        return outputs

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
        """Drop a request wherever it lives and free its pages. Returns
        False when the id is unknown (already finished/aborted)."""
        for queue_ in (self.waiting, self.prefilling, self.running):
            for req in queue_:
                if req.id == request_id:
                    queue_.remove(req)
                    req.finished_reason = "abort"
                    self.block_manager.release(req)
                    return True
        return False

    def reset(self) -> None:
        """Drop every request and free its pages (after a failed step)."""
        for queue_ in (self.waiting, self.prefilling, self.running):
            for req in queue_:
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
        prefix-cache effectiveness. Cheap (no device sync)."""
        bm = self.block_manager
        backlog = sum(len(r.context) - r.prefilled for r in self.prefilling)
        backlog += sum(len(r.context) for r in self.waiting)
        return {
            "waiting": len(self.waiting),
            "prefilling": len(self.prefilling),
            "running": len(self.running),
            "free_kv_blocks": bm.available(),
            "total_kv_blocks": self.runner.num_blocks,
            "block_size": self.block_size,
            "prefix_hits": bm.prefix_hits,
            "prefix_tokens_saved": bm.prefix_tokens_saved,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "queued_prefill_tokens": backlog,
            "preemptions": self.preemptions,
            "ticks": self.ticks,
            "step_compiles": self.runner.step_compiles,
            "token_budget": self.token_budget,
        }

    def warmup(self) -> int:
        """Run every token bucket of the unified tick once on padding
        inputs, so no request pays a first use (the kernel build, cuBLAS
        per-shape setup, allocator growth). Returns the number of buckets."""
        S = self.runner.batch_bucket(self.max_batch)
        buckets = token_buckets(self.token_budget)
        for Tb in buckets:
            self.runner.warm_mixed(Tb, S, 1)
        return len(buckets)

    # ---- internals -------------------------------------------------------

    def _admit(self):
        """waiting -> prefilling while pages for (context + 1 token) and
        batch slots are available."""
        while (self.waiting
               and len(self.prefilling) + len(self.running) < self.max_batch):
            req = self.waiting[0]
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

    def _ensure_pages(self) -> None:
        """Every running seq needs pages for its committed tokens + the
        next one; preempt the newest otherwise (recompute preemption)."""
        for req in list(self.running):
            if req not in self.running:
                continue
            while not self.block_manager.allocate(
                    req, min(req.num_tokens + 1, self._cap_tokens)):
                victim = self.running[-1]
                self.running.remove(victim)
                victim.prefilled = 0
                self.waiting.appendleft(victim)
                self.block_manager.release(victim)
                self.preemptions += 1
                if req is victim:
                    break

    def _mixed_tick(self) -> List[RequestOutput]:
        """ONE mixed batch per engine iteration: a token-budget composer
        admits decode rows FIRST (running sequences never stall behind a
        long prompt), fills the remaining budget from the prefill backlog,
        and dispatches the composition through ModelRunner.step_mixed,
        bucketed on total token count. Synchronous: the sampled ids are on
        the host when it returns."""
        outputs: List[RequestOutput] = []
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
                            "tokens": [req.output[-1] if req.output
                                       else req.prompt[-1]],
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
        reqs = [e["req"] for e in entries]
        temps, top_ks, top_ps, seeds = self._sampling_arrays(reqs, S)
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
                if self.block_manager.caching:
                    full = (min(req.prefilled, len(req.prompt))
                            // self.block_size)
                    while req.registered_blocks < full:
                        j = req.registered_blocks
                        self.block_manager.register_block(
                            req, j, req.prefix_hashes[j])
                        req.registered_blocks += 1
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
