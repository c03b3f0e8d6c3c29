"""LLM engine: continuous batching over a paged KV cache.

Port of ray_tpu/llm/engine.py:

  * BlockManager — host-side page allocator for the KV pool (free list,
    per-sequence block tables, automatic prefix caching).
  * LLMEngine — add_request / step / generate / stream / abort_request.
    A step() is either ONE unified mixed batch (decode and speculative
    verify rows first, then prefill chunk slices from the remaining token
    budget, through ModelRunner.step_mixed), or the split phases: a
    rectangular prefill chunk step, then a decode tick. With
    `speculative_ngram` the unified tick verifies n-gram drafts at any
    temperature (greedy rows by argmax agreement, temperature rows by
    seeded rejection sampling). The split decode is an async pipeline of
    up to `pipeline_depth` steps in flight, each chaining its input tokens
    from the previous one on the device; it runs k tokens per dispatch
    with `decode_multi_step`, greedy n-gram speculation with
    `speculative_ngram` and `unified_ticks=False`, and host sampling from
    full logits for requests with a repetition penalty. `_use_unified`
    picks the path per step, as in the JAX engine. Preemption (pages
    exhausted) evicts the newest sequence and re-admits it later by
    recomputing prompt + generated tokens.
  * The tick flight recorder: a bounded ring of per-tick records (batch
    composition, token budget used, bucket, recompile flag, tokens emitted
    per request), read through `tick_records`.
  * Multi-LoRA (llm/lora.py): a request names an adapter, pins its slot
    until it finishes, and every step carries each sequence's slot. The
    prefix digest chain is seeded with the slot, so cached KV is never
    shared across adapters.
  * The KV page plane: `export_request` / `export_session` /
    `adopt_request` move a live request with its pages between engines;
    `update_weights` swaps the weights in place and drops every cached
    prefix; `attach_prefix_store` wires the tiered prefix store
    (llm/prefix_store.py): the host tier catches evicted prefix blocks,
    its watermark victims are published to the cluster prefix table, and
    admission promotes from both, the host tier's run and then one fetch
    from the table, each written to the pool in one batched scatter;
    `export_prefixes` / `adopt_prefix` move idle prefix blocks.
  * Prefill-only engines (`prefill_only=True`, the prefill tier of
    disaggregated serving, llm/disagg.py): chunked prefill on the split
    path only, never a decode tick and never a unified tick (no unified
    CUDA graph is captured at warm-up); the caller exports each request
    after its first token. `request_breakdown` splits a finished
    request's latency into queue, prefill, handoff, decode and stall; at
    finish the breakdown is kept (`breakdowns`), observed in the
    ray_tpu_llm_{ttft,itl}_breakdown_ms histograms and recorded as the
    request's llm:queue/llm:prefill/llm:decode spans (host work after
    the tick, as the JAX engine's).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
import uuid
import zlib
from collections import OrderedDict, deque
from itertools import islice
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.llm.model_runner import HostCopy, _bucket, token_buckets
from ray_tpu_torch.llm.sampling import SamplingParams, sample
from ray_tpu_torch.ops import to_torch
from ray_tpu_torch.runtime import metric_defs
from ray_tpu_torch.util import tracing

log = logging.getLogger(__name__)

# Per-process key for the prefix-cache digest chain: unpredictable to
# clients, so cache addresses can't be forged across tenants.
_PREFIX_CACHE_SALT = os.urandom(16)

# Split decode steps kept in flight (the JAX package's llm_pipeline_depth).
PIPELINE_DEPTH = 4
# Finished requests whose request_breakdown the engine keeps.
BREAKDOWNS_KEPT = 256
# The cluster table's adoption gate (LLMEngine._fetch_pays): every this
# many-th fetch it refuses goes ahead, so the learned fetch cost follows
# the load.
FETCH_REPROBE = 32


class WeightSyncError(RuntimeError):
    """A weight hot-swap payload failed validation against the loaded model
    (structure, leaf shape or dtype), or the engine was mid-generation.
    Raised by `LLMEngine.update_weights` before any state is touched."""


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


def _leaf_pairs(old, new, keys: tuple = ()) -> List[tuple]:
    """(name, keys, engine tensor, payload leaf as a tensor) over two
    parameter dicts of one structure; WeightSyncError where the structures
    differ."""
    path = "".join(f"['{k}']" for k in keys)
    if isinstance(old, dict):
        if not isinstance(new, dict) or set(new) != set(old):
            got = sorted(new) if isinstance(new, dict) else type(new).__name__
            raise WeightSyncError(
                f"pytree structure mismatch at {path or 'the root'}: engine "
                f"has {sorted(old)}, payload has {got}")
        return [pair for k in sorted(old)
                for pair in _leaf_pairs(old[k], new[k], keys + (k,))]
    if isinstance(new, np.ndarray):
        new = to_torch(new)
    if not isinstance(new, torch.Tensor):
        raise WeightSyncError(f"pytree structure mismatch at {path}: "
                              f"payload leaf is {type(new).__name__}")
    return [(path, keys, old, new)]


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    prompt_token_ids: List[int]
    output_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None
    text: Optional[str] = None
    new_token_ids: List[int] = dataclasses.field(default_factory=list)


def _ema(old: Optional[float], sample: float) -> float:
    return sample if old is None else 0.75 * old + 0.25 * sample


class _Request:
    def __init__(self, request_id: str, prompt: List[int],
                 params: SamplingParams, lora_slot: int = 0):
        self.id = request_id
        self.prompt = list(prompt)
        self.params = params
        self.lora_slot = lora_slot    # 0 = base model (llm/lora.py)
        self.output: List[int] = []
        self.blocks: List[int] = []
        self.prefilled = 0          # context tokens already run through
        self.dispatched = 0         # device-sampled tokens not yet fetched
        # Sampling seed: explicit, else derived from the request id, so a
        # replay under the same id redraws the same tokens.
        self.seed_val = (params.seed if params.seed is not None
                         else zlib.crc32(request_id.encode()) & 0x7FFFFFFF)
        self.finished_reason: Optional[str] = None
        self.lora_pinned = lora_slot != 0   # released once on finish
        self.prefix_hashes: Optional[List[bytes]] = None  # lazy, per prompt
        self.registered_blocks = 0  # prompt blocks made cache-addressable
        self.adopted = False   # arrived via KV handoff (prefill elsewhere)
        # (admission time, tokens to prefill) of an admission that found
        # nothing in the host tier or the table: its first token is a
        # sample of the prefill's cost (LLMEngine._note_prefill).
        self.prefill_clock: Optional[Tuple[float, int]] = None
        # Lifecycle timestamps; they travel inside an exported request's
        # state, handoff_s/pause_s accumulate the time spent off-engine.
        self.timing: Dict[str, Optional[float]] = {
            "t_submit": time.time(), "t_admit": None,
            "t_first_token": None, "t_last_token": None,
            "handoff_s": 0.0, "pause_s": 0.0}

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
        # digest -> (lora_slot, lora_name, root-anchored token prefix
        # through that block): what the host prefix tier needs to
        # re-address and token-verify a block after it leaves the device.
        # The adapter NAME is resolved at registration, while the owning
        # request still pins its slot (slots are recycled across loads).
        self.digest_meta: Dict[bytes, Tuple[int, Optional[str],
                                            Tuple[int, ...]]] = {}
        # Hooks installed by LLMEngine.attach_prefix_store: spill_fn([(bid,
        # digest), ...]) runs just before parked cached blocks are
        # recycled (the last moment their pages are intact), once for all
        # the blocks one allocation recycles; lora_name_fn maps a pinned
        # slot to its adapter name ("" = base model).
        self.spill_fn = None
        self.lora_name_fn = None

    def _slot_name(self, lora_slot: int) -> Optional[str]:
        if self.lora_name_fn is not None:
            return self.lora_name_fn(lora_slot)
        return "" if lora_slot == 0 else None

    def blocks_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    def available(self) -> int:
        return len(self.free) + len(self.reusable)

    def can_allocate(self, num_tokens: int) -> bool:
        return self.available() >= self.blocks_needed(num_tokens)

    def _take_blocks(self, n: int) -> List[int]:
        """n pages, refcounted: free ones first, then the least recently
        used parked cached blocks, whose pages are spilled to the host
        prefix tier in one batch while they are still intact."""
        out = [self.free.popleft() for _ in range(min(n, len(self.free)))]
        victims = []
        for _ in range(n - len(out)):
            bid, _ = self.reusable.popitem(last=False)
            victims.append((bid, self.block_hash.pop(bid)))
        if victims and self.spill_fn is not None:
            self.spill_fn(victims)
        for bid, h in victims:
            self.cached.pop(h, None)
            self.digest_meta.pop(h, None)
            out.append(bid)
        for bid in out:
            self.refcount[bid] = self.refcount.get(bid, 0) + 1
        return out

    def allocate(self, req: _Request, num_tokens: int) -> bool:
        need = self.blocks_needed(num_tokens) - len(req.blocks)
        if need > self.available():
            return False
        req.blocks.extend(self._take_blocks(max(0, need)))
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

    def prefix_hashes(self, prompt: Sequence[int],
                      lora_slot: int = 0) -> List[bytes]:
        """Digest chain for this manager's cache addresses, seeded with the
        LoRA slot as 8 signed little-endian bytes: adapters change wk/wv,
        so KV differs per adapter and sharing it across them would be
        silently wrong."""
        slot = int(lora_slot).to_bytes(8, "little", signed=True)
        return prefix_digest_chain(prompt, self.block_size, seed=slot)

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
        self.digest_meta[h] = (
            req.lora_slot, self._slot_name(req.lora_slot),
            tuple(req.prompt[:(index + 1) * self.block_size]))

    def register_adopted_block(self, bid: int, h: bytes, lora_slot: int,
                               tokens: Sequence[int]) -> bool:
        """Make a block adopted from the prefix store addressable under
        digest `h` (the adopter already holds a refcount on `bid`). First
        writer wins, like register_block."""
        if not self.caching or h in self.cached or bid in self.block_hash:
            return False
        self.cached[h] = bid
        self.block_hash[bid] = h
        self.digest_meta[h] = (int(lora_slot), self._slot_name(lora_slot),
                               tuple(tokens))
        return True

    def invalidate_prefix_cache(self) -> int:
        """Drop every cached prefix mapping (after a weight swap cached KV
        is stale). Parked blocks return to the free pool; blocks of live
        sequences lose their address and free normally on release.
        Returns the number of entries dropped."""
        n = len(self.cached)
        self.cached.clear()
        self.block_hash.clear()
        self.digest_meta.clear()
        while self.reusable:
            bid, _ = self.reusable.popitem(last=False)
            self.free.append(bid)
        return n

    def invalidate_slot(self, lora_slot: int) -> int:
        """Drop the cached prefixes registered under one LoRA slot (its
        adapter's weights changed). Returns the number dropped."""
        stale = [h for h, meta in self.digest_meta.items()
                 if meta[0] == lora_slot]
        for h in stale:
            bid = self.cached.pop(h)
            del self.block_hash[bid]
            del self.digest_meta[h]
            if bid in self.reusable:
                del self.reusable[bid]
                self.free.append(bid)
        return len(stale)

    def adopt_blocks(self, n: int) -> Optional[List[int]]:
        """Allocate `n` fresh private pages for KV adopted from elsewhere,
        refcounted like any allocation; None (nothing taken) when the pool
        cannot fit them."""
        if self.available() < n:
            return None
        return self._take_blocks(n)


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
        # n-gram (prompt-lookup) speculative decoding: propose up to k
        # tokens per step from the sequence's own history and verify them
        # in one multi-position step. On the unified tick at any
        # temperature; on the split path only for all-greedy batches.
        self.spec_ngram = int(speculative_ngram)
        self.spec_tokens_accepted = 0
        self.spec_tokens_proposed = 0
        # Multi-step decode: one dispatch runs k decode steps on the device.
        # A batch uses k only when EVERY member has k tokens of page and
        # length headroom, else the single-step program.
        self.multi_step = max(1, int(decode_multi_step))
        self.unified_ticks = bool(unified_ticks)
        # Prefill tier of disaggregated serving: chunked prefill only.
        self.prefill_only = bool(prefill_only)
        # Bumped by update_weights.
        self.weights_version = 0
        # Prefill tokens actually run through the model (cache hits and
        # adopted KV excluded).
        self.prefill_tokens_computed = 0
        # Tiered prefix store (llm/prefix_store.py), attached by the
        # serving layer through attach_prefix_store: the host tier catches
        # device evictions, the cluster store makes published prefixes
        # adoptable by every server, and _admit promotes from both.
        self.host_prefix_tier = None
        self.cluster_store = None
        # ModelRunner.fingerprint of the served weights, taken when a
        # cluster store is attached: the rows this engine publishes carry
        # it and the rows it adopts must.
        self.model_fingerprint = ""
        # The table's adoption gate (_fetch_pays) learns both costs from
        # this engine's own runs: seconds a fetched block took, and
        # seconds a prefilled token took (None: not seen yet).
        self._fetch_s_per_block: Optional[float] = None
        self._prefill_s_per_token: Optional[float] = None
        self.table_fetches_skipped = 0
        # Pages of parked blocks gathered ahead of their spill (bid ->
        # (k, v)), filled only during _promote_prefix's host walk.
        self._spill_ahead: Dict[int, tuple] = {}
        self.host_prefix_hits = 0
        self.host_prefix_tokens_saved = 0
        self.cluster_prefix_hits = 0
        self.cluster_prefix_tokens_saved = 0
        self.preemptions = 0
        self.ticks = 0               # unified mixed steps dispatched
        # Rows per sequence of a unified tick: its last token, then the
        # proposals under verify.
        self._spec_width = 1 + self.spec_ngram
        # Token budget per unified tick: decode/verify rows are admitted
        # first, the remainder fills from the prefill backlog. It covers
        # every running row's verify width and stays a multiple of 8 (the
        # ragged kernel's q_block — token buckets inherit it).
        budget = (int(token_budget) if token_budget else
                  self.prefill_chunk + self.max_batch * self._spec_width)
        budget = max(budget, self.max_batch * self._spec_width, 8)
        self.token_budget = -(-budget // 8) * 8
        self._warm_mixed: set = set()   # token buckets already warmed
        self._warm_epoch = 0   # the LoRA stacks' epoch _warm_mixed holds
        # Tick flight recorder: a bounded ring of per-tick records, so a
        # slow token is attributable to a cause (a long prefill taking the
        # budget, a capture in the hot loop) and not just visible as a
        # gap. A dict per tick and no device sync: always on.
        self.flight_records: deque = deque(
            maxlen=int(os.environ.get("RAY_TPU_LLM_FLIGHT_RECORDS", "256")))
        self._tick_note: Dict = {}
        # request id -> request_breakdown of the newest finished requests
        # (the port's stand-in for the JAX package's breakdown histograms).
        self.breakdowns: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
        if model_runner.lora is not None:
            model_runner.lora.listeners.append(self._adapter_loaded)

    # ---- API -------------------------------------------------------------

    def add_request(self, prompt_token_ids: Sequence[int],
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    lora_name: Optional[str] = None) -> str:
        rid = request_id or uuid.uuid4().hex[:12]
        slot = 0
        if lora_name:
            if self.runner.lora is None:
                raise ValueError(
                    "engine has no LoRA manager; lora_name unsupported")
            slot = self.runner.lora.slot_of(lora_name)  # KeyError if absent
            # Pin until the request finishes: LRU eviction must not hand
            # this slot to another adapter mid-generation.
            self.runner.lora.pin(slot)
        self.waiting.append(_Request(rid, list(prompt_token_ids),
                                     params or SamplingParams(), slot))
        return rid

    def _adapter_loaded(self, slot: int) -> None:
        """A slot took new adapter weights (a refresh, or another adapter
        after an eviction): KV cached or spilled under that slot was
        computed with the old ones. The JAX engine keeps serving it; here
        it is dropped from both tiers."""
        self.block_manager.invalidate_slot(slot)
        if self.host_prefix_tier is not None:
            self.host_prefix_tier.drop(lambda e: e["lora_slot"] == slot)

    def _unpin_lora(self, req: _Request):
        if req.lora_pinned:
            req.lora_pinned = False
            self.runner.lora.unpin(req.lora_slot)

    def _lora_idx(self, batch, S) -> Optional[np.ndarray]:
        if self.runner.lora is None:
            return None
        idx = np.zeros(S, dtype=np.int32)
        for i, req in enumerate(batch):
            idx[i] = req.lora_slot
        return idx

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
        t0 = time.time()
        self._tick_note = {}
        if self._use_unified():
            outputs.extend(self._mixed_tick())
        else:
            if self.prefilling:
                outputs.extend(self._prefill_step())
            if not self.prefill_only and (self.running or self._flights):
                outputs.extend(self._decode_tick())
        note = self._tick_note
        if note:
            note["t"] = t0
            note["dur_ms"] = round((time.time() - t0) * 1e3, 3)
            note["waiting"] = len(self.waiting)
            # Each request's output length after this tick: a slow token's
            # position joins the tick that produced it.
            note["emitted"] = {o.request_id: len(o.output_token_ids)
                               for o in outputs if o.new_token_ids}
            self.flight_records.append(note)
        return outputs

    def _note(self, **fields):
        """Merge one phase's facts into the current tick record (the split
        path may run prefill AND decode inside one step)."""
        n = self._tick_note
        if "kind" in n and "kind" in fields:
            fields["kind"] = f"{n['kind']}+{fields['kind']}"
        n.update(fields)

    def _use_unified(self) -> bool:
        """Route this iteration through the unified mixed launch. Falls back
        to the split phases when a feature needs them: the multi-step
        decode, prefill-only engines, requests needing host logits
        (repetition penalty), or async flights still draining from a split
        tick."""
        if not (self.unified_ticks and self.multi_step == 1
                and not self.prefill_only):
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
                    self._unpin_lora(req)
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
                self._unpin_lora(req)
                self.block_manager.release(req)
            queue_.clear()

    def update_weights(self, params: Dict, *, version: Optional[int] = None,
                       force: bool = False) -> Dict:
        """Hot-swap the model weights in place (RLHF weight sync).

        Validates `params` (the port's parameter dict of global leaves;
        tensors or numpy arrays) against the loaded model first,
        structure, per-leaf shape and dtype, and raises `WeightSyncError`
        on any mismatch before touching anything. Then copies every leaf
        into the runner's existing tensor (`copy_`; under tensor
        parallelism each leaf goes to every rank over the device group and
        each copies its shard): a captured graph holds those tensors, so
        it replays the new weights with no recapture. The whole prefix
        cache and the host tier are invalidated (their KV was computed
        under the old weights), `weights_version` moves on and the cluster
        table's rows under older versions are purged.

        Refuses while requests are unfinished unless `force=True`: a
        sequence would mix logits from two policies mid-generation."""
        if self.has_unfinished() and not force:
            raise WeightSyncError(
                "engine has unfinished requests; drain rollouts before "
                "swapping weights (or pass force=True)")
        pairs = _leaf_pairs(self.runner.params_meta, params)
        for name, _, old, new in pairs:
            if old.shape != new.shape:
                raise WeightSyncError(
                    f"shape mismatch at {name}: engine {tuple(old.shape)}, "
                    f"payload {tuple(new.shape)}")
            if old.dtype != new.dtype:
                raise WeightSyncError(
                    f"dtype mismatch at {name}: engine {old.dtype}, "
                    f"payload {new.dtype}")
        for _, keys, _, new in pairs:
            self.runner.assign_param(keys, new)
        invalidated = self.block_manager.invalidate_prefix_cache()
        self.weights_version = (version if version is not None
                                else self.weights_version + 1)
        # Spilled KV is as stale as cached KV: drop the host tier and GC
        # the table's rows below the new version (adoption also gates on
        # the exact version, so a racing peer never revives old pages).
        if self.host_prefix_tier is not None:
            invalidated += self.host_prefix_tier.clear()
        if self.cluster_store is not None:
            self.model_fingerprint = self.runner.fingerprint()
            self.cluster_store.purge(
                below_weights_version=self.weights_version)
        return {"version": self.weights_version,
                "invalidated_prefix_entries": invalidated}

    def export_session(self, request_id: str):
        """Detach a live request wherever it lives, for a move to another
        engine. Returns (state, mode):

          * ("kv" mode) the request was decoding: state carries its block
            ids under "blocks", as export_request; the caller gathers the
            pages and the adopter resumes decode with no re-prefill.
          * ("replay" mode) the request had not finished prefill: its
            partial KV is dropped whole and state carries prompt, output
            and seed only; the importer re-runs from the prompt, and
            seeded sampling makes the retry token-identical.

        (None, None) when the id is unknown. Call drain_flights() first:
        a decode export needs dispatched == 0."""
        for req in self.running:
            if req.id == request_id:
                return self.export_request(request_id), "kv"
        for queue_ in (self.waiting, self.prefilling):
            for req in list(queue_):
                if req.id == request_id:
                    queue_.remove(req)
                    self._unpin_lora(req)
                    self._defer_release(req)
                    return {
                        "id": req.id,
                        "prompt": list(req.prompt),
                        "output": list(req.output),
                        "seed": req.seed_val,
                        "lora_slot": req.lora_slot,
                        "params": dataclasses.asdict(req.params),
                    }, "replay"
        return None, None

    def export_request(self, request_id: str) -> Optional[dict]:
        """Detach a running request for handoff to another engine. Returns
        its portable state with its (detached) block ids under "blocks";
        the caller gathers those pages (ModelRunner.gather_pages) and THEN
        releases them through block_manager.release_blocks, so shared
        cached prefix blocks stay addressable."""
        for req in self.running:
            if req.id == request_id:
                break
        else:
            return None
        if req.dispatched:
            raise RuntimeError(
                f"request {request_id} has in-flight decode steps; call "
                "drain_flights() first (its pages may still be written)")
        self.running.remove(req)
        self._unpin_lora(req)
        blocks, req.blocks = req.blocks, []
        return {
            "id": req.id,
            "prompt": list(req.prompt),
            "output": list(req.output),
            "seed": req.seed_val,
            "lora_slot": req.lora_slot,
            "params": dataclasses.asdict(req.params),
            "blocks": blocks,
            # The adopter books (adopt time - t_handoff) as handoff_s, or
            # pause_s for a migration.
            "timing": dict(req.timing, t_handoff=time.time()),
        }

    def adopt_request(self, state: dict, k_pages, v_pages) -> bool:
        """Adopt a request exported by another engine (this package's or
        the JAX package's; pages in gather_pages' layout): fresh private
        pages, the KV scattered in, the sequence enters decode directly.
        Its draws key on (seed, absolute position), both carried in
        `state`, so it decodes as it would have where it came from.
        Returns False (nothing allocated) when the pool can't fit it."""
        params = SamplingParams(**state["params"])
        req = _Request(state["id"], list(state["prompt"]), params,
                       int(state.get("lora_slot", 0)))
        req.output = [int(t) for t in state["output"]]
        req.seed_val = int(state["seed"])
        req.adopted = True
        timing = state.get("timing")
        if timing:
            for key in ("t_submit", "t_admit", "t_first_token",
                        "t_last_token", "handoff_s", "pause_s"):
                if timing.get(key) is not None:
                    req.timing[key] = timing[key]
            t_handoff = timing.get("t_handoff")
            if t_handoff is not None:
                gap = max(0.0, time.time() - float(t_handoff))
                key = "pause_s" if state.get("migrated") else "handoff_s"
                req.timing[key] = float(req.timing.get(key) or 0.0) + gap
        n_pages = int(np.shape(k_pages)[2])
        if self.block_manager.blocks_needed(len(req.context)) > n_pages:
            # The stream must cover every context token's KV: anything less
            # is a torn export, not pressure.
            raise ValueError(
                f"handoff for {req.id} carries {n_pages} pages; "
                f"{self.block_manager.blocks_needed(len(req.context))} "
                "needed")
        if req.lora_slot and self.runner.lora is None:
            raise ValueError(
                "handoff carries a LoRA slot but this engine has no LoRA "
                "manager (both engines must preload identical adapters)")
        # Headroom for the next token too when the pages cover the context
        # exactly: decode resumes without an immediate allocation.
        total = max(n_pages,
                    self.block_manager.blocks_needed(len(req.context) + 1))
        ids = self.block_manager.adopt_blocks(total)
        if ids is None:
            return False
        if req.lora_pinned:
            self.runner.lora.pin(req.lora_slot)
        req.blocks = ids
        req.prefilled = len(req.context)
        self.runner.scatter_pages(ids[:n_pages], k_pages, v_pages)
        if self.block_manager.caching:
            # Re-register full prompt blocks under THIS engine's digest
            # chain: the next prompt sharing the prefix hits locally.
            req.prefix_hashes = self.block_manager.prefix_hashes(
                req.prompt, req.lora_slot)
            full = min(len(req.prompt) // self.block_size, len(ids))
            while req.registered_blocks < full:
                j = req.registered_blocks
                self.block_manager.register_block(
                    req, j, req.prefix_hashes[j])
                req.registered_blocks += 1
        self.running.append(req)
        return True

    # ---- the tiered prefix store (llm/prefix_store.py) -------------------

    def attach_prefix_store(self, host_tier=None, cluster_store=None):
        """Wire the tiered prefix store in: BlockManager evictions spill
        through `host_tier` (whose blocks' page-locked buffers are
        reserved here), the victims past its capacity are published to
        `cluster_store`, and _admit promotes from both.
        Either may be None (host-only works alone; cluster-only skips host
        RAM)."""
        self.host_prefix_tier = host_tier
        self.cluster_store = cluster_store
        self.block_manager.lora_name_fn = self._lora_name
        if cluster_store is not None:
            self.model_fingerprint = self.runner.fingerprint()
        if host_tier is not None:
            self.block_manager.spill_fn = self._spill_blocks
            self.runner.reserve_host_pages(
                host_tier.capacity_bytes // self.runner.block_nbytes)
            if cluster_store is not None and host_tier.on_demote is None:
                host_tier.on_demote = self._demote_entry

    def _lora_name(self, lora_slot: int) -> Optional[str]:
        """Adapter name for a pinned slot: "" = base model, None = cannot
        resolve (no manager / unknown slot: such KV is unaddressable)."""
        if lora_slot == 0:
            return ""
        lm = self.runner.lora
        return lm.name_of(lora_slot) if lm is not None else None

    def _spillable(self, victims):
        """(bid, digest, meta) of the victims the host tier can re-address
        (registered, with a resolvable adapter name)."""
        out = []
        for bid, h in victims:
            meta = self.block_manager.digest_meta.get(h)
            if meta is not None and meta[1] is not None:
                out.append((bid, h, meta))
        return out

    def _spill_blocks(self, victims) -> None:
        """BlockManager eviction hook: copy the victim blocks' pages to the
        host tier, oldest first, before their device pages are recycled,
        on the current stream after every step that wrote them (pages
        gathered ahead by _promote_prefix are taken from there). Each
        block has a host buffer of its own, and the victims go in runs of
        at most the tier's capacity, one gather and one synchronize a run,
        so page-locked memory stays within the tier's bytes plus one run.
        Best-effort: a failed spill is a future cache miss, never an
        engine error."""
        tier = self.host_prefix_tier
        keep = self._spillable(victims) if tier is not None else []
        if not keep:
            return
        run = max(1, tier.capacity_bytes // self.runner.block_nbytes)
        for i in range(0, len(keep), run):
            part = keep[i:i + run]
            pages = {b: self._spill_ahead[b] for b, _, _ in part
                     if b in self._spill_ahead}
            missing = [b for b, _, _ in part if b not in pages]
            if missing:
                try:
                    pages.update(zip(missing,
                                     self.runner.gather_page_list(missing)))
                except Exception:
                    log.exception("prefix spill of %d blocks failed",
                                  len(missing))
                    return
            for bid, h, (slot, lora_name, tokens) in part:
                k, v = pages.pop(bid)
                tier.put(h, {"tokens": tokens, "k": k, "v": v,
                             "lora_slot": slot, "lora_name": lora_name,
                             "weights_version": self.weights_version,
                             "kv_dtype": self.runner.kv_dtype_name,
                             "model": self.model_fingerprint,
                             "nbytes": int(k.nbytes + v.nbytes)})

    def _demote_entry(self, entry: dict) -> None:
        """Host-tier watermark victim -> the cluster table (tier 2)."""
        if self.cluster_store is not None:
            self.cluster_store.publish(entry)

    def _promote_prefix(self, req: _Request) -> int:
        """Extend req's cached-chain attachment past the device tier: host
        RAM block by block, then ONE cluster-table fetch for the rest of
        the chain. Each tier's blocks go to fresh device pages in one
        batched scatter and are registered under the local digest chain,
        so the next prompt sharing them hits the device tier. A block is
        taken only if its tokens equal the prompt's (for the table this
        check is the forgery guard), its weights version is this
        engine's and, for the table, it is of this engine's model; under
        pool pressure the cluster run is cut short, and the table is not
        asked at all while a fetched block is expected to cost more than
        prefilling it (_fetch_pays). Returns tokens saved.

        The host walk keeps the JAX engine's order block for block (a read
        of the tier, then a page, whose recycled parked block spills to
        the tier, where a later read of the walk may find it), so blocks,
        counters and tokens are the same; only the device work is
        batched: at the walk's first recycle, the parked blocks the rest
        of it can recycle are gathered in one copy (_gather_ahead), and
        the promoted pages go up in one."""
        bm = self.block_manager
        bs = self.block_size
        limit = min(len(req.prefix_hashes), (len(req.prompt) - 1) // bs)
        lora_name = self._lora_name(req.lora_slot)
        promoted = 0
        t_adopt0 = time.time()
        tier = self.host_prefix_tier
        e = (tier.get(req.prefix_hashes[len(req.blocks)])
             if tier is not None and len(req.blocks) < limit else None)
        if e is not None:
            ids, pages, gathered = [], [], False
            try:
                while True:
                    j = len(req.blocks)
                    if (e is None or e.get("weights_version")
                            != self.weights_version
                            or e.get("lora_name") != lora_name
                            or tuple(e["tokens"])
                            != tuple(req.prompt[:(j + 1) * bs])):
                        break
                    if not gathered and not bm.free:
                        self._gather_ahead(req, j, limit)
                        gathered = True
                    got = bm.adopt_blocks(1)
                    if got is None:
                        break
                    ids += got
                    pages.append((e["k"], e["v"]))
                    req.blocks.extend(got)
                    bm.register_adopted_block(got[0], req.prefix_hashes[j],
                                              req.lora_slot, e["tokens"])
                    if len(req.blocks) >= limit:
                        break
                    e = tier.get(req.prefix_hashes[len(req.blocks)])
            finally:
                self._spill_ahead = {}
            if ids:
                self.runner.scatter_page_list(ids, pages)
            promoted += len(ids) * bs
            self.host_prefix_hits += len(ids)
            self.host_prefix_tokens_saved += len(ids) * bs
        if (self.cluster_store is not None and len(req.blocks) < limit
                and lora_name is not None and self._fetch_pays()):
            from ray_tpu_torch.llm.prefix_store import cluster_chain

            j0 = len(req.blocks)
            chain = cluster_chain(req.prompt[:limit * bs], bs, lora_name)
            shape, width = self.runner.block_page_layout
            t0 = time.perf_counter()
            rows = self.cluster_store.lookup_pages(
                chain[j0:limit], lora_id=lora_name,
                weights_version=self.weights_version,
                model=self.model_fingerprint)
            if rows:
                self._fetch_s_per_block = _ema(
                    self._fetch_s_per_block,
                    (time.perf_counter() - t0) / len(rows))
            run = []
            for e in rows:
                want = [int(t) for t in req.prompt[:(j0 + len(run) + 1)
                                                   * bs]]
                if [int(t) for t in e["tokens"]] != want:
                    break  # token verification is the forgery guard
                if (np.shape(e["k"]) != shape
                        or np.dtype(e["k"].dtype).itemsize != width):
                    break  # a row without a fingerprint, of another shape
                run.append((e, want))
            ids = None
            while run:  # pool pressure: adopt a shorter prefix
                ids = bm.adopt_blocks(len(run))
                if ids is not None:
                    break
                run.pop()
            if run:
                self.runner.scatter_page_list(
                    ids, [(e["k"], e["v"]) for e, _ in run])
                for bid, (_, want) in zip(ids, run):
                    bm.register_adopted_block(
                        bid, req.prefix_hashes[len(req.blocks)],
                        req.lora_slot, want)
                    req.blocks.append(bid)
                promoted += len(run) * bs
                self.cluster_prefix_hits += len(run)
                self.cluster_prefix_tokens_saved += len(run) * bs
        if promoted and tracing.enabled():
            # Tokens the prefill did not recompute show up in the request's
            # trace as a named span instead of unexplained TTFT variance.
            with tracing.trace_context(tracing.request_trace_id(req.id),
                                       None):
                tracing.record_span(
                    "llm:prefix_adopt", "llm", t_adopt0, time.time(),
                    request_id=req.id, tokens_saved=promoted)
        return promoted

    def _gather_ahead(self, req: _Request, j: int, limit: int) -> None:
        """Gather, in one copy, the parked blocks that the host walk from
        block j on can recycle: one a block the walk can still take, and
        it can take no block past the run of the prompt's digests held by
        the tier or by a parked block (whose spill the walk may find)."""
        bm = self.block_manager
        tier = self.host_prefix_tier
        n = 0
        while j + n < limit and (req.prefix_hashes[j + n] in tier
                                 or req.prefix_hashes[j + n] in bm.cached):
            n += 1
        ahead = self._spillable(
            (b, bm.block_hash[b]) for b in islice(bm.reusable, n))
        if ahead:
            bids = [b for b, _, _ in ahead]
            self._spill_ahead = dict(zip(
                bids, self.runner.gather_page_list(bids)))

    def _fetch_pays(self) -> bool:
        """Whether to ask the cluster table: a fetched block is expected
        to cost no more than prefilling its tokens, from the costs this
        engine has seen. Until both are seen it asks (the first fetch
        measures); of the fetches it refuses, every FETCH_REPROBE-th goes
        ahead, so the estimate follows the load."""
        f, p = self._fetch_s_per_block, self._prefill_s_per_token
        if f is None or p is None or f <= p * self.block_size:
            return True
        self.table_fetches_skipped += 1
        return self.table_fetches_skipped % FETCH_REPROBE == 0

    def _note_prefill(self, req: _Request, now: float) -> None:
        """A request's first token: where its admission found nothing in
        the host tier or the table and it prefilled a block or more, its
        time from admission over those tokens is a sample of the prefill
        cost a token (_fetch_pays)."""
        clock, req.prefill_clock = req.prefill_clock, None
        if clock is not None and clock[1] >= self.block_size:
            self._prefill_s_per_token = _ema(
                self._prefill_s_per_token, (now - clock[0]) / clock[1])

    def adopt_prefix(self, state: dict, k_pages, v_pages) -> int:
        """Adopt prefix blocks pushed by a draining peer (export_prefixes'
        state): scatter each block into a fresh page, register it under
        THIS engine's digest chain and park it in the reusable pool, as if
        a local request had prefilled and released it. Skips blocks it
        cannot place (stale weights, unknown adapters, token or shape
        mismatches, pool pressure). Returns blocks adopted."""
        if int(state.get("weights_version", 0)) != self.weights_version:
            return 0
        entries = state.get("entries") or []
        if np.ndim(k_pages) != 5 or int(np.shape(k_pages)[2]) != len(
                entries):
            return 0
        bm = self.block_manager
        bs = self.block_size
        adopted = 0
        for i, ent in enumerate(entries):
            tokens = [int(t) for t in (ent.get("tokens") or [])]
            if not tokens or len(tokens) % bs:
                continue
            lora = ent.get("lora") or ""
            slot = 0
            if lora:
                lm = self.runner.lora
                try:
                    slot = lm.slot_of(lora) if lm is not None else None
                except KeyError:
                    slot = None
                if slot is None or self._lora_name(slot) != lora:
                    continue  # adapter not resident here: unaddressable
            seed = int(slot).to_bytes(8, "little", signed=True)
            h = prefix_digest_chain(tokens, bs, seed=seed)[-1]
            if h in bm.cached:
                continue
            ids = bm.adopt_blocks(1)
            if ids is None:
                break
            self.runner.scatter_pages(ids, k_pages[:, :, i:i + 1],
                                      v_pages[:, :, i:i + 1])
            if bm.register_adopted_block(ids[0], h, slot, tokens):
                adopted += 1
            # Parks in `reusable` (hashed, refcount 0), or returns to
            # `free` if registration lost the race.
            bm.release_blocks(ids)
        return adopted

    def export_prefixes(self, limit: int = 16):
        """Snapshot the hottest idle prefix blocks for a push to a peer:
        parked device blocks first (hottest), then host-tier entries.
        Returns (state, k, v) in adopt_prefix's shape, or None when there
        is nothing worth pushing."""
        bm = self.block_manager
        picked = []
        for bid in reversed(bm.reusable):
            h = bm.block_hash.get(bid)
            meta = bm.digest_meta.get(h) if h is not None else None
            if meta is None:
                continue
            slot, lora_name, tokens = meta
            if lora_name is None:
                continue
            picked.append((bid, lora_name, tokens))
            if len(picked) >= limit:
                break
        entries, ks, vs = [], [], []
        if picked:
            k, v = self.runner.gather_pages([b for b, _, _ in picked])
            ks.append(k)
            vs.append(v)
            entries.extend({"tokens": list(t), "lora": name}
                           for _, name, t in picked)
        if self.host_prefix_tier is not None and len(entries) < limit:
            for e in self.host_prefix_tier.hottest(limit - len(entries)):
                entries.append({"tokens": list(e["tokens"]),
                                "lora": e["lora_name"]})
                ks.append(np.asarray(e["k"]))
                vs.append(np.asarray(e["v"]))
        if not entries:
            return None
        k = np.concatenate(ks, axis=2) if len(ks) > 1 else ks[0]
        v = np.concatenate(vs, axis=2) if len(vs) > 1 else vs[0]
        state = {"prefix": True, "entries": entries,
                 "weights_version": self.weights_version}
        return state, k, v

    def stats(self) -> Dict:
        """Scheduler/cache load signal: queue depths, KV pool occupancy,
        prefix-cache effectiveness, speculation. Cheap (no device sync)."""
        bm = self.block_manager
        backlog = sum(len(r.context) - r.prefilled for r in self.prefilling)
        backlog += sum(len(r.context) for r in self.waiting)
        out = {
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
            "weights_version": self.weights_version,
            "preemptions": self.preemptions,
            "spec_tokens_proposed": self.spec_tokens_proposed,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "ticks": self.ticks,
            "step_compiles": self.runner.step_compiles,
            "unified_ticks": self.unified_ticks,
            "token_budget": self.token_budget,
            "tick_records": len(self.flight_records),
        }
        if self.host_prefix_tier is not None:
            t = self.host_prefix_tier.stats()
            out.update({
                "host_prefix_entries": t["entries"],
                "host_prefix_bytes": t["bytes"],
                "host_prefix_spills": t["spills"],
                "host_prefix_demotions": t["demotions"],
                "host_prefix_hits": self.host_prefix_hits,
                "host_prefix_tokens_saved": self.host_prefix_tokens_saved,
            })
        if self.cluster_store is not None:
            c = self.cluster_store.stats()
            out.update({
                "cluster_prefix_published": c["published"],
                "cluster_prefix_adopted_blocks": c["adopted_blocks"],
                "cluster_prefix_stale_rejected": c["stale_rejected"],
                "cluster_prefix_hits": self.cluster_prefix_hits,
                "cluster_prefix_tokens_saved":
                    self.cluster_prefix_tokens_saved,
                "table_fetches_skipped": self.table_fetches_skipped,
            })
        lm = self.runner.lora
        if lm is not None:
            out.update({
                "lora_slots": lm.n_slots - 1,
                "lora_loaded": len(lm.loaded),
                "lora_pinned": len(lm._pins),
                "lora_loads": lm.loads,
                "lora_evictions": lm.evictions,
            })
        return out

    def tick_records(self, limit: Optional[int] = None,
                     request_id: Optional[str] = None) -> List[Dict]:
        """Flight-recorder snapshot, newest last. `request_id` keeps the
        ticks that emitted tokens for that request (the gaps of one
        stream); `limit` keeps the newest N after filtering."""
        records = list(self.flight_records)
        if request_id is not None:
            records = [r for r in records
                       if request_id in (r.get("emitted") or {})]
        if limit is not None:
            records = records[-int(limit):]
        return records

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
        shapes warmed (on the card with graphs, each token bucket of the
        unified tick is a capture). A prefill-only engine never takes the
        unified tick, so it captures none."""
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
        if (self.unified_ticks and self.multi_step == 1
                and not self.prefill_only):
            self._check_lora_epoch()
            S = r.batch_bucket(self.max_batch)
            for Tb in token_buckets(self.token_budget):
                if Tb in self._warm_mixed:
                    continue
                r.warm_mixed(Tb, S, self._spec_width)
                self._warm_mixed.add(Tb)
                warmed += 1
        return warmed

    # ---- internals -------------------------------------------------------

    def _check_lora_epoch(self) -> None:
        """A LoRA resize reallocated the slot stacks: every token bucket
        captures again on its next tick (recorded as a recompile)."""
        lm = self.runner.lora
        if lm is not None and lm.epoch != self._warm_epoch:
            self._warm_mixed.clear()
            self._warm_epoch = lm.epoch

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
                self._unpin_lora(req)
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
                        req.prompt, req.lora_slot)
                cached_tokens = self.block_manager.match_prefix(
                    req, req.prefix_hashes)
                # Device tier exhausted: promote from host RAM, then the
                # cluster table, so spilled blocks re-enter fresh device
                # pages instead of re-prefilling.
                promoted = 0
                if (self.host_prefix_tier is not None
                        or self.cluster_store is not None):
                    promoted = self._promote_prefix(req)
                    cached_tokens += promoted
                req.registered_blocks = len(req.blocks)
                req.prefill_clock = (
                    None if promoted or self.cluster_store is None
                    else (time.time(), len(req.context) - cached_tokens))
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
        self._note(kind="prefill", prefill_rows=len(batch),
                   chunk_bucket=Bq, prefill_tokens=sum(chunks))
        S = self.runner.batch_bucket(len(batch))
        args = self._rect_arrays(S, Bq, [
            (req, req.context[req.prefilled:req.prefilled + c],
             req.prefilled, req.prefilled + c)
            for req, c in zip(batch, chunks)])
        outputs: List[RequestOutput] = []
        lora_idx = self._lora_idx(batch, S)
        if self._needs_logits(batch):
            logits = self.runner.step(*args,
                                      lora_idx=lora_idx).cpu().numpy()
            sampled = None
        else:
            # A chunk samples at counter kv_len, as the unified tick does.
            counters = args[2].astype(np.int64)
            sampled = self.runner.step_sample(
                *args, *self._sampling_arrays(batch, S),
                counters, lora_idx=lora_idx).cpu().numpy()
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
        lora_idx = self._lora_idx(batch, S)
        if k > 1:
            dev_tokens = self.runner.step_sample_multi(
                k, toks, q_positions, kv_lens, q_lens, tables,
                *samp, lora_idx=lora_idx)                    # (S, k)
            last = dev_tokens[:, -1]
        else:
            last = self.runner.step_sample(
                toks, q_positions, kv_lens, q_lens, tables,
                *samp, lora_idx=lora_idx)                    # (S,)
            dev_tokens = last[:, None]
        for req in batch:
            req.dispatched += k
        self._note(kind="decode", decode_rows=len(batch), multi_step=k,
                   inflight=len(self._flights) + 1)
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
        self._note(kind="spec_verify", decode_rows=len(batch),
                   spec_tokens=sum(len(p) for p in proposals),
                   chunk_bucket=Bq)
        got = self.runner.step_verify(*self._rect_arrays(S, Bq, [
            (req, [req.last_token] + prop, req.num_tokens - 1,
             req.num_tokens + len(prop))
            for req, prop in zip(batch, proposals)]),
            lora_idx=self._lora_idx(batch, S)).cpu().numpy()
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
            if prop:
                self.spec_tokens_proposed += len(prop)
                metric_defs.LLM_SPEC_PROPOSED.inc(len(prop))
                if len(accepted) > 1:
                    metric_defs.LLM_SPEC_ACCEPTED.inc(len(accepted) - 1)
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
        self._note(kind="decode_host", decode_rows=len(batch))
        logits = self.runner.step(*self._rect_arrays(S, 1, [
            (req, [req.last_token], req.num_tokens - 1, req.num_tokens)
            for req in batch]),
            lora_idx=self._lora_idx(batch, S)).cpu().numpy()
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
        admits decode and speculative verify rows FIRST (running sequences
        never stall behind a long prompt), fills the remaining budget from
        the prefill backlog, and dispatches the composition through
        ModelRunner.step_mixed, bucketed on total token count.

        Speculation runs at any temperature: greedy rows accept by argmax
        agreement (the split `_decode_spec` rule) and temperature rows by
        seeded rejection sampling keyed on the request's seed and each
        token's absolute index, so a replay re-derives the same
        accept/reject trajectory. Synchronous: the sampled ids are on the
        host when it returns."""
        outputs: List[RequestOutput] = []
        self._drain_release()
        self._check_lora_epoch()
        W = self._spec_width
        budget = self.token_budget
        # The batch dimension is pinned to one bucket, and the composer
        # respects it as a ROW cap too (many near-finished prefills would
        # otherwise overflow cu/out_rows).
        S = self.runner.batch_bucket(self.max_batch)
        # -- decode / verify rows first -------------------------------------
        batch = self.running[:self.max_batch]
        proposals: List[List[int]] = []
        spec_left = budget - len(batch)   # 1 token a row is reserved
        for r in batch:
            room = self._cap_tokens - (r.num_tokens + 1)
            pb = min(self.spec_ngram, max(0, room),
                     r.params.max_tokens - len(r.output) - 1, spec_left)
            prop = self._ngram_propose(r.context, pb) if pb > 0 else []
            spec_left -= len(prop)
            proposals.append(prop)
        for req, prop in zip(list(batch), list(proposals)):
            if not self.block_manager.allocate(
                    req, min(req.num_tokens + len(prop) + 1,
                             self._cap_tokens)):
                # Page pressure: plain 1-token rows, then preempt-newest
                # until the plain tick fits.
                self._ensure_pages()
                batch = [r for r in batch if r in self.running]
                proposals = [[] for _ in batch]
                break
        entries: List[dict] = []
        used = 0
        for req, prop in zip(batch, proposals):
            entries.append({"req": req, "kind": "decode",
                            "tokens": [req.last_token] + prop,
                            "prop": prop,
                            "q_pos": req.num_tokens - 1,
                            "kv_len": req.num_tokens + len(prop),
                            "counter": req.num_tokens})
            used += 1 + len(prop)
        # -- remaining budget fills from the prefill backlog ----------------
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
                            "prop": [],
                            "q_pos": req.prefilled,
                            "kv_len": req.prefilled + c,
                            "counter": req.prefilled + c})
            used += c
            self.prefill_tokens_computed += c
        if not entries:
            return outputs
        # -- assemble the token-major batch ---------------------------------
        Tb = _bucket(used, token_buckets(budget))
        recompile = Tb not in self._warm_mixed
        self._note(
            kind="mixed", budget=budget, used=used, bucket=Tb,
            recompile=recompile,
            decode_rows=sum(e["kind"] == "decode" for e in entries),
            prefill_rows=sum(e["kind"] == "prefill" for e in entries),
            spec_tokens=sum(len(e["prop"]) for e in entries),
            budget_exhausted=used >= budget)
        if recompile:
            # A bucket outside the warmed ladder (or a tick before
            # warmup): capture it on padding BEFORE the real tokens ride
            # it, so the hot loop never absorbs the stall unannounced.
            self.runner.warm_mixed(Tb, S, W)
            self._warm_mixed.add(Tb)
        flat = np.zeros(Tb, dtype=np.int32)
        cu = np.zeros(S + 1, dtype=np.int32)
        q_positions = np.zeros(S, dtype=np.int32)
        kv_lens = np.zeros(S, dtype=np.int32)
        tables = np.zeros((S, self.max_blocks_per_seq), dtype=np.int32)
        out_rows = np.zeros((S, W), dtype=np.int32)
        props = np.zeros((S, W), dtype=np.int32)
        prop_lens = np.zeros(S, dtype=np.int32)
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
            if e["kind"] == "prefill":
                out_rows[i] = pos + n - 1   # the chunk's last row's logits
            else:
                # Row j of a verify span: logits after proposal tokens
                # 0..j-1 (clamped for the padding columns).
                out_rows[i] = [pos + min(j, n - 1) for j in range(W)]
            props[i, :len(e["prop"])] = e["prop"]
            prop_lens[i] = len(e["prop"])
            counters[i] = e["counter"]
            pos += n
        cu[len(entries) + 1:] = pos
        reqs = [e["req"] for e in entries]
        temps, top_ks, top_ps, seeds = self._sampling_arrays(reqs, S)
        accept, samples = self.runner.step_mixed(
            flat, q_positions, kv_lens, cu, tables, out_rows, props,
            prop_lens, temps, top_ks, top_ps, seeds, counters,
            lora_idx=self._lora_idx(reqs, S))
        self.ticks += 1
        # -- commit ---------------------------------------------------------
        for i, e in enumerate(entries):
            req = e["req"]
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
                token = int(samples[i, 0])
                req.output.append(token)
                outputs.append(self._emit(req, [token]))
                if req.finished_reason:
                    self.block_manager.release(req)
                else:
                    self.running.append(req)
                continue
            if req not in self.running:
                continue   # preempted inside this tick: recompute path
            prop = e["prop"]
            accepted: List[int] = []
            for j, t in enumerate(prop):
                if not accept[i, j]:
                    break
                accepted.append(int(t))
            # The model's own token after the agreed prefix (greedy rows)
            # or the residual / bonus sample (temperature rows).
            accepted.append(int(samples[i, len(accepted)]))
            room = req.params.max_tokens - len(req.output)
            accepted = accepted[:max(1, room)]
            stops = req.params.stop_token_ids or ()
            for j, t in enumerate(accepted):
                if t in stops:
                    accepted = accepted[:j + 1]
                    break
            req.output.extend(accepted)
            if prop:
                self.spec_tokens_proposed += len(prop)
                self.spec_tokens_accepted += len(accepted) - 1
                metric_defs.LLM_SPEC_PROPOSED.inc(len(prop))
                if len(accepted) > 1:
                    metric_defs.LLM_SPEC_ACCEPTED.inc(len(accepted) - 1)
            outputs.append(self._emit(req, accepted))
            if req.finished_reason:
                self.running.remove(req)
                self.block_manager.release(req)
        return outputs

    def _emit(self, req: _Request, new_tokens: List[int]) -> RequestOutput:
        metric_defs.LLM_TOKENS_GENERATED.inc(len(new_tokens))
        now = time.time()
        if req.timing["t_first_token"] is None:
            req.timing["t_first_token"] = now
            self._note_prefill(req, now)
        req.timing["t_last_token"] = now
        self._check_finished(req)
        done = req.finished_reason is not None
        if done:
            self._unpin_lora(req)
            self._finish_trace(req)
        return RequestOutput(
            req.id, req.prompt, list(req.output), done, req.finished_reason,
            self._detok(req.output) if done else None, new_tokens)

    def request_breakdown(self, req: _Request) -> Optional[Dict[str, float]]:
        """TTFT/ITL decomposition for one request from its lifecycle
        timestamps: queue_s (submit->admit), prefill_s (admit->first token,
        minus handoff time), handoff_s (disagg KV streams), decode_s
        (first->last token, minus stalls), stall_s (migration pauses)."""
        t = req.timing
        if t["t_first_token"] is None:
            return None
        t_submit = t["t_submit"]
        t_admit = t["t_admit"] if t["t_admit"] is not None else t_submit
        t_first = t["t_first_token"]
        t_last = (t["t_last_token"] if t["t_last_token"] is not None
                  else t_first)
        handoff_s = float(t.get("handoff_s") or 0.0)
        stall_s = float(t.get("pause_s") or 0.0)
        return {
            "queue_s": max(0.0, t_admit - t_submit),
            "prefill_s": max(0.0, t_first - t_admit),
            "handoff_s": handoff_s,
            "decode_s": max(0.0, t_last - t_first - handoff_s - stall_s),
            "stall_s": stall_s,
        }

    def _finish_trace(self, req: _Request):
        """Close out a finished request's latency attribution: keep its
        breakdown (`breakdowns`), observe the ray_tpu_llm_{ttft,itl}_
        breakdown_ms histograms and record the queue/prefill/decode spans
        under the request's trace (the trace id derives from the request
        id, so they stitch with the router's root span and the handoff
        spans with no context crossing a process boundary). Host work
        after the tick, as the JAX engine's."""
        bd = self.request_breakdown(req)
        if bd is None:
            return
        self.breakdowns[req.id] = bd
        while len(self.breakdowns) > BREAKDOWNS_KEPT:
            self.breakdowns.popitem(last=False)
        metric_defs.LLM_TTFT_BREAKDOWN_MS.observe(
            bd["queue_s"] * 1e3, tags={"phase": "queue"})
        metric_defs.LLM_TTFT_BREAKDOWN_MS.observe(
            bd["prefill_s"] * 1e3, tags={"phase": "prefill"})
        if bd["handoff_s"]:
            metric_defs.LLM_TTFT_BREAKDOWN_MS.observe(
                bd["handoff_s"] * 1e3, tags={"phase": "handoff"})
        # ITL phases are per inter-token gap: the mean decode gap, and the
        # stall share (migration pauses) amortized over the same gaps.
        gaps = max(1, len(req.output) - 1)
        metric_defs.LLM_ITL_BREAKDOWN_MS.observe(
            bd["decode_s"] * 1e3 / gaps, tags={"phase": "decode"})
        if bd["stall_s"]:
            metric_defs.LLM_ITL_BREAKDOWN_MS.observe(
                bd["stall_s"] * 1e3 / gaps, tags={"phase": "stall"})
        if not tracing.enabled():
            return
        t = req.timing
        t_admit = t["t_admit"] if t["t_admit"] is not None else t["t_submit"]
        with tracing.trace_context(tracing.request_trace_id(req.id), None):
            if t_admit > t["t_submit"]:
                tracing.record_span("llm:queue", "llm", t["t_submit"],
                                    t_admit, request_id=req.id)
            if not req.adopted:
                # Adopted requests prefilled elsewhere: that server
                # recorded the llm:prefill span.
                tracing.record_span(
                    "llm:prefill", "llm", t_admit, t["t_first_token"],
                    request_id=req.id, tokens=len(req.prompt))
            tracing.record_span(
                "llm:decode", "llm", t["t_first_token"], t["t_last_token"],
                request_id=req.id, tokens=len(req.output),
                finish_reason=req.finished_reason or "",
                **{k: round(v, 6) for k, v in bd.items()})

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
