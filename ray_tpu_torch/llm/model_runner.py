"""Model execution for serving: bucketed steps over a paged cache.

Port of ray_tpu/llm/model_runner.py:

  * The KV cache is a paged pool `(layers, kv_heads, num_blocks,
    block_size, head_dim)`; block tables map each sequence's logical
    positions onto pool pages.
  * `step_mixed` runs one token-major batch (decode rows and prefill chunk
    slices together), bucketed on total token count T by the engine:
    attention is ONE launch of ragged paged attention per layer (K5).
  * The split path's entry points run a rectangular (S, Bq) batch, one
    bucket of (batch, query tokens per sequence): `step` (fp32 logits of
    each sequence's last real row, for host sampling), `step_sample`
    (sampling on the device), `step_verify` (greedy ids at every row, for
    speculative verify) and `step_sample_multi` (k decode steps chained on
    the device). Their attention is the rectangular kernel (K6).
  * Attention goes through ops/paged_attention.py: the CUDA kernel on a
    CUDA tensor, the plain version on the CPU. Head dims where the JAX
    runner runs its reference (80, 96, ...) call the plain versions on
    the card too (`uses_kernel`). Every head samples with one sampler,
    `_device_sample`, so split and unified ticks draw alike.
  * Host arrays go to the device through pinned memory without waiting
    for it, and the split decode's sampled ids come back through
    `HostCopy`: nothing on the decode dispatch path synchronises.
  * PyTorch runs eagerly, so a new shape costs no compile; `step_compiles`
    still counts new shape signatures (the unit a later CUDA-graph capture
    per bucket will pay for).

The KV pool is updated in place (JAX donates and rebinds it).
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.models import llama as llama_mod
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops import resolve_device
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)

logger = logging.getLogger(__name__)


def init_kv_cache(config: llama_mod.LlamaConfig, num_blocks: int,
                  block_size: int, device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    shape = (config.n_layers, config.n_kv_heads, num_blocks, block_size,
             config.head_dim)
    return {"k": torch.zeros(shape, dtype=config.dtype, device=dev),
            "v": torch.zeros(shape, dtype=config.dtype, device=dev)}


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # Beyond the precomputed set: next power of two, never a silent cap
    # (capping would overflow the engine's padded arrays).
    return 1 << (n - 1).bit_length()


def token_buckets(budget: int) -> list:
    """Token-budget ladder for the unified step: powers of two from 8 up to
    (and always including) `budget`. Every bucket is a multiple of 8, the
    ragged kernel's q_block."""
    buckets, b = [], 8
    while b < budget:
        buckets.append(b)
        b *= 2
    buckets.append(budget)
    return buckets


# ---- counter-based sampling noise -----------------------------------------
#
# Each draw is keyed on (seed, counter) alone, so a request replayed under
# the same id redraws the same tokens whatever batch it rides in. The hash
# works on int64 tensors whose every product stays below 2**63, so CPU and
# GPU compute the same bits.

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32): partial products < 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection with full avalanche)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(N,) seeds, (N,) counters -> (N, vocab) float32 Gumbel(0, 1) noise,
    a pure function of (seed, counter, vocab index)."""
    key = _fmix32((seeds.long() & _M32) ^ 0x9E3779B9)
    key = _fmix32(key ^ (counters.long() & _M32))
    idx = _fmix32(torch.arange(vocab, device=seeds.device) + 0x632BE5AB)
    bits = _fmix32(key[:, None] ^ idx[None, :]) >> 8           # 24 bits
    u = (bits.float() + 0.5) * (1.0 / 16777216.0)              # (0, 1)
    return -torch.log(-torch.log(u))


class HostCopy:
    """A device tensor's copy into pinned host memory, started without
    waiting for the device (an event marks its end); `numpy()` waits on
    that event only. A CPU tensor is its own copy."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def uses_kernel(device_type: str, head_dim: int, n_heads: int,
                n_kv_heads: int) -> bool:
    """Whether the runner's paged attention launches K5/K6 (through the
    wrappers of ops/paged_attention.py) or calls their plain versions
    directly. The JAX runner's rule with "on a TPU" read as "on a CUDA
    device": its kernel where the head dim is a multiple of 128, its
    reference elsewhere (head dim 80, 96, ...); K5/K6 also take head dim
    64. Where the JAX rule picks its kernel and K5/K6 lack the shape (head
    dim 256, H/K > 32), raises: that kernel is ROADMAP queue 2 D."""
    if device_type != "cuda":
        return False
    if pa.kernel_fits(head_dim, n_heads, n_kv_heads):
        return True
    if head_dim % 128 == 0:
        raise ValueError(f"K5/K6 take head dims {pa.HEAD_DIMS} with "
                         f"H/K <= 32, not head_dim {head_dim}, H={n_heads}, "
                         f"K={n_kv_heads}; that kernel is ROADMAP queue 2 D")
    return False


class ModelRunner:
    """Eager bucketed steps over a paged cache, on one device."""

    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
    NEG_INF = -1e30

    def __init__(self, config: llama_mod.LlamaConfig, params: Dict,
                 num_blocks: int, block_size: int = 16,
                 chunk_size: int = 128,
                 max_blocks_per_seq: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        kernel = uses_kernel(self.device.type, config.head_dim,
                             config.n_heads, config.n_kv_heads)
        self._unified_attention = (
            pa.ragged_paged_attention_unified if kernel
            else pa.ragged_paged_attention_unified_reference)
        self._rect_attention = (pa.ragged_paged_attention if kernel
                                else pa.ragged_paged_attention_reference)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.chunk_size = chunk_size
        self.max_blocks_per_seq = max_blocks_per_seq or (
            (config.max_seq + block_size - 1) // block_size)
        self.params = _place(params, self.device)
        self.cache = init_kv_cache(config, num_blocks, block_size,
                                   self.device)
        self.cos, self.sin = rope_frequencies(
            config.head_dim, config.max_seq, config.rope_theta,
            device=self.device)
        self._seen_shapes: set = set()
        self.step_compiles = 0

    def _note_shapes(self, kind: str, *arrs) -> bool:
        """Record the padded shape signature entering the step. Returns True
        (counting it in step_compiles) when the signature is new."""
        key = (kind,) + tuple(tuple(np.shape(a)) for a in arrs)
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        self.step_compiles += 1
        logger.info("llm step shape #%d: %s", self.step_compiles, key)
        return True

    def to_device(self, a, dtype=torch.int32) -> torch.Tensor:
        """A host array (or a tensor) as `dtype` on the runner's device.
        Host arrays travel through pinned memory with a non-blocking copy:
        the upload never waits for queued device work."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=dtype)
        t = torch.as_tensor(np.ascontiguousarray(a)).to(dtype)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---- the unified ragged step -----------------------------------------

    def _backbone_mixed(self, tokens, q_positions, kv_lens, cu_q_lens,
                        block_tables, n_real: int) -> torch.Tensor:
        """Token-major backbone: `tokens` is flat (T,); sequence s owns rows
        [cu_q_lens[s], cu_q_lens[s+1]) and rows from n_real = cu_q_lens[S]
        on are padding. Writes this step's K/V into the pool and returns
        the final hidden states (T, d)."""
        config = self.config
        params = self.params
        T = tokens.shape[0]
        S = kv_lens.shape[0]
        H, K, hd = config.n_heads, config.n_kv_heads, config.head_dim
        scale = 1.0 / math.sqrt(hd)
        seq = pa.token_seq_ids(cu_q_lens, T, S)
        local = torch.arange(T, device=self.device) - cu_q_lens.long()[seq]
        positions = q_positions.long()[seq] + local
        x = params["embed"][tokens.long()].to(config.dtype)      # (T, d)
        logical_block = torch.clamp(positions // self.block_size, 0,
                                    block_tables.shape[1] - 1)
        # Only the n_real valid rows are written: torch has no drop mode
        # for out-of-bounds scatter indices, and -1 would wrap onto the
        # pool's last page.
        block_ids = block_tables.long()[seq, logical_block][:n_real]
        offsets = (positions % self.block_size)[:n_real]
        rope_pos = torch.clamp(positions, 0, config.max_seq - 1)
        layers = params["layers"]
        for li in range(config.n_layers):
            h = rms_norm(x, layers["attn_norm"][li], config.norm_eps)
            q = (h @ layers["wq"][li]).reshape(T, H, hd)
            k = (h @ layers["wk"][li]).reshape(T, K, hd)
            v = (h @ layers["wv"][li]).reshape(T, K, hd)
            q = apply_rope(q, self.cos, self.sin, rope_pos)
            k = apply_rope(k, self.cos, self.sin, rope_pos)
            ck, cv = self.cache["k"][li], self.cache["v"][li]
            # ck is (K, num_blocks, ps, hd): indexing [:, ids, offs] keeps
            # the kv-head dim FIRST, so the value is (K, n, hd) — token i's
            # K lands in page ids[i], slot offs[i], as JAX's
            # ck.at[li, :, ids, offs].set((T, K, hd)) writes it.
            ck[:, block_ids, offsets] = k[:n_real].transpose(0, 1)
            cv[:, block_ids, offsets] = v[:n_real].transpose(0, 1)
            attn = self._unified_attention(
                q, ck, cv, block_tables, kv_lens, q_positions, cu_q_lens,
                scale=scale)
            x = x + attn.reshape(T, H * hd) @ layers["wo"][li]
            h = rms_norm(x, layers["mlp_norm"][li], config.norm_eps)
            x = x + swiglu(h @ layers["w_gate"][li],
                           h @ layers["w_up"][li]) @ layers["w_down"][li]
        return rms_norm(x, params["final_norm"], config.norm_eps)

    def _logits(self, rows: torch.Tensor) -> torch.Tensor:
        """lm_head with fp32 accumulation AND fp32 output (not a bf16
        result cast up): logits feed argmax and sampling."""
        lm_head = self.params["lm_head"]
        if lm_head.dtype == torch.float32:
            return rows.float() @ lm_head
        if rows.is_cuda:
            return torch.mm(rows, lm_head, out_dtype=torch.float32)
        # CPU: the plain version (no reduced-precision mm kernel there).
        return rows.float() @ lm_head.float()

    @torch.no_grad()
    def step_mixed(self, tokens, q_positions, kv_lens, cu_q_lens,
                   block_tables, out_rows, proposals, prop_lens, temps,
                   top_ks, top_ps, seeds, counters, lora_idx=None):
        """One unified ragged launch per layer for a mixed decode / prefill
        batch. Inputs are host arrays padded by the engine (JAX's
        signature). Returns host arrays (accept (S, W) bool,
        samples (S, W) int32): row (s, j) samples with key
        (seeds[s], counters[s] + j). Speculative proposals are a later
        slice: any prop_lens > 0 raises, and accept is all False."""
        prop_lens = np.asarray(prop_lens)
        if prop_lens.any():
            raise ValueError("speculative proposals (prop_lens > 0) are not "
                             "ported yet (ROADMAP.md: speculative decoding)")
        if lora_idx is not None:
            raise ValueError("LoRA is not ported yet (ROADMAP.md)")
        self._note_shapes("mixed", tokens, out_rows, block_tables)
        cu_host = np.asarray(cu_q_lens)
        n_real = int(cu_host[-1])
        x = self._backbone_mixed(
            self.to_device(tokens), self.to_device(q_positions),
            self.to_device(kv_lens), self.to_device(cu_host),
            self.to_device(block_tables), n_real)
        out_rows = np.asarray(out_rows)
        S, W = out_rows.shape
        logits = self._logits(x[self.to_device(out_rows.reshape(-1),
                                             torch.long)])
        counters = (np.repeat(np.asarray(counters, np.int64), W)
                    + np.tile(np.arange(W), S))
        samples = self._device_sample(
            logits, np.repeat(temps, W), np.repeat(top_ks, W),
            np.repeat(top_ps, W), np.repeat(seeds, W), counters)
        samples = samples.reshape(S, W).cpu().numpy()
        return np.zeros((S, W), dtype=bool), samples

    def warm_mixed(self, T: int, S: int, W: int):
        """Run the mixed step for token bucket T on all-padding inputs
        (cu_q_lens all zero: no KV write, cache untouched, outputs
        ignored) so the bucket's first real tick pays no first-use cost."""
        z = lambda *s: np.zeros(s, np.int32)
        self.step_mixed(
            z(T), z(S), z(S), z(S + 1), z(S, self.max_blocks_per_seq),
            z(S, W), z(S, W), z(S), np.zeros(S, np.float32), z(S),
            np.ones(S, np.float32), z(S), z(S))

    # ---- the rectangular steps of the split path -------------------------

    def _backbone(self, tokens, q_positions, kv_lens, q_lens,
                  block_tables) -> torch.Tensor:
        """Rectangular backbone: `tokens` (S, Bq) is a host array or a
        device tensor (the previous step's sampled ids); q_positions,
        kv_lens, q_lens (S,) and block_tables (S, max_pages) are host
        arrays. Row (s, b) sits at position q_positions[s] + b. Writes the
        K/V of the valid rows b < q_lens[s] into the pool and returns the
        final hidden states, flat (S * Bq, d)."""
        config = self.config
        params = self.params
        S, Bq = np.shape(tokens)
        H, K, hd = config.n_heads, config.n_kv_heads, config.head_dim
        scale = 1.0 / math.sqrt(hd)
        tables = np.asarray(block_tables)
        positions = (np.asarray(q_positions, np.int64)[:, None]
                     + np.arange(Bq)[None, :])
        # Only the valid rows are written: torch has no drop mode for
        # out-of-bounds scatter indices, and -1 would wrap onto the pool's
        # last page. The rows, pages and slots are known on the host.
        s_idx, b_idx = np.nonzero(
            np.arange(Bq)[None, :] < np.asarray(q_lens)[:, None])
        pos = positions[s_idx, b_idx]
        logical = np.clip(pos // self.block_size, 0, tables.shape[1] - 1)
        n_valid = len(s_idx)
        rows = self.to_device(s_idx * Bq + b_idx, torch.long)
        block_ids = self.to_device(tables[s_idx, logical], torch.long)
        offsets = self.to_device(pos % self.block_size, torch.long)
        rope_pos = self.to_device(
            np.clip(positions, 0, config.max_seq - 1).reshape(-1), torch.long)
        tables_t = self.to_device(tables)
        kv_lens_t = self.to_device(kv_lens)
        q_pos_t = self.to_device(q_positions)
        x = params["embed"][self.to_device(tokens, torch.long).reshape(-1)]
        x = x.to(config.dtype)                                  # (S*Bq, d)
        layers = params["layers"]
        for li in range(config.n_layers):
            h = rms_norm(x, layers["attn_norm"][li], config.norm_eps)
            q = (h @ layers["wq"][li]).reshape(S * Bq, H, hd)
            k = (h @ layers["wk"][li]).reshape(S * Bq, K, hd)
            v = (h @ layers["wv"][li]).reshape(S * Bq, K, hd)
            q = apply_rope(q, self.cos, self.sin, rope_pos)
            k = apply_rope(k, self.cos, self.sin, rope_pos)
            ck, cv = self.cache["k"][li], self.cache["v"][li]
            if n_valid:
                # Kv-head dim first, as in _backbone_mixed.
                ck[:, block_ids, offsets] = k[rows].transpose(0, 1)
                cv[:, block_ids, offsets] = v[rows].transpose(0, 1)
            attn = self._rect_attention(
                q.reshape(S, Bq, H, hd), ck, cv, tables_t, kv_lens_t,
                q_pos_t, scale=scale)
            x = x + attn.reshape(S * Bq, H * hd) @ layers["wo"][li]
            h = rms_norm(x, layers["mlp_norm"][li], config.norm_eps)
            x = x + swiglu(h @ layers["w_gate"][li],
                           h @ layers["w_up"][li]) @ layers["w_down"][li]
        return rms_norm(x, params["final_norm"], config.norm_eps)

    def _last_logits(self, tokens, q_positions, kv_lens, q_lens,
                     block_tables) -> torch.Tensor:
        """fp32 logits (S, vocab) of each sequence's last real row: only
        those rows pay the vocab matmul."""
        x = self._backbone(tokens, q_positions, kv_lens, q_lens,
                           block_tables)
        S, Bq = np.shape(tokens)
        last = np.arange(S) * Bq + np.maximum(np.asarray(q_lens) - 1, 0)
        return self._logits(x[self.to_device(last, torch.long)])

    @torch.no_grad()
    def step(self, tokens, q_positions, kv_lens, q_lens,
             block_tables) -> torch.Tensor:
        """One rectangular step; inputs are host arrays padded to a
        (batch, Bq) bucket by the engine. Returns fp32 logits (S, vocab) of
        the last real row per sequence, on the device (host sampling)."""
        self._note_shapes("step", tokens, block_tables)
        return self._last_logits(tokens, q_positions, kv_lens, q_lens,
                                 block_tables)

    @torch.no_grad()
    def step_verify(self, tokens, q_positions, kv_lens, q_lens,
                    block_tables) -> torch.Tensor:
        """Speculative-verify step: greedy ids (S, Bq) int32 on the device;
        row j's id is the model's next token after tokens[:, :j+1]. The
        same `_logits` expression as `step` and `step_mixed`, so all heads
        round alike."""
        self._note_shapes("verify", tokens, block_tables)
        x = self._backbone(tokens, q_positions, kv_lens, q_lens,
                           block_tables)
        return torch.argmax(self._logits(x), dim=-1).to(
            torch.int32).reshape(np.shape(tokens))

    @torch.no_grad()
    def step_sample(self, tokens, q_positions, kv_lens, q_lens,
                    block_tables, temps, top_ks, top_ps, seeds,
                    counters) -> torch.Tensor:
        """Rectangular step + sampling on the device. `tokens` may be a
        device tensor (the previous step's ids: chaining without a host
        sync). Returns the sampled ids (S,) int32 on the device; the
        caller decides when to fetch them."""
        self._note_shapes("sample", tokens, block_tables)
        logits = self._last_logits(tokens, q_positions, kv_lens, q_lens,
                                   block_tables)
        return self._device_sample(logits, temps, top_ks, top_ps, seeds,
                                   counters)

    @torch.no_grad()
    def step_sample_multi(self, n_steps: int, tokens, q_positions, kv_lens,
                          q_lens, block_tables, temps, top_ks, top_ps, seeds,
                          counters) -> torch.Tensor:
        """n_steps decode tokens per sequence in one call (JAX's lax.scan
        as a loop): each step's sampled ids feed the next on the device,
        with q_positions, kv_lens and counters advanced by the step; no
        host sync between steps. The engine has allocated pages for all of
        them. Returns int32 (S, n_steps) on the device."""
        self._note_shapes(f"multi{n_steps}", tokens, block_tables)
        q_positions = np.asarray(q_positions)
        kv_lens = np.asarray(kv_lens)
        counters = np.asarray(counters, np.int64)
        out = []
        for step in range(n_steps):
            logits = self._last_logits(tokens, q_positions + step,
                                       kv_lens + step, q_lens, block_tables)
            sampled = self._device_sample(logits, temps, top_ks, top_ps,
                                          seeds, counters + step)
            out.append(sampled)
            tokens = sampled[:, None]
        return torch.stack(out, dim=1)

    # ---- on-device sampling ----------------------------------------------

    def _filter_logits(self, logits, temps, top_ks, top_ps):
        """Temperature / top-k / top-p filtering. top-p keeps the smallest
        prefix with mass >= p, the crossing token included (vLLM
        semantics). Returns filtered scaled logits; sampling from their
        softmax is the target distribution."""
        S, V = logits.shape
        scaled = logits / torch.clamp(temps[:, None], min=1e-6)
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        k_eff = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, V))
        kth = torch.gather(sorted_desc, 1,
                           torch.clamp(k_eff - 1, 0, V - 1)[:, None].long())
        neg = torch.full_like(scaled, self.NEG_INF)
        scaled = torch.where(scaled >= kth, scaled, neg)
        probs = torch.softmax(scaled, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(sp, dim=-1)
        # Keep token j iff the mass BEFORE it is < top_p (the crossing
        # token stays; robust to an fp32 cumsum that never reaches 1.0).
        keep_sorted = (csum - sp) < top_ps[:, None]
        cutoff = torch.where(keep_sorted, sp,
                             torch.full_like(sp, float("inf"))).amin(
                                 dim=-1, keepdim=True)
        return torch.where(probs >= cutoff, scaled, neg)

    def _device_sample(self, logits, temps, top_ks, top_ps, seeds,
                       counters) -> torch.Tensor:
        """The one sampler of every head: greedy where temps <= 0, else
        Gumbel-max over `_filter_logits` with noise keyed on (seeds,
        counters). Sampling parameters are host arrays (N,); the draw of a
        row depends on its own (seed, counter) only, so split and unified
        ticks sample alike. Returns int32 ids (N,) on the device."""
        samples = torch.argmax(logits, dim=-1)
        temps = np.asarray(temps, np.float32)
        if (temps > 0).any():
            temps_t = self.to_device(temps, torch.float32)
            scaled = self._filter_logits(
                logits, temps_t, self.to_device(top_ks, torch.int64),
                self.to_device(top_ps, torch.float32))
            noise = gumbel_noise(self.to_device(seeds, torch.int64),
                                 self.to_device(counters, torch.int64),
                                 logits.shape[-1])
            drawn = torch.argmax(scaled + noise, dim=-1)
            samples = torch.where(temps_t > 0, drawn, samples)
        return samples.to(torch.int32)

    # ---- buckets -----------------------------------------------------------

    def batch_bucket(self, n: int) -> int:
        return _bucket(n, self.BATCH_BUCKETS)

    def chunk_buckets(self) -> list:
        """Prefill-chunk bucket ladder: powers of two from 8 up to (and
        always including) chunk_size."""
        return token_buckets(self.chunk_size)

    def chunk_bucket(self, n: int) -> int:
        return _bucket(n, self.chunk_buckets())


def _place(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    return tree.to(device)
