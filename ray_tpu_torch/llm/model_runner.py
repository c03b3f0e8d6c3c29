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
    the card too (`uses_kernel`).
  * `step_mixed` samples with `acceptance_sample`, the counterpart of JAX
    `_step_mixed`'s seeded acceptance sampler: rows without a proposal
    draw exactly as the plain sampler does.
  * On a CUDA device each token bucket of `step_mixed` replays captured
    CUDA graphs (the counterpart of the JAX runner's one compiled program
    per bucket; two variants, all-greedy and sampled): embedding, every layer
    with its K5 launch, the head and the sampler replay from static
    buffers that take ONE packed int32 upload per tick, all buckets in
    one graph memory pool. `step_compiles`
    counts captures on the card and new shape signatures on the CPU,
    where the same step runs eagerly; `cuda_graphs=False` runs it eagerly
    on the card.
  * Host arrays go to the device through pinned memory without waiting
    for it, and the split decode's sampled ids come back through
    `HostCopy`: nothing on the decode dispatch path synchronises. The
    split path's steps run eagerly.
  * Multi-LoRA (`lora_manager`, llm/lora.py): every entry point takes a
    per-sequence adapter slot (`lora_idx`) and each target projection
    adds its delta where JAX's `proj` does. The slot stacks are static
    tensors of the captured graphs and the slot index one more field of
    the packed upload; a graph key holds the stacks' epoch, so a
    `resize` recaptures. Without a manager no step holds a LoRA
    operation.
  * The page plane: `gather_pages` / `scatter_pages` move whole KV pages
    between the pool and host arrays in JAX's layout (bf16 as uint16
    bits), for request export/adopt and the host prefix tier.
  * Tensor parallelism (`mesh=`, a DeviceMesh whose `tp` axis has more
    than one rank; llm/tp.py builds the world): parameters are this rank's
    shards by `SERVE_RULES` (wq, wk, wv, w_gate, w_up column-parallel, wo
    and w_down row-parallel, embed and lm_head over the vocabulary), the
    KV pool holds this rank's n_kv_heads / tp heads and K5/K6 run on its
    n_heads / tp query heads. Each layer all-reduces after wo and after
    w_down; the embedding is a masked lookup plus an all-reduce; the fp32
    logits are all-gathered along the vocabulary before sampling, so every
    rank samples the same ids. Rank 0 (`channel=`) runs the engine and
    sends each entry point to the other ranks before running it itself:
    the unified step as a small header (its bucket key), its packed input
    then reaching them inside the step (and inside its CUDA graph) as a
    broadcast from rank 0; the other entry points as a pickled call whose
    tensors go over the device group. The page plane gathers and scatters
    the ranks' kv-head slices, so it speaks the whole-pool layout.

The KV pool is updated in place (JAX donates and rebinds it). It holds
one scratch page past the block manager's `num_blocks`, the counterpart
of JAX's out-of-bounds drop: the unified step's padding rows write there,
so its KV write has one shape per bucket. No block table names it. A
captured graph holds the addresses of the pool, the parameters and the
LoRA stacks: `scatter_pages`, `LoRAManager.load_adapter` and
`LLMEngine.update_weights` write into them in place; only a LoRA
`resize` reallocates, and it recaptures.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.llm.lora import slot_mask
from ray_tpu_torch.models import llama as llama_mod
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops import resolve_device, to_numpy, to_torch
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.sharding import SERVE_RULES, shard, spec_for

logger = logging.getLogger(__name__)


NEG_INF = -1e30


def init_kv_cache(config: llama_mod.LlamaConfig, num_blocks: int,
                  block_size: int, device="cuda",
                  kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The K and V pools, (layers, kv_heads, num_blocks, block_size,
    head_dim); `kv_heads` is this rank's share under tensor parallelism
    (all of them by default)."""
    dev = resolve_device(device)
    shape = (config.n_layers, kv_heads or config.n_kv_heads, num_blocks,
             block_size, config.head_dim)
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


# Streams of the acceptance sampler: 0 is the plain sampler's draw (a
# bonus slot, or a row without a proposal), the others are the
# counterparts of JAX's fold_in(base, 101) and fold_in(base, 102).
STREAM_SAMPLE, STREAM_ACCEPT, STREAM_RESIDUAL = 0, 1, 2


def uniform_noise(seeds: torch.Tensor, counters: torch.Tensor, vocab: int,
                  streams: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) seeds, (N,) counters, optional (N,) stream ids -> (N, vocab)
    float32 uniform (0, 1) noise, a pure function of (seed, counter,
    stream, vocab index). Stream 0 (or no streams) is the key without a
    stream mixed in."""
    key = _fmix32((seeds.long() & _M32) ^ 0x9E3779B9)
    key = _fmix32(key ^ (counters.long() & _M32))
    if streams is not None:
        mixed = _fmix32(key ^ _fmix32((streams.long() & _M32) + 0x7F4A7C15))
        key = torch.where(streams == 0, key, mixed)
    idx = _fmix32(torch.arange(vocab, device=seeds.device) + 0x632BE5AB)
    bits = _fmix32(key[:, None] ^ idx[None, :]) >> 8           # 24 bits
    return (bits.float() + 0.5) * (1.0 / 16777216.0)           # (0, 1)


def gumbel_noise(seeds: torch.Tensor, counters: torch.Tensor, vocab: int,
                 streams: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) seeds, (N,) counters -> (N, vocab) float32 Gumbel(0, 1) noise,
    a pure function of (seed, counter, stream, vocab index)."""
    return -torch.log(-torch.log(uniform_noise(seeds, counters, vocab,
                                               streams)))


def filter_logits(logits, temps, top_ks, top_ps):
    """Temperature / top-k / top-p filtering of (N, V) logits with (N,)
    parameters. top-p keeps the smallest prefix with mass >= p, the
    crossing token included (vLLM semantics). Returns filtered scaled
    logits; sampling from their softmax is the target distribution."""
    S, V = logits.shape
    scaled = logits / torch.clamp(temps[:, None], min=1e-6)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, V))
    kth = torch.gather(sorted_desc, 1,
                       torch.clamp(k_eff - 1, 0, V - 1)[:, None].long())
    neg = torch.full_like(scaled, NEG_INF)
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


def acceptance_sample(logits, proposals, prop_lens, temps, top_ks, top_ps,
                      seeds, counters, sampled: bool = True):
    """Seeded acceptance sampling of the unified step, JAX `_step_mixed`'s
    sampler on tensors: logits (S*W, V) fp32, row s*W + j read after
    proposal tokens 0..j-1 of sequence s; proposals (S, W) and prop_lens
    (S,) the draft (length 0 for plain rows); temps, top_ks, top_ps,
    seeds, counters (S,). Row (s, j) keys on (seeds[s], counters[s] + j).

    Returns (accept (S, W) bool, samples (S, W) int32). Greedy rows
    (temps <= 0): accept = argmax == proposal, sample = argmax. Temperature
    rows: accept = u < softmax(filtered)[proposal], the rejection test of
    a point-mass draft; the sample is the plain Gumbel-max draw on a bonus
    slot (j >= prop_len) and a residual draw with the proposal masked out
    on the others. A slot commits either draw, never both, so one Gumbel
    stream per row serves: stream 0 on bonus slots (a row without a
    proposal reproduces the plain sampler bit for bit), the residual
    stream elsewhere; u has a stream of its own. Every row runs every
    branch and `torch.where` picks (no host branch, so a CUDA graph
    captures it). `sampled=False` promises every row greedy and runs the
    greedy branch alone: the filter's sorts and the noise over the
    vocabulary cost a greedy decode tick ~7% of its device time, and the
    result is the same."""
    S, W = proposals.shape
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    if not sampled:
        accept = greedy == proposals.reshape(-1)
        return accept.reshape(S, W), greedy.to(torch.int32).reshape(S, W)

    def rep(a):
        return a[:, None].expand(S, W).reshape(-1)

    t = rep(temps)
    scaled = filter_logits(logits, t, rep(top_ks), rep(top_ps))
    j = torch.arange(W, device=logits.device).repeat(S)
    n = rep(counters).long() + j
    sd = rep(seeds)
    is_bonus = j >= rep(prop_lens)
    prop = proposals.reshape(-1).long()[:, None]
    streams = (~is_bonus).long() * STREAM_RESIDUAL   # else STREAM_SAMPLE
    noise = gumbel_noise(sd, n, V, streams)
    masked = torch.where(is_bonus[:, None], scaled,
                         scaled.scatter(1, prop, NEG_INF))
    drawn = torch.argmax(masked + noise, dim=-1)
    u = uniform_noise(sd, n, 1, torch.full_like(j, STREAM_ACCEPT))[:, 0]
    p_prop = torch.softmax(scaled, dim=-1).gather(1, prop)[:, 0]
    is_greedy = t <= 0
    accept = torch.where(is_greedy, greedy == prop[:, 0], u < p_prop)
    samples = torch.where(is_greedy, greedy, drawn)
    return accept.reshape(S, W), samples.to(torch.int32).reshape(S, W)


# The unified step's inputs cross to the device as ONE packed int32 array:
# (field, shape) in order, each field starting 16-byte aligned. Floats
# travel as their bits; seeds and counters as their low 32 bits (all the
# noise keys on).
_FLOAT_FIELDS = ("temps", "top_ps")


def mixed_layout(T: int, S: int, W: int, max_pages: int,
                 lora: bool = False):
    """{field: (offset, shape)} of the packed input of a mixed step for
    token bucket T, S sequences, W rows per sequence; and its length.
    With `lora`, the (S,) adapter slot per sequence rides last."""
    shapes = {"tokens": (T,), "q_positions": (S,), "kv_lens": (S,),
              "cu_q_lens": (S + 1,), "block_tables": (S, max_pages),
              "out_rows": (S, W), "proposals": (S, W), "prop_lens": (S,),
              "top_ks": (S,), "seeds": (S,), "counters": (S,),
              "temps": (S,), "top_ps": (S,)}
    if lora:
        shapes["lora_idx"] = (S,)
    layout, at = {}, 0
    for name, shape in shapes.items():
        layout[name] = (at, shape)
        at += -(-math.prod(shape) // 4) * 4
    return layout, at


def pack_mixed(layout: dict, size: int, arrays: dict,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host arrays -> the packed int32 input (into `out` when given)."""
    buf = np.zeros(size, np.int32) if out is None else out
    for name, (at, shape) in layout.items():
        a = np.asarray(arrays[name])
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, the bucket needs "
                             f"{shape}")
        if name in _FLOAT_FIELDS:
            a = a.astype(np.float32).view(np.int32)
        else:
            a = (a.astype(np.int64) & _M32).astype(np.uint32).view(np.int32)
        buf[at:at + a.size] = a.reshape(-1)
    return buf


def unpack_mixed(buf: torch.Tensor, layout: dict) -> dict:
    """The packed input on the device -> {field: view of `buf`}."""
    out = {}
    for name, (at, shape) in layout.items():
        t = buf[at:at + math.prod(shape)].view(shape)
        out[name] = t.view(torch.float32) if name in _FLOAT_FIELDS else t
    return out


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


# Commands of rank 0 to the other ranks of a tensor-parallel world
# (llm/tp.py adds the world's own).
CMD_MIXED, CMD_CALL = 1, 2


@dataclasses.dataclass(frozen=True)
class _TensorArg:
    """Stands for the i-th tensor of a call sent to the other ranks."""
    i: int


def _fanned(fn):
    """A runner entry point that rank 0 of a tensor-parallel world first
    sends to the other ranks, which run it on their shards (their result is
    dropped)."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        if self._channel is None:
            return fn(self, *args, **kwargs)
        with self._channel.guard():
            self._call(fn.__name__, *args, **kwargs)
            return fn(self, *args, **kwargs)
    return run


def check_tensor_parallel(config: llama_mod.LlamaConfig, tp: int) -> None:
    """Raise unless `tp` ranks can split the heads, kv heads, vocabulary
    and MLP width evenly."""
    split = {"n_heads": config.n_heads, "n_kv_heads": config.n_kv_heads,
             "vocab_size": config.vocab_size, "d_ff": config.d_ff}
    bad = {k: v for k, v in split.items() if v % tp}
    if tp < 1 or bad:
        raise ValueError(f"tensor_parallel={tp} does not divide {bad}")


def param_axes_at(keys: Sequence[str]):
    """The logical axes of the parameter at `keys` (llama's names)."""
    axes = llama_mod.param_logical_axes()
    for k in keys:
        axes = axes[k]
    return axes


@dataclasses.dataclass
class _MixedGraph:
    """One token bucket's captured mixed step: the graph, its static
    packed input on the device and its pinned host twin, its static
    output (samples then accept, int32) and logits, and the K5 launches
    one replay makes."""
    graph: "torch.cuda.CUDAGraph"
    dev_in: torch.Tensor
    host_in: torch.Tensor
    dev_out: torch.Tensor
    logits: torch.Tensor
    launches: int


class ModelRunner:
    """Bucketed steps over a paged cache, on one device (this rank's, under
    a tensor-parallel `mesh`): the unified step replays one CUDA graph per
    token bucket on the card (eager with `cuda_graphs=False`, and always on
    the CPU); the split path's steps run eagerly. Under a mesh `params` are
    this rank's shards (llm/tp.py `local_params`), and rank 0 passes the
    world's `channel`."""

    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
    NEG_INF = NEG_INF

    def __init__(self, config: llama_mod.LlamaConfig, params: Dict,
                 num_blocks: int, block_size: int = 16,
                 chunk_size: int = 128,
                 max_blocks_per_seq: Optional[int] = None,
                 device="cuda", cuda_graphs: Optional[bool] = None,
                 lora_manager=None, mesh=None, channel=None):
        self.device = resolve_device(device)
        if cuda_graphs and self.device.type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, not "
                             f"{self.device}")
        # None: graphs wherever there is a card to capture them on.
        self.cuda_graphs = (self.device.type == "cuda" if cuda_graphs is None
                            else bool(cuda_graphs))
        self.config = config
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.size(
            mesh.mesh_dim_names.index("tp"))
        self.tp_rank = 0 if self.tp == 1 else mesh.get_local_rank("tp")
        self._tp_group = None if self.tp == 1 else mesh.get_group("tp")
        # Rank 0 of a tensor-parallel world sends every entry point to the
        # others through it; None on the others and without a mesh.
        self._channel = channel
        check_tensor_parallel(config, self.tp)
        self.n_heads = config.n_heads // self.tp
        self.n_kv_heads = config.n_kv_heads // self.tp
        kernel = uses_kernel(self.device.type, config.head_dim,
                             self.n_heads, self.n_kv_heads)
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
        # The global shape and dtype of every parameter (meta tensors):
        # what update_weights checks a payload against.
        self.params_meta = _map_params(
            lambda keys, p: torch.empty(self._global_shape(keys, p),
                                        dtype=p.dtype, device="meta"),
            self.params)
        # Multi-LoRA (llm/lora.py): with a manager, every step takes a
        # per-sequence slot index and adds each target's delta; without
        # one, no step (and no captured graph) holds a LoRA operation.
        self.lora = lora_manager
        if lora_manager is not None:
            if lora_manager.device != self.device:
                raise ValueError(f"LoRA stacks on {lora_manager.device}, "
                                 f"runner on {self.device}")
            if lora_manager.tp != (self.tp_rank, self.tp):
                raise ValueError(f"LoRA stacks for tp {lora_manager.tp}, "
                                 f"runner at {(self.tp_rank, self.tp)}")
            if channel is not None:
                lora_manager.fanout = self._call
        # Page num_blocks is the scratch page of the unified step's
        # padding rows.
        self.cache = init_kv_cache(config, num_blocks + 1, block_size,
                                   self.device, self.n_kv_heads)
        self.cos, self.sin = rope_frequencies(
            config.head_dim, config.max_seq, config.rope_theta,
            device=self.device)
        self._seen_shapes: set = set()
        self.step_compiles = 0
        self._graphs: Dict[tuple, _MixedGraph] = {}
        self._graph_pool = None
        self._graph_epoch = 0   # the LoRA stacks' epoch the graphs hold
        # fp32 logits (S*W, V) of the last mixed step, for inspection (on
        # the card with graphs: the bucket's static output).
        self.last_logits: Optional[torch.Tensor] = None
        # Called by close(): llm/tp.py sets it on rank 0 of a world.
        self.on_close = None

    # ---- tensor parallelism ------------------------------------------------

    def _global_shape(self, keys, local: torch.Tensor) -> tuple:
        spec = spec_for(param_axes_at(keys), SERVE_RULES)
        return tuple(n * (self.tp if "tp" in axes else 1)
                     for n, axes in zip(local.shape, spec))

    def _call(self, path: str, *args, **kwargs) -> None:
        """Send `self.<path>(*args, **kwargs)` to the other ranks; tensor
        arguments go over the device group."""
        tensors = []

        def strip(a):
            if isinstance(a, torch.Tensor):
                tensors.append(a)
                return _TensorArg(len(tensors) - 1)
            return a

        payload = (path, [strip(a) for a in args],
                   {k: strip(v) for k, v in kwargs.items()})
        self._channel.send(CMD_CALL, payload=payload, tensors=tensors)

    def run_call(self, payload, tensors) -> None:
        """Another rank's side of `_call`."""
        path, args, kwargs = payload

        def put(a):
            return tensors[a.i] if isinstance(a, _TensorArg) else a

        fn = self
        for name in path.split("."):
            fn = getattr(fn, name)
        fn(*[put(a) for a in args], **{k: put(v) for k, v in kwargs.items()})

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The row-parallel products' sum over the tp ranks (in place)."""
        if self.tp > 1:
            dist.all_reduce(x, group=self._tp_group)
        return x

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding rows of `tokens` in config.dtype; under tp each rank
        looks up the ids in its vocabulary rows (others zero) and the ranks
        sum."""
        table = self.params["embed"]
        if self.tp == 1:
            return table[tokens].to(self.config.dtype)
        rows = table.shape[0]
        local = tokens - self.tp_rank * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * inside[:, None].to(table.dtype)
        return self._all_reduce(x).to(self.config.dtype)

    def close(self) -> None:
        """Under tensor parallelism, release the CUDA graphs (they hold the
        world's collectives) and, on rank 0, the other ranks."""
        if self.tp > 1:
            for g in self._graphs.values():
                g.graph.reset()
            self._graphs.clear()
            self._graph_pool = self.last_logits = None
        if self.on_close is not None:
            fn, self.on_close = self.on_close, None
            fn()

    def _note_shapes(self, kind: str, *arrs) -> bool:
        """Record the padded shape signature entering the step. Returns True
        (counting it in step_compiles) when the signature is new."""
        key = (kind,) + tuple(tuple(np.shape(a)) for a in arrs)
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        self.step_compiles += 1
        from ray_tpu_torch.runtime import metric_defs
        from ray_tpu_torch.util import tracing

        metric_defs.LLM_STEP_COMPILES.inc()
        logger.info("llm step shape #%d: %s", self.step_compiles, key)
        # Instant span: the capture (or first eager run) happens in the
        # dispatch that follows; a marker in the request timeline is what
        # attributes the one slow inter-token gap to it.
        t = time.time()
        tracing.record_span("llm:step_compile", "llm", t, t,
                            entry_point=kind,
                            compile_index=self.step_compiles)
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

    def _lora_mask(self, tok_slots) -> Optional[torch.Tensor]:
        """(T,) adapter slot per row -> the (T, n_slots * r) mask of the
        rows' own slot columns; None without a manager."""
        lm = self.lora
        if lm is None:
            return None
        return slot_mask(tok_slots, lm.n_slots, lm.rank, self.config.dtype)

    def _project(self, h, li: int, names, mask):
        """h @ W of layer li for each target in `names` (targets that read
        the same input). With a LoRA mask each adapter target adds its
        delta where JAX's `proj` does: one product of h with the group's
        A of every slot, the columns of other slots zeroed, then one
        in-place addmm per target with its B of every slot."""
        layers = self.params["layers"]
        outs = [h @ layers[n][li] for n in names]
        lm = self.lora
        if mask is None:
            return outs
        group = tuple(n for n in names if n in lm.b)
        if not group:
            return outs
        N = lm.n_slots * lm.rank
        mid = (h @ lm.a_group[group][li]).view(-1, len(group), N)
        mid = mid * mask[:, None, :]
        for g, n in enumerate(group):
            outs[names.index(n)].addmm_(mid[:, g], lm.b[n][li])
        return outs

    def _layers(self, x, rope_pos, mask, attend, write_kv):
        """The decoder layers over flat rows x (T, d) at RoPE positions
        rope_pos (T,): `write_kv(li, k, v)` stores the layer's K/V (T, K,
        hd), `attend(li, q)` returns its attention output (T, H, hd).
        Returns the final-normed hidden states."""
        config = self.config
        T = x.shape[0]
        params = self.params
        H, K, hd = self.n_heads, self.n_kv_heads, config.head_dim
        layers = params["layers"]
        for li in range(config.n_layers):
            h = rms_norm(x, layers["attn_norm"][li], config.norm_eps)
            q, k, v = self._project(h, li, ("wq", "wk", "wv"), mask)
            q = apply_rope(q.reshape(T, H, hd), self.cos, self.sin,
                           rope_pos)
            k = apply_rope(k.reshape(T, K, hd), self.cos, self.sin,
                           rope_pos)
            write_kv(li, k, v.reshape(T, K, hd))
            attn = attend(li, q)
            x = x + self._all_reduce(self._project(
                attn.reshape(T, H * hd), li, ("wo",), mask)[0])
            h = rms_norm(x, layers["mlp_norm"][li], config.norm_eps)
            gate, up = self._project(h, li, ("w_gate", "w_up"), mask)
            x = x + self._all_reduce(self._project(
                swiglu(gate, up), li, ("w_down",), mask)[0])
        return rms_norm(x, params["final_norm"], config.norm_eps)

    def _backbone_mixed(self, tokens, q_positions, kv_lens, cu_q_lens,
                        block_tables, lora_idx=None) -> torch.Tensor:
        """Token-major backbone: `tokens` is flat (T,); sequence s owns rows
        [cu_q_lens[s], cu_q_lens[s+1]) and rows from cu_q_lens[S] on are
        padding. `lora_idx` (S,) is each sequence's adapter slot (with a
        manager). Writes this step's K/V into the pool (padding rows into
        the scratch page) and returns the final hidden states (T, d).
        Every shape is fixed by the bucket: nothing reads a value on the
        host."""
        config = self.config
        params = self.params
        T = tokens.shape[0]
        S = kv_lens.shape[0]
        scale = 1.0 / math.sqrt(config.head_dim)
        seq = pa.token_seq_ids(cu_q_lens, T, S)
        tok = torch.arange(T, device=self.device)
        local = tok - cu_q_lens.long()[seq]
        positions = q_positions.long()[seq] + local
        x = self._embed(tokens.long())                            # (T, d)
        logical_block = torch.clamp(positions // self.block_size, 0,
                                    block_tables.shape[1] - 1)
        # Padding rows write the scratch page (JAX drops them as out of
        # bounds; torch has no drop mode, and -1 would wrap onto a real
        # page).
        block_ids = torch.where(tok < cu_q_lens[S],
                                block_tables.long()[seq, logical_block],
                                self.num_blocks)
        offsets = positions % self.block_size
        rope_pos = torch.clamp(positions, 0, config.max_seq - 1)
        mask = (self._lora_mask(lora_idx.long()[seq])
                if lora_idx is not None else None)

        def write_kv(li, k, v):
            # ck is (K, num_blocks + 1, ps, hd): indexing [:, ids, offs]
            # keeps the kv-head dim FIRST, so the value is (K, T, hd) —
            # token i's K lands in page ids[i], slot offs[i], as JAX's
            # ck.at[li, :, ids, offs].set((T, K, hd)) writes it.
            self.cache["k"][li][:, block_ids, offsets] = k.transpose(0, 1)
            self.cache["v"][li][:, block_ids, offsets] = v.transpose(0, 1)

        def attend(li, q):
            return self._unified_attention(
                q, self.cache["k"][li], self.cache["v"][li], block_tables,
                kv_lens, q_positions, cu_q_lens, scale=scale)

        return self._layers(x, rope_pos, mask, attend, write_kv)

    def _logits(self, rows: torch.Tensor) -> torch.Tensor:
        """lm_head with fp32 accumulation AND fp32 output (not a bf16
        result cast up): logits feed argmax and sampling. Under tp each
        rank's vocabulary columns are all-gathered: every rank holds all
        the logits."""
        lm_head = self.params["lm_head"]
        if lm_head.dtype == torch.float32:
            out = rows.float() @ lm_head
        elif rows.is_cuda:
            out = torch.mm(rows, lm_head, out_dtype=torch.float32)
        else:
            # CPU: the plain version (no reduced-precision mm kernel there).
            out = rows.float() @ lm_head.float()
        if self.tp > 1:
            out = col.gather_global(out, self.mesh, 1, "tp")
        return out

    def _mixed_core(self, buf: torch.Tensor, layout: dict, sampled: bool):
        """The whole mixed step on the packed input `buf` (on the device):
        backbone, head and acceptance sampler. Returns (samples then
        accept as one int32 (2 S W,) tensor, logits (S W, V)). What a
        bucket's graphs capture, all-greedy (`sampled=False`) or not."""
        if self.tp > 1:
            # Rank 0's packed input reaches the others here, inside the
            # step (and inside its graph).
            dist.broadcast(buf, src=dist.get_global_rank(self._tp_group, 0),
                           group=self._tp_group)
        a = unpack_mixed(buf, layout)
        x = self._backbone_mixed(a["tokens"], a["q_positions"],
                                 a["kv_lens"], a["cu_q_lens"],
                                 a["block_tables"], a.get("lora_idx"))
        logits = self._logits(x[a["out_rows"].reshape(-1).long()])
        accept, samples = acceptance_sample(
            logits, a["proposals"], a["prop_lens"], a["temps"],
            a["top_ks"], a["top_ps"], a["seeds"], a["counters"], sampled)
        return torch.cat([samples.reshape(-1),
                          accept.reshape(-1).to(torch.int32)]), logits

    def _capture(self, key: tuple) -> _MixedGraph:
        """Capture `key` = (T, S, W, max_pages, sampled, LoRA epoch), a
        token bucket's sampled or all-greedy step, into a CUDA graph in the
        runner's one graph pool. The LoRA stacks of that epoch are static
        tensors of the capture, as the parameters and the KV pool are. The
        step first runs once
        eagerly on a side stream on all-padding input (only the scratch
        page is written): the kernel library's build and attributes and
        cuBLAS's handles and workspaces are set up there, never inside the
        capture. A failed capture raises."""
        *shape, sampled, _ = key
        layout, size = mixed_layout(*shape, lora=self.lora is not None)
        dev_in = torch.zeros(size, dtype=torch.int32, device=self.device)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._mixed_core(dev_in, layout, sampled)
        current.wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        counter = pa.ragged_paged_attention_unified
        before = counter.launches
        graph = torch.cuda.CUDAGraph()
        mode = "global"
        if self.tp > 1:
            # Every rank captures the same buckets in the same order; with
            # no collective in flight, the process group's watchdog has no
            # work to query on the capturing stream, and its CUDA calls in
            # other threads may go on during the capture.
            torch.cuda.synchronize(self.device)
            mode = "thread_local"
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              capture_error_mode=mode):
            dev_out, logits = self._mixed_core(dev_in, layout, sampled)
        # The capture recorded these launches; each replay makes them.
        launches = counter.launches - before
        counter.launches = before
        entry = _MixedGraph(graph, dev_in,
                            torch.empty(size, dtype=torch.int32,
                                        pin_memory=True),
                            dev_out, logits, launches)
        self._graphs[key] = entry
        return entry

    def _lora_epoch(self) -> int:
        """The LoRA stacks' epoch (0 without a manager). A resize moves it
        on: the graphs of the old stacks are released and each bucket's
        next step captures again."""
        if self.lora is None:
            return 0
        epoch = self.lora.epoch
        if epoch != self._graph_epoch:
            for g in self._graphs.values():
                g.graph.reset()
            self._graphs.clear()
            # The released pool cannot take new captures: start another;
            # the old one's memory returns once its last output is gone.
            self._graph_pool = None
            self._graph_epoch = epoch
        return epoch

    @torch.no_grad()
    def step_mixed(self, tokens, q_positions, kv_lens, cu_q_lens,
                   block_tables, out_rows, proposals, prop_lens, temps,
                   top_ks, top_ps, seeds, counters, lora_idx=None):
        """One unified ragged launch per layer for a mixed decode /
        spec-verify / prefill batch. Inputs are host arrays padded by the
        engine (JAX's signature). Returns host arrays (accept (S, W) bool,
        samples (S, W) int32), as `acceptance_sample` defines them: the
        host commits proposals[s, :n_acc] + [samples[s, n_acc]].

        A bucket has two variants: all rows greedy, or some row sampled
        (temps > 0). On the card with graphs, each is captured on its
        first use (counted in step_compiles, as a new variant is on the
        CPU), then each call packs the inputs into its pinned buffer,
        uploads them with one copy, replays and reads back one int32
        array.

        With a LoRA manager, `lora_idx` (S,) is each sequence's adapter
        slot (None: all slot 0); it rides in the packed upload. The graph
        key holds the stacks' epoch: after a `resize` each bucket captures
        again, counted in step_compiles."""
        T = np.shape(tokens)[0]
        S, W = np.shape(out_rows)
        sampled = bool((np.asarray(temps) > 0).any())
        epoch = self._lora_epoch()
        key = (T, S, W, np.shape(block_tables)[1], sampled, epoch)
        lora = self.lora is not None
        layout, size = mixed_layout(*key[:4], lora=lora)
        kind = ("mixed" if sampled else "mixed_greedy") + (
            f"@lora{epoch}" if epoch else "")
        arrays = dict(tokens=tokens, q_positions=q_positions,
                      kv_lens=kv_lens, cu_q_lens=cu_q_lens,
                      block_tables=block_tables, out_rows=out_rows,
                      proposals=proposals, prop_lens=prop_lens, temps=temps,
                      top_ks=top_ks, top_ps=top_ps, seeds=seeds,
                      counters=counters)
        if lora:
            arrays["lora_idx"] = (np.zeros(S, np.int32) if lora_idx is None
                                  else lora_idx)
        if self._channel is None:
            return self._step_mixed(key, layout, size, arrays, kind)
        with self._channel.guard():
            self._channel.send(CMD_MIXED, key[:4] + (int(sampled), epoch))
            return self._step_mixed(key, layout, size, arrays, kind)

    def _step_mixed(self, key, layout, size, arrays, kind):
        T, S, W, _, sampled, _ = key
        if self.cuda_graphs:
            g = self._graphs.get(key)
            if g is None:
                self._note_shapes(kind, arrays["tokens"], arrays["out_rows"],
                                  arrays["block_tables"])
                g = self._capture(key)
            pack_mixed(layout, size, arrays, out=g.host_in.numpy())
            g.dev_in.copy_(g.host_in, non_blocking=True)
            g.graph.replay()
            pa.ragged_paged_attention_unified.launches += g.launches
            out, self.last_logits = g.dev_out, g.logits
        else:
            self._note_shapes(kind, arrays["tokens"], arrays["out_rows"],
                              arrays["block_tables"])
            out, self.last_logits = self._mixed_core(
                self.to_device(pack_mixed(layout, size, arrays)), layout,
                sampled)
        out = HostCopy(out).numpy()
        n = S * W
        return out[n:].reshape(S, W).astype(bool), out[:n].reshape(S, W)

    @torch.no_grad()
    def follow_mixed(self, T: int, S: int, W: int, max_pages: int,
                     sampled: int, epoch: int) -> None:
        """Another rank's side of `step_mixed`: the same bucket's step (its
        graph on the card), its packed input arriving inside it from rank
        0. Nothing comes back to the host."""
        sampled = bool(sampled)
        key = (T, S, W, max_pages, sampled, self._lora_epoch())
        if key[-1] != epoch:
            raise RuntimeError(f"LoRA epoch {key[-1]} here, rank 0 at "
                               f"{epoch}")
        layout, size = mixed_layout(*key[:4], lora=self.lora is not None)
        kind = ("mixed" if sampled else "mixed_greedy") + (
            f"@lora{epoch}" if epoch else "")
        shapes = (np.empty(T), np.empty((S, W)), np.empty((S, max_pages)))
        if self.cuda_graphs:
            g = self._graphs.get(key)
            if g is None:
                self._note_shapes(kind, *shapes)
                g = self._capture(key)
            g.graph.replay()
            pa.ragged_paged_attention_unified.launches += g.launches
            self.last_logits = g.logits
        else:
            self._note_shapes(kind, *shapes)
            buf = torch.zeros(size, dtype=torch.int32, device=self.device)
            _, self.last_logits = self._mixed_core(buf, layout, sampled)

    def warm_mixed(self, T: int, S: int, W: int):
        """Run both variants of the mixed step for token bucket T (all
        greedy, then sampled) on all-padding inputs (cu_q_lens all zero:
        only the scratch page is written, outputs ignored) so the bucket's
        first real tick pays no first use; on the card with graphs this
        captures the bucket's two graphs."""
        z = lambda *s: np.zeros(s, np.int32)
        for temp in (0.0, 1.0):
            self.step_mixed(
                z(T), z(S), z(S), z(S + 1), z(S, self.max_blocks_per_seq),
                z(S, W), z(S, W), z(S), np.full(S, temp, np.float32), z(S),
                np.ones(S, np.float32), z(S), z(S),
                lora_idx=z(S) if self.lora is not None else None)

    # ---- the rectangular steps of the split path -------------------------

    def _backbone(self, tokens, q_positions, kv_lens, q_lens,
                  block_tables, lora_idx=None) -> torch.Tensor:
        """Rectangular backbone: `tokens` (S, Bq) is a host array or a
        device tensor (the previous step's sampled ids); q_positions,
        kv_lens, q_lens (S,), block_tables (S, max_pages) and lora_idx
        (S,), the adapter slot per sequence (with a manager; None means
        slot 0), are host arrays. Row (s, b) sits at position
        q_positions[s] + b. Writes the K/V of the valid rows b < q_lens[s]
        into the pool and returns the final hidden states, flat
        (S * Bq, d)."""
        config = self.config
        params = self.params
        S, Bq = np.shape(tokens)
        H, hd = self.n_heads, config.head_dim
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
        x = self._embed(self.to_device(tokens, torch.long).reshape(-1))
                                                                # (S*Bq, d)
        mask = None
        if self.lora is not None:
            slots = (np.zeros(S, np.int64) if lora_idx is None
                     else np.asarray(lora_idx, np.int64))
            mask = self._lora_mask(self.to_device(np.repeat(slots, Bq),
                                                  torch.long))

        def write_kv(li, k, v):
            if n_valid:
                # Kv-head dim first, as in _backbone_mixed.
                self.cache["k"][li][:, block_ids, offsets] = \
                    k[rows].transpose(0, 1)
                self.cache["v"][li][:, block_ids, offsets] = \
                    v[rows].transpose(0, 1)

        def attend(li, q):
            return self._rect_attention(
                q.reshape(S, Bq, H, hd), self.cache["k"][li],
                self.cache["v"][li], tables_t, kv_lens_t, q_pos_t,
                scale=scale)

        return self._layers(x, rope_pos, mask, attend, write_kv)

    def _last_logits(self, tokens, q_positions, kv_lens, q_lens,
                     block_tables, lora_idx=None) -> torch.Tensor:
        """fp32 logits (S, vocab) of each sequence's last real row: only
        those rows pay the vocab matmul."""
        x = self._backbone(tokens, q_positions, kv_lens, q_lens,
                           block_tables, lora_idx)
        S, Bq = np.shape(tokens)
        last = np.arange(S) * Bq + np.maximum(np.asarray(q_lens) - 1, 0)
        return self._logits(x[self.to_device(last, torch.long)])

    @torch.no_grad()
    @_fanned
    def step(self, tokens, q_positions, kv_lens, q_lens,
             block_tables, lora_idx=None) -> torch.Tensor:
        """One rectangular step; inputs are host arrays padded to a
        (batch, Bq) bucket by the engine (lora_idx (S,): each sequence's
        adapter slot, with a manager). Returns fp32 logits (S, vocab) of
        the last real row per sequence, on the device (host sampling)."""
        self._note_shapes("step", tokens, block_tables)
        return self._last_logits(tokens, q_positions, kv_lens, q_lens,
                                 block_tables, lora_idx)

    @torch.no_grad()
    @_fanned
    def step_verify(self, tokens, q_positions, kv_lens, q_lens,
                    block_tables, lora_idx=None) -> torch.Tensor:
        """Speculative-verify step: greedy ids (S, Bq) int32 on the device;
        row j's id is the model's next token after tokens[:, :j+1]. The
        same `_logits` expression as `step` and `step_mixed`, so all heads
        round alike."""
        self._note_shapes("verify", tokens, block_tables)
        x = self._backbone(tokens, q_positions, kv_lens, q_lens,
                           block_tables, lora_idx)
        return torch.argmax(self._logits(x), dim=-1).to(
            torch.int32).reshape(np.shape(tokens))

    @torch.no_grad()
    @_fanned
    def step_sample(self, tokens, q_positions, kv_lens, q_lens,
                    block_tables, temps, top_ks, top_ps, seeds,
                    counters, lora_idx=None) -> torch.Tensor:
        """Rectangular step + sampling on the device. `tokens` may be a
        device tensor (the previous step's ids: chaining without a host
        sync). Returns the sampled ids (S,) int32 on the device; the
        caller decides when to fetch them."""
        self._note_shapes("sample", tokens, block_tables)
        logits = self._last_logits(tokens, q_positions, kv_lens, q_lens,
                                   block_tables, lora_idx)
        return self._device_sample(logits, temps, top_ks, top_ps, seeds,
                                   counters)

    @torch.no_grad()
    @_fanned
    def step_sample_multi(self, n_steps: int, tokens, q_positions, kv_lens,
                          q_lens, block_tables, temps, top_ks, top_ps, seeds,
                          counters, lora_idx=None) -> torch.Tensor:
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
                                       kv_lens + step, q_lens, block_tables,
                                       lora_idx)
            sampled = self._device_sample(logits, temps, top_ks, top_ps,
                                          seeds, counters + step)
            out.append(sampled)
            tokens = sampled[:, None]
        return torch.stack(out, dim=1)

    # ---- the KV page plane ------------------------------------------------

    @property
    def kv_dtype_name(self) -> str:
        """The pool's dtype as the page codec names it ("bfloat16",
        "float32"): host copies of bf16 pages are its uint16 bits."""
        return str(self.cache["k"].dtype).replace("torch.", "")

    @property
    def block_page_layout(self):
        """(shape, bytes an element) of one block's k (or v) host array
        in gather_page_list's layout: what a page from elsewhere must have
        to be scattered into this pool."""
        pool = self.cache["k"]
        shape = ((pool.shape[0], self.config.n_kv_heads, 1)
                 + tuple(pool.shape[3:]))
        return shape, pool.element_size()

    @property
    def block_nbytes(self) -> int:
        """Host bytes of one block's k and v pages together."""
        shape, width = self.block_page_layout
        return 2 * width * int(np.prod(shape))

    def _check_ids(self, block_ids: Sequence[int]) -> None:
        """Explicit pool pages only: no drop sentinel (-1 would wrap onto
        the last page), never the scratch page."""
        bad = [b for b in (int(b) for b in block_ids)
               if not 0 <= b < self.num_blocks]
        if bad:
            raise ValueError(f"page ids {bad} outside [0, {self.num_blocks})")

    def _page_ids(self, block_ids: Sequence[int]) -> torch.Tensor:
        self._check_ids(block_ids)
        return torch.tensor([int(b) for b in block_ids],
                            dtype=torch.long).to(self.device)

    def gather_pages(self, block_ids: Sequence[int]):
        """The KV pages backing `block_ids` as host arrays, each
        (n_layers, n_kv_heads, n_pages, block_size, head_dim), JAX's
        layout (every kv head, whatever the tp). bf16 pages come back as
        their uint16 bits (numpy has no bf16). The copy runs on the
        current stream, after every step queued there."""
        self._check_ids(block_ids)
        return tuple(to_numpy(t) for t in
                     self._gather_pages([int(b) for b in block_ids]))

    def gather_page_list(self, block_ids: Sequence[int]):
        """gather_pages split per block: [(k, v)] with each array
        (n_layers, n_kv_heads, 1, block_size, head_dim), from one gather
        for the whole list and one synchronize. Each block's k and v are
        the two halves of a host buffer of that block's own (pinned on the
        card: torch's caching host allocator), copied into asynchronously,
        so whoever keeps a block keeps its bytes and no more; and
        scatter_page_list uploads such arrays asynchronously."""
        self._check_ids(block_ids)
        # (n, 2, L, K, bs, d): the block axis first, each block contiguous.
        dev = torch.stack([t.movedim(2, 0) for t in
                           self._gather_pages([int(b) for b in block_ids])],
                          dim=1)
        host = []
        for i in range(len(block_ids)):
            h = torch.empty(dev[i].shape, dtype=dev.dtype,
                            pin_memory=dev.is_cuda)
            host.append(h.copy_(dev[i], non_blocking=True))
        if dev.is_cuda:
            torch.cuda.current_stream(self.device).synchronize()
        out = []
        for h in host:
            kv = to_numpy(h)
            out.append((kv[0][:, :, None], kv[1][:, :, None]))
        return out

    def reserve_host_pages(self, n: int) -> None:
        """Page-lock n blocks' host buffers (gather_page_list's) once and
        hand them to torch's caching host allocator, which keeps them for
        reuse: the first spills and promotions then lock no memory of
        their own. Nothing to do off the card."""
        if self.device.type != "cuda" or n <= 0:
            return
        bufs = [torch.empty(self.block_nbytes, dtype=torch.uint8,
                            pin_memory=True) for _ in range(n)]
        del bufs

    def fingerprint(self) -> str:
        """A digest of the model this runner serves: its config and a
        corner of every parameter (the first 4 entries along each dim,
        only global index 0 along a tensor-parallel one, which rank 0
        holds), so every tensor-parallel degree of one model gives one
        value and two models of one shape (other seeds, a fine-tune) give
        two. The cluster prefix table's rows carry it, and an adopter
        takes no KV of another model."""
        import hashlib

        h = hashlib.blake2b(repr(self.config).encode(), digest_size=16)

        def leaves(tree, keys=()):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    yield from leaves(tree[k], keys + (k,))
                else:
                    yield keys + (k,), tree[k]

        for keys, p in leaves(self.params):
            spec = spec_for(param_axes_at(keys), SERVE_RULES)
            corner = p[tuple(slice(0, 1 if "tp" in axes else 4)
                             for axes in spec)]
            h.update("/".join(keys).encode())
            h.update(to_numpy(corner.float()).tobytes())
        return h.hexdigest()

    @_fanned
    def _gather_pages(self, block_ids):
        ids = self._page_ids(block_ids)
        out = []
        for side in ("k", "v"):
            t = self.cache[side].index_select(2, ids)
            if self.tp > 1:
                t = col.gather_global(t, self.mesh, 1, "tp")
            out.append(t)
        return out

    def scatter_pages(self, block_ids: Sequence[int], k_pages, v_pages):
        """Write pages (gather_pages' layout; numpy, JAX bf16 arrays, their
        uint16 bits, or tensors) into the pool at `block_ids`, in place:
        the pool a captured graph holds is never reallocated. Under tp
        each rank keeps its kv heads."""
        self._check_ids(block_ids)
        pool = self.cache["k"]
        want = ((pool.shape[0], self.config.n_kv_heads, len(block_ids))
                + pool.shape[3:])
        pages = []
        for side, p in (("k", k_pages), ("v", v_pages)):
            t = _device_pages(p, pool.dtype, self.device)
            if tuple(t.shape) != tuple(want):
                raise ValueError(f"{side} pages {tuple(t.shape)}, the pool "
                                 f"takes {tuple(want)}")
            pages.append(t)
        self._scatter_pages([int(b) for b in block_ids], *pages)

    def scatter_page_list(self, block_ids: Sequence[int], pages) -> None:
        """scatter_pages of one (k, v) pair per block, each array in
        gather_page_list's shape, with ONE write into the pool a side: the
        blocks are copied into one device buffer (asynchronously from
        pinned memory, gather_page_list's), which then goes to the pool.
        Returns once every host copy is done, so the caller may drop or
        reuse the arrays."""
        dtype = self.cache["k"].dtype
        shape = (2, len(pages)) + tuple(np.shape(pages[0][0]))
        dev = torch.empty(shape, dtype=dtype, device=self.device)
        for i, kv in enumerate(pages):
            for side in (0, 1):
                dev[side, i].copy_(_device_pages(kv[side], dtype, "cpu"),
                                   non_blocking=True)
        done = torch.cuda.Event() if dev.is_cuda else None
        if done is not None:
            done.record()
        # (2, n, L, K, 1, bs, d) -> gather_pages' (L, K, n, bs, d) a side.
        k, v = (dev[side].squeeze(3).movedim(0, 2).contiguous()
                for side in (0, 1))
        self.scatter_pages(block_ids, k, v)
        if done is not None:
            done.synchronize()

    @_fanned
    def _scatter_pages(self, block_ids, k_pages, v_pages):
        ids = self._page_ids(block_ids)
        K = self.n_kv_heads
        for side, t in (("k", k_pages), ("v", v_pages)):
            self.cache[side].index_copy_(
                2, ids, t.narrow(1, self.tp_rank * K, K))

    # ---- per-rank readings ---------------------------------------------------

    @_fanned
    def rank_launches(self, reset: bool = False):
        """[[K5, K6] launches] of every rank of the tp world in rank order
        (this rank's alone without a mesh), counted in each process since
        its last reset; `reset` zeroes them after the reading."""
        counters = (pa.ragged_paged_attention_unified,
                    pa.ragged_paged_attention)
        counts = torch.tensor([[c.launches for c in counters]],
                              dtype=torch.int64, device=self.device)
        if self.tp > 1:
            counts = col.gather_global(counts, self.mesh, 0, "tp")
        if reset:
            for c in counters:
                c.launches = 0
        return counts.tolist()

    @_fanned
    def rank_profile(self, start: bool):
        """torch.profiler on every rank: `start=True` begins it; False ends
        it and returns, per rank, [kernel time, NCCL kernel time] in
        microseconds of device time since the start."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        if start:
            self._profiler = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            self._profiler.__enter__()
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels)
        nccl = sum(e.self_device_time_total for e in kernels
                   if "nccl" in e.key.lower())
        out = torch.tensor([[total, nccl]], dtype=torch.float64,
                           device=self.device)
        if self.tp > 1:
            out = col.gather_global(out, self.mesh, 0, "tp")
        return out.tolist()

    # ---- weights -------------------------------------------------------------

    @_fanned
    def assign_param(self, keys, value: torch.Tensor) -> None:
        """Copy the global parameter `value` (at `keys`, e.g. ("layers",
        "wq")) into this rank's shard of it, in place: a captured graph
        holds the shard's address. The caller checked shape and dtype."""
        dst = self.params
        for k in keys:
            dst = dst[k]
        src = value.to(self.device)
        if self.tp > 1:
            src = shard(src, spec_for(param_axes_at(keys), SERVE_RULES),
                        self.mesh)
        with torch.no_grad():
            dst.copy_(src)

    # ---- on-device sampling of the split path ------------------------------

    _filter_logits = staticmethod(filter_logits)

    def _device_sample(self, logits, temps, top_ks, top_ps, seeds,
                       counters) -> torch.Tensor:
        """The split path's sampler: greedy where temps <= 0, else
        Gumbel-max over `filter_logits` with noise keyed on (seeds,
        counters), the draw `acceptance_sample` makes on a row without a
        proposal. Sampling parameters are host arrays (N,); the draw of a
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


def _device_pages(pages, dtype: torch.dtype, device) -> torch.Tensor:
    """Host or device pages -> a tensor of the pool's dtype on `device`.
    16-bit integer payloads are bf16 bits."""
    if not isinstance(pages, torch.Tensor):
        pages = to_torch(np.asarray(pages))
    if pages.dtype in (torch.int16, torch.uint16):
        pages = pages.view(torch.bfloat16)
    return pages.to(device=device, dtype=dtype)


def _place(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    return tree.to(device)


def _map_params(fn, tree, keys=()):
    """fn(keys, leaf) over a parameter tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_params(fn, v, keys + (k,)) for k, v in tree.items()}
    return fn(keys, tree)
