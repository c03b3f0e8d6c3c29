"""Llama-3-family decoder in plain PyTorch (port of ray_tpu/models/llama.py).

Parameters are a plain dict with the JAX package's keys and stacked
layouts — `layers[name]` is `(n_layers, in, out)` — so weights convert
one-to-one from the JAX pytree (`params_from_numpy`) and the layer stack
is a Python loop over the leading axis instead of `lax.scan`.

`forward` is the naive full-sequence forward (no KV cache): the tests
and `chip_smoke.py` decode against it, and `loss_fn` trains through it.
The serving path runs through llm/model_runner.py instead. While grad is
enabled, `backbone` wraps each layer in activation checkpointing
(`remat`, `remat_policy`); under `torch.no_grad` it runs the layers
as they are. Under an ambient mesh (`parallel.mesh.use_mesh`) the same
functions run one rank's shards of a DP/FSDP/TP/SP-sharded model
(`param_logical_axes`, `parallel.sharding.TRAIN_RULES`).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.ops import resolve_device, to_torch
from ray_tpu_torch.ops.attention import FLASH_FWD_OP, attention
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import current_mesh, current_rules, use_mesh
from ray_tpu_torch.parallel.ring import ring_attention, ulysses_attention
from ray_tpu_torch.parallel.sharding import axes_of, constrain, seq_shard
from ray_tpu_torch.util.tracing import profile_range

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 8192
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "full": recompute everything in backward. "dots": save the outputs
    # of the projections (aten.mm, the counterpart of JAX's
    # dots_with_no_batch_dims_saveable; the reference attention's bmm has
    # a batch dim and is recomputed). "flash": save only the flash
    # forward op's out and LSE, so the backward does not run the forward
    # kernel again (the long-context policy).
    remat_policy: str = "full"     # full | dots | flash
    # reference | flash | auto | ring | ulysses; the last two shard the
    # sequence over the mesh axis `sp_axis` (parallel/ring.py).
    attention_impl: str = "auto"
    sp_axis: str = "sp"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b(**overrides) -> "LlamaConfig":
        base = dict(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, d_ff=14336, rope_theta=500000.0)
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=128, max_seq=128)
        base.update(overrides)
        return LlamaConfig(**base)

    def num_params(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        mlp = 3 * d * f
        per_layer = attn + mlp + 2 * d
        return v * d + L * per_layer + d + d * v

    def flops_per_token(self, seq: int) -> float:
        """Training FLOPs/token (fwd+bwd ~= 6*N + attention term)."""
        n = self.num_params() - self.vocab_size * self.d_model
        attn_flops = 12 * self.n_layers * self.d_model * seq
        return 6.0 * n + attn_flops


# ---------------------------------------------------------------- parameters

_INIT_CHUNK = 1 << 26   # fp32 elements drawn at once (256 MiB)


def _dense(shape, fan_in, config, generator, device):
    """N(0, 1/fan_in) in config.dtype, drawn in fp32 slabs of at most
    _INIT_CHUNK elements, so an 8B model never holds a full fp32 copy."""
    out = torch.empty(shape, dtype=config.dtype, device=device)
    flat = out.view(-1, shape[-1])
    rows = max(1, _INIT_CHUNK // shape[-1])
    std = 1.0 / math.sqrt(fan_in)
    for slab in flat.split(rows):
        slab.copy_(torch.randn(slab.shape, generator=generator,
                               dtype=torch.float32, device=device) * std)
    return out


def layer_shapes(config: LlamaConfig) -> Dict[str, tuple]:
    """Per-layer (unstacked) weight shape and fan-in for each layer key."""
    d, f = config.d_model, config.d_ff
    hd, H, K = config.head_dim, config.n_heads, config.n_kv_heads
    return {"attn_norm": ((d,), None), "wq": ((d, H * hd), d),
            "wk": ((d, K * hd), d), "wv": ((d, K * hd), d),
            "wo": ((H * hd, d), H * hd), "mlp_norm": ((d,), None),
            "w_gate": ((d, f), d), "w_up": ((d, f), d),
            "w_down": ((f, d), f)}


def init_params(config: LlamaConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """Random weights with the JAX package's scales and layouts. The
    generator must live on `device` (torch.Generator(device=...))."""
    dev = resolve_device(device)
    d, v, L = config.d_model, config.vocab_size, config.n_layers
    layers = {}
    for name, (shape, fan_in) in layer_shapes(config).items():
        if fan_in is None:
            layers[name] = torch.ones((L,) + shape, dtype=config.dtype,
                                      device=dev)
        else:
            layers[name] = _dense((L,) + shape, fan_in, config, generator,
                                  dev)
    return {
        "embed": _dense((v, d), d, config, generator, dev),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=config.dtype, device=dev),
        "lm_head": _dense((d, v), d, config, generator, dev),
    }


def params_from_numpy(tree: Dict, config: LlamaConfig,
                      device="cuda") -> Dict:
    """Convert `jax.tree.map(np.asarray, llama.init_params(...))` of the
    JAX package (same keys, same stacked shapes) into this port's params
    on `device`, in config.dtype."""
    dev = resolve_device(device)

    def conv(a):
        return to_torch(np.asarray(a)).to(device=dev, dtype=config.dtype)

    return {"embed": conv(tree["embed"]),
            "layers": {k: conv(tree["layers"][k]) for k in LAYER_KEYS},
            "final_norm": conv(tree["final_norm"]),
            "lm_head": conv(tree["lm_head"])}


def param_logical_axes(config: Optional[LlamaConfig] = None) -> Dict:
    """Logical axis names per parameter (see parallel/sharding.py rules)."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", None),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", None),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


# ---------------------------------------------------------------- forward
#
# Under a mesh (parallel.mesh.use_mesh) every function below runs on this
# rank's shards and issues the collectives GSPMD inserts for the JAX
# package: tokens and activations are (batch, seq) shards, the hidden dim
# whole; each layer all-gathers its weights' fsdp factor (`constrain`,
# inside the checkpointed layer, so the recompute gathers again and no
# policy keeps a gathered weight); heads, mlp and vocab are split over tp
# between Megatron's f and g (`copy_to`, `reduce_from`). Outside a mesh
# every collective is absent and the functions are the single-device path.

def per_layer_axes(axes: Dict) -> Dict:
    """A stacked tree's layer logical axes with the leading "layers" axis
    dropped (what one layer's `unbind`-ed weights carry)."""
    return {k: v[1:] for k, v in axes["layers"].items()}


# Per-layer layout INSIDE the layer: "embed" gathered so each layer's
# weights are all-gathered over fsdp right before use (the FSDP recipe:
# gather weights, compute, discard; gradients reduce-scatter back). tp
# axes stay.
_LAYER_GATHER_AXES = {
    "attn_norm": (None,),
    "wq": (None, "heads"),
    "wk": (None, "kv_heads"),
    "wv": (None, "kv_heads"),
    "wo": ("heads", None),
    "mlp_norm": (None,),
    "w_gate": (None, "mlp"),
    "w_up": (None, "mlp"),
    "w_down": ("mlp", None),
}


def gather_layer_params(p: Dict, layer_axes: Dict,
                        extra_axes: Optional[Dict] = None) -> Dict:
    """One layer's weights from their stored layout (`layer_axes`) to the
    layout the layer computes in (fsdp factor gathered)."""
    axes = dict(_LAYER_GATHER_AXES)
    axes.update(extra_axes or {})
    return {k: constrain(v, layer_axes[k], axes[k]) for k, v in p.items()}


def _attention_dispatch(config, q, k, v):
    impl, mesh = config.attention_impl, current_mesh()
    if impl in ("ring", "ulysses"):
        if mesh is None:
            raise RuntimeError(
                f"attention_impl={impl!r} needs an ambient mesh: wrap the "
                "step in ray_tpu_torch.parallel.mesh.use_mesh(mesh)")
        fn = ring_attention if impl == "ring" else ulysses_attention
        return fn(q, k, v, mesh=mesh, axis=config.sp_axis, causal=True)
    if col.axes_size(mesh, axes_of("seq")) > 1:
        raise ValueError("the sequence is sharded over sp: attention_impl "
                         "must be 'ring' or 'ulysses'")
    return attention(q, k, v, causal=True, impl=impl)


def attention_sublayer(config, x, p, cos, sin):
    """Pre-norm GQA attention block with residual. Shared by every decoder
    family in models/ (config needs head_dim/norm_eps and the
    attention_impl/sp_axis fields _attention_dispatch reads). Under a mesh
    the projections hold this rank's heads: f before them, g after wo."""
    b, s, _ = x.shape
    hd, mesh = config.head_dim, current_mesh()
    H, K = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    with profile_range("norm"):
        h = rms_norm(x, p["attn_norm"], config.norm_eps)
    with profile_range("attention"):
        h = col.copy_to(h, mesh, axes_of("heads"))
        q = apply_rope((h @ p["wq"]).reshape(b, s, H, hd), cos, sin)
        k = apply_rope((h @ p["wk"]).reshape(b, s, K, hd), cos, sin)
        v = (h @ p["wv"]).reshape(b, s, K, hd)
        attn = _attention_dispatch(config, q, k, v)
        out = attn.reshape(b, s, H * hd) @ p["wo"]
        return x + col.reduce_from(out, mesh, axes_of("heads"))


_LAYER_AXES = per_layer_axes(param_logical_axes())


def _layer(config: LlamaConfig, x, p, cos, sin):
    """One decoder layer. x: (b, s, d)."""
    p = gather_layer_params(p, _LAYER_AXES)
    x = attention_sublayer(config, x, p, cos, sin)
    mesh, mlp = current_mesh(), axes_of("mlp")
    with profile_range("norm"):
        h = rms_norm(x, p["mlp_norm"], config.norm_eps)
    with profile_range("mlp"):
        h = col.copy_to(h, mesh, mlp)
        out = swiglu(h @ p["w_gate"], h @ p["w_up"]) @ p["w_down"]
        return x + col.reduce_from(out, mesh, mlp)


def _save_dots(ctx, func, *args, **kwargs):
    if func is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_flash(ctx, func, *args, **kwargs):
    if func is FLASH_FWD_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_POLICIES = {"full": None, "dots": _save_dots, "flash": _save_flash}


def _in_mesh(mesh, rules, fn, *args):
    with use_mesh(mesh, rules):
        return fn(*args)


def layer_fn(fn, remat: bool, policy: str = "full"):
    """`fn(x, p, cos, sin)` as the layer stack runs it: under the ambient
    mesh of the forward (which its recompute re-enters, so a backward
    outside `use_mesh` gathers as the forward did), and checkpointed under
    `policy` when `remat` is set and grad is enabled."""
    if current_mesh() is not None:
        fn = partial(_in_mesh, current_mesh(), current_rules(), fn)
    if not (remat and torch.is_grad_enabled()):
        return fn
    if policy not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy must be 'full', 'dots' or 'flash', "
                         f"got {policy!r}")
    kw = {} if _REMAT_POLICIES[policy] is None else {"context_fn": partial(
        create_selective_checkpoint_contexts, _REMAT_POLICIES[policy])}

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def rope_tables(config, seq: int, device):
    """cos/sin rows of this rank's positions: [r·seq, (r+1)·seq) for
    sequence shard r (the tables from 0 outside a mesh)."""
    cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                config.rope_theta, device=device)
    mesh, seq_axes = current_mesh(), axes_of("seq")
    if col.axes_size(mesh, seq_axes) > 1:
        start = col.linear_index(mesh, seq_axes) * seq
        cos, sin = cos[start:start + seq], sin[start:start + seq]
    return cos, sin


def embed(table: torch.Tensor, tokens: torch.Tensor, config) -> torch.Tensor:
    """Embedding lookup in config.dtype. Under a mesh the table's fsdp
    factor is gathered first and its rows are split over tp: each rank
    looks up the ids in its rows (others masked to zero) and g sums."""
    table = constrain(table, ("vocab", "embed"), ("vocab", None))
    tokens = tokens.to(table.device)
    vocab, mesh = axes_of("vocab"), current_mesh()
    if col.axes_size(mesh, vocab) == 1:
        return table[tokens].to(config.dtype)
    rows = table.shape[0]
    local = tokens - col.linear_index(mesh, vocab) * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return col.reduce_from(x, mesh, vocab).to(config.dtype)


def backbone(params: Dict, tokens: torch.Tensor,
             config: LlamaConfig) -> torch.Tensor:
    """tokens: (b, s) int -> final-norm hidden states (b, s, d) in
    config.dtype (under a mesh: this rank's (batch, seq) shard of both).
    Layers run under activation checkpointing only when config.remat is
    set and grad is enabled."""
    cos, sin = rope_tables(config, tokens.shape[1], params["embed"].device)
    x = embed(params["embed"], tokens, config)
    layer = layer_fn(partial(_layer, config), config.remat,
                     config.remat_policy)
    # unbind: the backward stacks the L per-layer gradients of a stacked
    # weight once, where indexing would add L full-size gradients.
    stacked = {k: params["layers"][k].unbind(0) for k in LAYER_KEYS}
    for li in range(config.n_layers):
        x = layer(x, {k: stacked[k][li] for k in LAYER_KEYS}, cos, sin)
    with profile_range("norm"):
        return rms_norm(x, params["final_norm"], config.norm_eps)


def logits_of(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """(b, s, d) hidden states -> fp32 logits; under a mesh the lm_head's
    fsdp factor is gathered and the logits are this rank's vocab shard."""
    lm_head = constrain(lm_head, ("embed", "vocab"), (None, "vocab"))
    x = col.copy_to(x, current_mesh(), axes_of("vocab"))
    return (x @ lm_head).float()


def forward(params: Dict, tokens: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """tokens: (b, s) int -> logits (b, s, vocab) float32."""
    return logits_of(backbone(params, tokens, config), params["lm_head"])


def _log_likelihood(logits, targets):
    """log p(target) per token; under a mesh the vocab-parallel log-softmax
    (max and sum of exponentials all-reduced over the vocab's axes)."""
    vocab, mesh = axes_of("vocab"), current_mesh()
    targets = targets[..., None].long()
    if col.axes_size(mesh, vocab) == 1:
        return torch.log_softmax(logits, dim=-1).gather(-1, targets)[..., 0]
    rows = logits.shape[-1]
    m = col.all_reduce(logits.detach().amax(dim=-1, keepdim=True), mesh,
                       vocab, op=torch.distributed.ReduceOp.MAX)
    sumexp = col.reduce_from(torch.exp(logits - m).sum(dim=-1), mesh, vocab)
    local = targets - col.linear_index(mesh, vocab) * rows
    inside = ((local >= 0) & (local < rows))[..., 0]
    picked = logits.gather(-1, local.clamp(0, rows - 1))[..., 0] * inside
    return col.reduce_from(picked, mesh, vocab) - m[..., 0] - torch.log(
        sumexp)


def data_axes():
    """Mesh axes the tokens are spread over (batch and sequence)."""
    return axes_of("batch") + axes_of("seq")


def next_token_ce(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy; mask (same shape as targets)
    optional. Under a mesh: the mean over the global batch (sums
    all-reduced over the batch and sequence axes, g's identity backward)."""
    mesh, axes = current_mesh(), data_axes()
    ll = _log_likelihood(logits, targets)
    if mask is not None:
        mask = mask.float()
        den = col.all_reduce(mask.sum(), mesh, axes)
        return -col.reduce_from((ll * mask).sum(), mesh, axes) / torch.clamp(
            den, min=1.0)
    if mesh is None:
        return -ll.mean()
    return -col.reduce_from(ll.sum(), mesh, axes) / (
        ll.numel() * col.axes_size(mesh, axes))


def shift_tokens(batch: Dict, device):
    """(inputs, targets, mask of the targets or None) of a {"tokens": (b,
    s+1)} batch, cut to this rank's sequence shard under a mesh."""
    tokens, mask = batch["tokens"], batch.get("mask")
    inputs = seq_shard(tokens[:, :-1])
    targets = seq_shard(tokens[:, 1:]).to(device)
    if mask is not None:
        mask = seq_shard(mask[:, 1:]).to(device)
    return inputs, targets, mask


def token_count(targets: torch.Tensor) -> torch.Tensor:
    """The global number of target tokens (this rank's under no mesh)."""
    return torch.tensor(float(targets.numel() * col.axes_size(
        current_mesh(), data_axes())), dtype=torch.float32)


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor],
            config: LlamaConfig) -> Tuple[torch.Tensor, Dict]:
    """batch: {"tokens": (b, s+1) int, optional "mask": (b, s+1)} ->
    (next-token cross entropy, {"loss", "tokens"}). Under a mesh the
    batch holds this rank's batch shard with the whole sequence (the JAX
    step's ("batch", None) layout); the loss is the global mean."""
    inputs, targets, mask = shift_tokens(batch, params["embed"].device)
    hidden = backbone(params, inputs, config)
    with profile_range("loss"):
        loss = next_token_ce(logits_of(hidden, params["lm_head"]), targets,
                             mask)
    return loss, {"loss": loss, "tokens": token_count(targets)}
