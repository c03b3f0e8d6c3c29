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
as they are.
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

from ray_tpu_torch.ops import resolve_device
from ray_tpu_torch.ops.attention import FLASH_FWD_OP, attention
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)

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
    attention_impl: str = "auto"   # reference | flash

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


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor, sharing its memory where it can."""
    # Writable + C-contiguous (np.asarray of a jax array is read-only);
    # copies only when the input is not already so.
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 (what np.asarray of a jax bf16 array gives)
        # is refused by torch.from_numpy: reinterpret the 16-bit payload.
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bf16 (which numpy lacks) as its uint16
    bits."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


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


# ---------------------------------------------------------------- forward

def _layer(config: LlamaConfig, x, p, cos, sin):
    """One decoder layer over dense attention. x: (b, s, d)."""
    b, s, _ = x.shape
    hd, H, K = config.head_dim, config.n_heads, config.n_kv_heads
    h = rms_norm(x, p["attn_norm"], config.norm_eps)
    q = apply_rope((h @ p["wq"]).reshape(b, s, H, hd), cos, sin)
    k = apply_rope((h @ p["wk"]).reshape(b, s, K, hd), cos, sin)
    v = (h @ p["wv"]).reshape(b, s, K, hd)
    attn = attention(q, k, v, causal=True, impl=config.attention_impl)
    x = x + attn.reshape(b, s, H * hd) @ p["wo"]
    h = rms_norm(x, p["mlp_norm"], config.norm_eps)
    return x + swiglu(h @ p["w_gate"], h @ p["w_up"]) @ p["w_down"]


def _save_dots(ctx, func, *args, **kwargs):
    if func is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_flash(ctx, func, *args, **kwargs):
    if func is FLASH_FWD_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_POLICIES = {"full": None, "dots": _save_dots, "flash": _save_flash}


def _checkpointed(config: LlamaConfig):
    """The layer function under the config's remat policy."""
    if config.remat_policy not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy must be 'full', 'dots' or 'flash', "
                         f"got {config.remat_policy!r}")
    policy = _REMAT_POLICIES[config.remat_policy]
    kw = {} if policy is None else {"context_fn": partial(
        create_selective_checkpoint_contexts, policy)}

    def run(x, p, cos, sin):
        return checkpoint(_layer, config, x, p, cos, sin,
                          use_reentrant=False, **kw)
    return run


def backbone(params: Dict, tokens: torch.Tensor,
             config: LlamaConfig) -> torch.Tensor:
    """tokens: (b, s) int -> final-norm hidden states (b, s, d) in
    config.dtype. Layers run under activation checkpointing only when
    config.remat is set and grad is enabled."""
    dev = params["embed"].device
    cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                config.rope_theta, device=dev)
    x = params["embed"][tokens.to(dev)].to(config.dtype)
    layer = partial(_layer, config)
    if config.remat and torch.is_grad_enabled():
        layer = _checkpointed(config)
    # unbind: the backward stacks the L per-layer gradients of a stacked
    # weight once, where indexing would add L full-size gradients.
    stacked = {k: params["layers"][k].unbind(0) for k in LAYER_KEYS}
    for li in range(config.n_layers):
        x = layer(x, {k: stacked[k][li] for k in LAYER_KEYS}, cos, sin)
    return rms_norm(x, params["final_norm"], config.norm_eps)


def forward(params: Dict, tokens: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """tokens: (b, s) int -> logits (b, s, vocab) float32."""
    x = backbone(params, tokens, config)
    return (x @ params["lm_head"]).float()


def next_token_ce(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy; mask (same shape as targets)
    optional."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.float()
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return -ll.mean()


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor],
            config: LlamaConfig) -> Tuple[torch.Tensor, Dict]:
    """batch: {"tokens": (b, s+1) int, optional "mask": (b, s+1)} ->
    (next-token cross entropy, {"loss", "tokens"})."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = forward(params, inputs, config)
    mask = batch.get("mask")
    loss = next_token_ce(logits, targets.to(logits.device),
                         mask[:, 1:].to(logits.device)
                         if mask is not None else None)
    return loss, {"loss": loss,
                  "tokens": torch.tensor(float(targets.numel()),
                                         dtype=torch.float32)}
