"""Llama-3-family decoder in plain PyTorch (port of ray_tpu/models/llama.py).

Parameters are a plain dict with the JAX package's keys and stacked
layouts — `layers[name]` is `(n_layers, in, out)` — so weights convert
one-to-one from the JAX pytree (`params_from_numpy`) and the layer stack
is a Python loop over the leading axis instead of `lax.scan`.

`forward` is the naive reference (dense attention over the whole
sequence, no KV cache): the tests and `chip_smoke.py` decode against it.
The serving path runs through llm/model_runner.py instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.ops import resolve_device
from ray_tpu_torch.ops.attention import attention
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
    attention_impl: str = "auto"   # reference (flash: training slice)

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


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    # Writable + C-contiguous (np.asarray of a jax array is read-only);
    # copies only when the input is not already so.
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 (what np.asarray of a jax bf16 array gives)
        # is refused by torch.from_numpy: reinterpret the 16-bit payload.
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: Dict, config: LlamaConfig,
                      device="cuda") -> Dict:
    """Convert `jax.tree.map(np.asarray, llama.init_params(...))` of the
    JAX package (same keys, same stacked shapes) into this port's params
    on `device`, in config.dtype."""
    dev = resolve_device(device)

    def conv(a):
        return _to_torch(np.asarray(a)).to(device=dev, dtype=config.dtype)

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


def backbone(params: Dict, tokens: torch.Tensor,
             config: LlamaConfig) -> torch.Tensor:
    """tokens: (b, s) int -> final-norm hidden states (b, s, d) in
    config.dtype."""
    dev = params["embed"].device
    cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                config.rope_theta, device=dev)
    x = params["embed"][tokens.to(dev)].to(config.dtype)
    for li in range(config.n_layers):
        p = {k: params["layers"][k][li] for k in LAYER_KEYS}
        x = _layer(config, x, p, cos, sin)
    return rms_norm(x, params["final_norm"], config.norm_eps)


def forward(params: Dict, tokens: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """tokens: (b, s) int -> logits (b, s, vocab) float32."""
    x = backbone(params, tokens, config)
    return (x @ params["lm_head"]).float()
