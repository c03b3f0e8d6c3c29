"""Elementwise / normalization / rotary ops (plain PyTorch).

Same layouts and numerics as ray_tpu/ops/layers.py: RMSNorm upcasts to
fp32, RoPE rotates the two HALVES of the head dim (not interleaved
pairs), theta defaults to 500000 (Llama-3).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 500000.0,
                     device=None):
    """Precompute RoPE cos/sin tables: (max_seq, head_dim//2), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim). cos/sin: (max_seq, head_dim//2).
    positions: (..., seq) absolute positions; default arange."""
    if positions is None:
        seq = x.shape[-3]
        c = cos[:seq][None, :, None, :]
        s = sin[:seq][None, :, None, :]
    else:
        c = cos[positions][..., :, None, :]
        s = sin[positions][..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
