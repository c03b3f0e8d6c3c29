"""Dense attention: GQA head repeat, the plain reference, and dispatch.

Mirrors the public surface of ray_tpu/ops/attention.py. The flash
kernels (the JAX package's K1-K4) come with the training slice; until
then `attention(impl="flash")` raises and "auto" resolves to the
reference, as it does in the JAX package on every non-TPU backend.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(batch, seq, kv_heads, hd) -> (batch, seq, kv_heads*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  positions_q: Optional[torch.Tensor] = None,
                  positions_kv: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """q: (b, sq, h, d); k/v: (b, skv, hkv, d). Returns (b, sq, h, d).

    Logits and softmax in fp32 (bf16 products are exact in fp32, so the
    upcast equals JAX's preferred_element_type=float32); probabilities
    are cast back to the value dtype before the second product."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = repeat_kv(k, h // hkv)
        v = repeat_kv(v, h // hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos_q = (positions_q if positions_q is not None
                 else torch.arange(sq, device=q.device))
        pos_k = (positions_kv if positions_kv is not None
                 else torch.arange(k.shape[1], device=q.device))
        mask = pos_q[:, None] >= pos_k[None, :]
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Dispatch: "reference" (plain PyTorch). "auto" is the reference
    until the flash kernels are ported."""
    if impl == "auto":
        impl = "reference"
    if impl == "reference":
        return mha_reference(q, k, v, causal=causal, scale=scale)
    if impl == "flash":
        raise NotImplementedError(
            "attention(impl='flash') needs the flash kernels K1-K4, which "
            "are still to be ported (ROADMAP.md, 'Training slice: flash "
            "attention K1-K4')")
    raise ValueError(f"unknown attention impl {impl!r}")
