"""Sequence parallelism over the `sp` mesh axis (port of
ray_tpu/parallel/ring.py): ring attention and Ulysses attention.

Ring: the sequence is sharded over `sp`; each rank holds one query block
and passes its K/V block, unrepeated (the flash kernels are GQA-native),
around the ring (`collectives.ring_shift`, batched isend/irecv; the
backward passes the gradients back the other way). Each arriving chunk
is attended by the flash kernels with their LSE output (`chunk_step`),
and the partials merge by logsumexp (`merge`). Shards are aligned,
equal-length runs of the global sequence, so relative to this rank's
queries a chunk from rank src is past (src < my: no mask), the diagonal
(src == my: causal) or future (src > my: contributes nothing), and the
flash kernels need no absolute positions.

A future chunk still goes through a node that takes q and the chunk and
returns zeros and an LSE of NEG_INF (as the JAX package's switch branch
does): every rank then builds the same autograd graph, so the backward
runs every ring step's send/recv on every rank in the same order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ray_tpu_torch.ops.attention import NEG_INF, flash_attention, repeat_kv
from ray_tpu_torch.parallel import collectives as col


class _Future(torch.autograd.Function):
    """The future chunk: zeros (b, sq, h, d) and an LSE of NEG_INF, with a
    zero gradient for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, sq, h, _ = q.shape
        return (torch.zeros_like(q),
                torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                           device=q.device))

    @staticmethod
    def backward(ctx, g_out, g_lse):
        return None, None, None


def chunk_case(src: int, my: int, causal: bool) -> str:
    """Where K/V chunk `src` lies relative to query chunk `my`."""
    if not causal or src < my:
        return "past"
    return "diagonal" if src == my else "future"


def chunk_step(q, k_blk, v_blk, case: str, scale: float):
    """(out, lse) of q against one K/V chunk: the flash kernels without a
    mask (past), causal (diagonal), or nothing (future)."""
    if case == "future":
        return _Future.apply(q, k_blk, v_blk)
    return flash_attention(q, k_blk, v_blk, causal=case == "diagonal",
                           scale=scale, return_lse=True)


def merge(out, lse, blk_out, blk_lse):
    """Numerically stable softmax merge of two normalised partials: out
    (b, sq, h, d) fp32, lse (b, h, sq) fp32."""
    lse_new = torch.logaddexp(lse, blk_lse)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_blk = torch.exp(blk_lse - lse_new).transpose(1, 2)[..., None]
    return out * w_old + blk_out.float() * w_blk, lse_new


def _ring(q, k, v, my: int, n: int, causal: bool, scale: float,
          next_block: Callable):
    """The ring's schedule for query block `my` of `n`: step 0 the local
    chunk (the diagonal, so every row's LSE starts finite), then the chunk
    from rank (my - i) % n at step i. Returns (out fp32, lse)."""
    out, lse = chunk_step(q, k, v, chunk_case(my, my, causal), scale)
    out = out.float()
    k_blk, v_blk = k, v
    for i in range(1, n):
        k_blk, v_blk = next_block(i, k_blk, v_blk)
        blk = chunk_step(q, k_blk, v_blk, chunk_case((my - i) % n, my,
                                                     causal), scale)
        out, lse = merge(out, lse, *blk)
    return out, lse


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, seq_local, h, d); k/v: (b, seq_local, hkv, d), this rank's
    shard: rank i of `axis` holds tokens [i*seq_local, (i+1)*seq_local).
    Returns (b, seq_local, h, d) in q's dtype."""
    n = col.axes_size(mesh, axis)
    my = col.linear_index(mesh, axis) if n > 1 else 0

    def next_block(i, k_blk, v_blk):
        return col.ring_shift((k_blk, v_blk), mesh, axis)

    out, _ = _ring(q, k, v, my, n, causal, _scale(q, scale), next_block)
    return out.to(q.dtype)


def ring_attention_chunks(q, k, v, n_chunks: int, *, causal: bool = True,
                          scale: Optional[float] = None):
    """The ring's schedule on one device: the sequence (dim 1) cut into
    `n_chunks` query and K/V chunks, each query chunk attending the K/V
    chunks in the order the ring delivers them, through `chunk_step` and
    `merge`. Returns (out in q's dtype, lse (b, h, s) fp32): what ring
    attention over `n_chunks` ranks computes, for holding the composition
    against whole-sequence flash attention."""
    scale = _scale(q, scale)
    qs, ks, vs = (x.chunk(n_chunks, dim=1) for x in (q, k, v))
    outs, lses = [], []
    for my in range(n_chunks):
        def next_block(i, k_blk, v_blk, my=my):
            src = (my - i) % n_chunks
            return ks[src], vs[src]

        out, lse = _ring(qs[my], ks[my], vs[my], my, n_chunks, causal,
                         scale, next_block)
        outs.append(out.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh, axis: str = "sp", causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses SP: an all-to-all swaps the sharded dim from
    sequence to heads, full-sequence flash attention runs on h/sp heads,
    and a second all-to-all swaps back. Needs h % sp == 0; K/V are
    repeated only as far as hkv % sp demands."""
    b, sq, h, d = q.shape
    sp = col.axes_size(mesh, axis)
    if h % sp:
        raise ValueError(f"heads {h} not divisible by sp {sp}")
    hkv = k.shape[2]
    if hkv % sp:
        # Repeat K/V only as much as the head all-to-all needs; the local
        # attention handles the remaining GQA grouping itself. Full repeat
        # to h when the minimal factor does not divide h.
        r = sp // math.gcd(hkv, sp)
        if h % (hkv * r):
            r = h // hkv
        k, v = repeat_kv(k, r), repeat_kv(v, r)

    def to_heads(x):   # (b, sq_local, h, d) -> (b, sq_global, h/sp, d)
        return col.all_to_all(x, mesh, axis, split_dim=2, concat_dim=1)

    out = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal, scale=scale)
    return col.all_to_all(out, mesh, axis, split_dim=1, concat_dim=2)
