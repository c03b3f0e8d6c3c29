"""Ragged paged attention: the serving hot op (plain versions, K5 and K6).

Port of ray_tpu/ops/paged_attention.py with the same layouts:
  q:            (S, Bq, H, hd) rectangular, or (T, H, hd) token-major
  k/v pages:    (K, P, ps, hd)  per-layer paged KV pool, K = kv heads
  block_tables: (S, max_pages)  int32, logical page i of seq s -> pool page
  kv_lens:      (S,) int32      context length INCLUDING this step's tokens
  q_positions:  (S,) int32      absolute position of the first query token
  cu_q_lens:    (S+1,) int32    token-major span starts (unified only)

`ragged_paged_attention_unified` (K5) is the attention of the engine's
unified tick, `ragged_paged_attention` (K6) that of the split path. On a
CUDA tensor each launches its hand-written Hopper kernel
(csrc/paged_attention.cu) and counts the launch; on a CPU tensor it runs
its plain version. Neither falls back from the kernel to the plain
version on a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def ragged_paged_attention_reference(
        q, k_pages, v_pages, block_tables, kv_lens, q_positions, *,
        scale: Optional[float] = None):
    """Plain version of the rectangular layout: gathers the full padded
    context of every sequence and runs a masked fp32 softmax."""
    S, Bq, H, hd = q.shape
    K, P, ps, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    max_ctx = max_pages * ps
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tables = block_tables.long()
    # (K, S, max_pages, ps, hd) -> (S, max_ctx, K, hd)
    k = k_pages[:, tables].permute(1, 2, 3, 0, 4).reshape(S, max_ctx, K, hd)
    v = v_pages[:, tables].permute(1, 2, 3, 0, 4).reshape(S, max_ctx, K, hd)
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    logits = torch.einsum("sqhd,skhd->shqk", q.float(), k.float()) * scale
    dev = q.device
    k_pos = torch.arange(max_ctx, device=dev)[None, None, None, :]
    q_abs = (q_positions.long()[:, None]
             + torch.arange(Bq, device=dev)[None, :])[:, None, :, None]
    mask = (k_pos < kv_lens.long()[:, None, None, None]) & (q_abs >= k_pos)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("shqk,skhd->sqhd", probs, v)


def token_seq_ids(cu_q_lens, T: int, S: int):
    """Sequence id per flat token (count of cu boundaries at or below it),
    clamped into [0, S-1] so padding tokens index real per-sequence rows;
    callers mask them out separately (tok >= cu_q_lens[S])."""
    tok = torch.arange(T, device=cu_q_lens.device)
    seq = (tok[:, None] >= cu_q_lens[None, 1:]).sum(dim=1)
    return torch.clamp(seq, max=S - 1)


def ragged_paged_attention_unified_reference(
        q, k_pages, v_pages, block_tables, kv_lens, q_positions, cu_q_lens,
        *, scale: Optional[float] = None):
    """Plain version of the token-major layout: scatters the valid flat
    rows into the rectangular (S, T, H, hd) layout, runs the rectangular
    plain version, gathers the rows back and zeroes the padding rows."""
    T, H, hd = q.shape
    S = kv_lens.shape[0]
    seq = token_seq_ids(cu_q_lens, T, S)
    tok = torch.arange(T, device=q.device)
    local = tok - cu_q_lens.long()[seq]
    valid = tok < cu_q_lens[S]
    # Only valid rows are written: torch has no out-of-bounds drop mode,
    # and a wrapped index would overwrite real rows.
    qr = torch.zeros((S, T, H, hd), dtype=q.dtype, device=q.device)
    qr[seq[valid], local[valid]] = q[valid]
    out_r = ragged_paged_attention_reference(
        qr, k_pages, v_pages, block_tables, kv_lens, q_positions,
        scale=scale)
    out = out_r[seq, local.clamp(0, T - 1)]
    return torch.where(valid[:, None, None], out, torch.zeros_like(out))


# Head dims the K5/K6 kernels are instantiated for (csrc/paged_attention.cu).
HEAD_DIMS = (64, 128)


def kernel_fits(head_dim: int, n_heads: int, n_kv_heads: int) -> bool:
    """True when K5/K6 take this attention shape: head dim 64 or 128,
    K | H and H/K <= 32."""
    return (head_dim in HEAD_DIMS and n_kv_heads > 0
            and n_heads % n_kv_heads == 0 and n_heads // n_kv_heads <= 32)


def _check_args(q, k_pages, v_pages, ints):
    """Checks shared by both kernels: q (..., H, hd) and the pages in
    bf16/fp32 alike, the head dims the kernels instantiate, GQA grouping,
    int32 index arrays, one device, contiguous, 16-byte aligned. `ints` is
    ((name, tensor, ndim), ...)."""
    H, hd = q.shape[-2:]
    K, P, ps, hd_k = k_pages.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q dtype {q.dtype}: kernel takes bfloat16/float32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if tuple(t.shape) != (K, P, ps, hd):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{(K, P, ps, hd)}")
    if hd_k != hd or hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: kernel takes 64/128")
    if not kernel_fits(hd, H, K):
        raise ValueError(f"H={H}, K={K}: need K | H and H/K <= 32")
    for name, t, ndim in ints:
        if t.dtype != torch.int32 or t.dim() != ndim:
            raise TypeError(f"{name}: need int32 with {ndim} dims, got "
                            f"{t.dtype} with {t.dim()}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    *((n, t) for n, t, _ in ints)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(entry, what, ws_bytes, inputs, scalars):
    """Run one launcher of the kernel library on q's current stream, q
    being inputs[0]: the output is allocated like q, the fp32 workspace
    holds key-split partials. Raises on a non-zero cudaError_t."""
    from ray_tpu_torch.ops import _build

    q = inputs[0]
    out = torch.empty_like(q)
    workspace = torch.empty(ws_bytes // 4, dtype=torch.float32,
                            device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = entry(*(t.data_ptr() for t in inputs), out.data_ptr(),
                     workspace.data_ptr(), *scalars, stream)
    _build.check(code, what)
    return out


def ragged_paged_attention(q, k_pages, v_pages, block_tables, kv_lens,
                           q_positions, *, scale: Optional[float] = None):
    """Rectangular ragged paged attention, the split path's attention: q is
    (S, Bq, H, hd), any Bq >= 1 (decode Bq = 1, verify and prefill chunks
    wider). Row (s, b) sits at position q_positions[s] + b; every row of a
    sequence with kv_lens[s] > 0 is computed (there are no q_lens), and a
    sequence with kv_lens[s] == 0 gives exact zeros on the card, as the TPU
    kernel does.

    CUDA tensors launch the K6 kernel (counted in `.launches`); CPU tensors
    run the plain version, whose kv_len == 0 rows are a uniform softmax
    over the gathered pages instead (no caller reads them). Block-table
    entries are trusted: the engine only hands out pages of the pool."""
    S, Bq, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, block_tables, kv_lens, q_positions,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2), ("kv_lens", kv_lens, 1),
                 ("q_positions", q_positions, 1)))
    if block_tables.shape[0] != S or kv_lens.shape[0] != S \
            or q_positions.shape[0] != S:
        raise ValueError("block_tables/kv_lens/q_positions disagree with "
                         f"S={S}")
    from ray_tpu_torch.ops import _build

    lib = _build.load_library()
    K, P, ps, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    is_bf16 = int(q.dtype == torch.bfloat16)
    out = _launch(
        lib.rpa_forward, "ragged_paged_attention",
        lib.rpa_workspace_bytes(S, Bq, H, ps, hd, max_pages, is_bf16),
        (q, k_pages, v_pages, block_tables, kv_lens, q_positions),
        (S, Bq, H, K, P, ps, hd, max_pages, float(scale), is_bf16))
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def ragged_paged_attention_unified(q, k_pages, v_pages, block_tables,
                                   kv_lens, q_positions, cu_q_lens, *,
                                   scale: Optional[float] = None,
                                   q_block: int = 8):
    """Unified ragged paged attention: ONE launch for a mixed batch where
    each sequence contributes its own query-token count (decode = 1,
    prefill chunk = up to chunk tokens). q is flat (T, H, hd); sequence s
    owns rows [cu_q_lens[s], cu_q_lens[s+1]); rows past cu_q_lens[S] are
    padding and come out as zeros. T must be a multiple of q_block (the
    engine pads to token buckets, all multiples of 8).

    CUDA tensors launch the K5 kernel (counted in `.launches`); CPU
    tensors run the plain version. Block-table entries are trusted: the
    engine only hands out pages of the pool."""
    T, H, hd = q.shape
    if T % q_block:
        raise ValueError(f"T={T} not a multiple of q_block={q_block}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return ragged_paged_attention_unified_reference(
            q, k_pages, v_pages, block_tables, kv_lens, q_positions,
            cu_q_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    S = kv_lens.shape[0]
    _check_args(q, k_pages, v_pages,
                (("block_tables", block_tables, 2), ("kv_lens", kv_lens, 1),
                 ("q_positions", q_positions, 1),
                 ("cu_q_lens", cu_q_lens, 1)))
    if block_tables.shape[0] != S or q_positions.shape[0] != S \
            or cu_q_lens.shape[0] != S + 1:
        raise ValueError("block_tables/q_positions/cu_q_lens disagree with "
                         f"S={S}")
    from ray_tpu_torch.ops import _build

    lib = _build.load_library()
    K, P, ps, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    is_bf16 = int(q.dtype == torch.bfloat16)
    out = _launch(
        lib.rpa_unified_forward, "ragged_paged_attention_unified",
        lib.rpa_unified_workspace_bytes(T, H, ps, hd, max_pages, is_bf16),
        (q, k_pages, v_pages, block_tables, kv_lens, q_positions,
         cu_q_lens),
        (T, H, K, P, ps, hd, S, max_pages, float(scale), is_bf16))
    ragged_paged_attention_unified.launches += 1
    return out


ragged_paged_attention_unified.launches = 0
