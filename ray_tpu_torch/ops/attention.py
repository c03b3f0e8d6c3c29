"""Dense attention: GQA head repeat, the plain reference, flash attention.

Mirrors the public surface of ray_tpu/ops/attention.py with its layouts:
q (b, sq, h, d), k/v (b, skv, hkv, d), hkv dividing h; query head
hi = kvh * n_rep + g reads kv head kvh; the causal mask is q_pos >= k_pos
with both positions counted from 0 (top-left aligned, also when
sq != skv); the LSE is that of the SCALED logits, (b, h, sq) fp32.

Flash attention is three dispatcher ops (`torch.library.custom_op`):
`ray_tpu_torch::flash_fwd` (out and LSE), `flash_bwd_dq` and
`flash_bwd_dkv`; the forward carries its gradient through
`register_autograd`, so selective activation checkpointing can see (and
save) the forward op, as `checkpoint_name(out, "flash_out")` lets a JAX
remat policy save the Pallas kernel's outputs. Each op runs its wrapper
(`flash_fwd`, `flash_bwd_dq`, `flash_bwd_dkv`): on a CUDA tensor the
wrapper launches its hand-written Hopper kernel (csrc/flash_attention.cu)
and counts the launch in `.launches`; on a CPU tensor it runs its plain
version (`*_reference`), written blockwise like the Pallas kernels so that
it fits in memory at long sequences. No other device is accepted, and a
CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# Head dims the flash kernels are instantiated for (csrc/flash_attention.cu).
FLASH_HEAD_DIMS = (64, 128)


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


# ---------------------------------------------------------------- plain versions
#
# Grouped fp32 layout: q-side tensors (b, hkv, n_rep, s, d), kv-side
# (b, hkv, 1, s, d), so a group's n_rep query heads broadcast against
# their kv head without a repeated copy.

def _grouped_q(x, hkv):
    b, s, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b, hkv, h // hkv, s, d)


def _grouped_kv(x):
    return x.float().permute(0, 2, 1, 3)[:, :, None]


def _grouped_rows(x, hkv):
    """(b, h, sq) per-row values -> (b, hkv, n_rep, sq, 1)."""
    b, h, s = x.shape
    return x.float().reshape(b, hkv, h // hkv, s)[..., None]


def _ungroup(x, dtype):
    """(b, hkv, n_rep, s, d) -> (b, s, hkv * n_rep, d) in dtype."""
    b, hkv, n_rep, s, d = x.shape
    return x.reshape(b, hkv * n_rep, s, d).permute(0, 2, 1, 3).to(
        dtype).contiguous()


def _live(qs, qe, ks, ke, causal, device):
    """(bq, bk) mask of the pairs a tile attends, None when all are."""
    if not causal or ke - 1 <= qs:
        return None
    q_pos = torch.arange(qs, qe, device=device)[:, None]
    return q_pos >= torch.arange(ks, ke, device=device)[None, :]


def _kv_end(qe, skv, causal):
    """Keys a q block [.., qe) reaches: up to its last row's position."""
    return min(skv, qe) if causal else skv


def flash_fwd_reference(q, k, v, causal: bool, scale: float,
                        block_q: int = 512, block_k: int = 512,
                        with_lse: bool = True):
    """Plain version of the flash forward (K1/K2): online softmax over
    key blocks in fp32, q·scale before the product, out = acc / max(l,
    1e-30) in q's dtype, lse = m + log(max(l, 1e-30)) as (b, h, sq) fp32
    (an empty tensor when with_lse is False)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = _grouped_q(q, hkv) * scale
    kg, vg = _grouped_kv(k), _grouped_kv(v)
    out = torch.empty_like(qg)
    lse = torch.empty(qg.shape[:-1], dtype=torch.float32, device=q.device)
    for qs in range(0, sq, block_q):
        qe = min(qs + block_q, sq)
        qb = qg[..., qs:qe, :]
        m = torch.full(qb.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for ks in range(0, _kv_end(qe, skv, causal), block_k):
            ke = min(ks + block_k, skv)
            s = qb @ kg[..., ks:ke, :].transpose(-1, -2)
            live = _live(qs, qe, ks, ke, causal, q.device)
            if live is not None:
                s = torch.where(live, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + p @ vg[..., ks:ke, :]
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[..., qs:qe, :] = acc / l
        lse[..., qs:qe] = (m + torch.log(l))[..., 0]
    if not with_lse:
        lse = q.new_empty(0, dtype=torch.float32)
    else:
        lse = lse.reshape(b, h, sq)
    return _ungroup(out, q.dtype), lse


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                           scale: float, block_q: int = 512,
                           block_k: int = 512):
    """Plain version of the dQ pass (K3/K4 dQ): per key block, p =
    exp(s·scale − lse), ds = p·(dO·Vᵀ − delta), dq += ds·K; writes
    dq·scale in q's dtype. lse and delta are (b, h, sq) fp32."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg, dog = _grouped_q(q, hkv), _grouped_q(dout, hkv)
    kg, vg = _grouped_kv(k), _grouped_kv(v)
    lse_g, delta_g = _grouped_rows(lse, hkv), _grouped_rows(delta, hkv)
    dq = torch.empty_like(qg)
    for qs in range(0, sq, block_q):
        qe = min(qs + block_q, sq)
        qb, dob = qg[..., qs:qe, :], dog[..., qs:qe, :]
        lb, db = lse_g[..., qs:qe, :], delta_g[..., qs:qe, :]
        acc = torch.zeros_like(qb)
        for ks in range(0, _kv_end(qe, skv, causal), block_k):
            ke = min(ks + block_k, skv)
            kb, vb = kg[..., ks:ke, :], vg[..., ks:ke, :]
            p = torch.exp((qb @ kb.transpose(-1, -2)) * scale - lb)
            live = _live(qs, qe, ks, ke, causal, q.device)
            if live is not None:
                p = torch.where(live, p, torch.zeros_like(p))
            ds = p * (dob @ vb.transpose(-1, -2) - db)
            acc = acc + ds @ kb
        dq[..., qs:qe, :] = acc * scale
    return _ungroup(dq, q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal: bool,
                            scale: float, block_q: int = 512,
                            block_k: int = 512):
    """Plain version of the dK/dV pass (K3/K4 dK/dV): per key block, the
    group's n_rep query heads and the q blocks from the diagonal on;
    dv += pᵀ·dO, dk += dsᵀ·Q summed over the group in fp32; writes
    dk·scale and dv in k's and v's dtypes."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg, dog = _grouped_q(q, hkv), _grouped_q(dout, hkv)
    kg, vg = _grouped_kv(k), _grouped_kv(v)
    lse_g, delta_g = _grouped_rows(lse, hkv), _grouped_rows(delta, hkv)
    dk = torch.empty_like(kg[:, :, 0])
    dv = torch.empty_like(dk)
    for ks in range(0, skv, block_k):
        ke = min(ks + block_k, skv)
        kb, vb = kg[..., ks:ke, :], vg[..., ks:ke, :]
        dk_acc = torch.zeros_like(kb)
        dv_acc = torch.zeros_like(kb)
        q_start = (ks // block_q) * block_q if causal else 0
        for qs in range(q_start, sq, block_q):
            qe = min(qs + block_q, sq)
            qb, dob = qg[..., qs:qe, :], dog[..., qs:qe, :]
            p = torch.exp((qb @ kb.transpose(-1, -2)) * scale
                          - lse_g[..., qs:qe, :])
            live = _live(qs, qe, ks, ke, causal, q.device)
            if live is not None:
                p = torch.where(live, p, torch.zeros_like(p))
            dv_acc = dv_acc + (p.transpose(-1, -2) @ dob).sum(
                dim=2, keepdim=True)
            ds = p * (dob @ vb.transpose(-1, -2) - delta_g[..., qs:qe, :])
            dk_acc = dk_acc + (ds.transpose(-1, -2) @ qb).sum(
                dim=2, keepdim=True)
        dk[..., ks:ke, :] = dk_acc[:, :, 0] * scale
        dv[..., ks:ke, :] = dv_acc[:, :, 0]
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


# ---------------------------------------------------------------- wrappers

def tma_aligned(data_ptr: int, strides, element_size: int) -> bool:
    """TMA's rule for a tensor it copies from (the bf16 forward reads q, k
    and v through tensor maps; every flash kernel loads 16 bytes a
    thread): a 16-byte aligned base, and every stride but the innermost a
    multiple of 16 bytes. `strides` are in elements, outermost first."""
    return data_ptr % 16 == 0 and all(
        st * element_size % 16 == 0 for st in tuple(strides)[:-1])


def _check_kernel_args(q, k, v, *rest):
    """What the kernels take: q, k, v and the q-shaped `rest` in one of
    bf16/fp32, one CUDA device, contiguous and TMA-aligned (`tma_aligned`);
    head dim 64 or 128; hkv | h."""
    b, sq, h, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q dtype {q.dtype}: kernel takes bfloat16/float32")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {d}: kernel takes 64/128")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or h % k.shape[2]:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v), *(("dout", t) for t in rest)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for t in (q, k, v, *rest):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous() or not tma_aligned(
                t.data_ptr(), t.stride(), t.element_size()):
            raise ValueError("flash kernels take contiguous tensors with a "
                             "16-byte aligned base and 16-byte strides")


def _check_rows(q, *rows):
    b, sq, h, _ = q.shape
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq) \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"lse/delta must be contiguous fp32 "
                             f"{(b, h, sq)} on {q.device}")


def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def _launch(kernel, ptrs, q, k, causal, scale):
    """Call `kernel`'s launcher (`<kernel>_launch` in the kernel library)
    on q's current stream with the shape scalars every flash launcher
    takes; raises on a non-zero cudaError_t."""
    from ray_tpu_torch.ops import _build

    entry = getattr(_build.load_library(), kernel + "_launch")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = entry(*ptrs, b, sq, skv, h, hkv, d, int(causal),
                     float(scale), int(q.dtype == torch.bfloat16), stream)
    _build.check(code, kernel)


def flash_fwd(q, k, v, causal: bool, scale: float, block_q: int = 512,
              block_k: int = 512, with_lse: bool = True):
    """Flash forward: (out (b, sq, h, d) in q's dtype, lse (b, h, sq) fp32,
    empty when with_lse is False). CUDA tensors launch the flash_fwd
    kernel (counted in `.launches`): bf16 the wgmma + TMA kernel, fp32 the
    CUDA-core one; CPU tensors run the plain version."""
    if _device_kind(q) == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale, block_q, block_k,
                                   with_lse)
    _check_kernel_args(q, k, v)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    _launch("flash_fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr() if with_lse
                          else None), q, k, causal, scale)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool, scale: float,
                 block_q: int = 512, block_k: int = 512):
    """dQ of flash attention in q's dtype. CUDA tensors launch the
    flash_bwd_dq kernel (counted in `.launches`); CPU tensors run the
    plain version."""
    if _device_kind(q) == "cpu":
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal,
                                      scale, block_q, block_k)
    _check_kernel_args(q, k, v, dout)
    _check_rows(q, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k, causal, scale)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  block_q: int = 512, block_k: int = 512):
    """(dK, dV) of flash attention in k's and v's dtypes, summed over each
    kv head's query group. CUDA tensors launch the flash_bwd_dkv kernel
    (counted in `.launches`); CPU tensors run the plain version."""
    if _device_kind(q) == "cpu":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal,
                                       scale, block_q, block_k)
    _check_kernel_args(q, k, v, dout)
    _check_rows(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k, causal, scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


# ---------------------------------------------------------------- dispatcher ops

_DEVICES = ("cpu", "cuda")


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=(),
                         device_types=_DEVICES)
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float, block_q: int, block_k: int,
                  with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal, scale, block_q, block_k, with_lse)


@torch.library.custom_op("ray_tpu_torch::flash_bwd_dq", mutates_args=(),
                         device_types=_DEVICES)
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dout: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, causal: bool, scale: float,
                     block_q: int, block_k: int) -> torch.Tensor:
    return flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale, block_q,
                        block_k)


@torch.library.custom_op("ray_tpu_torch::flash_bwd_dkv", mutates_args=(),
                         device_types=_DEVICES)
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool, scale: float,
                      block_q: int, block_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, block_q,
                         block_k)


def _fwd_setup_context(ctx, inputs, output):
    q, k, v, causal, scale, block_q, block_k, with_lse = inputs
    out, lse = output
    if not with_lse:
        ctx.mark_non_differentiable(out, lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.args = (causal, scale, block_q, block_k)


def _fwd_backward(ctx, g_out, g_lse):
    """The custom_vjp backward of the JAX package (`_flash_bwd_rule`):
    delta = rowsum(dO·O) − g_lse in fp32, from the output in its own
    dtype; an absent cotangent counts as zero."""
    q, k, v, out, lse = ctx.saved_tensors
    causal, scale, block_q, block_k = ctx.args
    if g_out is None:
        g_out = torch.zeros_like(out)
    g_out = g_out.to(out.dtype).contiguous()
    delta = (g_out.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    dq = _flash_bwd_dq_op(q, k, v, g_out, lse, delta, causal, scale,
                          block_q, block_k)
    dk, dv = _flash_bwd_dkv_op(q, k, v, g_out, lse, delta, causal, scale,
                               block_q, block_k)
    return dq, dk, dv, None, None, None, None, None


torch.library.register_autograd("ray_tpu_torch::flash_fwd", _fwd_backward,
                                setup_context=_fwd_setup_context)

FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


def _flash_prep(q, k, scale):
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv != 0:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads {hkv}")
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512,
                    return_lse: bool = False):
    """Differentiable flash attention (forward op + dQ and dK/dV ops in
    the backward). q: (b, sq, h, d), k/v: (b, skv, hkv, d). With
    return_lse=True also returns the (b, h, sq) logsumexp, whose
    cotangent folds into the backward's delta. `block_q`/`block_k` tile
    the plain versions; the CUDA kernels keep their own tiles (128 rows
    and keys for the bf16 forward, 64 otherwise; results agree up to the
    order of fp32 sums)."""
    scale = _flash_prep(q, k, scale)
    out, lse = _flash_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal, scale, block_q, block_k, True)
    return (out, lse) if return_lse else out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None, block_q: int = 512,
                        block_k: int = 512) -> torch.Tensor:
    """Forward-only entry point: the kernel writes no LSE, and the result
    has no gradient."""
    scale = _flash_prep(q, k, scale)
    out, _ = _flash_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal, scale, block_q, block_k, False)
    return out


def auto_impl(device_type: str, head_dim: int, sq: int) -> str:
    """attention(impl="auto")'s choice: the JAX package's rule with "on a
    TPU" read as "on a CUDA tensor": flash when the head dim is a multiple
    of 128 and sq >= 256, else the reference; always the reference on the
    CPU. Where that rule picks flash at a head dim the kernels lack (256),
    raises: the port has no such kernel yet (ROADMAP queue 2 D)."""
    if device_type != "cuda" or head_dim % 128 or sq < 256:
        return "reference"
    if head_dim not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim}: the flash kernels take "
                         f"{FLASH_HEAD_DIMS}; a d={head_dim} kernel is "
                         f"ROADMAP queue 2 D")
    return "flash"


def attention(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Dispatch: "reference" (plain PyTorch, O(s²) memory), "flash" (the
    flash ops: O(s) memory, differentiable; raises at a head dim the
    kernels lack), "auto" (`auto_impl`)."""
    if impl == "auto":
        impl = auto_impl(q.device.type, q.shape[-1], q.shape[1])
    if impl == "reference":
        return mha_reference(q, k, v, causal=causal, scale=scale)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
