#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases device,build,kernel
    python3 chip_smoke.py --phases device,build,kernel,split
    python3 chip_smoke.py --phases device,build,kernel,train
    python3 chip_smoke.py --phases device --turns parent,.,.,parent

Phases, in order; any failure raises and the exit code is non-zero:
  1. device    nvidia-smi name + power limit, torch.cuda device name; TF32
               off for matmuls and cuDNN.
  2. build     nvcc builds ray_tpu_torch/ops/csrc/*.cu (ops/_build.py);
               prints ptxas's registers and spills per kernel and the
               dynamic shared memory of the bf16 flash forward, dQ and
               dK/dV kernels.
  3. kernel    the K5 kernel (unified ragged paged attention) and the K6
               kernel (rectangular ragged paged attention) against their
               plain PyTorch versions on the card at Llama-3-8B attention
               shapes (H=32, K=8, hd=128, ps=16), bf16 and fp32. K5: decode
               only, the server tick's S=8 shapes at token buckets 136 and
               64, a mixed prefill chunk + decode rows, padding sequences
               (kv_len=0), non-contiguous page tables, padding rows past
               cu_q_lens[S]. K6: the split decode (S=8, Bq=1), prefill
               chunks (S=1 and S=4 at Bq=128, with padding rows), a verify
               step (S=8, Bq=8), padding sequences with shuffled tables.
               fp32 rtol=atol=1e-5, bf16 rtol=atol=2e-2, padding rows
               (K5) and padding sequences (K6) exact zeros. Times with
               CUDA events.
  4. server    LLMServer with Llama-3-8B at full width (32 layers, bf16,
               random weights from a seed) answers concurrent requests
               through unified ragged ticks; the K5 launch count must grow
               by at least n_layers x ticks; a seeded request replays to the
               same tokens on a fresh engine.
  5. split     the same model and weights through the split path: the
               server's request mix on a unified_ticks=False engine, a
               repetition-penalty request on a default engine (routed to
               the split host-logits path), multi-step and split
               speculative engines; every run launches K6 n_layers times
               per runner step and K5 never; decode-step profile.
  6. identity  full width at 2 layers in fp32: the greedy tokens of the
               unified, split, multi-step and split-speculative engines
               equal greedy decoding with the naive llama.forward, a
               repetition-penalty request equals naive forward + host
               sampling, and a seeded temperature request gives the same
               tokens alone, inside a batch and on the split path.
  7. train     the JAX package's bench training configuration (vocab
               32000, d 2048, 14 layers, 16/8 heads, d_ff 7168, bf16) at
               full width and depth: flash attention, "dots" remat, batch
               4 x 2048, AdamW(1e-4, 0.9, 0.95, mu bf16), 2 warm-up and 10
               timed steps on one seeded batch; the loss falls, every step
               launches flash_fwd 2 x 14 times and flash_bwd_dq and
               flash_bwd_dkv 14 times each; a torch.profiler step; the same
               step with reference attention as a yardstick. Then the
               long-context point (seq 16384, batch 1, "flash" remat: 14
               flash_fwd launches per step) and an fp32 identity check (2
               layers, batch 2 x 512: loss and every gradient with flash
               attention equal those with the reference).
The kernel phase also holds the three flash kernels (forward, dQ, dK/dV)
against their plain versions in bf16 and fp32 at the train shape (4, 2048,
16/8 heads, 128), with Llama-3-8B heads (32/8), a ragged tail (1000),
causal sq < skv (512/1024), non-causal (1024/1536), and the long regimes
(forward 16384, backward 8192), timing each beside
`scaled_dot_product_attention` (library_ms; the port never calls it).
fp32 tolerance 1e-5 for out/LSE and 1e-4 for gradients, bf16 2e-2.
`--turns A,B,...` then times the bf16 flash kernels of each listed tree's
ray_tpu_torch (a directory holding the package, e.g. a parent commit's
copy unpacked in a git-ignored directory), one child process per entry,
in the order given (TURN_CASES: the forward at train, gqa4 and long_fwd,
dQ and dK/dV at train and long_bwd): run parent, change, change, parent
to compare two versions on one card.
Prints a `{"kernels": [...]}` line, then, last, the device line
`{"ok": true, "device": {...}}`; `--out FILE` also writes every result as
JSON. Imports nothing of jax or ray_tpu.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import zlib

ALL_PHASES = ("device", "build", "kernel", "server", "split", "identity",
              "train")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,     # dense bf16 tensor-core rate
            "float32": 67e12}       # fp32 outside the tensor cores
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}   # sums of up to 16k terms
SEED = 20261016
RESULTS: dict = {}
_SHARED: dict = {}   # Llama-3-8B weights, made once for server and split


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phases

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"nvidia-smi: {smi}")
    log(f"device: {name} (count {torch.cuda.device_count()}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    RESULTS["nvidia_smi"] = smi
    RESULTS["device"] = name


def phase_build():
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load_library()
    wall = time.perf_counter() - t0
    name = "?"
    for line in _build.build_log.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            # _ZN..<len>flash_fwd_kernelI13__nv_bfloat16Li128EE... ->
            # flash_fwd_kernel<bf16,128>; flash_fwd_wgmma_kernel is bf16 only
            m = re.search(r"\d((?:flash|rua|rpa)[a-z_]*?kernel)I(\w*?)"
                          r"(?:Li(\d+))?E", entry[1])
            if m:
                dt = "bf16" if "bfloat" in m[2] or "wgmma" in m[1] else "f32"
                name = f"{m[1]}<{dt}{',' + m[3] if m[3] else ''}>"
            else:
                name = entry[1][:60]
        elif any(w in line for w in ("registers", "spill", "error",
                                     "warning", "Performance")):
            log(f"  ptxas {name}: {line.strip()}")
    smem = {"flash_fwd_wgmma_kernel": {
        d: lib.flash_fwd_smem_bytes(d, 1) for d in (64, 128)},
        "flash_bwd_dq_wgmma_kernel": {
        d: lib.flash_bwd_dq_smem_bytes(d) for d in (64, 128)},
        "flash_bwd_dkv_wgmma_kernel": {
        d: lib.flash_bwd_dkv_smem_bytes(d) for d in (64, 128)}}
    for kernel, by_d in smem.items():
        log(f"  {kernel} dynamic shared memory: " + ", ".join(
            f"d={d} {b} bytes" for d, b in by_d.items()))
    log(f"build: {wall:.2f} s (nvcc {_build.build_seconds or 0:.2f} s)")
    RESULTS["build_s"] = wall
    RESULTS["flash_fwd_smem_bytes"] = smem["flash_fwd_wgmma_kernel"]
    RESULTS["flash_bwd_dq_smem_bytes"] = smem["flash_bwd_dq_wgmma_kernel"]
    RESULTS["flash_bwd_dkv_smem_bytes"] = smem["flash_bwd_dkv_wgmma_kernel"]


def _time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _paged_case(torch, name, dtype, q_shape, q_lens, kv_lens, *, shuffle,
                K=8, hd=128, ps=16, max_pages=128):
    """Inputs at Llama-3-8B attention shapes (q_shape ends in H=32, hd):
    q, K/V pages holding every sequence's context (shuffled or in order),
    block tables, kv_lens and q_positions = kv_lens - q_lens."""
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + zlib.crc32(name.encode()))
    S = len(q_lens)
    pages = [math.ceil(n / ps) for n in kv_lens]
    P = sum(pages) + 1
    ids = (torch.randperm(P - 1, generator=gen, device="cuda") + 1
           if shuffle else torch.arange(1, P, device="cuda"))
    tables = torch.zeros((S, max_pages), dtype=torch.int32, device="cuda")
    at = 0
    for s, n in enumerate(pages):
        tables[s, :n] = ids[at:at + n]
        at += n
    kv = torch.tensor(kv_lens, dtype=torch.int32)
    q_pos = torch.clamp(kv - torch.tensor(q_lens, dtype=torch.int32), min=0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return (randn(*q_shape), randn(K, P, ps, hd), randn(K, P, ps, hd),
            tables, kv.cuda(), q_pos.cuda())


def _kernel_case(torch, name, dtype, q_lens, kv_lens, T, *, shuffle):
    """One ragged token-major batch (K5): q (T, H, hd) plus cu_q_lens."""
    cu = torch.zeros(len(q_lens) + 1, dtype=torch.int32)
    cu[1:] = torch.cumsum(torch.tensor(q_lens), 0)
    return _paged_case(torch, name, dtype, (T, 32, 128), q_lens, kv_lens,
                       shuffle=shuffle) + (cu.cuda(),)


def _rect_case(torch, name, dtype, q_lens, kv_lens, Bq, *, shuffle):
    """One rectangular (S, Bq) batch (K6): row (s, b) at position
    kv_lens[s] - q_lens[s] + b, rows b >= q_lens[s] being a chunk's
    padding, kv_lens[s] = 0 a padding sequence."""
    return _paged_case(torch, name, dtype, (len(q_lens), Bq, 32, 128),
                       q_lens, kv_lens, shuffle=shuffle)


def _least_ms(args, keys, dtype_name):
    """Least time for the work: the bytes it must move (the K/V pages of
    every sequence with keys, read once per kv head; q and out; the index
    arrays) over the HBM rate against 4 hd H flops per attended (row, key)
    pair over the peak rate. `keys` counts those pairs per query head."""
    q, kp, _, tables, kv = args[:5]
    H, hd = q.shape[-2:]
    K, _, ps, _ = kp.shape
    es = q.element_size()
    kv_bytes = sum(math.ceil(n / ps) * ps
                   for n in kv.tolist()) * K * hd * 2 * es
    idx_bytes = 4 * sum(t.numel() for t in args[3:])
    t_bytes = (kv_bytes + 2 * q.numel() * es + idx_bytes) / HBM_BYTES_PER_S
    t_ops = 4 * keys * H * hd / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bound(args, dtype_name):
    """K5: every valid token row t of sequence s attends to
    max(0, min(kv_len_s, q_pos_s + t + 1)) keys."""
    kv_l, qp_l, cu_l = (t.tolist() for t in args[4:7])
    keys = sum(max(0, min(kv_l[s], qp_l[s] + t + 1))
               for s in range(len(kv_l))
               for t in range(cu_l[s + 1] - cu_l[s]))
    return _least_ms(args, keys, dtype_name)


def _rect_bound(args, dtype_name):
    """K6: every one of the Bq rows of a sequence is computed (K6 takes no
    q_lens): sum_s sum_b max(0, min(kv_len_s, q_pos_s + b + 1)) keys."""
    Bq = args[0].shape[1]
    kv_l, qp_l = args[4].tolist(), args[5].tolist()
    keys = sum(max(0, min(kv_l[s], qp_l[s] + b + 1))
               for s in range(len(kv_l)) for b in range(Bq))
    return _least_ms(args, keys, dtype_name)


def _check_case(torch, kernel, name, dname, fn, plain, args, live, bound):
    """One kernel case: the kernel against its plain version on the rows
    in `live`, exact zeros elsewhere, CUDA-event times, the bound."""
    tol = TOLERANCE[dname]
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    err = (out[live].float() - ref[live].float()).abs()
    max_err = err.max().item()
    ok = torch.allclose(out[live].float(), ref[live].float(), rtol=tol,
                        atol=tol)
    zero = bool((out[~live] == 0).all().item())
    if not (ok and zero and torch.isfinite(out).all()):
        raise AssertionError(
            f"{kernel} {name}/{dname}: max_abs_err={max_err} (tol {tol}), "
            f"padding rows zero={zero}")
    k_ms = _time_ms(torch, lambda: fn(*args), 50)
    p_ms = _time_ms(torch, lambda: plain(*args), 5)
    bound_ms, bound_by = bound(args, dname)
    row = dict(kernel=kernel, case=name, dtype=dname, max_abs_err=max_err,
               kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
               bound_by=bound_by, launches=fn.launches - before)
    log("kernel " + " ".join(f"{k}={v}" for k, v in row.items()))
    return row


def phase_kernel(torch):
    from ray_tpu_torch.ops import paged_attention as pa

    rng = torch.Generator().manual_seed(SEED)
    decode_kv = torch.randint(64, 2049, (8,), generator=rng).tolist()
    decode_kv[0] = 2048
    mixed_q = [128] + [1] * 8
    mixed_kv = [768] + decode_kv
    k5_cases = [  # name, q_lens, kv_lens, T, shuffled page tables
        ("decode", [1] * 8, decode_kv, 8, False),
        # The server tick's own shapes: S = batch_bucket(8) = 8, decode
        # rows first, then one prefill chunk, T padded to a token bucket.
        ("tick_136", [1] * 7 + [128], decode_kv[:7] + [768], 136, True),
        ("tick_64", [1] * 7 + [57], decode_kv[:7] + [300], 64, True),
        ("mixed", mixed_q, mixed_kv, 136, False),
        ("kv_len_0", mixed_q + [0] * 7, mixed_kv + [0] * 7, 136, False),
        ("noncontig", mixed_q, mixed_kv, 136, True),
        ("pad_rows", mixed_q, mixed_kv, 160, True),
    ]
    verify_q = [1, 2, 3, 4, 5, 1, 2, 3]
    k6_cases = [  # name, q_lens, kv_lens, Bq, shuffled page tables
        # The split decode: S = batch_bucket(8), one row per sequence.
        ("split_decode", [1] * 8, decode_kv, 1, False),
        # Prefill chunk steps: Bq = chunk bucket 128; 57 and 20 real rows
        # leave padding rows, which K6 computes as the TPU kernel does.
        ("split_chunk", [128], [768], 128, True),
        ("split_chunk_batch", [128, 128, 57, 20], [768, 128, 313, 20], 128,
         True),
        # Speculative verify: S = 8, Bq = chunk bucket of 1 + proposals.
        ("split_verify", verify_q,
         [n + q - 1 for n, q in zip(decode_kv, verify_q)], 8, True),
        ("kv_len_0", [5, 0, 8, 0], [300, 0, 800, 0], 8, True),
    ]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for name, q_lens, kv_lens, T, shuffle in k5_cases:
            args = _kernel_case(torch, name, dtype, q_lens, kv_lens, T,
                                shuffle=shuffle)
            live = torch.arange(T, device="cuda") < sum(q_lens)
            rows.append(_check_case(
                torch, "K5", name, dname, pa.ragged_paged_attention_unified,
                pa.ragged_paged_attention_unified_reference, args, live,
                _bound))
            del args
        for name, q_lens, kv_lens, Bq, shuffle in k6_cases:
            args = _rect_case(torch, name, dtype, q_lens, kv_lens, Bq,
                              shuffle=shuffle)
            rows.append(_check_case(
                torch, "K6", name, dname, pa.ragged_paged_attention,
                pa.ragged_paged_attention_reference, args, args[4] > 0,
                _rect_bound))
            del args
    torch.cuda.empty_cache()
    rows += _flash_cases(torch)
    RESULTS["kernel_cases"] = rows


# Flash cases: name, (b, sq, skv, h, hkv), causal, passes. "fwd" checks the
# forward with and without LSE, "bwd" dQ and dK/dV with a random out
# cotangent, "bwd_glse" with an LSE cotangent as well.
FLASH_CASES = [
    ("train", (4, 2048, 2048, 16, 8), True, ("fwd", "bwd", "bwd_glse")),
    ("gqa4", (1, 2048, 2048, 32, 8), True, ("fwd",)),
    ("ragged_tail", (1, 1000, 1000, 16, 8), True, ("fwd", "bwd")),
    ("causal_rect", (1, 512, 1024, 16, 8), True, ("fwd", "bwd")),
    ("noncausal_rect", (1, 1024, 1536, 16, 8), False, ("fwd", "bwd")),
    ("long_fwd", (1, 16384, 16384, 16, 8), True, ("fwd",)),
    ("long_bwd", (1, 8192, 8192, 16, 8), True, ("bwd",)),
]


def _time_auto(torch, fn, budget_s=0.25, most=50):
    """CUDA-event ms per call, with as many calls (3 to `most`) as fit
    in about budget_s after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    return _time_ms(torch, fn, int(min(most, max(3, budget_s / once))))


def _live_pairs(sq, skv, causal):
    """(q, k) pairs under the mask per (batch, head): q_pos >= k_pos from
    0 when causal."""
    if not causal:
        return sq * skv
    return sum(min(skv, i + 1) for i in range(sq))


def _flash_bound(dims, causal, dname, n_products, n_in, n_out):
    """Least ms: 2 d flops per live pair and product over the peak rate,
    against n_in q-sized or kv-sized inputs read once and the outputs
    written once (plus the fp32 (b, h, sq) rows) over the HBM rate."""
    b, sq, skv, h, hkv = dims
    d = 128
    es = 2 if dname == "bfloat16" else 4
    flops = 2 * d * n_products * _live_pairs(sq, skv, causal) * b * h
    q_bytes, kv_bytes = b * sq * h * d * es, b * skv * hkv * d * es
    moved = sum(q_bytes if x == "q" else kv_bytes if x == "kv"
                else 4 * b * h * sq for x in n_in + n_out)
    t_ops, t_bytes = flops / PEAK_OPS[dname], moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _close(torch, label, got, ref, tol):
    """Max abs error of `got` against `ref` (tuples); raises past tol."""
    err = 0.0
    for g, r in zip(got, ref):
        err = max(err, (g.float() - r.float()).abs().max().item())
        if not (torch.isfinite(g).all() and torch.allclose(
                g.float(), r.float(), rtol=tol, atol=tol)):
            raise AssertionError(f"{label}: max_abs_err={err} (tol {tol})")
    return err


def _flash_inputs(torch, name, dims, dtype):
    """Seeded q, k, v of a FLASH_CASES row (head dim 128) and the case's
    generator, as `randn(*shape, dt=dtype)`."""
    b, sq, skv, h, hkv = dims
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + zlib.crc32(name.encode()))

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    return (randn, randn(b, sq, h, 128), randn(b, skv, hkv, 128),
            randn(b, skv, hkv, 128))


def _flash_cases(torch):
    from ray_tpu_torch.ops import attention as attn

    F = torch.nn.functional
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for name, dims, causal, passes in FLASH_CASES:
            b, sq, skv, h, hkv = dims
            randn, q, k, v = _flash_inputs(torch, name, dims, dtype)
            scale = 1.0 / math.sqrt(128)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

            def sdpa(qt=qt, kt=kt, vt=vt):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale,
                    enable_gqa=True)

            def row(kernel, case, err, fn, plain, bound, library_ms):
                before = getattr(attn, kernel).launches
                r = dict(kernel=kernel, case=case, dtype=dname,
                         max_abs_err=err, kernel_ms=_time_auto(torch, fn),
                         plain_ms=_time_auto(torch, plain, most=5),
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=library_ms,
                         launches=getattr(attn, kernel).launches - before)
                log("kernel " + " ".join(f"{k_}={v_}" for k_, v_ in
                                         r.items()))
                return r

            lib_fwd = _time_auto(torch, sdpa)
            ref_out, ref_lse = attn.flash_fwd_reference(q, k, v, causal,
                                                        scale)
            if "fwd" in passes:
                tol = TOLERANCE[dname]
                out, lse = attn.flash_fwd(q, k, v, causal, scale)
                out2, _ = attn.flash_fwd(q, k, v, causal, scale,
                                         with_lse=False)
                torch.cuda.synchronize()
                err = _close(torch, f"flash_fwd {name}/{dname}",
                             (out, lse, out2), (ref_out, ref_lse, ref_out),
                             tol)
                rows.append(row(
                    "flash_fwd", name, err,
                    lambda: attn.flash_fwd(q, k, v, causal, scale),
                    lambda: attn.flash_fwd_reference(q, k, v, causal,
                                                     scale),
                    _flash_bound(dims, causal, dname, 2, ("q", "kv", "kv"),
                                 ("q", "rows")), lib_fwd))
                if name == "train":
                    rows.append(row(
                        "flash_fwd", name + "_nolse", err,
                        lambda: attn.flash_fwd(q, k, v, causal, scale,
                                               with_lse=False),
                        lambda: attn.flash_fwd_reference(
                            q, k, v, causal, scale, with_lse=False),
                        _flash_bound(dims, causal, dname, 2,
                                     ("q", "kv", "kv"), ("q",)), lib_fwd))
            for bwd in (p for p in passes if p.startswith("bwd")):
                tol = GRAD_TOLERANCE[dname]
                case = name + "_" + bwd
                dout = randn(b, sq, h, 128)
                delta = (dout.float() * ref_out.float()).sum(-1).transpose(
                    1, 2)
                if bwd == "bwd_glse":
                    delta = delta - randn(b, h, sq, dt=torch.float32)
                delta = delta.contiguous()
                args = (q, k, v, dout, ref_lse, delta, causal, scale)
                dq = attn.flash_bwd_dq(*args)
                dk, dv = attn.flash_bwd_dkv(*args)
                torch.cuda.synchronize()
                err_dq = _close(torch, f"flash_bwd_dq {case}/{dname}", (dq,),
                                (attn.flash_bwd_dq_reference(*args),), tol)
                err_dkv = _close(torch, f"flash_bwd_dkv {case}/{dname}",
                                 (dk, dv),
                                 attn.flash_bwd_dkv_reference(*args), tol)
                g_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
                dout_t = dout.transpose(1, 2).contiguous()
                out_t = sdpa(*g_in)

                # SDPA's backward alone, on a kept graph: one autograd call
                # of a few launches, so a slow host inflates it less than
                # the difference of two timings would.
                def sdpa_bwd():
                    torch.autograd.grad(out_t, g_in, dout_t,
                                        retain_graph=True)

                lib_bwd = _time_auto(torch, sdpa_bwd)
                rin = ("q", "kv", "kv", "q", "rows", "rows")
                rows.append(row(
                    "flash_bwd_dq", case, err_dq,
                    lambda: attn.flash_bwd_dq(*args),
                    lambda: attn.flash_bwd_dq_reference(*args),
                    _flash_bound(dims, causal, dname, 3, rin, ("q",)),
                    lib_bwd))
                rows.append(row(
                    "flash_bwd_dkv", case, err_dkv,
                    lambda: attn.flash_bwd_dkv(*args),
                    lambda: attn.flash_bwd_dkv_reference(*args),
                    _flash_bound(dims, causal, dname, 4, rin, ("kv", "kv")),
                    lib_bwd))
                del g_in, dout_t, out_t, dq, dk, dv
            del q, k, v, qt, kt, vt, ref_out, ref_lse
            torch.cuda.empty_cache()
    return rows


# (kernel, FLASH_CASES case) pairs timed in turns against another tree's
# ray_tpu_torch (--turns).
TURN_CASES = (("flash_fwd", "train"), ("flash_fwd", "gqa4"),
              ("flash_fwd", "long_fwd"), ("flash_bwd_dq", "train"),
              ("flash_bwd_dq", "long_bwd"), ("flash_bwd_dkv", "train"),
              ("flash_bwd_dkv", "long_bwd"))


def _turn_label(kernel, case):
    return f"{kernel}/{case}"


def _turn_times(torch):
    """Child of --turns: the bf16 flash kernels of whichever ray_tpu_torch
    this process imports, at TURN_CASES: CUDA-event ms and the worst error
    against the plain version (the forward with LSE; dQ and dK/dV on the
    plain forward's LSE and a seeded out cotangent). Prints one TURN
    line."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import _build

    _build.load_library()
    res = {"package": os.path.relpath(os.path.dirname(os.path.dirname(
        os.path.dirname(attn.__file__))))}
    cases = {name: (dims, causal) for name, dims, causal, _ in FLASH_CASES}
    for kernel, name in TURN_CASES:
        dims, causal = cases[name]
        randn, q, k, v = _flash_inputs(torch, name, dims, torch.bfloat16)
        scale = 1.0 / math.sqrt(128)
        ref_out, ref_lse = attn.flash_fwd_reference(q, k, v, causal, scale)
        if kernel == "flash_fwd":
            args = (q, k, v, causal, scale)
            ref = (ref_out, ref_lse)
            tol = TOLERANCE["bfloat16"]
        else:
            b, sq, _, h, _ = dims
            dout = randn(b, sq, h, 128)
            delta = (dout.float() * ref_out.float()).sum(-1).transpose(
                1, 2).contiguous()
            args = (q, k, v, dout, ref_lse, delta, causal, scale)
            ref = getattr(attn, kernel + "_reference")(*args)
            tol = GRAD_TOLERANCE["bfloat16"]
        fn = getattr(attn, kernel)
        got = fn(*args)
        if torch.is_tensor(got):   # dQ: one tensor
            got, ref = (got,), (ref,)
        torch.cuda.synchronize()
        err = _close(torch, f"turn {kernel} {name}", got, ref, tol)
        res[_turn_label(kernel, name)] = dict(ms=_time_auto(
            torch, lambda: fn(*args), budget_s=1.0, most=200),
            max_abs_err=err)
        del q, k, v, got, ref, ref_out, ref_lse, args
        torch.cuda.empty_cache()
    print("TURN " + json.dumps(res), flush=True)


def run_turns(trees):
    """The bf16 flash kernels of each tree in `trees` (a directory holding
    a ray_tpu_torch package, e.g. a parent commit's unpacked copy), one
    child process each, in the order given (parent, change, change,
    parent): kernel ms per TURN_CASES pair."""
    here = os.path.abspath(__file__)
    rows = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, here, "--phases", "device", "--turn-in", tree],
            capture_output=True, text=True, timeout=900)
        line = next((x for x in proc.stdout.splitlines()
                     if x.startswith("TURN ")), None)
        if proc.returncode != 0 or line is None:
            raise RuntimeError(f"turn in {tree} failed:\n{proc.stdout}"
                               f"\n{proc.stderr[-4000:]}")
        row = json.loads(line[5:])
        rows.append(row)
        labels = [_turn_label(*c) for c in TURN_CASES]
        log(f"turn {tree}: " + ", ".join(
            f"{c} {row[c]['ms']:.4f} ms (err {row[c]['max_abs_err']:.3g})"
            for c in labels))
    RESULTS["turns"] = rows


def _prompts(n_tokens, vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in n_tokens]


def _stream(server, request, record):
    t0 = time.perf_counter()
    first = None
    tokens = []
    for ev in server.completions_stream(request):
        if ev["finished"]:
            tokens = ev["token_ids"]
        elif first is None:
            first = time.perf_counter()
    record[request["request_id"]] = dict(
        tokens=tokens, ttft_s=first - t0, total_s=time.perf_counter() - t0)


def _llama8b(torch):
    """Llama-3-8B at full width, bf16, random weights from SEED: made once,
    shared by the server and split phases."""
    from ray_tpu_torch.models import llama

    if "llama8b" not in _SHARED:
        config = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        params = llama.init_params(config, gen, "cuda")
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params["layers"].values()) + sum(
            params[k].numel() for k in ("embed", "final_norm", "lm_head"))
        assert n_params == config.num_params()
        log(f"Llama-3-8B random weights {n_params / 1e9:.3f} B params in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
        _SHARED["llama8b"] = (config, params)
    return _SHARED["llama8b"]


def _engine_config(config, **kw):
    """The smoke's serving configuration: block 16, 512 KV pages, max
    batch 8, prefill chunk 128."""
    from ray_tpu_torch.llm.serving import LLMConfig

    return LLMConfig(model_config=config, block_size=16, num_kv_blocks=512,
                     max_batch_size=8, prefill_chunk=128, device="cuda",
                     **kw)


def _mix_requests(config, tag):
    """Four greedy prompts of 20 to 700 tokens and one seeded temperature
    request, 32 new tokens each."""
    lengths = [20, 100, 300, 700]
    prompts = _prompts(lengths + [60], config.vocab_size, SEED)
    requests = [dict(prompt=p, max_tokens=32, request_id=f"{tag}-{n}")
                for p, n in zip(prompts, lengths)]
    requests.append(dict(prompt=prompts[-1], max_tokens=32, temperature=0.8,
                         top_k=50, seed=1234, request_id="smoke-seeded"))
    return requests


def _drive(torch, server, requests, config):
    """Stream `requests` concurrently through `server`; every request must
    give 32 valid tokens. Returns (record, wall seconds)."""
    record: dict = {}
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_stream, args=(server, r, record))
               for r in requests]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(record) != len(requests):
        raise AssertionError(f"only {sorted(record)} finished")
    for r in requests:
        got = record[r["request_id"]]["tokens"]
        if len(got) != 32 or not all(0 <= t < config.vocab_size
                                     for t in got):
            raise AssertionError(f"{r['request_id']}: bad output {got}")
    return record, wall


def phase_server(torch):
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import LLMServer, build_engine
    from ray_tpu_torch.ops import paged_attention as pa

    config, params = _llama8b(torch)
    cfg = _engine_config(config)
    t0 = time.perf_counter()
    server = LLMServer(cfg, params=params)
    log(f"server: engine built + warmed in {time.perf_counter() - t0:.1f} "
        f"s, token budget {server.engine.token_budget}")
    requests = _mix_requests(config, "greedy")
    seeded = requests[-1]
    ticks0 = server.engine_stats()["ticks"]
    pa.ragged_paged_attention_unified.launches = 0
    pa.ragged_paged_attention.launches = 0
    record, wall = _drive(torch, server, requests, config)
    launches = pa.ragged_paged_attention_unified.launches
    k6 = pa.ragged_paged_attention.launches
    stats = server.engine_stats()
    ticks = stats["ticks"] - ticks0
    if launches < config.n_layers * ticks or ticks == 0 or k6:
        raise AssertionError(f"K5 launches {launches} < n_layers x ticks "
                             f"({config.n_layers} x {ticks}), or K6 "
                             f"launches {k6} != 0")
    n_gen = sum(len(v["tokens"]) for v in record.values())
    ttft = {k: round(v["ttft_s"] * 1e3, 1) for k, v in record.items()}
    log(f"server: {len(requests)} concurrent requests, {n_gen} tokens in "
        f"{wall:.2f} s ({n_gen / wall:.1f} generated tok/s), {ticks} "
        f"ticks, K5 launches {launches} (= {launches / ticks:.1f}/tick), "
        f"prefill tokens {stats['prefill_tokens_computed']}")
    log(f"server: TTFT ms {ttft}")
    server.close()
    del server
    # Seeded replay: each draw is keyed on (seed, counter) only, so the
    # same request id replayed on a fresh engine under the same batch
    # composition redraws the same tokens. Across compositions (the
    # concurrent run above) bf16 GEMMs and reductions may round
    # differently; whether those tokens match too is reported. The identity
    # phase holds alone == batched in fp32.
    replays = []
    for _ in range(2):
        engine = build_engine(cfg, params=params)
        engine.add_request(seeded["prompt"], SamplingParams(
            temperature=0.8, top_k=50, seed=1234, max_tokens=32),
            request_id=seeded["request_id"])
        done = []
        while engine.has_unfinished():
            done += [o for o in engine.step() if o.finished]
        replays.append(done[0].output_token_ids)
    if replays[0] != replays[1] or len(replays[0]) != 32:
        raise AssertionError(f"seeded replay differs:\n{replays}")
    concurrent = record["smoke-seeded"]["tokens"]
    same = sum(a == b for a, b in zip(replays[0], concurrent))
    log(f"server: seeded request replayed on two fresh engines: identical "
        f"({len(replays[0])} tokens); equal to the concurrent run at "
        f"{same}/32 positions")
    RESULTS["server"] = dict(
        requests=len(requests), wall_s=wall, generated_tokens=n_gen,
        ticks=ticks, k5_launches=launches, ttft_ms=ttft,
        generated_tok_s=n_gen / wall, seeded_replay_identical=True,
        seeded_positions_equal_concurrent=same,
        prefill_tokens=stats["prefill_tokens_computed"])
    RESULTS["decode_profile"] = _profile_decode(torch, engine, config,
                                                "rua_kernel", "K5")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def _count_runner_steps(runner) -> dict:
    """Count the runner's rectangular steps from now on (a k-step
    multi-step call counts k): the unit of K6's n_layers launches."""
    counts = {"steps": 0}

    def counted(fn, n_of=lambda *a: 1):
        def wrapped(*args, **kwargs):
            counts["steps"] += n_of(*args)
            return fn(*args, **kwargs)
        return wrapped

    for name in ("step", "step_sample", "step_verify"):
        setattr(runner, name, counted(getattr(runner, name)))
    runner.step_sample_multi = counted(runner.step_sample_multi,
                                       lambda n, *a: n)
    return counts


def _split_run(torch, server, requests, config, label):
    """Drive one split-path run with both launch counts at 0 just before
    it: K6 must launch n_layers times per runner step, K5 never."""
    from ray_tpu_torch.ops import paged_attention as pa

    counts = _count_runner_steps(server.engine.runner)
    stats0 = server.engine_stats()
    pa.ragged_paged_attention.launches = 0
    pa.ragged_paged_attention_unified.launches = 0
    record, wall = _drive(torch, server, requests, config)
    k6 = pa.ragged_paged_attention.launches
    k5 = pa.ragged_paged_attention_unified.launches
    steps = counts["steps"]
    stats = server.engine_stats()
    if steps == 0 or k6 < config.n_layers * steps or k5:
        raise AssertionError(f"split {label}: K6 launches {k6} for {steps} "
                             f"runner steps x {config.n_layers} layers, K5 "
                             f"launches {k5}")
    n_gen = sum(len(v["tokens"]) for v in record.values())
    ttft = {k: round(v["ttft_s"] * 1e3, 1) for k, v in record.items()}
    spec = (stats["spec_tokens_accepted"] - stats0["spec_tokens_accepted"],
            stats["spec_tokens_proposed"] - stats0["spec_tokens_proposed"])
    log(f"split {label}: {len(requests)} requests, {n_gen} tokens in "
        f"{wall:.2f} s ({n_gen / wall:.1f} generated tok/s), {steps} "
        f"runner steps, K6 launches {k6} (= {k6 / steps:.1f}/step), K5 0, "
        f"spec accepted/proposed {spec[0]}/{spec[1]}; TTFT ms {ttft}")
    return dict(requests=len(requests), wall_s=wall, generated_tokens=n_gen,
                generated_tok_s=n_gen / wall, runner_steps=steps,
                k6_launches=k6, ttft_ms=ttft, spec_accepted=spec[0],
                spec_proposed=spec[1])


def _decode_walls(torch, engines, config, n_ticks=12):
    """Host wall per engine step of each engine in steady decode (8
    running rows at 64-token prompts), timed in turns a, b, b, a, a, b,
    b, a on one card in one process, so that the engines compare within
    the host clock's noise."""
    from ray_tpu_torch.llm.sampling import SamplingParams

    prompts = _prompts([64] * 8, config.vocab_size, SEED + 5)
    for engine in engines.values():
        for i, p in enumerate(prompts):
            engine.add_request(p, SamplingParams(max_tokens=6 * n_ticks + 8),
                               request_id=f"walls-{i}")
        while engine.waiting or engine.prefilling:
            engine.step()
    names = list(engines)
    walls = {name: [] for name in names}
    for name in 2 * (names + names[::-1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            engines[name].step()
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) / n_ticks * 1e3)
    for engine in engines.values():
        while engine.has_unfinished():
            engine.step()
    log("decode step host wall ms (8 rows, turns "
        f"{' '.join(2 * (names + names[::-1]))}): "
        + "; ".join(f"{n} {w}" for n, w in walls.items()))
    return walls


def phase_split(torch):
    from ray_tpu_torch.llm.serving import LLMServer, build_engine

    config, params = _llama8b(torch)
    runs = {}
    prompts = _prompts([80, 400], config.vocab_size, SEED + 4)
    cases = [  # label, engine options, requests
        ("mix", dict(unified_ticks=False), _mix_requests(config, "split")),
        # A default (unified) engine routes this request to the split
        # host-logits path.
        ("repetition_penalty", {},
         [dict(prompt=prompts[0], max_tokens=32, repetition_penalty=1.3,
               request_id="split-rep")]),
        ("multi_step", dict(decode_multi_step=4, warmup_buckets="off"),
         [dict(prompt=p, max_tokens=32, request_id=f"multi-{i}")
          for i, p in enumerate(prompts)]),
        ("speculative", dict(speculative_ngram=4, unified_ticks=False,
                             warmup_buckets="off"),
         [dict(prompt=p, max_tokens=32, request_id=f"spec-{i}")
          for i, p in enumerate(prompts)]),
    ]
    profile_engine = None
    for label, kw, requests in cases:
        t0 = time.perf_counter()
        server = LLMServer(_engine_config(config, **kw), params=params)
        log(f"split {label}: engine built + warmed in "
            f"{time.perf_counter() - t0:.1f} s")
        runs[label] = _split_run(torch, server, requests, config, label)
        server.close()
        if label == "mix":
            profile_engine = server.engine
        del server
        gc.collect()
    RESULTS["split"] = dict(
        runs=runs, k6_launches=sum(r["k6_launches"] for r in runs.values()),
        runner_steps=sum(r["runner_steps"] for r in runs.values()))
    unified = build_engine(_engine_config(config, warmup_buckets="light"),
                           params=params)
    RESULTS["decode_walls_ms"] = _decode_walls(
        torch, {"unified": unified, "split": profile_engine}, config)
    del unified
    RESULTS["split_decode_profile"] = _profile_decode(
        torch, profile_engine, config, "rpa_kernel", "K6")
    del profile_engine
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _profile_decode(torch, engine, config, kernel, label, n_ticks=12):
    """Where a steady decode step's time goes: 8 running sequences, host
    wall per engine step without the profiler, then torch.profiler kernel
    times (device busy share, the attention kernel's share, GEMM share,
    top kernels). `kernel` names the attention kernel (rua_kernel for K5,
    rpa_kernel for K6), `label` its id."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.llm.sampling import SamplingParams

    for i, p in enumerate(_prompts([64] * 8, config.vocab_size, SEED + 2)):
        engine.add_request(p, SamplingParams(max_tokens=2 * n_ticks + 4),
                           request_id=f"profile-{i}")
    while engine.waiting or engine.prefilling:
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        engine.step()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / n_ticks * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            engine.step()
        torch.cuda.synchronize()
    while engine.has_unfinished():
        engine.step()
    # Kernel events only: a CPU op's device time repeats its kernels'.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in kernels)

    def share(pred):
        return sum(e.self_device_time_total for e in kernels
                   if pred(e.key)) / max(total_us, 1e-9)

    attn = share(lambda k: kernel in k)
    gemm = share(lambda k: any(s in k.lower() for s in (
        "gemm", "nvjet", "cutlass", "xmma", "cublas")))
    device_ms = total_us / 1e3 / n_ticks
    weights_ms = sum(p.numel() * p.element_size() for p in (
        list(engine.runner.params["layers"].values())
        + [engine.runner.params["lm_head"]])) / HBM_BYTES_PER_S * 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    top = [(e.key[:70], round(e.self_device_time_total / 1e3 / n_ticks, 4),
            e.count // n_ticks) for e in top]
    log(f"decode step, {label} engine (8 rows): {tick_ms:.2f} ms host wall, "
        f"device busy {device_ms:.2f} ms ({device_ms / tick_ms:.1%}), "
        f"{label} {attn:.1%} and GEMMs {gemm:.1%} of device time; "
        f"weight-read bound {weights_ms:.2f} ms")
    for name, ms, n in top:
        log(f"  kernel {ms:.4f} ms/tick x{n}: {name}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    host = [(e.key[:50], round(e.self_cpu_time_total / 1e3 / n_ticks, 3),
             e.count // n_ticks) for e in host]
    for name, ms, n in host:
        log(f"  host op {ms:.3f} ms/tick (self) x{n}: {name}")
    return dict(rows=8, tick_ms=tick_ms, device_ms=device_ms,
                kernel=label, kernel_share=attn, gemm_share=gemm,
                weight_bound_ms=weights_ms, top=top, host_top=host)


def _naive(torch, llama, params, config, prompt, n_new, pick):
    """Decode n_new tokens with the naive full forward, choosing each with
    pick(fp32 last-row logits, tokens so far)."""
    tokens = list(prompt)
    with torch.no_grad():
        for _ in range(n_new):
            logits = llama.forward(
                params, torch.tensor([tokens], device="cuda"), config)
            tokens.append(int(pick(logits[0, -1].float(), tokens)))
    return tokens[len(prompt):]


def phase_identity(torch):
    import numpy as np

    from ray_tpu_torch.llm.sampling import SamplingParams, sample
    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = llama.init_params(config, gen, "cuda")

    def engine_for(**kw):
        return build_engine(LLMConfig(
            model_config=config, block_size=16, num_kv_blocks=256,
            max_batch_size=8, prefill_chunk=128, device="cuda", **kw),
            params=params)

    prompts = _prompts([37, 150, 260], config.vocab_size, SEED + 1)
    n_new = 8
    greedy = [_naive(torch, llama, params, config, p, n_new,
                     lambda lg, _: torch.argmax(lg)) for p in prompts]
    paths = [("unified", {}), ("split", dict(unified_ticks=False)),
             ("multi-step", dict(decode_multi_step=4)),
             ("split-speculative", dict(speculative_ngram=4,
                                        unified_ticks=False))]
    for label, kw in paths:
        outs = engine_for(**kw).generate(prompts,
                                         SamplingParams(max_tokens=n_new))
        for p, o, ref in zip(prompts, outs, greedy):
            if o.output_token_ids != ref:
                raise AssertionError(
                    f"identity {label}: engine {o.output_token_ids} != "
                    f"naive {ref} (prompt {len(p)} tokens)")
    log(f"identity: fp32 full width, 2 layers: greedy of the "
        f"{', '.join(label for label, _ in paths)} engines == naive forward "
        f"for {len(prompts)} prompts x {n_new} tokens")
    # Repetition penalty: a default engine routes the request to the split
    # path, which samples on the host from the full logits.
    rep = SamplingParams(max_tokens=n_new, repetition_penalty=1.3)
    got = engine_for().generate(prompts[:1], rep)[0].output_token_ids
    ref = _naive(torch, llama, params, config, prompts[0], n_new,
                 lambda lg, toks: sample(lg.cpu().numpy(), rep,
                                         np.asarray(toks)))
    if got != ref:
        raise AssertionError(f"identity repetition_penalty: engine {got} "
                             f"!= naive + host sampling {ref}")
    log(f"identity: repetition_penalty=1.3 request == naive forward + host "
        f"sampling ({n_new} tokens)")
    # Seeded sampling does not depend on the batch: in fp32, where GEMM
    # batch variance is far below the gaps between sampled scores, the
    # seeded request gives the same tokens alone and inside a batch (other
    # slot, other token counts per tick, shared prefill ticks), and on the
    # split path, whose sampler keys each draw on the same (seed, index).
    seeded = SamplingParams(temperature=0.8, top_k=50, seed=1234,
                            max_tokens=32)
    seeded_prompt = _prompts([60], config.vocab_size, SEED + 3)[0]
    runs = []
    for others, kw in (([], {}), (prompts, {}),
                       ([], dict(unified_ticks=False))):
        engine = engine_for(**kw)
        for i, p in enumerate(others):
            engine.add_request(p, SamplingParams(max_tokens=40),
                               request_id=f"other-{i}")
        engine.add_request(seeded_prompt, seeded, request_id="smoke-seeded")
        done = {}
        while engine.has_unfinished():
            done.update({o.request_id: o.output_token_ids
                         for o in engine.step() if o.finished})
        runs.append(done["smoke-seeded"])
    if runs[0] != runs[1] or runs[0] != runs[2] or len(runs[0]) != 32:
        raise AssertionError(f"fp32 seeded request alone / in a batch / "
                             f"split differ:\n{runs}")
    log(f"identity: fp32 seeded request (temperature 0.8, top-k 50) alone "
        f"== inside a batch of {len(prompts) + 1} == on the split path: "
        f"{len(runs[0])} tokens")
    RESULTS["identity"] = dict(prompts=[len(p) for p in prompts],
                               tokens=n_new, equal=True,
                               greedy_paths=[label for label, _ in paths],
                               repetition_penalty_equal=True,
                               seeded_alone_equals_batched=True,
                               seeded_split_equals_unified=True)
    del params, engine
    gc.collect()
    torch.cuda.empty_cache()


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _bench_train_config(torch, **kw):
    """The JAX package's bench training configuration (its bench.py,
    `main`): ~0.92 B parameters, bf16, flash attention, "dots" remat."""
    from ray_tpu_torch.models import llama

    base = dict(vocab_size=32000, d_model=2048, n_layers=14, n_heads=16,
                n_kv_heads=8, d_ff=7168, max_seq=2048, remat_policy="dots",
                attention_impl="flash", dtype=torch.bfloat16)
    base.update(kw)
    return llama.LlamaConfig(**base)


def _flash_counts():
    from ray_tpu_torch.ops import attention as attn

    return {k: getattr(attn, k).launches for k in FLASH_KERNELS}


def _train_run(torch, config, batch, n_warm, n_timed, per_step=None):
    """Train `config` from SEED weights on one seeded batch with the
    bench's AdamW: flash launch counts at 0 just before the first step,
    read after each. Returns the run's numbers and (step, state, tokens)
    for a profiled step."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import init_state, make_step

    opt = adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    state = init_state(config, opt,
                       torch.Generator(device="cuda").manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tokens = torch.randint(0, config.vocab_size,
                           (batch, config.max_seq + 1), generator=gen,
                           device="cuda")
    step = make_step(config, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in FLASH_KERNELS:
        getattr(attn, k).launches = 0
    losses, steps = [], []
    for i in range(n_warm + n_timed):
        if i == n_warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = _flash_counts()
        state, loss = step(state, tokens)
        losses.append(loss)
        steps.append({k: v - before[k] for k, v in _flash_counts().items()})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches = _flash_counts()
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if per_step is not None and any(s != per_step for s in steps):
        raise AssertionError(f"flash launches per step {steps} != "
                             f"{per_step}")
    tokens_per_s = batch * config.max_seq / step_ms * 1e3
    out = dict(batch=batch, seq=config.max_seq, n_layers=config.n_layers,
               remat_policy=config.remat_policy,
               attention_impl=config.attention_impl, step_ms=step_ms,
               tokens_per_s=tokens_per_s,
               mfu=tokens_per_s * config.flops_per_token(config.max_seq)
               / PEAK_OPS["bfloat16"],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               loss_first=losses[0], loss_last=losses[-1],
               launches=launches, launches_per_step=steps[-1],
               warmup_steps=n_warm, timed_steps=n_timed)
    log(f"train {config.attention_impl}/{config.remat_policy} batch "
        f"{batch} x {config.max_seq}, {config.n_layers} layers: "
        f"{step_ms:.2f} ms/step ({n_timed} timed after {n_warm}), "
        f"{tokens_per_s:.0f} tokens/s, MFU {out['mfu']:.2%} of 989 "
        f"TFLOP/s, peak {out['peak_mem_gib']:.2f} GiB, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, flash launches per step "
        f"{steps[-1]}")
    return out, (step, state, tokens)


def _profile_train_step(torch, step, state, tokens, step_ms):
    """One step under torch.profiler: device-busy share of the timed
    step's wall, each flash kernel's and the GEMMs' share of device
    time, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, tokens)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in kernels)

    def share(pred):
        return sum(e.self_device_time_total for e in kernels
                   if pred(e.key)) / max(total_us, 1e-9)

    shares = {k: share(lambda key, k=k: f"{k}_kernel" in key
                       or f"{k}_wgmma_kernel" in key)
              for k in FLASH_KERNELS}
    shares["gemm"] = share(lambda key: any(s in key.lower() for s in (
        "gemm", "nvjet", "cutlass", "xmma", "cublas")))
    shares["elementwise_copy"] = share(
        lambda key: "elementwise" in key or "copy" in key)
    shares["reduce"] = share(lambda key: "reduce" in key)
    device_ms = total_us / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    top = [(e.key[:70], round(e.self_device_time_total / 1e3, 3), e.count)
           for e in top]
    log(f"train step profile: device busy {device_ms:.2f} ms = "
        f"{device_ms / step_ms:.1%} of the {step_ms:.2f} ms step; shares of "
        "device time: " + ", ".join(f"{k} {v:.1%}" for k, v in
                                    shares.items()))
    for name, ms, n in top:
        log(f"  kernel {ms:.3f} ms/step x{n}: {name}")
    return dict(device_ms=device_ms, busy_share=device_ms / step_ms,
                shares=shares, top=top)


def _train_identity(torch):
    """fp32, full width, 2 layers, batch 2 x 512: loss and every gradient
    with flash attention against the reference (TF32 off). Tolerance per
    leaf: max |flash - reference| <= 1e-4 x max |reference| (fp32 sums in
    another order)."""
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.optim import leaves

    config = _bench_train_config(torch, n_layers=2, max_seq=512,
                                 dtype=torch.float32)
    params = llama.init_params(config, torch.Generator(
        device="cuda").manual_seed(SEED + 3))
    for _, p in leaves(params):
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    batch = {"tokens": torch.randint(0, config.vocab_size, (2, 513),
                                     generator=gen, device="cuda")}
    got = {}
    for impl in ("flash", "reference"):
        cfg = dataclasses.replace(config, attention_impl=impl)
        loss, _ = llama.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, [p for _, p in leaves(params)])
        got[impl] = (loss.item(), grads)
    (lf, gf), (lr, gr) = got["flash"], got["reference"]
    worst = 0.0
    for (path, _), a, b in zip(leaves(params), gf, gr):
        rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        worst = max(worst, rel)
        if rel > 1e-4:
            raise AssertionError(f"train identity: d{path} flash vs "
                                 f"reference rel err {rel}")
    if abs(lf - lr) > 1e-5 * abs(lr):
        raise AssertionError(f"train identity: loss {lf} != {lr}")
    log(f"train identity: fp32 full width, 2 layers, batch 2 x 512: loss "
        f"flash {lf:.7f} vs reference {lr:.7f}; every gradient within "
        f"{worst:.2e} x its leaf's max (tolerance 1e-4)")
    return dict(loss_flash=lf, loss_reference=lr, worst_grad_rel=worst)


def phase_train(torch):
    import dataclasses

    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    config = _bench_train_config(torch)
    L = config.n_layers
    bench, (step, state, tokens) = _train_run(
        torch, config, 4, 2, 10,
        per_step={"flash_fwd": 2 * L, "flash_bwd_dq": L,
                  "flash_bwd_dkv": L})
    if not bench["loss_last"] < bench["loss_first"]:
        raise AssertionError(f"loss did not fall: {bench}")
    bench["profile"] = _profile_train_step(torch, step, state, tokens,
                                           bench["step_ms"])
    del step, state, tokens
    gc.collect()
    torch.cuda.empty_cache()
    yardstick, _ = _train_run(
        torch, dataclasses.replace(config, attention_impl="reference"), 4,
        2, 10, per_step={k: 0 for k in FLASH_KERNELS})
    gc.collect()
    torch.cuda.empty_cache()
    long_ctx, _ = _train_run(
        torch, dataclasses.replace(config, max_seq=16384,
                                   remat_policy="flash"), 1, 1, 2,
        per_step={"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L})
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["train"] = dict(bench=bench, reference=yardstick,
                            long_context=long_ctx,
                            identity=_train_identity(torch))
    gc.collect()
    torch.cuda.empty_cache()


def kernels_line() -> dict:
    """The machine-readable kernel summary, one entry per kernel: headline
    numbers from its bf16 case at the main path's own shape (K5: the
    server tick, tick_136; K6: the split decode, split_decode; the flash
    kernels: the train step's shape, train and train_bwd), worst error
    over all its cases. `launches` is the count of the run that drives the
    kernel's path (server phase for K5, split phase for K6, the bench
    train run for the flash kernels; counts reset to 0 just before each
    run), null when that phase did not run. `cuda_kernel` names the
    `__global__` functions the bf16 case launches, as profiles show them."""
    rows = RESULTS.get("kernel_cases", [])
    train = RESULTS.get("train", {}).get("bench", {}).get("launches", {})

    def entry(kernel, name, cuda_kernel, source, replaces, head_case,
              launches):
        mine = [r for r in rows if r["kernel"] == kernel]
        head = next((r for r in mine if r["case"] == head_case
                     and r["dtype"] == "bfloat16"), {})
        return {
            "name": name, "route": "cuda", "cuda_kernel": cuda_kernel,
            "source": f"ray_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max((r["max_abs_err"] for r in mine),
                               default=None),
            "ms": head.get("kernel_ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms")}

    attn = "ray_tpu/ops/attention.py"
    return {"kernels": [
        entry("K5", "ragged_paged_attention_unified",
              "rua_kernel (+ rua_merge_kernel when split)",
              "paged_attention.cu",
              "ray_tpu/ops/paged_attention.py:177", "tick_136",
              RESULTS.get("server", {}).get("k5_launches")),
        entry("K6", "ragged_paged_attention",
              "rpa_kernel (+ rpa_merge_kernel when split)",
              "paged_attention.cu",
              "ray_tpu/ops/paged_attention.py:69", "split_decode",
              RESULTS.get("split", {}).get("k6_launches")),
        entry("flash_fwd", "flash_fwd", "flash_fwd_wgmma_kernel",
              "flash_attention.cu",
              f"{attn}:520 (K1), {attn}:553 (K2)", "train",
              train.get("flash_fwd")),
        entry("flash_bwd_dq", "flash_bwd_dq", "flash_bwd_dq_wgmma_kernel",
              "flash_attention.cu",
              f"{attn}:616 (K3 dQ), {attn}:738 (K4 dQ)", "train_bwd",
              train.get("flash_bwd_dq")),
        entry("flash_bwd_dkv", "flash_bwd_dkv", "flash_bwd_dkv_wgmma_kernel",
              "flash_attention.cu",
              f"{attn}:634 (K3 dK/dV), {attn}:771 (K4 dK/dV)", "train_bwd",
              train.get("flash_bwd_dkv"))]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--out", help="also write all results as JSON here")
    ap.add_argument("--turns", help="comma-separated trees, each holding "
                    "a ray_tpu_torch package: time their bf16 flash "
                    "kernels at " + ", ".join(_turn_label(*c) for c in
                                              TURN_CASES)
                    + " in this order")
    ap.add_argument("--turn-in", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn_in:
        sys.path.insert(0, os.path.abspath(args.turn_in))
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    t_all = time.perf_counter()
    phase_device(torch)   # always: TF32 off and the card's identity
    for name in phases:
        if name == "device":
            continue
        t0 = time.perf_counter()
        fn = globals()[f"phase_{name}"]
        if name == "build":
            fn()
        else:
            fn(torch)
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    if args.turn_in:
        _turn_times(torch)
        return 0
    if args.turns:
        run_turns(args.turns.split(","))
    RESULTS["phases"] = phases
    RESULTS["wall_s"] = time.perf_counter() - t_all
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    log(f"nvidia-smi: {RESULTS['nvidia_smi']}")
    log(json.dumps(kernels_line()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
