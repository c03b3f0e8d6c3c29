#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases device,build,kernel
    python3 chip_smoke.py --phases device,build,kernel,split

Phases, in order; any failure raises and the exit code is non-zero:
  1. device    nvidia-smi name + power limit, torch.cuda device name; TF32
               off for matmuls and cuDNN.
  2. build     nvcc builds ray_tpu_torch/ops/csrc/*.cu (ops/_build.py).
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
import subprocess
import sys
import threading
import time
import zlib

ALL_PHASES = ("device", "build", "kernel", "server", "split", "identity")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,     # dense bf16 tensor-core rate
            "float32": 67e12}       # fp32 outside the tensor cores
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
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
    _build.load_library()
    wall = time.perf_counter() - t0
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build: {wall:.2f} s (nvcc {_build.build_seconds or 0:.2f} s)")
    RESULTS["build_s"] = wall


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
    RESULTS["kernel_cases"] = rows


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


def kernels_line() -> dict:
    """The machine-readable kernel summary, one entry per kernel: headline
    numbers from its bf16 case at the main path's own shape (K5: the
    server tick, tick_136; K6: the split decode, split_decode), worst
    error over all its cases. `launches` is the count of the run that
    drives the kernel's path (server phase for K5, split phase for K6;
    counts reset to 0 just before each run), null when that phase did not
    run."""
    rows = RESULTS.get("kernel_cases", [])

    def entry(kernel, name, replaces, head_case, launches):
        mine = [r for r in rows if r["kernel"] == kernel]
        head = next((r for r in mine if r["case"] == head_case
                     and r["dtype"] == "bfloat16"), {})
        return {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max((r["max_abs_err"] for r in mine),
                               default=None),
            "ms": head.get("kernel_ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"), "library_ms": None}

    return {"kernels": [
        entry("K5", "ragged_paged_attention_unified",
              "ray_tpu/ops/paged_attention.py:177", "tick_136",
              RESULTS.get("server", {}).get("k5_launches")),
        entry("K6", "ragged_paged_attention",
              "ray_tpu/ops/paged_attention.py:69", "split_decode",
              RESULTS.get("split", {}).get("k6_launches"))]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--out", help="also write all results as JSON here")
    args = ap.parse_args(argv)
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
