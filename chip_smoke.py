#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --phases device,build,kernel
    python3 chip_smoke.py --phases device,build,kernel,split
    python3 chip_smoke.py --phases device,build,kernel,train
    python3 chip_smoke.py --phases device,build,lora,pages
    python3 chip_smoke.py --phases device,build,disagg
    python3 chip_smoke.py --phases device,build,mesh
    python3 chip_smoke.py --phases device,build,checkpoint,tp   # 2-4 cards
    python3 chip_smoke.py --phases device,build,pipeline,rlhf,resnet
    python3 chip_smoke.py --phases device,build,runtime
    python3 chip_smoke.py --phases device,build,serve
    python3 chip_smoke.py --phases device,build,router
    python3 chip_smoke.py --phases device,build,prefix_store
    python3 chip_smoke.py --phases device,build,collective   # (b) on 2+ cards
    python3 chip_smoke.py --phases device --turns parent,.,.,parent
    python3 chip_smoke.py --phases device --turns a,b,b,a --turn-legs server

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
               cu_q_lens[S], a 128-row chunk at 4096 keys, the
               speculative tick (8 sequences x 5 rows at 64-1024 keys,
               bucket 64). K6: the split
               decode (S=8, Bq=1), prefill chunks (S=1 and S=4 at Bq=128,
               with padding rows), a verify step (S=8, Bq=8), padding
               sequences with shuffled tables. fp32 rtol=atol=1e-5, bf16
               rtol=atol=2e-2, padding rows (K5) and padding sequences
               (K6) exact zeros, each output also within
               ||got - ref|| / ||ref|| <= 5e-6 (fp32) or 1e-2 (bf16).
               Times with CUDA events: eagerly, host included, as the
               engine calls them, and device time alone over a CUDA
               graph of 20 calls (graph_ms); bf16 calls split into
               attention and merge by torch.profiler.
  4. server    LLMServer with Llama-3-8B at full width (32 layers, bf16,
               random weights from a seed) answers concurrent requests
               through unified ragged ticks, each tick one replay of one
               of its token bucket's two CUDA graphs (all-greedy,
               sampled): the K5 launch count (replays
               count) must grow by at least n_layers x ticks, K6 stay at 0
               and step_compiles stay unchanged after warmup; tok/s, TTFT
               and the streamed tokens' ITL p50/p99. A seeded request
               replays to the same tokens on a fresh engine. A unified
               speculative server (speculative_ngram=4) runs the same
               mix (proposed > 0, accepted <= proposed). The mix on the
               graphed and an eager (cuda_graphs=False) server in turns
               a, b, b, a; decode steps of 8 rows on both, host wall in
               turns and device time (torch.profiler); reserved memory
               over each one's warmup (the graphs' pool).
  5. lora      multi-LoRA at full width: the graphed Llama-3-8B server
               with four rank-8 adapters over all seven targets (the
               port's init_adapter from the seed) serves the server's mix
               spread over the base model and the adapters, against the
               base server on the same weights and mix in turns a, b, b,
               a (K5 >= n_layers x ticks counted on replays,
               step_compiles unchanged after warmup); a load_adapter
               between ticks changes that adapter's next tokens with no
               capture; a resize captures each token bucket once and
               keeps every loaded adapter's columns; decode walls in
               turns, profiles and graph memory of both, the stacks'
               memory and read bound.
  6. pages     the KV page plane on the 8B engine: 8 pages through
               gather, encode, decode and scatter byte-exactly; a request
               exported after 8 tokens and adopted by a second engine
               decodes on; a 96-page pool whose repeated 1024-token
               prompt is evicted by fillers, spilled and promoted from
               the host tier, twice a round over two rounds, each first
               token timed against the cold one (prefill computed ==
               prompt - saved; `_promote_run`); an
               update_weights in place (no capture) that drops both
               tiers, then the old weights back.
  7. disagg    disaggregated prefill/decode and live migration on one
               card, on the same Llama-3-8B weights: a PrefillServer
               (prefill-only engine: the split path, K6, no CUDA graph)
               hands every request of the server's mix over localhost
               (llm/disagg.py wire, through router.prefill_with_retry) to
               a graphed decode LLMServer (K5 in its replays); TTFT, ITL
               p50/p99 and tok/s against the unified server in turns a,
               b, b, a; per handoff its bytes, send ms, GB/s and the
               decode side's request_breakdown handoff_s; a handoff of
               44 pages split into gather, wire and scatter. Each tier's
               launches from 0: the prefill tier K6 only (its handoffs
               held by a listener), the decode server K5 only with no
               capture. Mid-decode the unified server migrates its five
               live requests to the decode server (pause per request,
               migrated/replayed split; every consumer re-collects on the
               target). fp32 at 2 layers: greedy tokens through prefill ->
               wire -> decode equal a single unified server's and naive
               forward's, a session migrated at token 4 equals one that
               never moved, a seeded request equals its single-server run,
               every page ends free.
  8. split     the same model and weights through the split path: the
               server's request mix on a unified_ticks=False engine, a
               repetition-penalty request on a default engine (routed to
               the split host-logits path), multi-step and split
               speculative engines; every run launches K6 n_layers times
               per runner step and K5 never; decode-step profile.
  9. identity  full width at 2 layers in fp32: the greedy tokens of the
               unified (graphed and eager), unified-speculative, split,
               multi-step and split-speculative engines equal greedy
               decoding with the naive llama.forward, the unified
               speculative engine fed the naive continuation accepts every
               draft, a
               repetition-penalty request equals naive forward + host
               sampling, and a seeded temperature request gives the same
               tokens alone, inside a batch and on the split path.
               LoRA: each adapter's greedy tokens equal the naive forward
               with merged weights W + A·B·scaling, base-slot requests
               the base engine's, unchanged by a resize, and a refreshed
               adapter's its merged forward's; an adopted request and a
               host-promoted prefix give the undisturbed run's tokens;
               after update_weights the engine equals a fresh engine on
               the new weights.
 10. train     the JAX package's bench training configuration (vocab
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
               attention equal those with the reference). The profiled
               step's device time is split by the record_function ranges
               of models/llama.py and train/step.py (attention, mlp, norm,
               loss, optimizer; backward kernels follow their forward op),
               each range with its elementwise and copy share.
 11. pipeline  LocalPipeline (parallel/pipeline.py): (a) fp32 at the bench
               widths, 4 layers, batch 4 x 128, 3 AdamW steps, 2 stages and
               2 x interleave 2 on cuda:0 and the last card against
               train/step.py on one card (losses within 1e-4 relative,
               parameters within lr elementwise and 1e-3 by norm of their
               movement); (b) the bench cell in bf16, all 14 layers, batch
               8 x 2048 in 8 microbatches, stages on min(4, cards) cards (2
               on cuda:0 on one card), plain 1F1B and interleave 2 in turns
               with the one-card bench step on the same tokens: step ms,
               tokens/s, each card's busy share of a profiled step against
               the bubble, peak memory per card, bytes between cards, flash
               launches a step (K1 = (L - L_last)·m + L·m, K3 = L·m,
               asserted), device time by sub-layer range; (c) with 2+
               cards, K1, K3 dQ and K3 dK/dV launched on the last card
               while cuda:0 is current, against their plain versions.
 12. rlhf      the colocated RLHF loop on the port's engine: (a) fp32 at
               the bench widths, 2 layers: greedy rollouts equal the naive
               forward, and after one LearnerWorker.update and
               colocated_hot_swap the engine's greedy tokens equal the
               learner's; (b) all 14 layers, fp32, three iterations of a
               RolloutCoordinator round of 8 prompts (4 greedy, 4 at
               temperature 0.8 seeded; 32 new tokens), an update and a
               swap: rollout s and tok/s, update s and its flash launches
               (asserted), sync ms, K5 launches (graph replays),
               step_compiles unchanged across each swap, the ledger (every
               seq_no once, no duplicate).
 13. resnet    resnet50 at CIFAR-10 shapes (width 64), batch 128, fp32 and
               bf16, AdamW on one seeded batch: step ms, images/s, peak
               memory; over 20 steps the loss falls.
 14. mesh      in-program parallelism (ray_tpu_torch.parallel) on a
               one-rank NCCL group: (a) fsdp.build_train_step on a mesh of
               one rank against train/step.py on the same weights (the
               bench configuration, 3 warm-up steps each, then 3 steps
               at a time in turns single, mesh, mesh, single, single,
               mesh, mesh, single; the 15 losses and grad_norms of each
               path equal within 1e-6 relative, flash launches 2L/L/L
               per step);
               (b) the ring's chunk steps and merges over 4 chunks of a
               16384-token causal sequence (heads 16/8, d 128, bf16),
               forward and backward with output and LSE cotangents,
               against whole-sequence flash attention (by norm, 1e-2; 10
               launches of each flash kernel); (c) the JAX package's
               default MoEConfig at full width (3.55 B parameters, 1.14 B
               active; bf16, flash, full remat, batch 2 x 2048) for 2
               warm-up and 5 timed steps: step ms, tokens/s, MFU, peak
               memory, dropped_frac (and, at the first and the last
               weights, each layer's dropped share and its busiest
               expert's share of the routes), 2L/L/L flash launches per
               step, the profiled share of the fp32 dispatch and combine
               einsums;
               the loss falls; an fp32 identity at 2 layers (loss and its
               parts on flash equal reference attention, 1e-5); (d) with 2
               or more cards, a world of up to 4 NCCL ranks trains a
               2-layer full-width Llama on MeshConfig(fsdp=2, tp=2) (or
               fsdp=2) against the same steps on one card (losses 1e-5
               and grad_norms 1e-4 relative; after 2 steps the parameters'
               movement within 1e-3 by norm and every element within one
               step's movement, lr); it prints its number of ranks either
               way.
 15. checkpoint sharded checkpoints in the ray-tpu-ckpt-v1 format: the
               bench cell's train state (bf16) after 2 steps saved at
               world 1 (save_sharded) and world 2 (CheckpointPlane async
               saves), restored, and one more step: its loss equals the
               uninterrupted step's bit for bit (save/restore ms, GB/s);
               a 2-layer full-width Llama-3-8B fp32 server loaded through
               LLMConfig.params_checkpoint gives the greedy tokens of the
               server built from memory and of naive llama.forward.
 16. tp        tensor-parallel serving, with 2 or more cards (it logs that
               it did not run on one): fp32 2-layer full-width Llama-3-8B
               greedy tokens at tp = 4 (or 2) equal one card's on the
               unified, speculative and split servers; the bf16 Llama-3-8B
               server at tp = 4 (or 2) serves the server phase's mix (K5
               launches of every rank >= n_layers x ticks, K6 none,
               step_compiles unchanged), decode steps of 8 rows in turns
               with the one-card server, device time per rank and its NCCL
               share (torch.profiler on every rank); mesh (d)'s state,
               trained on NCCL ranks and saved sharded, served at tp = 2
               equals a one-card server loaded from the same directory.
               (e) after the identity's world closed, worlds of 2 and 4
               (or 2) ranks start, serve and close in the same process,
               each giving one card's fp32 tokens. The mesh checkpoint
               and bf16 legs run in new processes of this script
               (`--tp-leg`).
 17. runtime   the port's actor runtime (ray_tpu_torch.init on this host,
               GPU the scheduled accelerator): cluster_resources' GPU equals
               nvidia-smi's count; Llama-3-8B (bf16, full width, the SEED
               weights) in a num_gpus=1 actor in a placement group of one
               {"GPU": 1, "CPU": 1} bundle serves the server phase's
               five-request mix concurrently through .completions.remote:
               tok/s, TTFT per request, ITL p50/p99 beside the in-process
               server's of the same run (the server phase's, else an
               in-process run here), K5 launches counted inside the actor
               (>= n_layers x ticks, K6 none, no capture); a second
               num_gpus=1 actor stays pending 5 s while the first holds the
               card and starts after the kill; a bf16 CUDA tensor put by
               the driver is bit-equal in the actor, on its card, and back
               on the driver's; a task without a GPU lease asking for CUDA
               raises; an actor-hosted fp32 2-layer Llama-3-8B gives the
               in-process server's greedy tokens; after shutdown no
               `python -m ray_tpu_torch` process of this run's session and
               not its /dev/shm/store_torch_<node>.shm file is left.
 18. serve     Serve on the port's runtime: inside one init(), the
               controller actor, the HTTP proxy actor, then
               build_openai_app(LLMConfig(...)) of the unified server's
               cell (Llama-3-8B bf16 from the SEED weights, one replica of
               one card) — each part of the deploy timed, the controller's
               unpickling of the init args (its torch import) apart. The
               five-request mix is POSTed concurrently over HTTP, plainly
               and as server-sent events (?method=completions_stream&
               stream=1): tok/s beside the in-process server's of the same
               run, TTFT per request and ITL p50/p99 from the client's
               events, K5 launches counted inside the replica (exactly
               n_layers x ticks, all replays, K6 none, no capture). The
               replica runs a subclass of LLMServer defined here that
               reads and resets its process's counts. A 2-layer fp32
               Llama-3-8B app gives the in-process server's greedy tokens
               over HTTP; with 2+ cards, two one-card replicas of it both
               take requests and each sees only its own card (skipped on
               one card). After serve.delete, serve.shutdown and shutdown
               no process of the session and no store file is left.
 19. router    the LLM router front on the port's runtime: inside one
               init(), build_openai_app(LLMConfig(routing="affinity"))
               of the unified server's cell (Llama-3-8B bf16, SEED
               weights, one one-card engine replica) deploys the engine
               tier and the LLMRouter deployment, each tier's deploy timed
               (the router actor's start apart). The five-request mix is
               POSTed concurrently through the router, then (same lengths,
               another seed) straight to the engine deployment: tok/s of
               both beside the in-process server's of the same run; K5
               launches counted inside the replica (exactly n_layers x
               ticks, all replays, K6 none, no capture). A shared-prefix
               leg (3 prompts of 512 tokens, each sent 4 times): the
               router's affinity hits and the engine's
               prefix_tokens_saved; llm_serving_summary over the pushed
               gauges. The 2-layer fp32 Llama-3-8B through the router
               gives the in-process server's greedy tokens. With 2+
               cards: two one-card 8B replicas, drain_replica mid-decode
               migrates live sessions (every client whole, the event in
               list_cluster_events); a disaggregate=1 fp32 app (K6 counted
               on the prefill replica = n_layers x its runner steps, K5 on
               the engine replica = n_layers x ticks, every request handed
               off) gives the in-process tokens. Skipped on one card, and
               logged. Nothing of the session is left after shutdown.
               The app runs on the default cluster prefix store: (b) its
               replica publishes a shared prompt to the GCS table under
               fillers, is killed and restarted, and the new replica
               adopts the prompt (16 tokens prefilled, K5 replays); no
               row is left after serve.delete. With 2+ cards (c): a new
               router sends a published prompt back to its owner through
               the table's hint; after the owner's kill the survivor
               adopts it.
  collective the out-of-program collective plane and checkpoint
               replication on a two-node port cluster of this host
               (cluster_utils.Cluster: node A with the cards, node B CPU
               only, ckpt_replicate on): (a) one card, data-parallel
               training of the bench Llama at full width over a tcp
               group, rank 0 this process and rank 1 a one-GPU actor,
               each its half of a seeded 4 x 2048 batch through the
               flash kernels, reduce_gradients and AdamW, 3 steps:
               parameter and optimizer digests equal on both ranks every
               step, step 1's gradients and parameters within
               GRAD_TOLERANCE of one process's step over the whole
               batch, the flash launches a step; step ms, gradient
               bytes, the ring's GB/s and share of the step; (c) a rank
               withheld from an allreduce, the driver's
               abort_collective_group, the blocked rank's
               CollectiveAbortError within 2 watchdog intervals + 0.5 s;
               (d) both ranks save the train state at world 2 with
               replication: two list_checkpoint_shards rows, each
               replica homed on node B (locate_object), the state
               restored from the replicas' bytes alone equal bit for
               bit; replication and save GB/s. With 2+ cards (b): the
               same training over the torch backend (NCCL) between 2
               (4 where there are 4) one-GPU actors, its allreduce GB/s
               beside a raw torch.distributed.all_reduce of the same
               bytes in a parallel/launch.spawn world, step ms against
               one card's, and the abort over NCCL.
  prefix_store (after pages) the cluster prefix store: the runtime up in
               this process, two in-process 8B servers on its GCS table;
               the owner's host tier publishes a 1024-token prompt's 64
               blocks under fillers, the survivor adopts them (16 tokens
               prefilled, the llm:prefix_fetch span's ms and GB/s, TTFT
               adopted vs cold, K5 from 0 all replays, tokens n of 16);
               a narrow fp32 pair the same way, tokens equal. With 2+
               cards (c): a tensor_parallel=2 server takes migrations
               into and out of it, a prefill handoff and a table
               adoption, each with one card's fp32 tokens.
The kernel phase also holds the three flash kernels (forward, dQ, dK/dV)
against their plain versions in bf16 and fp32 at the train shape (4, 2048,
16/8 heads, 128), with Llama-3-8B heads (32/8), a ragged tail (1000),
causal sq < skv (512/1024), non-causal (1024/1536), and the long regimes
(forward 16384, backward 8192), timing each beside
`scaled_dot_product_attention` (library_ms; the port never calls it).
fp32 tolerance 1e-5 for out/LSE and 1e-4 for gradients, bf16 2e-2.
`--turns A,B,...` then times the bf16 kernels of each listed tree's
ray_tpu_torch (a directory holding the package, e.g. a parent commit's
copy unpacked in a git-ignored directory), one child process per entry,
in the order given (TURN_CASES: the forward at train, gqa4 and long_fwd,
dQ and dK/dV at train and long_bwd, K5 at tick_136, tick_64, mixed,
decode and prefill_long, K6 at split_decode, split_chunk,
split_chunk_batch and split_verify): run parent, change, change, parent
to compare two versions on one card. `--turn-legs server` (or
`kernels,server`) runs, in each child, the server phase's graphed
Llama-3-8B server on the tree's package instead: the five-request mix
three times and decode steps of 8 rows (`_decode_walls`);
`--turn-legs promote` the host tier's promotion (`_promote_run`).
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
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

ALL_PHASES = ("device", "build", "kernel", "server", "lora", "pages",
              "prefix_store", "disagg", "split", "identity", "train",
              "pipeline", "rlhf", "resnet", "mesh", "checkpoint", "tp",
              "runtime", "serve", "router", "collective")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,     # dense bf16 tensor-core rate
            "float32": 67e12}       # fp32 outside the tensor cores
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}   # sums of up to 16k terms
# K5/K6 outputs are also held as a whole, ||got - ref|| / ||ref||: at 4096
# keys |out| is about the elementwise tolerance, so a dropped 64-key stage
# can pass elementwise while it moves the norm by about sqrt(64 / 4096).
NORM_TOLERANCE = {"float32": 5e-6, "bfloat16": 1e-2}
SEED = 20261016
RESULTS: dict = {}
_SHARED: dict = {}   # Llama-3-8B weights, made once for server and split

if os.environ.get("CHIP_SMOKE_STACKS_AFTER_S"):
    # A rank of the tp phase (it imports this file): stacks if it hangs.
    import faulthandler

    faulthandler.dump_traceback_later(
        float(os.environ["CHIP_SMOKE_STACKS_AFTER_S"]))


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
    from ray_tpu_torch.ops import paged_attention as pa

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
                dt = ("bf16" if "bfloat" in m[2] or "wgmma" in m[1]
                      or "tile" in m[1] else "f32")
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
        d: lib.flash_bwd_dkv_smem_bytes(d) for d in (64, 128)},
        "rua_tile_kernel/rpa_tile_kernel": {
        d: lib.paged_tile_smem_bytes(d, pa.SPLIT_KEYS, 16)
        for d in (64, 128)}}
    for kernel, by_d in smem.items():
        log(f"  {kernel} dynamic shared memory: " + ", ".join(
            f"d={d} {b} bytes" for d, b in by_d.items()))
    log(f"build: {wall:.2f} s (nvcc {_build.build_seconds or 0:.2f} s)")
    RESULTS["build_s"] = wall
    RESULTS["flash_fwd_smem_bytes"] = smem["flash_fwd_wgmma_kernel"]
    RESULTS["flash_bwd_dq_smem_bytes"] = smem["flash_bwd_dq_wgmma_kernel"]
    RESULTS["flash_bwd_dkv_smem_bytes"] = smem["flash_bwd_dkv_wgmma_kernel"]
    RESULTS["paged_tile_smem_bytes"] = smem["rua_tile_kernel/rpa_tile_kernel"]


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


def _graph_ms(torch, fn, calls=20, reps=10):
    """Device ms per call of `fn`: `calls` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events. A K5/K6 launch takes its
    wrapper tens of microseconds of Python, as long as a decode-size
    kernel, so eager timing there measures the host; the graph leaves the
    device's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the capture's stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


def _kernel_times(torch, fn, calls=10):
    """Device ms per call of each CUDA kernel that `fn` launches, from a
    torch.profiler trace of `calls` calls (K5/K6: the attention kernel and
    the key-split merge)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {(re.search(r"\w*kernel\w*", e.key) or [e.key[:40]])[0]:
            e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def _paged_case(torch, name, dtype, q_shape, q_lens, kv_lens, *, shuffle,
                K=8, hd=128, ps=16):
    """Inputs at Llama-3-8B attention shapes (q_shape ends in H=32, hd):
    q, K/V pages holding every sequence's context (shuffled or in order),
    block tables of 128 pages (2048 keys, or as many as the longest
    context needs), kv_lens and q_positions = kv_lens - q_lens."""
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + zlib.crc32(name.encode()))
    S = len(q_lens)
    max_pages = max(128, math.ceil(max(kv_lens) / ps))
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


def _paged_close(torch, label, out, ref, live, dname):
    """(max abs error, norm-relative error) of a K5/K6 output on the rows
    in `live`; raises unless both are within their tolerances, the output
    is finite and every other row is an exact zero."""
    tol, norm_tol = TOLERANCE[dname], NORM_TOLERANCE[dname]
    got, want = out[live].float(), ref[live].float()
    max_err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    ok = torch.allclose(got, want, rtol=tol, atol=tol) and rel <= norm_tol
    zero = bool((out[~live] == 0).all().item())
    if not (ok and zero and torch.isfinite(out).all()):
        raise AssertionError(
            f"{label}: max_abs_err={max_err} (tol {tol}), norm-relative "
            f"error={rel} (tol {norm_tol}), padding rows zero={zero}")
    return max_err, rel


def _check_case(torch, kernel, name, dname, fn, plain, args, live, bound):
    """One kernel case: the kernel against its plain version on the rows
    in `live`, exact zeros elsewhere, CUDA-event times (`kernel_ms` eager,
    host included, as the serving engine calls it; `graph_ms` device time
    alone), the bound."""
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    max_err, rel = _paged_close(torch, f"{kernel} {name}/{dname}", out,
                                plain(*args), live, dname)
    k_ms = _time_ms(torch, lambda: fn(*args), 50)
    graph_ms = _graph_ms(torch, lambda: fn(*args))
    p_ms = _time_ms(torch, lambda: plain(*args), 5)
    bound_ms, bound_by = bound(args, dname)
    row = dict(kernel=kernel, case=name, dtype=dname, max_abs_err=max_err,
               norm_rel_err=rel, kernel_ms=k_ms, graph_ms=graph_ms,
               plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
               launches=fn.launches - before)
    if dname == "bfloat16":
        row["kernels_ms"] = _kernel_times(torch, lambda: fn(*args))
    log("kernel " + " ".join(f"{k}={v}" for k, v in row.items()))
    return row


def _paged_cases(torch):
    """The K5 and K6 cases at Llama-3-8B attention shapes: (name, q_lens,
    kv_lens, T or Bq, shuffled page tables) each."""
    rng = torch.Generator().manual_seed(SEED)
    decode_kv = torch.randint(64, 2049, (8,), generator=rng).tolist()
    decode_kv[0] = 2048
    spec_kv = torch.randint(64, 1025, (8,), generator=rng).tolist()
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
        # A 128-row chunk deep in a prompt: tiles and key splits together.
        ("prefill_long", [128], [4096], 128, True),
        # The speculative tick: 8 sequences of 5 rows (the last token and
        # 4 proposals), 64 to 1024 keys, in token bucket 64.
        ("spec_tick", [5] * 8, spec_kv, 64, True),
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
    return k5_cases, k6_cases


def _paged_inputs(torch, kernel, dtype, case):
    """Inputs of one K5 or K6 case, the rows that must match the plain
    version (the rest must be exact zeros), the wrapper, the plain
    version and the bound."""
    from ray_tpu_torch.ops import paged_attention as pa

    name, q_lens, kv_lens, n, shuffle = case
    if kernel == "K5":
        args = _kernel_case(torch, name, dtype, q_lens, kv_lens, n,
                            shuffle=shuffle)
        live = torch.arange(n, device="cuda") < sum(q_lens)
        return (args, live, pa.ragged_paged_attention_unified,
                pa.ragged_paged_attention_unified_reference, _bound)
    args = _rect_case(torch, name, dtype, q_lens, kv_lens, n,
                      shuffle=shuffle)
    return (args, args[4] > 0, pa.ragged_paged_attention,
            pa.ragged_paged_attention_reference, _rect_bound)


def phase_kernel(torch):
    k5_cases, k6_cases = _paged_cases(torch)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for kernel, cases in (("K5", k5_cases), ("K6", k6_cases)):
            for case in cases:
                args, live, fn, plain, bound = _paged_inputs(
                    torch, kernel, dtype, case)
                rows.append(_check_case(torch, kernel, case[0], dname, fn,
                                        plain, args, live, bound))
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


# (kernel, case) pairs timed in turns against another tree's ray_tpu_torch
# (--turns): the flash kernels at FLASH_CASES cases, K5 and K6 at the
# cases of _paged_cases.
TURN_CASES = (("flash_fwd", "train"), ("flash_fwd", "gqa4"),
              ("flash_fwd", "long_fwd"), ("flash_bwd_dq", "train"),
              ("flash_bwd_dq", "long_bwd"), ("flash_bwd_dkv", "train"),
              ("flash_bwd_dkv", "long_bwd"), ("K5", "tick_136"),
              ("K5", "tick_64"), ("K5", "mixed"), ("K5", "decode"),
              ("K5", "prefill_long"), ("K6", "split_decode"),
              ("K6", "split_chunk"), ("K6", "split_chunk_batch"),
              ("K6", "split_verify"))


def _turn_label(kernel, case):
    return f"{kernel}/{case}"


def _turn_paged(torch, kernel, name):
    """One K5/K6 turn case in bf16: the worst error against the plain
    version on the live rows (the others must be exact zeros), then the
    eager ms per call, host included, as the flash turns take it, and the
    device ms per call alone (`_graph_ms`)."""
    k5_cases, k6_cases = _paged_cases(torch)
    case = next(c for c in (k5_cases if kernel == "K5" else k6_cases)
                if c[0] == name)
    args, live, fn, plain, _ = _paged_inputs(torch, kernel, torch.bfloat16,
                                             case)
    out = fn(*args)
    torch.cuda.synchronize()
    err, rel = _paged_close(torch, f"turn {kernel} {name}", out,
                            plain(*args), live, "bfloat16")
    return dict(ms=_time_auto(torch, lambda: fn(*args), budget_s=1.0,
                              most=200),
                graph_ms=_graph_ms(torch, lambda: fn(*args)),
                max_abs_err=err, norm_rel_err=rel)


def _turn_times(torch):
    """Child of --turns: the bf16 kernels of whichever ray_tpu_torch this
    process imports, at TURN_CASES: CUDA-event ms and the worst error
    against the plain version (the forward with LSE; dQ and dK/dV on the
    plain forward's LSE and a seeded out cotangent; K5/K6 on their live
    rows). Prints one TURN line."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import _build

    _build.load_library()
    res = {"package": os.path.relpath(os.path.dirname(os.path.dirname(
        os.path.dirname(attn.__file__))))}
    cases = {name: (dims, causal) for name, dims, causal, _ in FLASH_CASES}
    for kernel, name in TURN_CASES:
        if kernel in ("K5", "K6"):
            res[_turn_label(kernel, name)] = _turn_paged(torch, kernel, name)
            torch.cuda.empty_cache()
            continue
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


def _turn_server(torch):
    """Child of --turns, server leg: the server phase's graphed Llama-3-8B
    server of whichever ray_tpu_torch this process imports runs the
    five-request mix three times (new prompts each time), then decode
    steps of 8 rows (`_decode_walls`). Prints one TURN_SERVER line."""
    from ray_tpu_torch.llm.serving import LLMServer, build_engine

    config, params = _llama8b(torch)
    server = LLMServer(_engine_config(config), params=params)
    runs = []
    for i in range(3):
        _, numbers = _server_run(
            torch, server, _mix_requests(config, f"tserver{i}",
                                         SEED + 50 + i),
            config, f"turn server {i}")
        runs.append({k: numbers[k] for k in (
            "generated_tok_s", "itl_p50_ms", "itl_p99_ms", "ttft_ms",
            "ticks", "k5_launches", "wall_s")})
    server.close()
    del server
    gc.collect()
    engine = build_engine(_engine_config(config, warmup_buckets="light"),
                          params=params)
    walls = _decode_walls(torch, {"graphed": engine}, config)["graphed"]
    print("TURN_SERVER " + json.dumps(dict(runs=runs, decode_walls_ms=walls)),
          flush=True)


def run_turns(trees, legs=("kernels",)):
    """Each tree in `trees` (a directory holding a ray_tpu_torch package,
    e.g. a parent commit's unpacked copy) in a child process of its own,
    in the order given (parent, change, change, parent): with the
    "kernels" leg the bf16 kernels' ms per TURN_CASES pair, with the
    "server" leg the server mix and decode walls (`_turn_server`), with
    the "promote" leg the host tier's promotion (`_turn_promote`)."""
    here = os.path.abspath(__file__)
    rows = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, here, "--phases", "device", "--turn-in", tree,
             "--turn-legs", ",".join(legs)],
            capture_output=True, text=True, timeout=900)
        lines = {x.split(" ", 1)[0]: x.split(" ", 1)[1]
                 for x in proc.stdout.splitlines()
                 if x.startswith(("TURN ", "TURN_SERVER ",
                                  "TURN_PROMOTE "))}
        want = {"kernels": "TURN", "server": "TURN_SERVER",
                "promote": "TURN_PROMOTE"}
        if proc.returncode != 0 or any(want[leg] not in lines
                                       for leg in legs):
            raise RuntimeError(f"turn in {tree} failed:\n{proc.stdout}"
                               f"\n{proc.stderr[-4000:]}")
        row = {"tree": tree}
        if "kernels" in legs:
            row.update(json.loads(lines["TURN"]))
            labels = [_turn_label(*c) for c in TURN_CASES]
            log(f"turn {tree}: " + ", ".join(
                f"{c} {row[c]['ms']:.4f} ms"
                + (f" (graph {row[c]['graph_ms']:.4f})"
                   if "graph_ms" in row[c] else "")
                + f" (err {row[c]['max_abs_err']:.3g})" for c in labels))
        if "server" in legs:
            row["server"] = json.loads(lines["TURN_SERVER"])
            log(f"turn server {tree}: mix tok/s "
                + ", ".join(f"{r['generated_tok_s']:.1f}"
                            for r in row["server"]["runs"])
                + "; ITL p50 ms "
                + ", ".join(f"{r['itl_p50_ms']:.2f}"
                            for r in row["server"]["runs"])
                + f"; decode step ms {row['server']['decode_walls_ms']}")
        if "promote" in legs:
            row["promote"] = json.loads(lines["TURN_PROMOTE"])
            log(f"turn promote {tree}: first token ms (cold, promoted, "
                "again) by round: " + "; ".join(
                    ", ".join(f"{x[k]['ttft_ms']:.1f}"
                              for k in ("cold", "promoted", "again"))
                    for x in row["promote"]["promote_rounds"]))
        rows.append(row)
    RESULTS["turns"] = rows


def _prompts(n_tokens, vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in n_tokens]


def _stream(server, request, record):
    """Stream one request; record its tokens, TTFT and the arrival time of
    every streamed token (tokens of one speculative tick arrive
    together)."""
    t0 = time.perf_counter()
    times = []
    tokens = []
    for ev in server.completions_stream(request):
        if ev["finished"]:
            tokens = ev["token_ids"]
        else:
            times.append(time.perf_counter())
    record[request["request_id"]] = dict(
        tokens=tokens, ttft_s=times[0] - t0,
        total_s=time.perf_counter() - t0,
        gaps_s=[b - a for a, b in zip(times, times[1:])])


def _mix_numbers(record, wall):
    """Generated tok/s, TTFT per request (ms) and the inter-token gaps'
    p50/p99 (ms) over every streamed token of the mix."""
    import numpy as np

    n_gen = sum(len(v["tokens"]) for v in record.values())
    gaps = np.asarray([g for v in record.values() for g in v["gaps_s"]])
    return dict(generated_tokens=n_gen, wall_s=wall,
                generated_tok_s=n_gen / wall,
                ttft_ms={k: round(v["ttft_s"] * 1e3, 1)
                         for k, v in record.items()},
                itl_p50_ms=float(np.percentile(gaps, 50) * 1e3),
                itl_p99_ms=float(np.percentile(gaps, 99) * 1e3))


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
    batch 8, prefill chunk 128; the prefix tiers at LLMConfig's defaults
    (a 32 MB host tier, and the cluster table where the port's runtime is
    up in the server's process)."""
    from ray_tpu_torch.llm.serving import LLMConfig

    return LLMConfig(**dict(dict(
        model_config=config, block_size=16, num_kv_blocks=512,
        max_batch_size=8, prefill_chunk=128, device="cuda"), **kw))


def _mix_requests(config, tag, seed=SEED, loras=None):
    """Four greedy prompts of 20 to 700 tokens and one seeded temperature
    request, 32 new tokens each; `loras` names each one's adapter (None:
    the base model)."""
    lengths = [20, 100, 300, 700]
    prompts = _prompts(lengths + [60], config.vocab_size, seed)
    requests = [dict(prompt=p, max_tokens=32, request_id=f"{tag}-{n}")
                for p, n in zip(prompts, lengths)]
    requests.append(dict(prompt=prompts[-1], max_tokens=32, temperature=0.8,
                         top_k=50, seed=1234, request_id="smoke-seeded"))
    for r, name in zip(requests, loras or ()):
        r["lora_name"] = name
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


def _server_run(torch, server, requests, config, label):
    """Drive one unified-path run with the K5 and K6 counts at 0 just
    before it: K5 must launch at least n_layers times per tick (replays
    count), K6 never, and no step may be captured (or, eagerly, meet a
    new shape) after warmup."""
    from ray_tpu_torch.ops import paged_attention as pa

    stats0 = server.engine_stats()
    pa.ragged_paged_attention_unified.launches = 0
    pa.ragged_paged_attention.launches = 0
    record, wall = _drive(torch, server, requests, config)
    launches = pa.ragged_paged_attention_unified.launches
    k6 = pa.ragged_paged_attention.launches
    stats = server.engine_stats()
    ticks = stats["ticks"] - stats0["ticks"]
    if launches < config.n_layers * ticks or ticks == 0 or k6:
        raise AssertionError(f"{label}: K5 launches {launches} < n_layers x "
                             f"ticks ({config.n_layers} x {ticks}), or K6 "
                             f"launches {k6} != 0")
    if stats["step_compiles"] != stats0["step_compiles"]:
        raise AssertionError(f"{label}: step_compiles {stats0['step_compiles']}"
                             f" -> {stats['step_compiles']} after warmup")
    out = _mix_numbers(record, wall)
    proposed = stats["spec_tokens_proposed"] - stats0["spec_tokens_proposed"]
    accepted = stats["spec_tokens_accepted"] - stats0["spec_tokens_accepted"]
    out.update(requests=len(requests), ticks=ticks, k5_launches=launches,
               step_compiles=stats["step_compiles"],
               spec_proposed=proposed, spec_accepted=accepted,
               prefill_tokens=stats["prefill_tokens_computed"]
               - stats0["prefill_tokens_computed"])
    log(f"server {label}: {len(requests)} concurrent requests, "
        f"{out['generated_tokens']} tokens in {wall:.2f} s "
        f"({out['generated_tok_s']:.1f} generated tok/s), {ticks} ticks, "
        f"K5 launches {launches} (= {launches / ticks:.1f}/tick), ITL p50 "
        f"{out['itl_p50_ms']:.2f} ms p99 {out['itl_p99_ms']:.2f} ms, spec "
        f"accepted/proposed {accepted}/{proposed}, step_compiles "
        f"{stats['step_compiles']} (unchanged); TTFT ms {out['ttft_ms']}")
    return record, out


def _warm_memory(torch, engine, label):
    """Reserved device memory that a full warmup leaves behind (each side
    measured after empty_cache): with graphs, their private pool."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    engine.warmup(full=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    graphs = len(engine.runner._graphs)
    log(f"memory {label}: reserved {before / 2**30:.3f} -> "
        f"{after / 2**30:.3f} GiB over warmup(full=True), {graphs} graphs, "
        f"step_compiles {engine.runner.step_compiles}")
    return dict(reserved_before_gib=before / 2**30,
                reserved_after_gib=after / 2**30, graphs=graphs,
                step_compiles=engine.runner.step_compiles)


def phase_server(torch):
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import LLMServer, build_engine

    config, params = _llama8b(torch)
    cfg = _engine_config(config)
    t0 = time.perf_counter()
    server = LLMServer(cfg, params=params)
    log(f"server: engine built + warmed (two CUDA graphs per token bucket, "
        f"all-greedy and sampled) in {time.perf_counter() - t0:.1f} s, "
        f"token budget "
        f"{server.engine.token_budget}, step_compiles "
        f"{server.engine_stats()['step_compiles']}")
    requests = _mix_requests(config, "greedy")
    seeded = requests[-1]
    record, main = _server_run(torch, server, requests, config, "graphed")
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
        del engine
    if replays[0] != replays[1] or len(replays[0]) != 32:
        raise AssertionError(f"seeded replay differs:\n{replays}")
    concurrent = record["smoke-seeded"]["tokens"]
    same = sum(a == b for a, b in zip(replays[0], concurrent))
    log(f"server: seeded request replayed on two fresh engines: identical "
        f"({len(replays[0])} tokens); equal to the concurrent run at "
        f"{same}/32 positions")
    RESULTS["server"] = dict(main, seeded_replay_identical=True,
                             seeded_positions_equal_concurrent=same)
    # Unified speculation on the same weights and mix: verify rows ride
    # the same K5 launch and the same graphs (W = 5 rows a sequence).
    spec_server = LLMServer(_engine_config(config, speculative_ngram=4),
                            params=params)
    _, spec = _server_run(torch, spec_server,
                          _mix_requests(config, "spec"), config,
                          "speculative")
    spec_server.close()
    del spec_server
    if not 0 < spec["spec_proposed"] or \
            spec["spec_accepted"] > spec["spec_proposed"]:
        raise AssertionError(f"speculative server: accepted/proposed "
                             f"{spec['spec_accepted']}/"
                             f"{spec['spec_proposed']}")
    spec["acceptance_rate"] = spec["spec_accepted"] / spec["spec_proposed"]
    RESULTS["server_speculative"] = spec
    # Graphed against eager (cuda_graphs=False) on the same mix, in turns
    # a, b, b, a; each turn's prompts are new (same lengths), so no run
    # meets another's prefix cache.
    eager = LLMServer(cfg, params=params, cuda_graphs=False)
    turns = []
    for i, (label, srv) in enumerate((("graphed", server), ("eager", eager),
                                      ("eager", eager),
                                      ("graphed", server))):
        _, numbers = _server_run(
            torch, srv, _mix_requests(config, f"turn{i}", SEED + 10 + i),
            config, f"{label} (turn {i})")
        turns.append(dict(numbers, path=label))
    RESULTS["server_turns"] = turns
    for srv in (server, eager):
        srv.close()
    del server, eager
    gc.collect()
    # Decode steps of 8 rows, graphed against eager: host wall in turns,
    # then each one's device time; the graphs' memory.
    graphed = build_engine(_engine_config(config, warmup_buckets="off"),
                           params=params)
    eager = build_engine(_engine_config(config, warmup_buckets="off"),
                         params=params, cuda_graphs=False)
    RESULTS["graph_memory"] = {"graphed": _warm_memory(torch, graphed,
                                                       "graphed"),
                               "eager": _warm_memory(torch, eager, "eager")}
    RESULTS["decode_walls_graphed_eager_ms"] = _decode_walls(
        torch, {"graphed": graphed, "eager": eager}, config)
    RESULTS["decode_profile"] = _profile_decode(torch, graphed, config,
                                                "rua_", "K5 graphed")
    RESULTS["decode_profile_eager"] = _profile_decode(torch, eager, config,
                                                      "rua_", "K5 eager")
    del graphed, eager
    gc.collect()
    torch.cuda.empty_cache()


LORA_MIX = (None, "a0", "a1", "a2", "a3")   # the mix's five requests


def _adapters(torch, config, n=4, seed=SEED + 20):
    """n rank-8 adapters over all seven targets, a0, a1, ..., from the
    port's init_adapter on seeded generators, B drawn at scale 0.5 (the
    default is 0.1) so that an adapter moves the greedy tokens of random
    weights."""
    from ray_tpu_torch.llm import lora

    return [lora.init_adapter(config, f"a{i}", rank=8, targets=lora.TARGETS,
                              scale=0.5,
                              generator=torch.Generator().manual_seed(
                                  seed + i))
            for i in range(n)]


def _alone(server, prompt, name, rid, n=16):
    """One request alone on the server's engine under the server lock
    (the loop thread waits), to completion; returns its tokens."""
    from ray_tpu_torch.llm.sampling import SamplingParams

    with server._lock:
        engine = server.engine
        engine.add_request(prompt, SamplingParams(max_tokens=n),
                           request_id=rid, lora_name=name)
        out = None
        while engine.has_unfinished():
            for o in engine.step():
                if o.request_id == rid and o.finished:
                    out = o.output_token_ids
    return out


def _stacks_bound_ms(manager):
    """Least time to read every slot stack once (each tick's LoRA
    products read all of them) at the HBM rate."""
    return manager.nbytes() / HBM_BYTES_PER_S * 1e3


def phase_lora(torch):
    """Multi-LoRA serving at full width: the graphed Llama-3-8B server
    with four rank-8 adapters over all seven targets, against the base
    server on the same weights and mix, in turns; decode walls, profiles
    and graph memory of both; a load_adapter between ticks; a resize."""
    from ray_tpu_torch.llm import lora
    from ray_tpu_torch.llm.serving import LLMServer, build_engine

    config, params = _llama8b(torch)
    adapters = _adapters(torch, config)
    t0 = time.perf_counter()
    server = LLMServer(_engine_config(config, lora_adapters=adapters),
                       params=params)
    mgr = server.engine.runner.lora
    log(f"lora: server with {len(adapters)} adapters (rank 8, all 7 "
        f"targets, {mgr.n_slots - 1} user slots) built + warmed in "
        f"{time.perf_counter() - t0:.1f} s; stacks {mgr.nbytes() / 2**30:.3f}"
        f" GiB, read bound {_stacks_bound_ms(mgr):.3f} ms a tick; "
        f"step_compiles {server.engine_stats()['step_compiles']}")
    base = LLMServer(_engine_config(config), params=params)
    turns = []
    for i, (label, srv) in enumerate((("base", base), ("lora", server),
                                      ("lora", server), ("base", base))):
        requests = _mix_requests(config, f"lora-turn{i}", SEED + 30 + i,
                                 loras=LORA_MIX if label == "lora" else None)
        _, numbers = _server_run(torch, srv, requests, config,
                                 f"{label} (turn {i})")
        turns.append(dict(numbers, path=label))
    out = dict(turns=turns, adapters=len(adapters), rank=8,
               stacks_gib=mgr.nbytes() / 2**30,
               stacks_bound_ms=_stacks_bound_ms(mgr),
               k5_launches=turns[1]["k5_launches"], ticks=turns[1]["ticks"])
    base.close()
    del base
    # load_adapter between ticks: in place, no capture; the adapter's next
    # request decodes with the new weights, and loading the old ones back
    # gives the old tokens (alone, same composition: bf16 exact).
    eng = server.engine
    prompt = _prompts([90], config.vocab_size, SEED + 40)[0]
    compiles = eng.runner.step_compiles
    before = _alone(server, prompt, "a1", "swap-0")
    fresh = lora.init_adapter(config, "a1", rank=8, targets=lora.TARGETS,
                              scale=0.5,
                              generator=torch.Generator().manual_seed(
                                  SEED + 99))
    with server._lock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.load_adapter(fresh)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    after = _alone(server, prompt, "a1", "swap-1")
    with server._lock:
        mgr.load_adapter(adapters[1])
    back = _alone(server, prompt, "a1", "swap-2")
    if after == before or eng.runner.step_compiles != compiles:
        raise AssertionError(f"lora load_adapter: tokens {before} -> "
                             f"{after}, step_compiles {compiles} -> "
                             f"{eng.runner.step_compiles}")
    same_back = sum(a == b for a, b in zip(back, before))
    log(f"lora: load_adapter between ticks in {load_ms:.1f} ms, no capture "
        f"(step_compiles {compiles}); a1's next tokens changed at "
        f"{sum(a != b for a, b in zip(after, before))}/16 positions; the old"
        f" weights loaded back give the old tokens at {same_back}/16")
    out.update(load_adapter_ms=load_ms, load_changed_tokens=True,
               load_back_equal=same_back)
    # resize: the stacks are reallocated; each token bucket captures once
    # on its next tick (recorded as a recompile), the loaded adapters'
    # columns are kept, and later ticks replay.
    short = _prompts([15], config.vocab_size, SEED + 41)[0]
    names = [None] + mgr.loaded
    stacks = {t: [x.clone() for x in mgr.slot_stacks(t)]
              for t in mgr.targets}
    outs = [_alone(server, short, n, f"pre-{i}") for i, n in
            enumerate(names)]
    compiles = eng.runner.step_compiles
    last = eng.flight_records[-1]
    with server._lock:
        new_slots = mgr.resize(12)
    post = [_alone(server, short, n, f"post-{i}") for i, n in
            enumerate(names)]
    records = list(eng.flight_records)
    records = records[next(i for i in range(len(records) - 1, -1, -1)
                           if records[i] is last) + 1:]
    recaptured = [r["bucket"] for r in records if r.get("recompile")]
    grown = eng.runner.step_compiles - compiles
    for i, n in enumerate(names):     # the same buckets again: no capture
        _alone(server, short, n, f"again-{i}")
    kept = all(torch.equal(x, y[:, :x.shape[1]]) for t in mgr.targets
               for x, y in zip(stacks[t], mgr.slot_stacks(t)))
    if (len(recaptured) != len(set(recaptured)) or not recaptured
            or eng.runner.step_compiles - compiles != grown or not kept):
        raise AssertionError(f"lora resize: recaptured buckets "
                             f"{recaptured}, step_compiles +{grown} then "
                             f"{eng.runner.step_compiles - compiles}, "
                             f"columns kept {kept}")
    same = sum(a == b for x, y in zip(outs, post) for a, b in zip(x, y))
    log(f"lora: resize to {new_slots} user slots: each of buckets "
        f"{sorted(recaptured)} captured once ({grown} graphs), none after; "
        f"every loaded column kept; tokens after == before at "
        f"{same}/{16 * len(names)} (bf16; fp32 in the identity phase)")
    out.update(resize_slots=new_slots, resize_recaptured_buckets=recaptured,
               resize_graphs=grown, resize_columns_kept=kept,
               resize_tokens_equal=same, resize_tokens=16 * len(names))
    RESULTS["lora"] = out
    server.close()
    del server, eng
    gc.collect()
    # Decode steps of 8 rows (the LoRA engine's rows over base + a0..a3),
    # host wall in turns and device time; each one's graph memory.
    lora_eng = build_engine(_engine_config(config, warmup_buckets="off",
                                           lora_adapters=adapters),
                            params=params)
    base_eng = build_engine(_engine_config(config, warmup_buckets="off"),
                            params=params)
    out["graph_memory"] = {"base": _warm_memory(torch, base_eng, "base"),
                           "lora": _warm_memory(torch, lora_eng, "lora")}
    out["decode_walls_ms"] = _decode_walls(
        torch, {"base": base_eng, "lora": lora_eng}, config)
    out["decode_profile_base"] = _profile_decode(torch, base_eng, config,
                                                 "rua_", "K5 base")
    out["decode_profile_lora"] = _profile_decode(torch, lora_eng, config,
                                                 "rua_", "K5 lora")
    del lora_eng, base_eng
    gc.collect()
    torch.cuda.empty_cache()


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _promote_run(torch, config, params, rounds=2):
    """The host prefix tier on the Llama-3-8B graphed engine (bf16) with a
    96-page pool: per round a new 1024-token system prompt runs cold, two
    new 700-token fillers evict its parked blocks to host RAM, the prompt
    comes back promoted from the tier, two more fillers, and it comes back
    promoted again. Each first token is timed with the promotion itself
    (`_promote_prefix`, synchronised), the spills made meanwhile (the
    parked filler blocks that the promoted ones replace) and the graphs
    captured. Returns (engine, numbers); the numbers'
    top level is round 0. Uses only what the package has had since its
    host prefix tier, so `--turn-legs promote` runs it on older trees."""
    import numpy as np

    from ray_tpu_torch.llm import prefix_store
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import build_engine

    h = build_engine(_engine_config(config, warmup_buckets="light",
                                    num_kv_blocks=96), params=params)
    h.attach_prefix_store(host_tier=prefix_store.HostPrefixTier(512 << 20))
    spill_ms, spilled, promote_ms = [], [], []
    spill, promote = h.block_manager.spill_fn, h._promote_prefix

    def timed_spill(*args):
        # Older trees call the hook once a block (bid, digest); this one
        # once a batch ([(bid, digest), ...]).
        t0 = time.perf_counter()
        spill(*args)
        spill_ms.append((time.perf_counter() - t0) * 1e3)
        spilled.append(len(args[0]) if len(args) == 1 else 1)

    def timed_promote(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = promote(req)
        torch.cuda.synchronize()
        promote_ms.append((time.perf_counter() - t0) * 1e3)
        return got

    h.block_manager.spill_fn = timed_spill
    h._promote_prefix = timed_promote

    def first_token(prompt, rid):
        def once():
            h.add_request(prompt, SamplingParams(max_tokens=1),
                          request_id=rid)
            got = None
            while h.has_unfinished():
                for o in h.step():
                    if o.request_id == rid and o.finished:
                        got = o.output_token_ids
            return got
        del promote_ms[:]
        n0 = len(spill_ms)
        s0, c0 = h.stats(), h.runner.step_compiles
        tok, ms = _timed(torch, once)
        s1 = h.stats()
        hits = s1["host_prefix_hits"] - s0["host_prefix_hits"]
        saved = (s1["host_prefix_tokens_saved"]
                 - s0["host_prefix_tokens_saved"]
                 + s1["prefix_tokens_saved"] - s0["prefix_tokens_saved"])
        computed = (s1["prefill_tokens_computed"]
                    - s0["prefill_tokens_computed"])
        return tok, dict(ttft_ms=ms, hits=hits, saved=saved,
                         computed=computed,
                         captures=h.runner.step_compiles - c0,
                         promote_ms=sum(promote_ms),
                         spill_ms=sum(spill_ms[n0:]),
                         spilled=sum(spilled[n0:]))

    def fill(seed, tag):
        for i, f in enumerate(_prompts([700, 700], config.vocab_size,
                                       seed)):
            first_token(f, f"{tag}-{i}")

    rows = []
    for r in range(rounds):
        system = _prompts([1024], config.vocab_size, SEED + 52 + 10 * r)[0]
        tok0, cold = first_token(system, f"sys{r}-cold")
        fill(SEED + 53 + 10 * r, f"fill{r}a")
        tok1, promoted = first_token(system, f"sys{r}-promoted")
        fill(SEED + 54 + 10 * r, f"fill{r}b")
        tok2, again = first_token(system, f"sys{r}-again")
        for label, row in (("promoted", promoted), ("again", again)):
            if (row["hits"] <= 0 or not spill_ms
                    or row["computed"] != len(system) - row["saved"]):
                raise AssertionError(f"pages host tier round {r} {label}: "
                                     f"{row}, spills {len(spill_ms)}")
        rows.append(dict(cold=cold, promoted=promoted, again=again,
                         same_first_token=tok0 == tok1 == tok2))
        log(f"pages: host tier round {r}: first token cold "
            f"{cold['ttft_ms']:.1f} ms ({cold['captures']} graphs "
            f"captured), promoted {promoted['ttft_ms']:.1f} ms "
            f"({promoted['hits']} blocks, promotion "
            f"{promoted['promote_ms']:.1f} ms, {promoted['captures']} "
            f"graphs captured, {promoted['computed']} tokens computed), "
            f"promoted again {again['ttft_ms']:.1f} ms (promotion "
            f"{again['promote_ms']:.1f} ms, {again['captures']} captured); "
            f"same first token: {tok0 == tok1 == tok2}")
    s = h.stats()
    block_mib = s["host_prefix_bytes"] / max(s["host_prefix_entries"],
                                             1) / 2**20
    log(f"pages: host tier: {sum(spilled)} blocks spilled in "
        f"{len(spill_ms)} calls ({sum(spill_ms):.1f} ms in all, median "
        f"{float(np.median(spill_ms)):.2f} ms a call; {block_mib:.1f} MiB "
        f"a block)")
    first = rows[0]
    return h, dict(spills=sum(spilled), spill_calls=len(spill_ms),
                   spill_ms_total=sum(spill_ms),
                   spill_ms_median=float(np.median(spill_ms)),
                   host_hits=first["promoted"]["hits"],
                   tokens_saved=first["promoted"]["saved"],
                   prefill_computed=first["promoted"]["computed"],
                   ttft_cold_ms=first["cold"]["ttft_ms"],
                   ttft_promoted_ms=first["promoted"]["ttft_ms"],
                   promote_rounds=rows)


def _turn_promote(torch):
    """Child of --turns, promote leg: `_promote_run` on whichever
    ray_tpu_torch this process imports. Prints one TURN_PROMOTE line."""
    config, params = _llama8b(torch)
    h, numbers = _promote_run(torch, config, params)
    del h
    print("TURN_PROMOTE " + json.dumps(numbers), flush=True)


def phase_pages(torch):
    """The KV page plane on the Llama-3-8B graphed engine (bf16): pages
    through the codec and back, a request moved between two engines, the
    host prefix tier under a small pool, a weight swap in place."""
    import numpy as np

    from ray_tpu_torch.llm import prefix_store
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import build_engine

    config, params = _llama8b(torch)
    out = {}

    def run(engine, prompt, n, rid):
        engine.add_request(prompt, SamplingParams(max_tokens=n),
                           request_id=rid)
        got = None
        while engine.has_unfinished():
            for o in engine.step():
                if o.request_id == rid and o.finished:
                    got = o.output_token_ids
        return got

    a = build_engine(_engine_config(config, warmup_buckets="light"),
                     params=params)
    b = build_engine(_engine_config(config, warmup_buckets="light"),
                     params=params)
    # gather -> encode -> decode -> scatter, byte-exact.
    run(a, _prompts([300], config.vocab_size, SEED + 50)[0], 4, "codec")
    ids = list(a.block_manager.reusable)[:8]
    dst = list(a.block_manager.free)[:8]
    (k, v), gather_ms = _timed(torch, lambda: a.runner.gather_pages(ids))
    buf, encode_ms = _timed(torch, lambda: prefix_store.encode_pages(
        {"tokens": [], "lora_name": ""}, k, v,
        kv_dtype=a.runner.kv_dtype_name))
    (meta, k2, v2), decode_ms = _timed(torch, lambda:
                                       prefix_store.decode_pages(buf))
    _, scatter_ms = _timed(torch, lambda: a.runner.scatter_pages(dst, k2,
                                                                 v2))
    k3, v3 = a.runner.gather_pages(dst)
    exact = all(torch.equal(a.runner.cache[n][:, :, dst],
                            a.runner.cache[n][:, :, ids]) for n in "kv")
    if not (exact and k3.tobytes() == k.tobytes()
            and v3.tobytes() == v.tobytes()):
        raise AssertionError("pages: gather/encode/decode/scatter differ")
    mb = (k.nbytes + v.nbytes) / 2**20
    log(f"pages: 8 pages ({mb:.1f} MiB, bf16 as uint16 bits) gather "
        f"{gather_ms:.2f} ms, encode {encode_ms:.2f} ms, decode "
        f"{decode_ms:.2f} ms, scatter {scatter_ms:.2f} ms; byte-exact")
    out.update(codec_pages=8, codec_mib=mb, gather_ms=gather_ms,
               encode_ms=encode_ms, decode_ms=decode_ms,
               scatter_ms=scatter_ms, codec_exact=True)
    # export_request on a, adopt_request on b: the adopted request
    # continues; b's undisturbed run of the same request is the yardstick
    # (alone both times: the same compositions).
    moved = _prompts([200], config.vocab_size, SEED + 51)[0]
    ref = run(b, moved, 32, "ref")
    a.add_request(moved, SamplingParams(max_tokens=32), request_id="m")
    while not (a.running and len(a.running[0].output) >= 8):
        a.step()
    state = a.export_request("m")
    (k, v), gather_ms = _timed(torch, lambda:
                               a.runner.gather_pages(state["blocks"]))
    a.block_manager.release_blocks(state["blocks"])
    ok, adopt_ms = _timed(torch, lambda: b.adopt_request(state, k, v))
    got = None
    while b.has_unfinished():
        for o in b.step():
            if o.request_id == "m" and o.finished:
                got = o.output_token_ids
    if not ok or len(got) != 32 or got[:8] != state["output"] or \
            not all(0 <= t < config.vocab_size for t in got):
        raise AssertionError(f"pages: adopted request {got}")
    same = sum(x == y for x, y in zip(got, ref))
    log(f"pages: export after 8 tokens, {len(state['blocks'])} pages "
        f"gathered in {gather_ms:.2f} ms, adopted in {adopt_ms:.2f} ms; the "
        f"adopted request decoded to 32 tokens, equal to the undisturbed "
        f"run at {same}/32 (bf16; fp32 in the identity phase)")
    out.update(export_pages=len(state["blocks"]), export_gather_ms=gather_ms,
               adopt_ms=adopt_ms, adopted_equal=same)
    del a
    gc.collect()
    h, numbers = _promote_run(torch, config, params)
    out.update(numbers)
    # update_weights: a full new copy of the weights (wo halved) written in
    # place (no capture), both tiers dropped; then the old weights back.
    # The runner's tensors are the shared weights themselves.
    prompt = _prompts([40], config.vocab_size, SEED + 54)[0]
    before = run(h, prompt, 16, "w-0")
    compiles = h.runner.step_compiles
    ptr = h.runner.params["layers"]["wo"].data_ptr()
    payload = {k: (t.clone() if k != "layers" else
                   {n: w.clone() for n, w in t.items()})
               for k, t in params.items()}
    orig_wo = payload["layers"]["wo"].clone()
    payload["layers"]["wo"] *= 0.5
    entries = h.stats()["host_prefix_entries"]
    res, swap_ms = _timed(torch, lambda: h.update_weights(payload))
    after = run(h, prompt, 16, "w-1")
    stats = h.stats()
    payload["layers"]["wo"].copy_(orig_wo)
    h.update_weights(payload)
    back = run(h, prompt, 16, "w-2")
    del orig_wo, payload
    if (h.runner.step_compiles != compiles or after == before
            or h.runner.params["layers"]["wo"].data_ptr() != ptr
            or stats["host_prefix_entries"] != 0 or entries == 0
            or res["invalidated_prefix_entries"] <= entries
            or stats["weights_version"] != 1):
        raise AssertionError(f"pages update_weights: {res}, {stats}")
    log(f"pages: update_weights in {swap_ms:.1f} ms (every weight copied "
        f"in place, no capture), dropped "
        f"{res['invalidated_prefix_entries']} prefix entries ({entries} "
        f"host); tokens changed; the old weights back "
        f"give the old tokens at {sum(x == y for x, y in zip(back, before))}"
        f"/16")
    out.update(update_weights_ms=swap_ms,
               invalidated=res["invalidated_prefix_entries"],
               host_entries_dropped=entries,
               weights_back_equal=sum(x == y for x, y in zip(back, before)))
    RESULTS["pages"] = out
    del h, b
    gc.collect()
    torch.cuda.empty_cache()


def _block_mib(config, block_size=16):
    """MiB of one KV block (k and v, every layer and kv head)."""
    import torch

    item = torch.empty((), dtype=config.dtype).element_size()
    return (2 * config.n_layers * config.n_kv_heads * block_size
            * config.head_dim * item) / 2**20


def _prefix_adopt(torch, config, params, label, n_new=16):
    """Two in-process servers of `config` on one table: the port's runtime
    is up in this process, so each LLMServer holds a ClusterPrefixStore on
    the real call_raw path to its GCS. The owner (a 128-page pool, a host
    tier of 4 blocks, low watermark 0.2) serves a 1024-token system prompt
    plus a 16-token suffix, then 700-token fillers until the table holds
    the prompt's 64 blocks; the owner closes. A survivor with a fresh pool
    and no host tier serves a cold 1040-token prompt, then the owner's
    request: it adopts the blocks from the table, prefills the suffix
    alone, and its K5 launches (counted from 0) are graph replays."""
    from ray_tpu_torch.llm.prefix_store import (ClusterPrefixStore,
                                                cluster_chain)
    from ray_tpu_torch.llm.serving import LLMServer
    from ray_tpu_torch.util import tracing

    vocab = config.vocab_size
    system, cold, suffix = _prompts([1024, 1024, 16], vocab,
                                    SEED + 60 + zlib.crc32(label.encode()))
    request = dict(prompt=system + suffix, max_tokens=n_new)
    chain = cluster_chain(system, 16)
    table = ClusterPrefixStore(16)
    name = f"smoke-prefix-{label}"
    host_mb = 4 * _block_mib(config)
    owner = LLMServer(_engine_config(
        config, num_kv_blocks=128, host_prefix_mb=host_mb,
        host_prefix_low_watermark=0.2, deployment_name=name), params=params)
    if owner.engine.cluster_store is None:
        raise AssertionError(f"prefix_store {label}: the owner has no "
                             "cluster store inside the runtime")
    rec: dict = {}
    _stream(owner, dict(request, request_id=f"{label}-owner"), rec)
    ref = rec[f"{label}-owner"]["tokens"]
    fillers, hit = 0, None
    t0 = time.perf_counter()
    while fillers < 16:
        filler = _prompts([700], vocab, SEED + 61 + fillers)[0]
        owner.completions(dict(prompt=filler, max_tokens=1))
        fillers += 1
        deadline = time.monotonic() + 1
        while time.monotonic() < deadline:
            hit = table.lookup_owner(chain)
            if hit and hit["n_blocks"] == len(chain):
                break
            time.sleep(0.05)
        if hit and hit["n_blocks"] == len(chain):
            break
    publish_s = time.perf_counter() - t0
    ostats = owner.engine_stats()
    if not hit or hit["n_blocks"] != len(chain):
        raise AssertionError(f"prefix_store {label}: the table holds "
                             f"{hit} of {len(chain)} blocks after "
                             f"{fillers} fillers; owner {ostats}")
    owner.close()
    del owner
    gc.collect()
    survivor = LLMServer(_engine_config(
        config, host_prefix_mb=0, deployment_name=name), params=params)
    if survivor.engine.cluster_store is None:
        raise AssertionError(f"prefix_store {label}: no survivor store")
    _stream(survivor, dict(prompt=cold + suffix, max_tokens=n_new,
                           request_id=f"{label}-cold"), rec)
    n_spans = len(tracing.get_spans())
    stats0 = _reset_counts(survivor)
    _stream(survivor, dict(request, request_id=f"{label}-survivor"), rec)
    counts = _counts_since(survivor, stats0)
    stats = survivor.engine_stats()
    spans = [sp for sp in tracing.get_spans()[n_spans:]
             if sp["name"] == "llm:prefix_fetch"]
    adopt_spans = [sp for sp in tracing.get_spans()[n_spans:]
                   if sp["name"] == "llm:prefix_adopt"]
    # The costs the table's adoption gate learned: a fetched block's, and
    # a prefilled token's (the cold request's).
    f, p = (survivor.engine._fetch_s_per_block,
            survivor.engine._prefill_s_per_token)
    if f is None or p is None:
        raise AssertionError(f"prefix_store {label}: the gate learned no "
                             f"cost (fetch {f}, prefill {p})")
    gate = dict(fetch_ms_per_block=f * 1e3, prefill_ms_per_block=p * 16e3,
                asks_next=f <= p * 16)
    survivor.close()
    del survivor
    gc.collect()
    torch.cuda.empty_cache()
    got = rec[f"{label}-survivor"]["tokens"]
    adopted = (stats["cluster_prefix_adopted_blocks"]
               - stats0["cluster_prefix_adopted_blocks"])
    computed = (stats["prefill_tokens_computed"]
                - stats0["prefill_tokens_computed"])
    fetch_ms = spans[-1]["dur"] / 1e3 if spans else None
    fetch_bytes = spans[-1]["args"]["bytes"] if spans else 0
    parts = _fetch_parts(table, chain)
    out = dict(
        blocks=len(chain), fillers=fillers, publish_s=publish_s,
        published=ostats["cluster_prefix_published"],
        owner_host_demotions=ostats["host_prefix_demotions"],
        adopted_blocks=adopted,
        hits=stats["cluster_prefix_hits"] - stats0["cluster_prefix_hits"],
        prefill_computed=computed,
        ttft_cold_ms=rec[f"{label}-cold"]["ttft_s"] * 1e3,
        ttft_adopted_ms=rec[f"{label}-survivor"]["ttft_s"] * 1e3,
        ttft_owner_ms=rec[f"{label}-owner"]["ttft_s"] * 1e3,
        fetch_ms=fetch_ms, fetch_bytes=fetch_bytes,
        fetch_gb_s=(fetch_bytes / (fetch_ms / 1e3) / 1e9
                    if fetch_ms else None),
        adopt_ms=adopt_spans[-1]["dur"] / 1e3 if adopt_spans else None,
        fetch_parts=parts, gate=gate, survivor_counts=counts, tokens_equal=sum(
            a == b for a, b in zip(got, ref)), n_tokens=len(ref))
    _check_replica_counts(counts, config, f"prefix_store {label} survivor")
    log(f"prefix_store {label}: the owner published "
        f"{out['published']} blocks ({out['owner_host_demotions']} "
        f"host-tier demotions; the prompt's {len(chain)} in the table after "
        f"{fillers} fillers, {publish_s:.2f} s); the survivor adopted "
        f"{adopted} blocks ({out['hits']} hits), prefill computed "
        f"{computed} tokens of {len(request['prompt'])}; first token "
        f"{out['ttft_adopted_ms']:.1f} ms adopted vs "
        f"{out['ttft_cold_ms']:.1f} ms cold (owner "
        f"{out['ttft_owner_ms']:.1f} ms); llm:prefix_fetch "
        + (f"{fetch_ms:.1f} ms for {fetch_bytes / 2**20:.1f} MiB "
           f"({out['fetch_gb_s']:.2f} GB/s)" if fetch_ms else "not recorded")
        + f" (the adoption with its scatter {out['adopt_ms']} ms; alone on "
        f"this host: the round trip {parts['rpc_ms']:.1f} ms, of which the "
        f"GCS's join {parts['join_ms']:.1f}, a MAC {parts['mac_ms']:.1f} "
        f"each way, the socket and the reader's copies "
        f"{parts['rest_ms']:.1f}; a metadata-only round trip "
        f"{parts['meta_ms']:.1f}; the decode {parts['decode_ms']:.1f}); "
        f"the gate learned {gate['fetch_ms_per_block']:.2f} ms a fetched "
        f"block against {gate['prefill_ms_per_block']:.2f} ms a prefilled "
        f"one, so the next miss {'asks' if gate['asks_next'] else 'skips'} "
        f"the table"
        + f"; survivor K5 {counts['k5_launches']} over {counts['ticks']} "
        f"ticks, step_compiles {counts['step_compiles']}; tokens equal to "
        f"the owner's at {out['tokens_equal']}/{len(ref)}")
    if (adopted <= 0 or out["hits"] != len(chain)
            or computed != len(request["prompt"]) - 16 * len(chain)
            or len(got) != n_new):
        raise AssertionError(f"prefix_store {label}: {out}")
    return out


def _fetch_parts(table, chain) -> dict:
    """The parts of a fetch of `chain` from the table, timed on this host
    in ms: the raw-frame round trip with its payload (the GCS joins the
    rows' payloads and MACs the reply, the socket carries it, the reader
    copies it and checks its MAC), one without (want_payload=False), and,
    alone on the reply's bytes, the join, one keyed blake2b MAC (the
    wire's) and the decode. `rest_ms` is the round trip less the join
    and two MACs: the socket and the reader's copies."""
    import hashlib

    from ray_tpu_torch.llm.prefix_store import decode_all
    from ray_tpu_torch.runtime import wire

    def lookup(want):
        m = wire.PrefixLookupMsg(
            digests=list(chain), lora_id="", weights_version=0,
            block_size=16, want_payload=want).encode()
        t0 = time.perf_counter()
        out = table._call("prefix_lookup", m)
        if out is None:
            raise AssertionError("prefix_store: the table did not answer")
        return (time.perf_counter() - t0) * 1e3, out

    meta_ms, _ = lookup(False)
    rpc_ms, (_, payload) = lookup(True)
    payload = bytes(payload)
    size = len(payload) // len(chain)
    rows = [payload[i * size:(i + 1) * size] for i in range(len(chain))]
    t0 = time.perf_counter()
    b"".join(rows)
    join_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hashlib.blake2b(payload, key=os.urandom(32), digest_size=16).digest()
    mac_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    decode_all(payload)
    decode_ms = (time.perf_counter() - t0) * 1e3
    return dict(bytes=len(payload), rpc_ms=rpc_ms, meta_ms=meta_ms,
                join_ms=join_ms, mac_ms=mac_ms, decode_ms=decode_ms,
                rest_ms=rpc_ms - join_ms - 2 * mac_ms)


def _tp_prefix_legs(torch):
    """(c) ROADMAP's open item of a handoff into a tensor-parallel server,
    on 2+ cards: fp32, full width, 2 layers, seeded weights. A one-card
    server's greedy tokens are the reference. A tensor_parallel=2 server
    (rank 0 holds the listener and scatters the whole pool through the
    fanned scatter_pages) takes live sessions migrated from a one-card
    server and hands others back, takes a prefill tier's handoffs, and
    adopts a prefix another server published to the table; every leg
    gives the reference tokens."""
    from ray_tpu_torch.llm.disagg import PrefillServer
    from ray_tpu_torch.llm.prefix_store import (ClusterPrefixStore,
                                                cluster_chain)
    from ray_tpu_torch.llm.serving import LLMServer
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    kw = dict(seed=SEED + 63, num_kv_blocks=256, warmup_buckets="light")
    vocab = config.vocab_size
    prompts = _prompts([150, 260], vocab, SEED + 64)
    system, suffix = _prompts([320, 16], vocab, SEED + 65)

    def requests(tag):
        return [dict(prompt=p, max_tokens=32, request_id=f"{tag}-{i}")
                for i, p in enumerate(prompts)]

    out: dict = {}
    one = LLMServer(_engine_config(config, **kw))
    try:
        ref = [one.completions(r)["choices"][0]["token_ids"]
               for r in requests("ref")]
        adopt_req = dict(prompt=system + suffix, max_tokens=32)
        ref_adopt = one.completions(dict(adopt_req))["choices"][0][
            "token_ids"]
        t0 = time.perf_counter()
        tp = LLMServer(_engine_config(config, tensor_parallel=2, **kw))
        log(f"prefix_store (c): tensor_parallel=2 server up in "
            f"{time.perf_counter() - t0:.1f} s")
        try:
            legs = {}
            for label, src, dst in (("into_tp", one, tp),
                                    ("out_of_tp", tp, one)):
                res = _migrate_live(torch, src, dst, requests(label),
                                    config)
                legs[label] = dict(
                    migrated=len(res["migrated"]),
                    replayed=len(res["replayed"]),
                    equal=[res["tokens"][f"{label}-{i}"] == ref[i]
                           for i in range(len(prompts))])
            pre = PrefillServer(_engine_config(config, **kw))
            try:
                rec: dict = {}
                for r in requests("handoff"):
                    _disagg_request(pre, tp, r, rec)
                legs["handoff_into_tp"] = dict(equal=[
                    rec[f"handoff-{i}"]["tokens"] == ref[i]
                    for i in range(len(prompts))])
            finally:
                pre.close()
            owner = LLMServer(_engine_config(
                config, **dict(kw, num_kv_blocks=64),
                host_prefix_mb=4 * _block_mib(config),
                host_prefix_low_watermark=0.2))
            try:
                owner.completions(dict(adopt_req))
                table = ClusterPrefixStore(16)
                chain = cluster_chain(system, 16)
                for i in range(12):
                    owner.completions(dict(prompt=_prompts(
                        [400], vocab, SEED + 66 + i)[0], max_tokens=1))
                    hit = table.lookup_owner(chain)
                    if hit and hit["n_blocks"] == len(chain):
                        break
                    time.sleep(0.5)
            finally:
                owner.close()
            s0 = tp.engine_stats()
            got = tp.completions(dict(adopt_req))["choices"][0]["token_ids"]
            s1 = tp.engine_stats()
            legs["adopt_into_tp"] = dict(
                adopted=(s1["cluster_prefix_adopted_blocks"]
                         - s0["cluster_prefix_adopted_blocks"]),
                computed=(s1["prefill_tokens_computed"]
                          - s0["prefill_tokens_computed"]),
                equal=[got == ref_adopt])
        finally:
            _close_world(tp.close, 2, "prefix_store (c)")
    finally:
        one.close()
    out["legs"] = legs
    log(f"prefix_store (c) fp32 full width, 2 layers, tensor_parallel=2: "
        f"{legs}")
    bad = [k for k, v in legs.items() if not all(v["equal"])]
    if (bad or legs["adopt_into_tp"]["adopted"] != len(chain)
            or legs["adopt_into_tp"]["computed"] != len(suffix)
            or not legs["into_tp"]["migrated"]
            or not legs["out_of_tp"]["migrated"]):
        raise AssertionError(f"prefix_store (c): legs {bad} differ from "
                             f"one card's tokens, or moved nothing: {legs}")
    return out


def _await_clean(session_dir, store_path, label):
    """Wait up to 60 s for the session's processes and store file to go."""
    deadline = time.monotonic() + 60
    while True:
        procs = _runtime_processes(session_dir)
        shm = os.path.exists(store_path)
        if not procs and not shm:
            return
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: after shutdown: processes "
                                 f"{procs}, store file {store_path} left: "
                                 f"{shm}")
        time.sleep(0.5)


def phase_prefix_store(torch):
    """The cluster prefix store on the card (ROADMAP queue 1 item 6.3): the
    port's runtime up in this process, its GCS holding the prefix table.
    (a) Llama-3-8B bf16: a server's host tier publishes a 1024-token
    system prompt's 64 blocks, a second server adopts them
    (`_prefix_adopt`); the same on a narrow fp32 model, where the
    survivor's tokens equal the owner's exactly. (c) With 2+ cards, the
    tensor-parallel legs (`_tp_prefix_legs`)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.models import llama

    out: dict = {}
    config, params = _llama8b(torch)
    rt.init(object_store_memory=256 << 20)
    try:
        session_dir = rt.get_runtime_context().session_dir
        store_path = api._head.store_path
        out["bf16"] = _prefix_adopt(torch, config, params, "8b")
        narrow = llama.LlamaConfig.llama3_8b(
            n_layers=2, d_model=1024, n_heads=8, n_kv_heads=8, d_ff=2048,
            dtype=torch.float32)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
        fp32 = _prefix_adopt(torch, narrow, llama.init_params(
            narrow, gen, "cuda"), "fp32")
        if fp32["tokens_equal"] != fp32["n_tokens"]:
            raise AssertionError(f"prefix_store fp32: the survivor's tokens "
                                 f"differ from the owner's: {fp32}")
        out["fp32"] = fp32
        out["survivor_counts"] = out["bf16"]["survivor_counts"]
        if torch.cuda.device_count() >= 2:
            out["tp"] = _tp_prefix_legs(torch)
        else:
            log("prefix_store: one card: the tensor-parallel legs (a "
                "migration into and out of a tensor_parallel=2 server, a "
                "prefill handoff into it, a table adoption into it) skipped")
    finally:
        rt.shutdown()
    _await_clean(session_dir, store_path, "prefix_store")
    RESULTS["prefix_store"] = out


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


def _row_adapter(engine, i):
    """The adapter of decode row i: with a LoRA manager, rows cycle over
    the base model and every loaded adapter."""
    lm = engine.runner.lora
    names = [None] + (lm.loaded if lm is not None else [])
    return names[i % len(names)]


def _decode_walls(torch, engines, config, n_ticks=12):
    """Host wall per engine step of each engine in steady decode (8
    running rows at 64-token prompts; a LoRA engine's rows spread over
    its adapters), timed in turns a, b, b, a, a, b, b, a on one card in
    one process, so that the engines compare within the host clock's
    noise."""
    from ray_tpu_torch.llm.sampling import SamplingParams

    prompts = _prompts([64] * 8, config.vocab_size, SEED + 5)
    for engine in engines.values():
        for i, p in enumerate(prompts):
            engine.add_request(p, SamplingParams(max_tokens=6 * n_ticks + 8),
                               request_id=f"walls-{i}",
                               lora_name=_row_adapter(engine, i))
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


def _disagg_request(prefill, decode, request, record):
    """One disaggregated request: prefill on the prefill tier through
    prefill_with_retry (the handoff over localhost), then the decode
    server's stream. TTFT is the time until the first token exists on the
    decode side (prefill done, pages adopted); the gaps run from there
    through every token the decode server streams."""
    from ray_tpu_torch.llm.router import LocalReplica, prefill_with_retry

    t0 = time.perf_counter()
    res = prefill_with_retry([LocalReplica(prefill, name="prefill-0")],
                             request, decode.handoff_address())
    if not res["handoff"]:
        raise AssertionError(f"{request['request_id']} finished at prefill")
    times = [time.perf_counter()]
    tokens = []
    for ev in decode.completions_collect_stream(res["rid"]):
        if ev["finished"]:
            tokens = ev["token_ids"]
        else:
            times.append(time.perf_counter())
    record[request["request_id"]] = dict(
        tokens=tokens, ttft_s=times[0] - t0,
        total_s=time.perf_counter() - t0,
        gaps_s=[b - a for a, b in zip(times, times[1:])],
        handoff_bytes=res["handoff_bytes"], handoff_s=res["handoff_s"])


def _disagg_run(torch, prefill, decode, requests, config, label):
    """The mix through the prefill tier and the decode server at once,
    the K5 and K6 counts at 0 just before it: both kernels must launch
    (K6 on the prefill engine's split steps, K5 on the decode server's
    replays) and the decode server must capture nothing. Per handoff its
    bytes, send ms and GB/s, and the decode side's request_breakdown."""
    from ray_tpu_torch.ops import paged_attention as pa

    stats0 = decode.engine_stats()
    pa.ragged_paged_attention_unified.launches = 0
    pa.ragged_paged_attention.launches = 0
    record: dict = {}
    t0 = time.perf_counter()
    errors = []

    def one(r):
        try:
            _disagg_request(prefill, decode, r, record)
        except Exception as e:  # re-raised below: the phase fails
            errors.append(e)

    threads = [threading.Thread(target=one, args=(r,)) for r in requests]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    k5 = pa.ragged_paged_attention_unified.launches
    k6 = pa.ragged_paged_attention.launches
    stats = decode.engine_stats()
    for r in requests:
        got = record[r["request_id"]]["tokens"]
        if len(got) != 32 or not all(0 <= t < config.vocab_size
                                     for t in got):
            raise AssertionError(f"{r['request_id']}: bad output {got}")
    if not k5 or not k6:
        raise AssertionError(f"disagg {label}: K5 {k5}, K6 {k6} launches")
    if stats["step_compiles"] != stats0["step_compiles"]:
        raise AssertionError(f"disagg {label}: the decode server captured "
                             f"{stats['step_compiles']} != "
                             f"{stats0['step_compiles']}")
    adopted = stats["handoffs_adopted"] - stats0["handoffs_adopted"]
    if adopted != len(requests):
        raise AssertionError(f"disagg {label}: {adopted} handoffs adopted")
    out = _mix_numbers(record, wall)
    handoffs = [dict(request=k, bytes=v["handoff_bytes"],
                     ms=v["handoff_s"] * 1e3,
                     gb_s=v["handoff_bytes"] / v["handoff_s"] / 1e9,
                     breakdown_handoff_ms=decode.engine.breakdowns[k][
                         "handoff_s"] * 1e3)
                for k, v in record.items()]
    out.update(requests=len(requests), k5_launches=k5, k6_launches=k6,
               step_compiles=stats["step_compiles"], handoffs=handoffs)
    log(f"disagg {label}: {len(requests)} requests, "
        f"{out['generated_tokens']} tokens in {wall:.2f} s "
        f"({out['generated_tok_s']:.1f} generated tok/s), ITL p50 "
        f"{out['itl_p50_ms']:.2f} ms p99 {out['itl_p99_ms']:.2f} ms, K5 "
        f"{k5} K6 {k6} launches, step_compiles {stats['step_compiles']} "
        f"(unchanged); TTFT ms {out['ttft_ms']}; handoffs (bytes, ms, "
        f"GB/s, breakdown handoff ms): "
        + ", ".join(f"{h['bytes']} {h['ms']:.2f} {h['gb_s']:.3f} "
                    f"{h['breakdown_handoff_ms']:.2f}" for h in handoffs))
    return out


def _disagg_launches(torch, prefill, decode, requests, config):
    """Each tier's kernels alone: the prefill tier hands the mix to a
    listener that holds the pages (counts from 0: K6 only), then the held
    requests go over the wire to the decode server (counts from 0: K5
    only, no capture)."""
    from ray_tpu_torch.llm.disagg import KVStreamServer, send_handoff
    from ray_tpu_torch.ops import paged_attention as pa

    held = []
    holder = KVStreamServer(lambda s, k, v: held.append((s, k, v)) or True)
    try:
        pa.ragged_paged_attention_unified.launches = 0
        pa.ragged_paged_attention.launches = 0
        for r in requests:
            prefill.prefill(r, holder.address)
        torch.cuda.synchronize()
        tier = {"prefill": [pa.ragged_paged_attention_unified.launches,
                            pa.ragged_paged_attention.launches]}
    finally:
        holder.close()
    stats0 = decode.engine_stats()
    pa.ragged_paged_attention_unified.launches = 0
    pa.ragged_paged_attention.launches = 0
    kv_dtype = decode.engine.runner.kv_dtype_name
    for state, k, v in held:
        send_handoff(decode.handoff_address(), state, k, v, kv_dtype=kv_dtype)
    for state, _, _ in held:
        decode.completions_collect(state["id"])
    torch.cuda.synchronize()
    tier["decode"] = [pa.ragged_paged_attention_unified.launches,
                      pa.ragged_paged_attention.launches]
    stats = decode.engine_stats()
    ok = (tier["prefill"][0] == 0 and tier["prefill"][1] > 0
          and tier["decode"][0] > 0 and tier["decode"][1] == 0
          and stats["step_compiles"] == stats0["step_compiles"])
    log(f"disagg launches [K5, K6]: prefill tier {tier['prefill']}, decode "
        f"server {tier['decode']}, decode step_compiles "
        f"{stats0['step_compiles']} -> {stats['step_compiles']}")
    if not ok:
        raise AssertionError(f"disagg launches per tier {tier}")
    return tier


def _handoff_parts(torch, decode, n_pages=44, reps=3):
    """Where a handoff's time goes, at the 700-token prompt's 44 pages
    (88 MiB of bf16 KV): gather_pages (device to host), the wire alone
    (send_handoff to a listener that adopts nothing) and scatter_pages
    (host to device), each on the idle decode server's free pages under
    its lock; best of `reps`, ms and GB/s."""
    from ray_tpu_torch.llm.disagg import KVStreamServer, send_handoff

    ids = list(range(n_pages))
    runner = decode.engine.runner
    times = {"gather": [], "wire": [], "scatter": []}
    sink = KVStreamServer(lambda *a: True)
    try:
        for _ in range(reps):
            with decode._lock:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                k, v = runner.gather_pages(ids)
                times["gather"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            send_handoff(sink.address, {"id": "parts"}, k, v,
                         kv_dtype=runner.kv_dtype_name)
            times["wire"].append(time.perf_counter() - t0)
            with decode._lock:
                t0 = time.perf_counter()
                runner.scatter_pages(ids, k, v)
                torch.cuda.synchronize()
                times["scatter"].append(time.perf_counter() - t0)
    finally:
        sink.close()
    nbytes = int(k.nbytes + v.nbytes)
    out = {name: dict(ms=min(t) * 1e3, gb_s=nbytes / min(t) / 1e9)
           for name, t in times.items()}
    out["bytes"] = nbytes
    log(f"handoff parts, {n_pages} pages ({nbytes} bytes), best of {reps}: "
        + ", ".join(f"{name} {out[name]['ms']:.2f} ms "
                    f"({out[name]['gb_s']:.2f} GB/s)" for name in times))
    return out


def _migrate_live(torch, source, target, requests, config):
    """Mid-decode, `source` migrates its live requests to `target`: every
    consumer gets SESSION_MIGRATED and re-collects on the target (kv) or
    re-submits there (replay); each must end with its 32 tokens. Returns
    the split and the per-request pause (the target's stall_s)."""
    from ray_tpu_torch.llm.router import _migrated_mode

    tokens, modes, errors = {}, {}, []

    def consume(r):
        rid = r["request_id"]
        try:
            out = source.completions(r)
            modes[rid] = "finished"
        except Exception as e:
            mode = _migrated_mode(e)
            if mode is None:
                errors.append(e)
                return
            modes[rid] = mode
            out = (target.completions_collect(rid) if mode == "kv"
                   else target.completions(r))
        tokens[rid] = out["choices"][0]["token_ids"]

    threads = [threading.Thread(target=consume, args=(r,))
               for r in requests]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 120
    while True:
        with source._lock:
            running = [len(r.output) for r in source.engine.running]
        if len(running) == len(requests) and min(running) >= 2:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"migration: running {running}")
        time.sleep(0.001)
    t0 = time.perf_counter()
    res = source.migrate_sessions(target.handoff_address())
    migrate_s = time.perf_counter() - t0
    for th in threads:
        th.join(600)
    source.resume_admission()
    if errors:
        raise errors[0]
    for r in requests:
        got = tokens.get(r["request_id"], [])
        if len(got) != 32:
            raise AssertionError(f"migration {r['request_id']}: {got}")
    pause = {rid: target.engine.breakdowns[rid]["stall_s"] * 1e3
             for rid in res["migrated"]}
    out = dict(migrated=res["migrated"], replayed=res["replayed"],
               finished=res["finished"], send_failed=res["send_failed"],
               migrate_sessions_ms=migrate_s * 1e3, pause_ms=pause,
               modes=modes, tokens=tokens)
    log(f"migration: {len(res['migrated'])} migrated with KV, "
        f"{len(res['replayed'])} replayed, {len(res['finished'])} finished "
        f"in the harvest, migrate_sessions {migrate_s * 1e3:.1f} ms; pause "
        f"ms {({k: round(v, 2) for k, v in pause.items()})}")
    return out


def _disagg_identity(torch):
    """fp32, 2 layers at full width: greedy tokens through prefill ->
    wire -> decode equal a single unified server's and naive
    llama.forward's; a session migrated mid-decode gives the tokens of
    one that never moved; a seeded request (temperature 0.8) equals its
    single-server run; every server ends with every page free."""
    from ray_tpu_torch.llm.disagg import PrefillServer
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = llama.init_params(config, gen, "cuda")
    cfg = LLMConfig(model_config=config, block_size=16, num_kv_blocks=256,
                    max_batch_size=8, prefill_chunk=128, device="cuda")
    single = LLMServer(cfg, params=params)
    decode = LLMServer(cfg, params=params)
    prefill = PrefillServer(cfg, params=params)
    # The migration's source: its loop is stopped, so each session is
    # exported at a known token (4 of 24).
    source = LLMServer(cfg, params=params)
    source._stop.set()
    source._loop.join(10)
    try:
        prompts = _prompts([37, 150, 260], config.vocab_size, SEED + 1)
        n_new = 8
        naive = [_naive(torch, llama, params, config, p, n_new,
                        lambda lg, _: torch.argmax(lg)) for p in prompts]
        out = {}
        for i, p in enumerate(prompts):
            req = dict(prompt=p, max_tokens=n_new, request_id=f"id-{i}")
            record: dict = {}
            _disagg_request(prefill, decode, req, record)
            got = record[req["request_id"]]["tokens"]
            alone = single.completions(dict(req))["choices"][0]["token_ids"]
            if not got == alone == naive[i]:
                raise AssertionError(f"disagg identity {i}: {got} vs single "
                                     f"{alone} vs naive {naive[i]}")
        out["greedy_equal"] = len(prompts)
        seeded = dict(prompt=prompts[1], max_tokens=16, temperature=0.8,
                      top_k=50, seed=1234, request_id="id-seeded")
        record = {}
        _disagg_request(prefill, decode, seeded, record)
        alone = single.completions(dict(seeded))["choices"][0]["token_ids"]
        if record["id-seeded"]["tokens"] != alone:
            raise AssertionError(f"seeded disagg {record['id-seeded']} vs "
                                 f"{alone}")
        out["seeded_equal"] = True
        from ray_tpu_torch.llm.sampling import SamplingParams

        moved = {}
        for i, p in enumerate(prompts[:2]):
            rid = f"mig-{i}"
            source._submit(p, SamplingParams(max_tokens=24), rid)
            while not any(r.id == rid and len(r.output) >= 4
                          for r in source.engine.running):
                source.engine.step()
            res = source.migrate_sessions(decode.handoff_address())
            source.resume_admission()
            if res["migrated"] != [rid]:
                raise AssertionError(f"identity migration {res}")
            moved[rid] = decode.completions_collect(rid)["choices"][0][
                "token_ids"]
            unmoved = single.completions(dict(prompt=p, max_tokens=24))[
                "choices"][0]["token_ids"]
            if moved[rid] != unmoved or moved[rid][:n_new] != naive[i]:
                raise AssertionError(f"migrated {rid}: {moved[rid]} vs "
                                     f"unmoved {unmoved}")
        out["migrated_equal"] = len(moved)
        free = {}
        for name, srv in (("single", single), ("decode", decode),
                          ("source", source)):
            st = srv.engine_stats()
            free[name] = (st["free_kv_blocks"], st["total_kv_blocks"])
        bm = prefill.engine.block_manager
        free["prefill"] = (bm.available(), prefill.engine.runner.num_blocks)
        if any(a != b for a, b in free.values()):
            raise AssertionError(f"pages not all free: {free}")
        out["pages_free"] = free
        log(f"disagg identity (fp32, 2 layers): greedy tokens through "
            f"prefill -> wire -> decode equal the single server's and naive "
            f"forward's ({len(prompts)} prompts); seeded equal; "
            f"{len(moved)} sessions migrated at token 4 equal unmoved runs; "
            f"every page free {free}")
        return out
    finally:
        for srv in (single, decode, prefill, source):
            srv.close()


def phase_disagg(torch):
    from ray_tpu_torch.llm.disagg import PrefillServer
    from ray_tpu_torch.llm.serving import LLMServer

    config, params = _llama8b(torch)
    cfg = _engine_config(config)
    t0 = time.perf_counter()
    unified = LLMServer(cfg, params=params)
    decode = LLMServer(cfg, params=params)
    prefill = PrefillServer(cfg, params=params)
    graphs = {"unified": len(unified.engine.runner._graphs),
              "decode": len(decode.engine.runner._graphs),
              "prefill": len(prefill.engine.runner._graphs)}
    log(f"disagg: unified server, decode server and prefill tier built and "
        f"warmed on one copy of the weights in "
        f"{time.perf_counter() - t0:.1f} s; CUDA graphs {graphs}")
    if graphs["prefill"]:
        raise AssertionError(f"the prefill tier captured {graphs['prefill']}"
                             " graphs")
    try:
        res = {"graphs": graphs}
        res["launches"] = _disagg_launches(
            torch, prefill, decode, _mix_requests(config, "tier"), config)
        res["handoff_parts"] = _handoff_parts(torch, decode)
        turns = []
        for i, path in enumerate(("unified", "disagg", "disagg",
                                  "unified")):
            requests = _mix_requests(config, f"dturn{i}", SEED + 30 + i)
            if path == "unified":
                _, numbers = _server_run(torch, unified, requests, config,
                                         f"unified (turn {i})")
            else:
                numbers = _disagg_run(torch, prefill, decode, requests,
                                      config, f"(turn {i})")
            turns.append(dict(numbers, path=path))
        res["turns"] = turns
        res["migration"] = _migrate_live(
            torch, unified, decode, _mix_requests(config, "migrate",
                                                  SEED + 40), config)
        for name, srv in (("unified", unified), ("decode", decode)):
            st = srv.engine_stats()
            if st["free_kv_blocks"] != st["total_kv_blocks"]:
                raise AssertionError(f"{name}: pages left {st}")
        RESULTS["disagg"] = res
    finally:
        for srv in (unified, decode, prefill):
            srv.close()
        del unified, decode, prefill
        gc.collect()
        torch.cuda.empty_cache()
    RESULTS["disagg"]["identity"] = _disagg_identity(torch)
    gc.collect()
    torch.cuda.empty_cache()


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
        torch, profile_engine, config, "rpa_", "K6")
    del profile_engine
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _profile_decode(torch, engine, config, kernel, label, n_ticks=12):
    """Where a steady decode step's time goes: 8 running sequences, host
    wall per engine step without the profiler, then torch.profiler kernel
    times (device busy share, the attention kernel's share, GEMM share,
    top kernels). `kernel` is the attention kernels' name prefix (rua_
    for K5, rpa_ for K6, the merge included), `label` their id."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.llm.sampling import SamplingParams

    for i, p in enumerate(_prompts([64] * 8, config.vocab_size, SEED + 2)):
        engine.add_request(p, SamplingParams(max_tokens=2 * n_ticks + 4),
                           request_id=f"profile-{i}",
                           lora_name=_row_adapter(engine, i))
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

    def engine_for(cuda_graphs=None, weights=None, **kw):
        return build_engine(LLMConfig(**dict(dict(
            model_config=config, block_size=16, num_kv_blocks=256,
            max_batch_size=8, prefill_chunk=128, device="cuda"), **kw)),
            params=params if weights is None else weights,
            cuda_graphs=cuda_graphs)

    prompts = _prompts([37, 150, 260], config.vocab_size, SEED + 1)
    n_new = 8
    greedy = [_naive(torch, llama, params, config, p, n_new,
                     lambda lg, _: torch.argmax(lg)) for p in prompts]
    paths = [("unified (graphed)", {}),
             ("unified (eager)", dict(cuda_graphs=False)),
             ("unified-speculative", dict(speculative_ngram=4)),
             ("split", dict(unified_ticks=False)),
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
    # A proposer fed the naive continuation: the unified speculative
    # engine must accept every draft.
    prompt, cont = prompts[0], greedy[0]
    engine = engine_for(speculative_ngram=4)
    engine._ngram_propose = lambda context, k, n=3: list(
        cont[len(context) - len(prompt):len(context) - len(prompt) + k])
    got = engine.generate([prompt], SamplingParams(max_tokens=n_new))[0]
    stats = engine.stats()
    if got.output_token_ids != cont or stats["spec_tokens_proposed"] == 0 \
            or stats["spec_tokens_accepted"] != stats["spec_tokens_proposed"]:
        raise AssertionError(
            f"identity forced continuation: {got.output_token_ids} vs "
            f"{cont}, accepted/proposed {stats['spec_tokens_accepted']}/"
            f"{stats['spec_tokens_proposed']}")
    log(f"identity: unified speculative engine fed the naive continuation "
        f"accepted {stats['spec_tokens_accepted']}/"
        f"{stats['spec_tokens_proposed']} drafts")
    del engine
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
                               forced_continuation_accepted=True,
                               repetition_penalty_equal=True,
                               seeded_alone_equals_batched=True,
                               seeded_split_equals_unified=True)
    del engine
    RESULTS["identity"].update(_identity_lora_pages(
        torch, llama, config, params, engine_for, prompts, greedy, n_new))
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _identity_lora_pages(torch, llama, config, params, engine_for, prompts,
                         greedy, n_new):
    """The identity phase's LoRA and page-plane checks (fp32, where every
    path's tokens are exact): adapters against merged weights, base slots
    against the base engine, resize and refresh, an adopted request, a
    host-promoted prefix, tokens after update_weights."""
    from ray_tpu_torch.llm import lora, prefix_store
    from ray_tpu_torch.llm.sampling import SamplingParams

    argmax = lambda lg, _: torch.argmax(lg)  # noqa: E731

    def merged(adapter):
        out = dict(params, layers=dict(params["layers"]))
        for t, (a, b) in adapter.weights.items():
            delta = torch.from_numpy(a @ b * adapter.scaling).to("cuda")
            out["layers"][t] = out["layers"][t] + delta
        return out

    def generate(engine, reqs):
        for i, (p, name) in enumerate(reqs):
            engine.add_request(p, SamplingParams(max_tokens=n_new),
                               request_id=f"i{i}", lora_name=name)
        done = {}
        while engine.has_unfinished():
            done.update({o.request_id: o.output_token_ids
                         for o in engine.step() if o.finished})
        return [done[f"i{i}"] for i in range(len(reqs))]

    adapters = _adapters(torch, config)
    names = [None] + [a.name for a in adapters]
    reqs = [(p, n) for p in prompts[:2] for n in names]
    engine = engine_for(lora_adapters=adapters, max_loras=4)
    got = generate(engine, reqs)
    want = {}
    for a in adapters:
        m = merged(a)
        want[a.name] = [_naive(torch, llama, m, config, p, n_new, argmax)
                        for p in prompts[:2]]
        del m
    for (p, name), toks in zip(reqs, got):
        ref = greedy[prompts.index(p)] if name is None else \
            want[name][prompts.index(p)]
        if toks != ref:
            raise AssertionError(f"identity lora {name}: {toks} != {ref}")
    log(f"identity: LoRA engine, {len(adapters)} rank-8 adapters over all "
        f"targets: each adapter's greedy == naive forward with merged "
        f"W + A·B·scaling, base-slot requests == the base engine "
        f"({len(reqs)} requests in one batch)")
    compiles = engine.runner.step_compiles
    engine.runner.lora.resize(6)
    if generate(engine, reqs) != got or engine.runner.step_compiles == \
            compiles:
        raise AssertionError("identity lora: tokens changed by resize")
    fresh = lora.init_adapter(config, "a1", rank=8, targets=lora.TARGETS,
                              scale=0.5,
                              generator=torch.Generator().manual_seed(7))
    engine.runner.lora.load_adapter(fresh)
    m = merged(fresh)
    ref = [_naive(torch, llama, m, config, p, n_new, argmax)
           for p in prompts[:2]]
    del m
    if generate(engine, [(p, "a1") for p in prompts[:2]]) != ref:
        raise AssertionError("identity lora: refreshed adapter differs")
    log("identity: after resize(6) every request's tokens are unchanged; "
        "a refreshed adapter == naive forward with its merged weights")
    del engine
    # An adopted request continues with the undisturbed run's tokens.
    src, dst = engine_for(), engine_for()
    src.add_request(prompts[1], SamplingParams(max_tokens=n_new),
                    request_id="m")
    while not (src.running and len(src.running[0].output) >= 3):
        src.step()
    state = src.export_request("m")
    k, v = src.runner.gather_pages(state["blocks"])
    src.block_manager.release_blocks(state["blocks"])
    dst.adopt_request(state, k, v)
    got = None
    while dst.has_unfinished():
        got = next((o.output_token_ids for o in dst.step() if o.finished),
                   got)
    if got != greedy[1]:
        raise AssertionError(f"identity adopted: {got} != {greedy[1]}")
    del src, dst
    # A host-promoted prefix: a 16-page pool, a 150-token prompt's blocks
    # evicted by a filler and promoted back.
    eng = engine_for(num_kv_blocks=24)
    eng.attach_prefix_store(host_tier=prefix_store.HostPrefixTier(1 << 30))
    generate(eng, [(prompts[1], None)])
    generate(eng, [(_prompts([300], config.vocab_size, SEED + 6)[0], None)])
    got = generate(eng, [(prompts[1], None)])[0]
    hits = eng.stats()["host_prefix_hits"]
    if got != greedy[1] or hits == 0:
        raise AssertionError(f"identity host tier: {got} vs {greedy[1]}, "
                             f"{hits} promoted blocks")
    log(f"identity: an adopted request's continuation and a prefix "
        f"promoted from the host tier ({hits} blocks) == the undisturbed "
        f"run's tokens")
    # update_weights: the swapped engine == a fresh engine on new weights.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    new = llama.init_params(config, gen, "cuda")
    compiles = eng.runner.step_compiles
    eng.update_weights(new)
    got = generate(eng, [(p, None) for p in prompts])
    ref = generate(engine_for(weights=new), [(p, None) for p in prompts])
    if got != ref or got == greedy or eng.runner.step_compiles != compiles:
        raise AssertionError(f"identity update_weights: {got} vs {ref}")
    log("identity: after update_weights (in place, no capture) the engine "
        "== a fresh engine built on the new weights")
    del eng, new
    return dict(lora_equals_merged=True, lora_base_slot_equal=True,
                lora_resize_equal=True, lora_refresh_equal=True,
                adopted_equal=True, host_promoted_equal=True,
                update_weights_equal=True)


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


def _profile_train_step(torch, step, state, tokens, step_ms,
                        label="train step"):
    """One step under torch.profiler: device-busy share of the timed
    step's wall, each flash kernel's and the GEMMs' share of device
    time, the top kernels, the device time by sub-layer range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, tokens)
        torch.cuda.synchronize()
    # The ranges' own device-side annotations are no kernels.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and e.key not in SUBLAYER_RANGES]
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
    log(f"{label} profile: device busy {device_ms:.2f} ms = "
        f"{device_ms / step_ms:.1%} of the {step_ms:.2f} ms step; shares of "
        "device time: " + ", ".join(f"{k} {v:.1%}" for k, v in
                                    shares.items()))
    for name, ms, n in top:
        log(f"  kernel {ms:.3f} ms/step x{n}: {name}")
    ranges = _range_split(prof)
    _log_ranges(label, ranges)
    return dict(device_ms=device_ms, busy_share=device_ms / step_ms,
                shares=shares, top=top, ranges=ranges)


# Ranges of `torch.profiler.record_function` the port's train path opens
# (models/llama.py, train/step.py, parallel/pipeline.py).
SUBLAYER_RANGES = ("attention", "mlp", "norm", "loss", "optimizer")


def _kernel_class(name):
    if "flash" in name:
        return "flash"
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma",
                                       "cublas")):
        return "gemm"
    if "elementwise" in name or "copy" in name:
        return "elementwise_copy"
    return "reduce" if "reduce" in name else "other"


def _range_split(prof, amounts=None):
    """Device ms of a profiled run by sub-layer range and kernel class:
    {range: {class: ms}}. A kernel belongs to the range its launching op
    ran in (a checkpointed layer's recompute opens its ranges again); an
    op of the backward pass, under an autograd engine node, to the range
    of the forward op whose thread and sequence number the node carries;
    the rest (embedding, the engine's accumulations) to "other".
    `amounts(event)` gives an event's (kernel name, us) pairs: its
    kernels by default."""
    from torch.autograd import DeviceType

    amounts = amounts or (lambda e: [(k.name, k.duration) for k in e.kernels
                                     if k.name not in SUBLAYER_RANGES])
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def up(e, pred):
        while e is not None and not pred(e):
            e = e.cpu_parent
        return e

    def named(e):
        r = up(e, lambda x: x.name in SUBLAYER_RANGES)
        return None if r is None else r.name

    forward = {}
    for e in events:
        r = named(e)
        if r is not None and e.sequence_nr >= 0:
            forward.setdefault((e.thread, e.sequence_nr), r)
    out: dict = {}
    for e in events:
        got = amounts(e)
        if not got:
            continue
        r = named(e)
        if r is None:
            node = up(e, lambda x: x.name.startswith(
                "autograd::engine::evaluate_function"))
            if node is not None:
                r = forward.get((node.fwd_thread, node.sequence_nr))
        by = out.setdefault(r or "other", {})
        for name, us in got:
            c = _kernel_class(name)
            by[c] = by.get(c, 0.0) + us / 1e3
    return out


def _log_ranges(label, ranges):
    total = sum(sum(by.values()) for by in ranges.values()) or 1e-9
    for r, by in sorted(ranges.items(), key=lambda kv: -sum(kv[1].values())):
        ms = sum(by.values())
        ew = by.get("elementwise_copy", 0.0)
        log(f"  {label} range {r}: {ms:.3f} ms ({ms / total:.1%} of device "
            f"time), elementwise+copy {ew:.3f} ms ({ew / max(ms, 1e-9):.1%} "
            "of the range); " + ", ".join(f"{c} {v:.3f}" for c, v in
                                         sorted(by.items())))


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


# ---------------------------------------------------------------- pipeline

PIPE_MICROBATCHES = 8
PIPE_BATCH = 8                  # sequences of 2048 tokens, 1 a microbatch


def _pipe_counts(config, n_chunks, m):
    """Flash launches a pipeline step makes without remat: the forward
    kernel once per layer and microbatch in `fwd` (every chunk but the
    last) and again in each `bwd`'s re-run; dQ and dK/dV once in `bwd`."""
    from ray_tpu_torch.parallel.pipeline import stage_layer_ranges

    L = config.n_layers
    lo, hi = stage_layer_ranges(L, n_chunks)[-1]
    return {"flash_fwd": (L - (hi - lo)) * m + L * m,
            "flash_bwd_dq": L * m, "flash_bwd_dkv": L * m}


def _pipe_identity(torch):
    """(a) fp32 at the bench widths, 4 layers, batch 4 x 128, 3 AdamW
    steps: 2 stages, and 2 x interleave 2, on cuda:0 and the last card,
    against train/step.py on cuda:0 from the same weights. Losses within
    GRAD_TOLERANCE relative; the merged parameters' movement within 1e-3
    by norm of one card's and every element within 2·lr (elements whose
    gradient is near Adam's eps move as the order of fp32 sums decides:
    1.01e-4 at lr 1e-4 after 3 steps on an H100; a chunk that skipped an
    update moves a third less by norm)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.pipeline import LocalPipeline
    from ray_tpu_torch.train.optim import adamw, leaves
    from ray_tpu_torch.train.step import make_step

    lr, m = 1e-4, 4
    tol = GRAD_TOLERANCE["float32"]
    config = _bench_train_config(torch, n_layers=4, max_seq=128, remat=False,
                                 dtype=torch.float32)
    devices = ["cuda:0", f"cuda:{torch.cuda.device_count() - 1}"]
    params = llama.init_params(config, torch.Generator(
        device="cuda").manual_seed(SEED + 30))
    tokens = torch.randint(0, config.vocab_size, (4, 129), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(SEED + 31))
    start = [t.clone() for _, t in leaves(params)]
    pipes = {v: LocalPipeline(config, params, 2, adamw(lr), devices=devices,
                              interleave=v) for v in (1, 2)}
    opt = adamw(lr)
    for _, p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params)}
    step = make_step(config, opt)
    want = [step(state, tokens)[1].item() for _ in range(3)]
    out = {"one_card_losses": want, "devices": devices}
    for v, pipe in pipes.items():
        _reset_flash()
        got = [pipe.train_step(tokens, m)["loss"] for _ in range(3)]
        launches = {k: n // 3 for k, n in _flash_counts().items()}
        if launches != _pipe_counts(config, 2 * v, m):
            raise AssertionError(f"pipeline (a) 2x{v}: flash launches a "
                                 f"step {launches}")
        merged = pipe.merged_params("cuda:0")
        loss_err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        elem = max((a - b).abs().max().item() for (_, a), (_, b) in zip(
            leaves(merged), leaves(state["params"])))
        move = torch.cat([(a - s).flatten() for (_, a), s in zip(
            leaves(merged), start)])
        ref_move = torch.cat([(b.detach() - s).flatten() for (_, b), s in
                              zip(leaves(state["params"]), start)])
        move_err = _norm_err(move, ref_move)
        log(f"pipeline (a) 2 stages x interleave {v} on {devices}, fp32 "
            f"bench widths, 4 layers, batch 4 x 128: losses {got} vs one "
            f"card {want} (worst {loss_err:.2e}, tol {tol}); parameters "
            f"after 3 steps within {elem:.2e} (tol 2 lr {2 * lr}), "
            f"movement within {move_err:.2e} by norm (tol 1e-3); flash "
            f"launches a step {launches}")
        if loss_err > tol or elem > 2 * lr or move_err > 1e-3:
            raise AssertionError(f"pipeline (a) 2x{v} differs from one card")
        out[f"2x{v}"] = dict(losses=got, loss_rel_err=loss_err,
                             param_max_diff=elem, move_rel_err=move_err,
                             launches_per_step=launches)
        del merged, move, ref_move
    return out


def _device_busy(torch, prof):
    """Device ms of the profiled kernels on each card (by device index)."""
    from torch.autograd import DeviceType

    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                e.name not in SUBLAYER_RANGES:
            busy[e.device_index] = busy.get(e.device_index, 0.0) + \
                e.device_time_total / 1e3
    return busy


def _pipe_bench(torch):
    """(b) the bench cell in bf16: all 14 layers, batch 8 x 2048, 8
    microbatches of 1, no remat inside the stages (their memory model is
    the recompute from the stage input). Stages on min(4, cards) cards (2
    stages on cuda:0 on one card); plain 1F1B and interleave 2 in turns
    with train/step.py's bench step (dots remat) on the same tokens on
    cuda:0: single, plain, interleaved, interleaved, plain, single, each
    1 warm-up and 3 timed steps. Per variant: step ms, tokens/s, each
    card's device ms in a profiled step over the mean timed step (the
    busy share; its idle share against the bubble (p-1)/(m+p-1),
    (p-1)/(v·m+p-1) interleaved), peak memory per
    card, bytes moved between cards a step, flash launches a step
    against `_pipe_counts`, and the profiled step's device time by
    sub-layer range."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.pipeline import LocalPipeline
    from ray_tpu_torch.train.optim import adamw, leaves
    from ray_tpu_torch.train.step import make_step

    cards = torch.cuda.device_count()
    p = min(4, cards) if cards > 1 else 2
    devices = ([f"cuda:{i}" for i in range(p)] if cards > 1
               else ["cuda:0"] * p)
    if cards == 1:
        log("pipeline (b): one card: the 2 stages share cuda:0 (no bubble "
            "to measure: the card runs both stages' work)")
    m = PIPE_MICROBATCHES
    config = _bench_train_config(torch)
    pipe_config = _bench_train_config(torch, remat=False)
    L = config.n_layers
    params = llama.init_params(config, torch.Generator(
        device="cuda").manual_seed(SEED))
    tokens = torch.randint(0, config.vocab_size,
                           (PIPE_BATCH, config.max_seq + 1), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(SEED + 7))
    pipes = {v: LocalPipeline(pipe_config, params, p, adamw(
        1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16), devices=devices,
        interleave=v) for v in (1, 2)}
    opt = adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    for _, t in leaves(params):
        t.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params)}
    step = make_step(config, opt)
    runs = {"single": lambda: step(state, tokens)[1]}
    for v, pipe in pipes.items():
        runs["plain" if v == 1 else "interleaved"] = (
            lambda pipe=pipe: pipe.train_step(tokens, m)["loss"])
    ms = {k: [] for k in runs}
    losses = {k: [] for k in runs}
    n_tok = PIPE_BATCH * config.max_seq

    def sync_all():
        for i in range(cards):
            torch.cuda.synchronize(i)

    for name in ("single", "plain", "interleaved", "interleaved", "plain",
                 "single"):
        losses[name].append(float(runs[name]()))
        sync_all()
        t0 = time.perf_counter()
        for _ in range(3):
            losses[name].append(float(runs[name]()))
        sync_all()
        ms[name].append((time.perf_counter() - t0) / 3 * 1e3)
    out = {"stages": p, "cards": cards, "devices": devices,
           "microbatches": m, "batch": PIPE_BATCH, "seq": config.max_seq}
    for name in runs:
        if not all(math.isfinite(x) for x in losses[name]):
            raise AssertionError(f"pipeline (b) {name}: losses "
                                 f"{losses[name]}")
        out[name] = dict(step_ms=ms[name], losses=losses[name],
                         tokens_per_s=[n_tok / t * 1e3 for t in ms[name]])
    for v, pipe in pipes.items():
        name = "plain" if v == 1 else "interleaved"
        for i in range(cards):
            torch.cuda.reset_peak_memory_stats(i)
        _reset_flash()
        sync_all()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.train_step(tokens, m)
            sync_all()
            prof_ms = (time.perf_counter() - t0) * 1e3
        launches = _flash_counts()
        want = _pipe_counts(pipe_config, p * v, m)
        if launches != want:
            raise AssertionError(f"pipeline (b) {name}: flash launches "
                                 f"{launches} != {want}")
        busy = _device_busy(torch, prof)
        peak = {i: torch.cuda.max_memory_allocated(i) / 2**30
                for i in range(cards)}
        step_ms = sum(ms[name]) / len(ms[name])
        bubble = (p - 1) / (v * m + p - 1)
        ranges = _range_split(prof)
        out[name].update(
            launches_per_step=launches, bytes_per_step=pipe.last_step_bytes,
            profiled_step_ms=prof_ms, busy_ms=busy,
            busy_share={i: busy.get(i, 0.0) / step_ms for i in range(cards)},
            peak_mem_gib=peak,
            bubble_model=bubble, ranges=ranges)
        log(f"pipeline (b) {name}: {p} stages x interleave {v} on "
            f"{devices}, bf16 bench cell {L} layers, batch {PIPE_BATCH} x "
            f"{config.max_seq} in {m} microbatches: step ms "
            f"{[round(t, 2) for t in ms[name]]} "
            f"({[round(n_tok / t * 1e3) for t in ms[name]]} tokens/s); "
            f"one card's step {[round(t, 2) for t in ms['single']]} ms; "
            f"device ms of a profiled step ({prof_ms:.1f} ms) per card and "
            "its share of the mean timed step "
            + ", ".join(f"cuda:{i} {busy.get(i, 0.0):.1f} ms "
                        f"{busy.get(i, 0.0) / step_ms:.1%}"
                        for i in range(cards))
            + f" (idle against the bubble model {bubble:.1%}); peak "
            + ", ".join(f"cuda:{i} {gib:.2f} GiB" for i, gib in peak.items())
            + f"; {pipe.last_step_bytes / 2**20:.1f} MiB between cards a "
            f"step; flash launches a step {launches} (model {want})")
        _log_ranges(f"pipeline (b) {name}", ranges)
    del pipes, state, step, runs
    return out


def _flash_on_other_card(torch):
    """(c) with 2 or more cards: K1, K3 dQ and K3 dK/dV launched on the
    last card while cuda:0 is the thread's current device, at the bench
    train shape of one microbatch (1 x 2048, 16/8 heads, 128), bf16 and
    fp32, held against their plain versions on that card."""
    from ray_tpu_torch.ops import attention as attn

    cards = torch.cuda.device_count()
    if cards < 2:
        log("pipeline (c): one card: the launch on a card other than the "
            "current one did not run")
        return None
    dev = torch.device(f"cuda:{cards - 1}")
    torch.cuda.set_device(0)
    out = {"device": str(dev)}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        randn, q, k, v = _flash_inputs(torch, "train",
                                       (1, 2048, 2048, 16, 8), dtype)
        q, k, v = (x.to(dev) for x in (q, k, v))
        dout = randn(1, 2048, 16, 128).to(dev)
        scale = 1.0 / math.sqrt(128)
        assert torch.cuda.current_device() == 0
        out_k, lse = attn.flash_fwd(q, k, v, True, scale)
        ref_out, ref_lse = attn.flash_fwd_reference(q, k, v, True, scale)
        delta = (dout.float() * ref_out.float()).sum(-1).transpose(
            1, 2).contiguous()
        args = (q, k, v, dout, ref_lse, delta, True, scale)
        dq = attn.flash_bwd_dq(*args)
        dk, dv = attn.flash_bwd_dkv(*args)
        torch.cuda.synchronize(dev)
        errs = {
            "flash_fwd": _close(torch, f"(c) flash_fwd {dname} on {dev}",
                                (out_k, lse), (ref_out, ref_lse),
                                TOLERANCE[dname]),
            "flash_bwd_dq": _close(torch, f"(c) dQ {dname} on {dev}", (dq,),
                                   (attn.flash_bwd_dq_reference(*args),),
                                   GRAD_TOLERANCE[dname]),
            "flash_bwd_dkv": _close(torch, f"(c) dK/dV {dname} on {dev}",
                                    (dk, dv),
                                    attn.flash_bwd_dkv_reference(*args),
                                    GRAD_TOLERANCE[dname])}
        if out_k.device != dev or torch.cuda.current_device() != 0:
            raise AssertionError("(c) the kernels ran on the wrong card")
        log(f"pipeline (c) {dname}: K1, K3 dQ, K3 dK/dV on {dev} with "
            f"cuda:0 current equal their plain versions there: max abs err "
            f"{errs}")
        out[dname] = errs
    return out


def phase_pipeline(torch):
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["pipeline"] = {"identity": _pipe_identity(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["pipeline"]["bench"] = _pipe_bench(torch)
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["pipeline"]["other_card"] = _flash_on_other_card(torch)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- rlhf

RLHF_SYSTEM = (2, 3, 5, 7)
RLHF_PROMPT_LEN, RLHF_NEW_TOKENS, RLHF_PROMPTS = 6, 32, 8
# The bench widths (_bench_train_config) as LlamaConfig.tiny overrides.
RLHF_WIDTHS = dict(vocab_size=32000, d_model=2048, n_heads=16,
                   n_kv_heads=8, d_ff=7168)


def _rlhf_setup(torch, n_layers):
    """A LearnerWorker at the bench widths (fp32, flash attention, full
    remat) from SEED and a graphed engine on its own copy of the LM."""
    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.rlhf.trainer import LearnerWorker

    kw = dict(RLHF_WIDTHS, n_layers=n_layers, max_seq=128,
              attention_impl="flash")
    hyper = dict(lr=1e-5, clip_eps=0.2, kl_coef=0.05, gamma=0.99, lam=0.95,
                 vf_coef=0.5, ent_coef=0.0, ppo_epochs=1,
                 pad_batch=RLHF_PROMPTS,
                 pad_tokens=(len(RLHF_SYSTEM) + RLHF_PROMPT_LEN
                             + RLHF_NEW_TOKENS),
                 prefix=list(RLHF_SYSTEM))
    learner = LearnerWorker(0, 1, kw, hyper, seed=SEED + 40)
    lm = {k: ({n: t.detach().clone() for n, t in v.items()}
              if isinstance(v, dict) else v.detach().clone())
          for k, v in learner.policy["lm"].items()}
    engine = build_engine(LLMConfig(
        model_config=learner.config, num_kv_blocks=64, block_size=16,
        max_batch_size=8, prefill_chunk=128), params=lm)
    return learner, engine


def _rlhf_prompts(start, n):
    from ray_tpu_torch.rlhf.trainer import default_prompt_fn

    return [default_prompt_fn(start + i, RLHF_PROMPT_LEN,
                              RLHF_WIDTHS["vocab_size"]) for i in range(n)]


def _rlhf_identity(torch):
    """(a) fp32 at the bench widths, 2 layers: greedy rollouts equal greedy
    decoding with the naive forward of the learner's LM; after one
    update and colocated_hot_swap, the engine's greedy tokens equal the
    learner's (and differ from before the update somewhere)."""
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.rlhf import rollout, weight_sync

    learner, engine = _rlhf_setup(torch, 2)
    items = list(enumerate(_rlhf_prompts(0, 4)))
    exps = rollout.run_rollout_round(
        engine, items, system_prompt=RLHF_SYSTEM,
        max_new_tokens=RLHF_NEW_TOKENS)
    for e in exps:
        want = learner.greedy_tokens(list(RLHF_SYSTEM) + e.prompt,
                                     RLHF_NEW_TOKENS)
        if e.response != want:
            raise AssertionError(f"rlhf (a) seq {e.seq_no}: engine "
                                 f"{e.response} != naive {want}")
    metrics = learner.update(exps)
    weight_sync.colocated_hot_swap(engine, learner.policy["lm"],
                                   learner.lm_meta, version=learner.version)
    probes = [list(RLHF_SYSTEM) + p for p in _rlhf_prompts(100, 3)]
    got = [list(o.output_token_ids) for o in engine.generate(
        probes, SamplingParams(max_tokens=16))]
    want = [learner.greedy_tokens(p, 16) for p in probes]
    if got != want:
        raise AssertionError(f"rlhf (a): after the swap the engine gives "
                             f"{got}, the learner {want}")
    log(f"rlhf (a): fp32 bench widths, 2 layers: 4 greedy rollouts equal "
        f"the naive forward; after update ({metrics}) and "
        f"colocated_hot_swap the engine's greedy tokens equal the "
        f"learner's on 3 probes")
    del learner, engine
    return dict(update=metrics, equal=True)


def _rlhf_loop(torch):
    """(b) the colocated loop, fp32 at the bench widths and all 14 layers
    on one card: three iterations of a RolloutCoordinator round of 8
    prompts (system prompt 4 + 6 tokens, 32 new tokens; 4 greedy, then 4
    at temperature 0.8 seeded by rollout_seed), one PPO update, one
    colocated_hot_swap. Per iteration: rollout s and generated tok/s,
    update s and its flash launches (2L forward in `_stats`, then 2L
    forward, L dQ, L dK/dV in the checkpointed loss), sync ms, the K5
    launches of the rollouts (all graph replays) and step_compiles
    before and after the swap (unchanged). The ledger: every seq_no done
    once, no duplicate."""
    from ray_tpu_torch.ops import paged_attention as pa
    from ray_tpu_torch.rlhf import rollout, weight_sync

    learner, engine = _rlhf_setup(torch, 14)
    L = learner.config.n_layers
    coord = rollout.RolloutCoordinator()
    consumed, iters = [], []
    per_update = {"flash_fwd": 4 * L, "flash_bwd_dq": L,
                  "flash_bwd_dkv": L}
    for it in range(3):
        coord.add_prompts(_rlhf_prompts(it * RLHF_PROMPTS, RLHF_PROMPTS))
        pa.ragged_paged_attention_unified.launches = 0
        pa.ragged_paged_attention.launches = 0
        compiles0 = engine.stats()["step_compiles"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exps = []
        for temperature in (0.0, 0.8):
            exps += rollout.run_rollout_round(
                engine, coord.take(RLHF_PROMPTS // 2),
                system_prompt=RLHF_SYSTEM, max_new_tokens=RLHF_NEW_TOKENS,
                temperature=temperature, base_seed=SEED)
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
        k5 = pa.ragged_paged_attention_unified.launches
        k6 = pa.ragged_paged_attention.launches
        fresh = coord.complete(exps)
        batch = coord.drain_done()
        consumed += [e.seq_no for e in batch]
        _reset_flash()
        t0 = time.perf_counter()
        metrics = learner.update(batch)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        launches = _flash_counts()
        if launches != per_update:
            raise AssertionError(f"rlhf (b): flash launches an update "
                                 f"{launches} != {per_update}")
        t0 = time.perf_counter()
        info = weight_sync.colocated_hot_swap(
            engine, learner.policy["lm"], learner.lm_meta,
            version=learner.version)
        torch.cuda.synchronize()
        sync_ms = (time.perf_counter() - t0) * 1e3
        compiles1 = engine.stats()["step_compiles"]
        n_tok = sum(len(e.response) for e in exps)
        if k5 < L or k6 != 0 or compiles1 != compiles0 or \
                len(fresh) != RLHF_PROMPTS:
            raise AssertionError(f"rlhf (b) iteration {it}: K5 {k5}, K6 "
                                 f"{k6}, step_compiles {compiles0} -> "
                                 f"{compiles1}, {len(fresh)} fresh")
        row = dict(rollout_s=rollout_s, tokens=n_tok,
                   tokens_per_s=n_tok / rollout_s, update_s=update_s,
                   sync_ms=sync_ms, k5_launches=k5, k6_launches=k6,
                   step_compiles=(compiles0, compiles1),
                   flash_per_update=launches, metrics=metrics,
                   version=info["version"])
        iters.append(row)
        log(f"rlhf (b) iteration {it}: rollout {rollout_s:.3f} s ({n_tok} "
            f"tokens, {n_tok / rollout_s:.1f} tok/s), update "
            f"{update_s:.3f} s ({metrics}), sync {sync_ms:.1f} ms; K5 {k5} "
            f"launches (replays), K6 {k6}; step_compiles {compiles0} -> "
            f"{compiles1}; flash an update {launches}")
    ledger = coord.ledger()
    if sorted(consumed) != list(range(3 * RLHF_PROMPTS)) or \
            ledger["dup_completions"] or not coord.round_complete():
        raise AssertionError(f"rlhf (b) ledger {ledger}, consumed "
                             f"{consumed}")
    log(f"rlhf (b) ledger {ledger}: seq_nos 0..{3 * RLHF_PROMPTS - 1} each "
        "consumed once")
    del learner, engine
    return dict(iterations=iters, ledger=ledger, layers=L)


def phase_rlhf(torch):
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["rlhf"] = {"identity": _rlhf_identity(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["rlhf"]["loop"] = _rlhf_loop(torch)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- resnet

RESNET_BATCH, RESNET_STEPS = 128, 20
RESNET_CONFIG = dict(depth="resnet50", num_classes=10, width=64)


def _resnet_run(torch, dtype):
    """resnet50 at CIFAR-10 shapes (32 x 32 x 3, 10 classes, width 64),
    batch RESNET_BATCH, AdamW(1e-3) on one seeded batch: RESNET_STEPS
    timed steps after 2 warm-up ones; the loss falls."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.train.optim import adamw, leaves

    config = resnet.ResNetConfig(dtype=dtype, **RESNET_CONFIG)
    params, state = resnet.init(config, torch.Generator(
        device="cuda").manual_seed(SEED + 50))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    batch = {"image": torch.randn((RESNET_BATCH, 32, 32, 3), generator=gen,
                                  device="cuda"),
             "label": torch.randint(0, 10, (RESNET_BATCH,), generator=gen,
                                    device="cuda")}
    flat = [t.requires_grad_(True) for _, t in leaves(params)]
    opt = adamw(1e-3)
    opt_state = opt.init(params)

    def step(state):
        loss, aux = resnet.loss_fn(params, state, batch, config)
        opt.update(params, torch.autograd.grad(loss, flat), opt_state)
        return aux["state"], loss.detach()

    losses = []
    for _ in range(2):
        state, loss = step(state)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        state, loss = step(state)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / RESNET_STEPS * 1e3
    losses = [float(x) for x in losses]
    name = str(dtype).split(".")[1]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"resnet {name}: losses {losses}")
    out = dict(step_ms=step_ms, images_per_s=RESNET_BATCH / step_ms * 1e3,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               loss_first=losses[0], loss_last=losses[-1])
    log(f"resnet50 {name}, CIFAR-10 shapes, batch {RESNET_BATCH}: "
        f"{step_ms:.2f} ms/step ({RESNET_STEPS} timed after 2), "
        f"{out['images_per_s']:.0f} images/s, peak "
        f"{out['peak_mem_gib']:.2f} GiB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    out["profile"] = _profile_train_step(
        torch, lambda st, _: step(st), state, None, step_ms,
        label=f"resnet50 {name} step")
    return out


def phase_resnet(torch):
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    RESULTS["resnet"] = {str(dt).split(".")[1]: _resnet_run(torch, dt)
                         for dt in (torch.float32, torch.bfloat16)}
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- mesh

RING_CHUNKS = 4
# The one-rank mesh runs the single-card step's arithmetic: its losses and
# grad_norms equal the single card's up to the order of fp32 sums.
MESH_TOLERANCE = 1e-6    # relative


def _norm_err(got, ref):
    """||got - ref|| / ||ref|| in fp32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).norm() / ref.norm().clamp(min=1e-30)).item()


def _reset_flash():
    from ray_tpu_torch.ops import attention as attn

    for k in FLASH_KERNELS:
        getattr(attn, k).launches = 0


def _steps(torch, step, state, tokens, n, per_step, losses, label):
    """n steps of `step(state, tokens)` (train/step.py's (state, loss) or
    fsdp's (state, metrics)), each step's loss or metrics appended to
    `losses`; host ms per step, each step's flash launches held to
    `per_step`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        before = _flash_counts()
        state, out = step(state, tokens)
        losses.append(out)
        got = {k: v - before[k] for k, v in _flash_counts().items()}
        if got != per_step:
            raise AssertionError(f"{label}: flash launches per step {got} "
                                 f"!= {per_step}")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


class _NormOf:
    """An optimizer that records the global norm of the gradients it is
    given (fp32 sums of squares, as fsdp.global_norm takes them), so that
    train/step.py's step can be held to the mesh step's grad_norm."""

    def __init__(self, torch, opt):
        self.torch, self.opt, self.norms = torch, opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, params, grads, state):
        vn = self.torch.linalg.vector_norm
        self.norms.append(self.torch.sqrt(sum(
            vn(g, dtype=self.torch.float32).square() for g in grads)))
        return self.opt.update(params, grads, state)


def _mesh_of_one(torch, mesh):
    """(a) fsdp.build_train_step on a one-rank mesh against train/step.py
    on the same weights and batch: the bench configuration, 3 warm-up
    steps each, then 3 steps at a time in turns single, mesh, mesh,
    single, single, mesh, mesh, single; the 15 losses and grad_norms of
    each path held pairwise within MESH_TOLERANCE."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.fsdp import build_train_step
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import init_state, make_step

    config = _bench_train_config(torch)
    L = config.n_layers
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    opt = adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    single_opt = _NormOf(torch, opt)
    single = init_state(config, single_opt, torch.Generator(
        device="cuda").manual_seed(SEED))
    init_fn, make_mesh_step = build_train_step(
        lambda p, b: llama.loss_fn(p, b, config), opt, mesh,
        llama.param_logical_axes(config), {"tokens": ("batch", None)})
    state, specs = init_fn(llama.init_params(config, torch.Generator(
        device="cuda").manual_seed(SEED)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tokens = torch.randint(0, config.vocab_size, (4, config.max_seq + 1),
                           generator=gen, device="cuda")
    paths = {"single": [make_step(config, single_opt), single, []],
             "mesh": [make_mesh_step(specs), state, []]}
    batch = {"single": tokens, "mesh": {"tokens": tokens}}
    ms = {"single": [], "mesh": []}
    _reset_flash()
    for name in ("single", "mesh"):
        step, st, losses = paths[name]
        _steps(torch, step, st, batch[name], 3, per_step, losses, name)
    for name in ("single", "mesh", "mesh", "single") * 2:
        step, st, losses = paths[name]
        ms[name].append(_steps(torch, step, st, batch[name], 3, per_step,
                               losses, name))
    launches = _flash_counts()
    single_l = [float(x) for x in paths["single"][2]]
    single_n = [float(x) for x in single_opt.norms]
    mesh_l = [float(m["loss"]) for m in paths["mesh"][2]]
    mesh_n = [float(m["grad_norm"]) for m in paths["mesh"][2]]
    worst = max(abs(a - b) / abs(b) for a, b in zip(mesh_l, single_l))
    worst_n = max(abs(a - b) / abs(b) for a, b in zip(mesh_n, single_n))
    if len(mesh_n) != len(single_n) or max(worst, worst_n) > \
            MESH_TOLERANCE or not all(map(math.isfinite, mesh_l + mesh_n)):
        raise AssertionError(f"mesh (a): losses {mesh_l}, grad_norms "
                             f"{mesh_n} vs single {single_l}, {single_n}")
    if not mesh_l[-1] < mesh_l[0]:
        raise AssertionError(f"mesh (a): loss did not fall: {mesh_l}")
    tps = 4 * config.max_seq
    order, seen = [], {"single": 0, "mesh": 0}
    for name in ("single", "mesh", "mesh", "single") * 2:
        order.append(f"{name} {ms[name][seen[name]]:.2f}")
        seen[name] += 1
    log(f"mesh (a) one-rank mesh vs single card, bench config batch 4 x "
        f"{config.max_seq}: step ms in turns {', '.join(order)}; losses "
        f"{mesh_l[0]:.4f} -> {mesh_l[-1]:.4f} (single {single_l[0]:.4f} -> "
        f"{single_l[-1]:.4f}), grad_norm {mesh_n[0]:.4f} -> {mesh_n[-1]:.4f}"
        f"; worst relative difference loss {worst:.2e}, grad_norm "
        f"{worst_n:.2e} (tol {MESH_TOLERANCE}); flash launches {launches} "
        f"over {2 * len(mesh_l)} steps")
    return dict(step_ms=ms, losses_single=single_l, losses_mesh=mesh_l,
                grad_norms_single=single_n, grad_norms_mesh=mesh_n,
                worst_rel_loss_diff=worst, worst_rel_norm_diff=worst_n,
                launches=launches,
                tokens_per_s_mesh=[tps / t * 1e3 for t in ms["mesh"]],
                tokens_per_s_single=[tps / t * 1e3 for t in ms["single"]])


def _flash_share(torch, fn):
    """Share of fn's device time (torch.profiler) in the flash kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = [(e.key, e.self_device_time_total) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    total = sum(t for _, t in times)
    return sum(t for k, t in times if "flash_" in k) / max(total, 1e-9)


def _ring_composition(torch):
    """(b) the ring's chunk steps and merges (ring_attention_chunks) over
    RING_CHUNKS chunks of a 16384-token causal sequence at the bench's
    heads (16/8, d 128, bf16), forward and backward with cotangents on
    the output and the LSE, against flash attention on the whole
    sequence; errors by norm (NORM_TOLERANCE), times by CUDA events."""
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel.ring import ring_attention_chunks

    b, s, h, hkv, d = 1, 16384, 16, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def randn(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, k, v = (randn(b, s, n, d).requires_grad_(True)
               for n in (h, hkv, hkv))
    g_out, g_lse = randn(b, s, h, d), randn(b, h, s, dt=torch.float32)

    def run(fn):
        out, lse = fn()
        loss = (out.float() * g_out.float()).sum() + (lse * g_lse).sum()
        return (out, lse, *torch.autograd.grad(loss, [q, k, v]))

    ring = lambda: ring_attention_chunks(  # noqa: E731
        q, k, v, RING_CHUNKS, causal=True)
    whole = lambda: flash_attention(  # noqa: E731
        q, k, v, causal=True, return_lse=True)
    _reset_flash()
    got = run(ring)
    torch.cuda.synchronize()
    launches = _flash_counts()
    # 4 diagonal and 6 past chunks attend; the 6 future ones launch none.
    n = RING_CHUNKS * (RING_CHUNKS + 1) // 2
    if launches != {k: n for k in FLASH_KERNELS}:
        raise AssertionError(f"mesh (b): launches {launches}, want {n} each")
    ref = run(whole)
    errs = {name: _norm_err(g, r) for name, g, r in
            zip(("out", "lse", "dq", "dk", "dv"), got, ref)}
    bad = {k: e for k, e in errs.items() if not e <= NORM_TOLERANCE[
        "bfloat16"]}
    if bad:
        raise AssertionError(f"mesh (b): ring vs whole by norm {errs}")
    flash_share = _flash_share(torch, lambda: run(ring))
    ring_ms = _time_auto(torch, lambda: run(ring), budget_s=1.0, most=10)
    whole_ms = _time_auto(torch, lambda: run(whole), budget_s=1.0, most=10)
    fwd_ring = _time_auto(torch, lambda: ring_attention_chunks(
        q.detach(), k.detach(), v.detach(), RING_CHUNKS), most=10)
    fwd_whole = _time_auto(torch, lambda: flash_attention(
        q.detach(), k.detach(), v.detach(), causal=True), most=10)
    chunk = s // RING_CHUNKS
    log(f"mesh (b) ring composition, {RING_CHUNKS} chunks of {chunk} (b 1, "
        f"heads {h}/{hkv}, d {d}, bf16): fwd+bwd "
        f"{ring_ms:.3f} ms vs whole-sequence flash {whole_ms:.3f} ms; fwd "
        f"{fwd_ring:.3f} vs {fwd_whole:.3f} ms; errors by norm "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {NORM_TOLERANCE['bfloat16']}); launches {launches}; "
        f"flash kernels {flash_share:.1%} of the ring's device time")
    return dict(seq=s, chunks=RING_CHUNKS, fwd_bwd_ms=ring_ms,
                flash_share=flash_share,
                whole_fwd_bwd_ms=whole_ms, fwd_ms=fwd_ring,
                whole_fwd_ms=fwd_whole, norm_errors=errs, launches=launches)


def _dispatch_share(torch, prof, slots):
    """Share of the profiled device time in the MoE dispatch and combine
    einsums: the fp32 bmm calls (forward, recompute and backward) with an
    operand dimension of E x C slots."""
    from torch.autograd import DeviceType

    kernels = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    einsums = sum(getattr(e, "device_time_total", 0)
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.key == "aten::bmm"
                  and any(slots in shape for shape in e.input_shapes))
    return einsums / max(kernels, 1e-9), kernels / 1e3


def _moe_routes(torch, moe, config, params, tokens):
    """Per layer of one no-grad forward: (dropped share of the routes,
    the busiest expert's share of the routes), from moe_block's own
    dropped_frac and the top-k of its router logits."""
    rows, block = [], moe.moe_block

    def spy(config, x, router, *weights):
        out, aux = block(config, x, router, *weights)
        idx = torch.topk(x.float() @ router, config.top_k, dim=-1).indices
        load = torch.bincount(idx.flatten(), minlength=config.n_experts)
        rows.append((float(aux["dropped_frac"]),
                     float(load.max()) / idx.numel()))
        return out, aux

    moe.moe_block = spy
    try:
        with torch.no_grad():
            moe.forward(params, tokens["tokens"][:, :-1], config)
    finally:
        moe.moe_block = block
    return rows


def _moe_train(torch, mesh):
    """(c) the JAX package's default MoEConfig at full width (3.55 B
    parameters, 1.14 B active), bf16, flash, full remat, batch 2 x 2048,
    the bench's AdamW, through fsdp.build_train_step on the one-rank
    mesh: 2 warm-up and 5 timed steps; the loss falls; every step
    launches flash_fwd 2L times, dQ and dK/dV L times; a profiled step;
    each layer's routes at the first and the last weights."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel.fsdp import build_train_step
    from ray_tpu_torch.train.optim import adamw

    config = moe.MoEConfig(attention_impl="flash", dtype=torch.bfloat16)
    L, batch, seq = config.n_layers, 2, config.max_seq
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    opt = adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    init_fn, make_step = build_train_step(
        lambda p, b: moe.loss_fn(p, b, config), opt, mesh,
        moe.param_logical_axes(config), {"tokens": ("batch", None)})
    state, specs = init_fn(moe.init_params(config, torch.Generator(
        device="cuda").manual_seed(SEED + 11)))
    gc.collect()
    torch.cuda.empty_cache()
    step = make_step(specs)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    tokens = {"tokens": torch.randint(0, config.vocab_size, (batch, seq + 1),
                                      generator=gen, device="cuda")}
    routes = [_moe_routes(torch, moe, config, state["params"], tokens)]
    torch.cuda.reset_peak_memory_stats()
    _reset_flash()
    every = []
    ms_warm = _steps(torch, step, state, tokens, 2, per_step, every, "moe")
    step_ms = _steps(torch, step, state, tokens, 5, per_step, every, "moe")
    launches = _flash_counts()
    losses = [float(m["loss"]) for m in every]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"mesh (c): MoE losses {losses}")
    dropped = [float(m["dropped_frac"]) for m in every]
    tps = batch * seq / step_ms * 1e3
    mfu = tps * config.flops_per_token(seq) / PEAK_OPS["bfloat16"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    routes.append(_moe_routes(torch, moe, config, state["params"], tokens))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(state, tokens)
        torch.cuda.synchronize()
    share, device_ms = _dispatch_share(
        torch, prof, config.n_experts * config.capacity(seq))
    n_all, n_active = config.num_params() / 1e9, config.active_params() / 1e9
    log(f"mesh (c) MoE {n_all:.2f} B ({n_active:.2f} B active), {L} layers, "
        f"batch {batch} x "
        f"{seq}, bf16, flash, full remat: {step_ms:.2f} ms/step (5 timed "
        f"after 2 at {ms_warm:.2f}), {tps:.0f} tokens/s, MFU {mfu:.2%} of "
        f"989 TFLOP/s, peak {peak:.2f} GiB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, dropped_frac {dropped[0]:.4f} -> {dropped[-1]:.4f}"
        f" over the 7 steps, flash launches "
        f"per step {per_step}; profiled step {device_ms:.2f} ms of device "
        f"time, fp32 dispatch+combine einsums {share:.1%} of it")
    for when, rows in zip(("before step 1", "after step 7"), routes):
        log(f"mesh (c) MoE routes {when}, per layer (dropped share, busiest"
            f" expert's share of the routes; even {1 / config.n_experts:.3f}"
            f"): " + ", ".join(f"{d:.3f}/{b:.3f}" for d, b in rows))
    return dict(step_ms=step_ms, tokens_per_s=tps, mfu=mfu,
                peak_mem_gib=peak, losses=losses, dropped_frac=dropped,
                routes_per_layer={"before": routes[0], "after": routes[1]},
                launches=launches, launches_per_step=per_step,
                device_ms=device_ms, dispatch_combine_share=share,
                params=config.num_params(),
                active_params=config.active_params())


def _moe_identity(torch):
    """(c) fp32 identity: the default MoEConfig at full width with 2
    layers, batch 2 x 512: the loss and its parts on flash equal those on
    reference attention with the same weights (relative 1e-5)."""
    import dataclasses

    from ray_tpu_torch.models import moe

    config = moe.MoEConfig(n_layers=2, max_seq=512, dtype=torch.float32,
                           attention_impl="flash")
    params = moe.init_params(config, torch.Generator(
        device="cuda").manual_seed(SEED + 13))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    batch = {"tokens": torch.randint(0, config.vocab_size, (2, 513),
                                     generator=gen, device="cuda")}
    got = {}
    with torch.no_grad():
        for impl, launches in (("flash", config.n_layers), ("reference", 0)):
            _reset_flash()
            _, m = moe.loss_fn(params, batch, dataclasses.replace(
                config, attention_impl=impl))
            got[impl] = {k: float(v) for k, v in m.items()}
            if _flash_counts()["flash_fwd"] != launches:
                raise AssertionError(f"mesh (c) identity: {impl} launched "
                                     f"{_flash_counts()}")
    worst = max(abs(got["flash"][k] - v) / max(abs(v), 1e-30)
                for k, v in got["reference"].items())
    if worst > 1e-5:
        raise AssertionError(f"mesh (c) identity: {got}")
    log(f"mesh (c) MoE identity, fp32 full width, 2 layers, batch 2 x 512: "
        f"total loss flash {got['flash']['total_loss']:.7f} vs reference "
        f"{got['reference']['total_loss']:.7f}; worst relative difference "
        f"of the loss and its parts {worst:.2e} (tolerance 1e-5)")
    return dict(flash=got["flash"], reference=got["reference"], worst=worst)


MULTI_CARD_MESH = {4: dict(fsdp=2, tp=2), 2: dict(fsdp=2)}


def _sharded_rank(rank, world, mesh_kw, save_dir=None):
    """(d) on card `rank` of an NCCL world: a 2-layer, full-width Llama
    (the bench's widths, fp32, flash) for 2 steps on the sharded mesh,
    against the same 2 steps without a mesh on the same card and weights:
    losses, grad_norms and every gathered parameter, elementwise and as
    the error of the parameters' movement by norm. With `save_dir`, the
    trained state is then saved there (parallel/checkpoint.py)."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.fsdp import build_train_step
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.sharding import gather_tree
    from ray_tpu_torch.train.optim import adamw, leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = _bench_train_config(torch, n_layers=2, dtype=torch.float32)
    lr = 1e-4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    tokens = torch.randint(0, config.vocab_size, (4, config.max_seq + 1),
                           generator=gen, device="cuda")

    def weights():
        return llama.init_params(config, torch.Generator(
            device="cuda").manual_seed(SEED + 22))

    params, opt = weights(), adamw(lr)
    flat = [p.requires_grad_(True) for _, p in leaves(params)]
    opt_state, ref = opt.init(params), []
    for _ in range(2):
        loss, _ = llama.loss_fn(params, {"tokens": tokens}, config)
        grads = torch.autograd.grad(loss, flat)
        ref.append((loss.item(), torch.sqrt(sum(
            g.square().sum() for g in grads)).item()))
        opt.update(params, grads, opt_state)
    mesh = build_mesh(MeshConfig(**mesh_kw))
    init_fn, make_step = build_train_step(
        lambda p, b: llama.loss_fn(p, b, config), adamw(lr), mesh,
        llama.param_logical_axes(config), {"tokens": ("batch", None)})
    state, specs = init_fn(weights())
    step, got = make_step(specs), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        state, m = step(state, {"tokens": tokens})
        got.append((m["loss"].item(), m["grad_norm"].item()))
    step_ms = (time.perf_counter() - t0) / 2 * 1e3
    save_ms = None
    if save_dir is not None:
        from ray_tpu_torch.parallel.checkpoint import save_state

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(state, specs, mesh, save_dir)
        save_ms = (time.perf_counter() - t0) * 1e3
    full = gather_tree(state["params"], specs["params"], mesh)
    diff = max((a - b).abs().max().item() for (_, a), (_, b) in
               zip(leaves(full), leaves(params)))
    moved = err = 0.0
    for (_, a), (_, b), (_, p0) in zip(leaves(full), leaves(params),
                                       leaves(weights())):
        moved += (b.detach() - p0).double().square().sum().item()
        err += (a - b.detach()).double().square().sum().item()
    return dict(rank=rank, losses=got, ref=ref, param_max_diff=diff,
                moved_norm=math.sqrt(moved),
                move_rel_err=math.sqrt(err / max(moved, 1e-300)),
                step_ms=step_ms, save_ms=save_ms, local_params=sum(
                    p.numel() for _, p in leaves(state["params"])))


def _multi_card(torch):
    """(d) the sharded step across cards, when the machine has two or
    more; the number of ranks either way."""
    from ray_tpu_torch.parallel.launch import spawn

    count = torch.cuda.device_count()
    world = 4 if count >= 4 else 2 if count >= 2 else 1
    if world == 1:
        log(f"mesh (d): ranks 1 ({count} card): the multi-card leg needs "
            "2 or more cards and did not run")
        return dict(ranks=1, cards=count)
    mesh_kw = MULTI_CARD_MESH[world]
    res = spawn(_sharded_rank, world, mesh_kw, device="cuda", timeout=600)
    lr = 1e-4
    for r in res:
        for (loss, norm), (ref_loss, ref_norm) in zip(r["losses"], r["ref"]):
            if abs(loss - ref_loss) > 1e-5 * abs(ref_loss) or \
                    abs(norm - ref_norm) > 1e-4 * abs(ref_norm):
                raise AssertionError(f"mesh (d) rank {r['rank']}: "
                                     f"{r['losses']} vs {r['ref']}")
        # A step moves an element by about lr: a rank whose parameters did
        # not move, or moved the wrong way, fails both checks. Elements
        # whose gradient is near Adam's eps move by an amount the order of
        # fp32 sums decides, hence no elementwise limit below lr.
        if r["param_max_diff"] > lr or r["move_rel_err"] > 1e-3:
            raise AssertionError(
                f"mesh (d) rank {r['rank']}: params differ by "
                f"{r['param_max_diff']} (movement by norm "
                f"{r['move_rel_err']:.2e} off)")
    log(f"mesh (d): ranks {world} on {count} cards, MeshConfig({mesh_kw}), "
        f"2-layer full-width Llama fp32: (loss, grad_norm) per step "
        f"{res[0]['losses']} vs one card {res[0]['ref']}; parameters after 2"
        f" steps within {max(r['param_max_diff'] for r in res):.2e} "
        f"(tol {lr}), their movement ({res[0]['moved_norm']:.4f} by norm) "
        f"within {max(r['move_rel_err'] for r in res):.2e} by norm (tol "
        f"1e-3); step {res[0]['step_ms']:.1f} ms; "
        f"{res[0]['local_params']} parameters a rank")
    return dict(ranks=world, cards=count, mesh=mesh_kw, results=res)


def phase_mesh(torch):
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.parallel.launch import init_rank
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # NCCL takes one card a rank: the one-card legs run on a world of 1.
        init_rank(0, 1, os.path.join(tmp, "store"), "cuda")
        try:
            mesh = build_mesh(MeshConfig(), device="cuda")
            for name, fn in (("mesh_of_one", lambda: _mesh_of_one(torch,
                                                                   mesh)),
                             ("ring", lambda: _ring_composition(torch)),
                             ("moe", lambda: _moe_train(torch, mesh)),
                             ("moe_identity", lambda: _moe_identity(torch))):
                out[name] = fn()
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    out["multi_card"] = _multi_card(torch)
    out["ranks"] = out["multi_card"]["ranks"]
    RESULTS["mesh"] = out

# ---------------------------------------------------------------- checkpoint

def _disk(path):
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize / 2**30


def _restored_state(torch, directory):
    """train/step.py's state from a manifest-format checkpoint of one: the
    parameters require grad, the AdamW count is an int again."""
    from ray_tpu_torch.checkpoint import restore_tree
    from ray_tpu_torch.train.optim import leaves

    tree = restore_tree(directory, device="cuda")
    for _, p in leaves(tree["params"]):
        p.requires_grad_(True)
    tree["opt"]["count"] = int(tree["opt"]["count"])
    return tree


def _train_checkpoint(torch, tmp):
    """(a) the bench cell's train state at 7 of its 14 layers (bf16,
    AdamW with bf16 mu; the depth halved to keep every phase inside the
    time limit) after 2 steps, saved at world 1 (save_sharded) and at
    world 2 (two ranks' shards through the CheckpointPlane's async save),
    then the uninterrupted third step; each checkpoint restored and
    stepped gives that step's loss bit for bit. Save and restore ms and
    GB/s."""
    from ray_tpu_torch.checkpoint import (CheckpointPlane, read_manifest,
                                          save_sharded)
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import init_state, make_step

    config = _bench_train_config(torch, n_layers=7)
    opt = adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    state = init_state(config, opt,
                       torch.Generator(device="cuda").manual_seed(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    tokens = torch.randint(0, config.vocab_size, (4, config.max_seq + 1),
                           generator=gen, device="cuda")
    step = make_step(config, opt)
    for _ in range(2):
        state, _ = step(state, tokens)
    torch.cuda.synchronize()
    dirs = {1: os.path.join(tmp, "world1"), 2: os.path.join(tmp, "world2")}
    t0 = time.perf_counter()
    save_sharded(state, dirs[1], step=2)
    save1 = (time.perf_counter() - t0) * 1e3
    plane = CheckpointPlane()
    t0 = time.perf_counter()
    pend = [plane.save_async(state, dirs[2], rank=r, world=2, step=2)
            for r in (1, 0)]
    stall2 = (time.perf_counter() - t0) * 1e3
    if not plane.flush(timeout=600) or not pend[1].committed:
        raise AssertionError(f"checkpoint world 2: {[p.info() for p in pend]}")
    save2 = (time.perf_counter() - t0) * 1e3
    plane.close()
    _, want = step(state, tokens)
    want = want.item()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    nbytes = read_manifest(dirs[1])["nbytes"]
    out = dict(bytes=nbytes, save_ms={1: save1, 2: save2},
               snapshot_stall_ms_world2=stall2,
               snapshot_ms_world2=[p.snapshot_ms for p in pend],
               persist_ms_world2=[p.persist_ms for p in pend],
               restore_ms={}, loss_next=want)
    for world, d in dirs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = _restored_state(torch, d)
        torch.cuda.synchronize()
        out["restore_ms"][world] = (time.perf_counter() - t0) * 1e3
        _, got = step(restored, tokens)
        got = got.item()
        if got != want:
            raise AssertionError(f"checkpoint world {world}: next loss "
                                 f"{got!r} != uninterrupted {want!r}")
        del restored
        gc.collect()
        torch.cuda.empty_cache()
    gb = nbytes / 1e9
    log(f"checkpoint (a) bench train state, 7 layers ({gb:.3f} GB: params, "
        f"AdamW mu and nu, bf16) after 2 steps: save world 1 {save1:.0f} ms "
        f"({gb / save1 * 1e3:.2f} GB/s), world 2 through the plane "
        f"{save2:.0f} ms ({gb / save2 * 1e3:.2f} GB/s; the caller stalled "
        f"{stall2:.0f} ms for both snapshots); restore world 1 "
        f"{out['restore_ms'][1]:.0f} ms ({gb / out['restore_ms'][1] * 1e3:.2f}"
        f" GB/s), world 2 {out['restore_ms'][2]:.0f} ms; the next step's "
        f"loss {want!r} equal bit for bit after both")
    return out


def _serve_checkpoint(torch, tmp):
    """(a) a 2-layer full-width Llama-3-8B in fp32, saved with
    Checkpoint.save_pytree and served through LLMConfig.params_checkpoint:
    its greedy tokens equal the same server built from memory and naive
    llama.forward (the identity phase's yardstick)."""
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.checkpoint import Checkpoint

    config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    params = llama.init_params(config, torch.Generator(
        device="cuda").manual_seed(SEED + 1))
    d = os.path.join(tmp, "params")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Checkpoint.save_pytree(params, d)
    save_ms = (time.perf_counter() - t0) * 1e3
    prompts = _prompts([37, 150, 260], config.vocab_size, SEED + 1)
    n_new = 8
    naive = [_naive(torch, llama, params, config, p, n_new,
                    lambda lg, _: torch.argmax(lg)) for p in prompts]
    cfg = dict(model_config=config, block_size=16, num_kv_blocks=256,
               max_batch_size=8, prefill_chunk=128, device="cuda",
               warmup_buckets="light")
    got = {}
    for label, kw in (("memory", dict(params=params)), ("checkpoint", {})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = build_engine(LLMConfig(**dict(
            cfg, params_checkpoint=d if label == "checkpoint" else None)),
            **kw)
        built = (time.perf_counter() - t0) * 1e3
        got[label] = [o.output_token_ids for o in engine.generate(
            prompts, SamplingParams(max_tokens=n_new))]
        got[label + "_build_ms"] = built
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if not got["checkpoint"] == got["memory"] == naive:
        raise AssertionError(f"checkpoint (a) serving: {got} vs naive "
                             f"{naive}")
    nbytes = sum(p.numel() * 4 for p in params["layers"].values()) + sum(
        params[k].numel() * 4 for k in ("embed", "final_norm", "lm_head"))
    log(f"checkpoint (a) 2-layer full-width Llama-3-8B fp32 ({nbytes / 1e9:.3f}"
        f" GB) saved in {save_ms:.0f} ms; the server loaded through "
        f"params_checkpoint (built + warmed in "
        f"{got['checkpoint_build_ms']:.0f} ms, from memory "
        f"{got['memory_build_ms']:.0f} ms) gives the greedy tokens of the "
        f"server built from memory and of naive forward for "
        f"{len(prompts)} prompts x {n_new} tokens")
    return dict(bytes=nbytes, save_ms=save_ms,
                build_ms={k: got[k + "_build_ms"]
                          for k in ("memory", "checkpoint")},
                tokens_equal=True)


def phase_checkpoint(torch):
    import tempfile

    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        log(f"checkpoint: writing under {tmp} ({_disk(tmp):.0f} GiB free)")
        out = dict(train=_train_checkpoint(torch, tmp))
        for d in ("world1", "world2"):
            shutil.rmtree(os.path.join(tmp, d))
        out["serve"] = _serve_checkpoint(torch, tmp)
    RESULTS["checkpoint"] = out
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- tp

TP_PROMPTS = (37, 150, 260)


def _greedy(engine, prompts, n_new):
    from ray_tpu_torch.llm.sampling import SamplingParams

    return [o.output_token_ids for o in engine.generate(
        prompts, SamplingParams(max_tokens=n_new))]


def _engines_on(engine, paths):
    """An engine per path of `paths` ({label: engine options}) over
    `engine`'s runner (one runner, so one world at tp), with the smoke's
    serving options; used one at a time."""
    from ray_tpu_torch.llm.engine import LLMEngine

    return {label: LLMEngine(engine.runner, max_batch_size=8,
                             prefill_chunk=128, **kw)
            for label, kw in paths.items()}


TP_PATHS = {"unified": {}, "speculative": dict(speculative_ngram=4),
            "split": dict(unified_ticks=False)}


def _close_world(close, tp, label):
    """Call `close` (a runner's or a server's, which stops its tp world),
    then check that no rank process and no process group is left; logs how
    long the close took."""
    import multiprocessing

    import torch.distributed as dist

    t0 = time.perf_counter()
    close()
    left = multiprocessing.active_children()
    if dist.is_initialized() or left:
        raise AssertionError(f"{label}: after close, process group "
                             f"{dist.is_initialized()}, processes {left}")
    if tp > 1:
        log(f"{label}: world of {tp} ranks closed in "
            f"{time.perf_counter() - t0:.1f} s, no process left")


def _tp_identity(torch, tp):
    """(b) fp32, full width, 2 layers: greedy tokens of the tp server
    (unified graphed, unified speculative, split; one runner) equal the
    one-card server's on the same seeded weights; K5 and K6 launches of
    every rank on each path. The one-card server runs first, and each tp
    path's tokens are compared (and logged) as soon as it has run, before
    its world closes."""
    from ray_tpu_torch.llm.serving import build_engine
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    prompts = _prompts(TP_PROMPTS, config.vocab_size, SEED + 1)
    n_new, got, out = 8, {}, {}
    for n in (1, tp):
        t0 = time.perf_counter()
        base = build_engine(_engine_config(
            config, tensor_parallel=n, seed=SEED + 1, num_kv_blocks=256,
            warmup_buckets="light"))
        log(f"tp (b) identity: tp={n} engine built in "
            f"{time.perf_counter() - t0:.1f} s")
        try:
            for label, engine in _engines_on(base, TP_PATHS).items():
                base.runner.rank_launches(reset=True)
                got[(n, label)] = _greedy(engine, prompts, n_new)
                launches = base.runner.rank_launches(reset=True)
                out[f"{label}_{n}_launches"] = launches
                same = got[(n, label)] == got[(1, label)]
                log(f"tp (b) identity: tp={n} {label}: [K5, K6] per rank "
                    f"{launches}" + (f"; tokens {'==' if same else '!='} "
                                     f"one card's" if n > 1 else ""))
                if not same:
                    raise AssertionError(f"tp identity {label}: tp={n} "
                                         f"{got[(n, label)]} != one card "
                                         f"{got[(1, label)]}")
                k = 1 if label == "split" else 0
                if any(r[k] == 0 or r[1 - k] for r in launches):
                    raise AssertionError(f"tp identity {label} at {n}: "
                                         f"[K5, K6] per rank {launches}")
        finally:
            _close_world(base.runner.close, n, f"tp (b) identity: tp={n}")
        del base
        gc.collect()
        torch.cuda.empty_cache()
    log(f"tp (b) identity, fp32 full width, 2 layers: greedy tokens at "
        f"tp={tp} == one card on the unified, speculative and split "
        f"servers ({len(prompts)} prompts x {n_new})")
    return out


def _tp_serving(torch, tp):
    """(b) Llama-3-8B at full width, bf16, seeded weights drawn on every
    rank: the server phase's five-request mix on the tp server (tok/s,
    TTFT, ITL; K5 launches of every rank at least n_layers x ticks,
    step_compiles unchanged after warmup); decode steps of 8 rows, host
    wall in turns with a one-card engine on the same weights, device time
    of every rank and its NCCL share (torch.profiler on each rank)."""
    from ray_tpu_torch.llm.serving import LLMServer, build_engine
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
    one = build_engine(_engine_config(config, seed=SEED,
                                      warmup_buckets="light"))
    t0 = time.perf_counter()
    server = LLMServer(_engine_config(config, tensor_parallel=tp, seed=SEED))
    build_s = time.perf_counter() - t0
    log(f"tp={tp}: Llama-3-8B bf16 server built + warmed in {build_s:.1f} s")
    runner = server.engine.runner
    try:
        runner.rank_launches(reset=True)
        _, mix = _server_run(torch, server, _mix_requests(config, f"tp{tp}"),
                             config, f"tp={tp}")
        per_rank = runner.rank_launches(reset=True)
        if any(k5 < config.n_layers * mix["ticks"] or k6
               for k5, k6 in per_rank):
            raise AssertionError(f"tp={tp}: [K5, K6] per rank {per_rank}, "
                                 f"{mix['ticks']} ticks")
        server._stop.set()
        server._loop.join(10)
        engine = server.engine
        walls = _decode_walls(torch, {f"tp{tp}": engine, "one": one}, config)
        for i, p in enumerate(_prompts([64] * 8, config.vocab_size,
                                       SEED + 2)):
            engine.add_request(p, SamplingParams(max_tokens=40),
                               request_id=f"tp-profile-{i}")
        while engine.waiting or engine.prefilling:
            engine.step()
        n_ticks = 12
        runner.rank_profile(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            engine.step()
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) / n_ticks * 1e3
        prof = runner.rank_profile(False)
        while engine.has_unfinished():
            engine.step()
    finally:
        _close_world(server.close, tp, f"tp={tp} server")
    device_ms = [t / 1e3 / n_ticks for t, _ in prof]
    nccl = [n / max(t, 1e-9) for t, n in prof]
    out = dict(mix, tp=tp, build_s=build_s, launches_per_rank=per_rank,
               decode_walls_ms=walls, profiled_tick_ms=tick_ms,
               device_ms_per_rank=device_ms, nccl_share_per_rank=nccl,
               weight_bound_ms_per_rank=16.06e9 / tp / HBM_BYTES_PER_S * 1e3)
    log(f"tp={tp}: launches [K5, K6] per rank {per_rank}; decode step of 8 "
        f"rows under the profiler {tick_ms:.2f} ms host wall, device time "
        f"per rank {[round(x, 3) for x in device_ms]} ms, NCCL kernels "
        f"{[f'{x:.1%}' for x in nccl]} of it (weight-read bound "
        f"{out['weight_bound_ms_per_rank']:.2f} ms a rank)")
    return out


def _tp_from_mesh_checkpoint(torch, count):
    """(b) the mesh (d) cell's 2-layer full-width Llama (the bench's widths,
    fp32) trained 2 steps on up to 4 NCCL ranks and saved sharded
    (parallel/checkpoint.py), then served at tp=2 from that directory:
    greedy tokens equal a one-card server loaded from the same
    directory."""
    import tempfile

    from ray_tpu_torch.checkpoint import read_manifest
    from ray_tpu_torch.llm.serving import build_engine
    from ray_tpu_torch.parallel.launch import spawn

    world = 4 if count >= 4 else 2
    config = _bench_train_config(torch, n_layers=2, dtype=torch.float32,
                                 attention_impl="reference")
    prompts = _prompts(TP_PROMPTS, config.vocab_size, SEED + 6)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        res = spawn(_sharded_rank, world, MULTI_CARD_MESH[world], d,
                    device="cuda", timeout=600)
        manifest = read_manifest(d)
        got = {}
        for n in (1, 2):
            engine = build_engine(_engine_config(
                config, tensor_parallel=n, params_checkpoint=d, num_kv_blocks=256,
                warmup_buckets="light"))
            try:
                got[n] = _greedy(engine, prompts, 8)
                if n == 2:
                    log(f"tp (b) mesh checkpoint: tokens at tp=2 "
                        f"{'==' if got[2] == got[1] else '!='} one card's")
                    if got[2] != got[1]:
                        raise AssertionError(
                            f"tp from the mesh checkpoint: tp=2 {got[2]} "
                            f"!= one card {got[1]}")
            finally:
                _close_world(engine.runner.close, n,
                             f"tp (b) mesh checkpoint: tp={n}")
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    save_ms = max(r["save_ms"] for r in res)
    log(f"tp (b) mesh checkpoint: {world} NCCL ranks on "
        f"MeshConfig({MULTI_CARD_MESH[world]}) trained 2 steps and saved "
        f"{manifest['nbytes'] / 1e9:.3f} GB in {world} shards "
        f"({save_ms:.0f} ms); served at tp=2 from it: greedy tokens == a "
        f"one-card server loaded from the same directory "
        f"({len(prompts)} prompts x 8)")
    return dict(ranks=world, mesh=MULTI_CARD_MESH[world], save_ms=save_ms,
                bytes=manifest["nbytes"], tokens_equal=True)


def _tp_two_worlds(torch, tp):
    """(e) One process holds one NCCL world after another: after the
    identity's world of `tp` ranks closed in this process, worlds of 2 and
    of `tp` ranks start, serve (unified, graphed) and close in it too; the
    fp32 2-layer Llama-3-8B's greedy tokens of each equal one card's."""
    from ray_tpu_torch.llm.serving import build_engine
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    prompts = _prompts(TP_PROMPTS, config.vocab_size, SEED + 1)
    got, out = {}, {}
    for n in (1, 2, tp):
        t0 = time.perf_counter()
        engine = build_engine(_engine_config(
            config, tensor_parallel=n, seed=SEED + 1, num_kv_blocks=256,
            warmup_buckets="light"))
        try:
            got[n] = _greedy(engine, prompts, 8)
        finally:
            _close_world(engine.runner.close, n, f"tp (e) two worlds: tp={n}")
        out[f"tp{n}_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out["tokens_equal"] = got[2] == got[1] and got[tp] == got[1]
    log(f"tp (e) two worlds in one process: after the tp={tp} identity, "
        f"tp=2 then tp={tp} started and closed here; greedy tokens == one "
        f"card's: {out['tokens_equal']} ({out})")
    if not out["tokens_equal"]:
        raise AssertionError(f"tp two worlds: {got}")
    return out


def _tp_leg(name, *args):
    """`name(torch, *args)`, a leg of the tp phase that starts a
    tensor-parallel world, run in a new process of this script; returns
    its result (JSON). The 8B legs run apart, so each starts with the
    card's memory to itself."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as d:
        out = os.path.join(d, "result.json")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--phases", "device", "--tp-leg",
                        json.dumps([name, list(args), out])],
                       check=True, timeout=900)
        with open(out) as f:
            return json.load(f)


def phase_tp(torch):
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    count = torch.cuda.device_count()
    if count < 2:
        log(f"tp: ranks 1 ({count} card): tensor-parallel serving needs 2 "
            "or more cards and did not run")
        RESULTS["tp"] = dict(ranks=1, cards=count)
        return
    import faulthandler

    # A rank that hangs prints every thread's stack (its children too:
    # they import this file) instead of dying silently at the time limit.
    os.environ["CHIP_SMOKE_STACKS_AFTER_S"] = "300"
    faulthandler.dump_traceback_later(600)
    tp = 4 if count >= 4 else 2
    out = dict(cards=count, sizes=[tp])
    # The identity's world, then two more in this process; the heavy legs
    # each in a process of their own.
    out["identity"] = _tp_identity(torch, tp)
    out["two_worlds"] = _tp_two_worlds(torch, tp)
    out["mesh_checkpoint"] = _tp_leg("_tp_from_mesh_checkpoint", count)
    out["serving"] = {tp: _tp_leg("_tp_serving", tp)}
    out["ranks"] = tp
    faulthandler.cancel_dump_traceback_later()
    RESULTS["tp"] = out


# ---------------------------------------------------------------- runtime

class RuntimeHost:
    """Actor body of the runtime phase (ray_tpu_torch.remote wraps it; a
    worker unpickles it by reference, importing this file as a module).
    kind "llama3_8b": an LLMServer of Llama-3-8B at full width in bf16 on
    the SEED weights, as the server phase builds it; "identity": the
    2-layer fp32 Llama-3-8B of the fp32 identity; "probe": no model."""

    def __init__(self, kind: str):
        self.t_init = time.time()
        import torch

        self.t_torch = time.time()
        self.torch = torch
        self.server = None
        if kind == "probe":
            return
        from ray_tpu_torch.llm.serving import LLMServer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        config, params = _runtime_weights(torch, kind)
        self.config = config
        t0 = time.perf_counter()
        self.server = LLMServer(_engine_config(config), params=params)
        self.build_s = time.perf_counter() - t0

    def info(self) -> dict:
        """Where the actor runs; wall times (time.time(), one host) of its
        __init__'s start, after torch's import and after CUDA's init."""
        torch = self.torch
        name = torch.cuda.get_device_name(0)
        return {"cuda_visible_devices": os.environ.get(
            "CUDA_VISIBLE_DEVICES"), "pid": os.getpid(),
            "device_count": torch.cuda.device_count(), "device": name,
            "build_s": getattr(self, "build_s", None),
            "t_init": self.t_init, "t_torch": self.t_torch,
            "t_cuda": time.time()}

    def completions(self, request: dict) -> dict:
        """One request, streamed inside the actor as the in-process
        server's mix is (`_stream`): tokens, TTFT and inter-token gaps."""
        record: dict = {}
        _stream(self.server, request, record)
        return record[request["request_id"]]

    def reset_counts(self) -> None:
        self._stats0 = _reset_counts(self.server)

    def counts(self) -> dict:
        return _counts_since(self.server, self._stats0)

    def tensor_check(self, t, shape, seed) -> dict:
        """The driver's bf16 CUDA tensor as this actor read it: on its
        CUDA device, bit for bit the tensor made here from the seed."""
        torch = self.torch
        want = _seeded_bf16(torch, shape, seed)
        return {"device": str(t.device), "dtype": str(t.dtype),
                "bit_equal": bool(t.device.type == "cuda" and torch.equal(
                    t.view(torch.int16), want.view(torch.int16)))}

    def tensor_echo(self, t):
        return t


def _reset_counts(server) -> dict:
    """Set this process's K5/K6 launch counts to 0; the server's engine
    stats at that moment."""
    from ray_tpu_torch.ops import paged_attention as pa

    pa.ragged_paged_attention_unified.launches = 0
    pa.ragged_paged_attention.launches = 0
    return server.engine_stats()


def _counts_since(server, stats0) -> dict:
    """K5/K6 launches, ticks and step_compiles (before, now) since
    `_reset_counts` returned `stats0`."""
    from ray_tpu_torch.ops import paged_attention as pa

    stats = server.engine_stats()
    return {"k5_launches": pa.ragged_paged_attention_unified.launches,
            "k6_launches": pa.ragged_paged_attention.launches,
            "ticks": stats["ticks"] - stats0["ticks"],
            "step_compiles": [stats0["step_compiles"],
                              stats["step_compiles"]]}


def _seeded_bf16(torch, shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _needs_card():
    """A task with no GPU lease: its worker sees no card, so asking for
    CUDA must raise (the port never falls back to the CPU)."""
    from ray_tpu_torch.ops import resolve_device

    return str(resolve_device("cuda"))


def _runtime_weights(torch, kind):
    from ray_tpu_torch.models import llama

    if kind == "llama3_8b":
        config = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
        seed = SEED
    else:
        config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
        seed = SEED + 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return config, llama.init_params(config, gen, "cuda")


def _wait_gone(pid: int, timeout: float) -> float:
    """time.time() once process `pid` has left /proc."""
    deadline = time.monotonic() + timeout
    while os.path.exists(f"/proc/{pid}"):
        if time.monotonic() > deadline:
            raise AssertionError(f"process {pid} still alive after kill")
        time.sleep(0.02)
    return time.time()


def _runtime_processes(session_dir: str):
    """Command lines of the port runtime processes of one session: the GCS
    and raylet name the session directory on their command line, workers
    in their environment. Another checkout's runtime on the same host is
    not this run's."""
    key = session_dir.encode()
    env_key = b"RAY_TPU_TORCH_SESSION_DIR=" + key
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ")
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if b"-m ray_tpu_torch" in cmd and (key in cmd or env_key in env):
            found.append(f"{entry} {cmd.decode(errors='replace').strip()}")
    return found


def _in_process_mix(torch):
    """The server phase's graphed mix on an in-process server, for the
    runtime phase to stand beside (when the server phase did not run)."""
    from ray_tpu_torch.llm.serving import LLMServer

    config, params = _llama8b(torch)
    server = LLMServer(_engine_config(config), params=params)
    _, numbers = _server_run(torch, server, _mix_requests(config, "greedy"),
                             config, "in-process")
    server.close()
    del server
    return numbers


def _actor_mix(torch, rt, host, config):
    """The server phase's five-request mix, concurrently through the
    actor's .completions.remote(...): every request 32 valid tokens, the
    K5 launches counted inside the actor (exactly one a layer a tick, K6
    none, no capture after warmup)."""
    requests = _mix_requests(config, "greedy")
    rt.get(host.reset_counts.remote(), timeout=60)
    t0 = time.perf_counter()
    refs = [host.completions.remote(r) for r in requests]
    out = rt.get(refs, timeout=600)
    wall = time.perf_counter() - t0
    record = {r["request_id"]: o for r, o in zip(requests, out)}
    for r in requests:
        got = record[r["request_id"]]["tokens"]
        if len(got) != 32 or not all(0 <= t < config.vocab_size
                                     for t in got):
            raise AssertionError(f"actor {r['request_id']}: bad output {got}")
    counts = rt.get(host.counts.remote(), timeout=60)
    ticks = counts["ticks"]
    if (counts["k5_launches"] != config.n_layers * ticks or ticks == 0
            or counts["k6_launches"]
            or counts["step_compiles"][0] != counts["step_compiles"][1]):
        raise AssertionError(f"actor mix: {counts} (n_layers "
                             f"{config.n_layers})")
    return dict(_mix_numbers(record, wall), **counts)


def phase_runtime(torch):
    """The port's actor runtime on the card: a cluster of this host,
    Llama-3-8B served from a one-GPU actor in a placement group."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.runtime.scheduling import PlacementGroupStrategy

    import chip_smoke as this   # actor bodies pickled by reference

    out: dict = {}
    inproc = RESULTS.get("server") or _in_process_mix(torch)
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    smi_count = len([ln for ln in subprocess.run(
        ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60,
        check=True).stdout.splitlines() if ln.startswith("GPU ")])
    t0 = time.perf_counter()
    rt.init(object_store_memory=1 << 30)
    try:
        # This session's own processes and store file, for the check after
        # shutdown.
        session_dir = rt.get_runtime_context().session_dir
        store_path = api._head.store_path
        out["init_s"] = time.perf_counter() - t0
        resources = rt.cluster_resources()
        log(f"runtime: init in {out['init_s']:.2f} s, cluster_resources "
            f"{resources}; nvidia-smi -L lists {smi_count} card(s)")
        if resources.get("GPU") != smi_count:
            raise AssertionError(f"GPU {resources.get('GPU')} != nvidia-smi "
                                 f"count {smi_count}")
        out.update(cluster_resources=resources, nvidia_smi_count=smi_count)
        Host = rt.remote(this.RuntimeHost)
        pg = rt.placement_group([{"GPU": 1, "CPU": 1}])
        if not pg.wait(60):
            raise AssertionError("placement group not created in 60 s")
        in_pg = PlacementGroupStrategy(pg, 0)
        # Llama-3-8B from a one-GPU actor in the group's bundle.
        t0 = time.perf_counter()
        server = Host.options(num_gpus=1, num_cpus=1, max_concurrency=8,
                              scheduling_strategy=in_pg).remote("llama3_8b")
        info = rt.get(server.info.remote(), timeout=900)
        out["actor_up_s"] = time.perf_counter() - t0
        log(f"runtime: 8B actor up in {out['actor_up_s']:.1f} s (server "
            f"built in {info['build_s']:.1f} s) on {info['device']}, "
            f"CUDA_VISIBLE_DEVICES={info['cuda_visible_devices']}, "
            f"{info['device_count']} visible card(s)")
        if info["device_count"] != 1:
            raise AssertionError(f"actor sees {info['device_count']} cards")
        config = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
        mix = _actor_mix(torch, rt, server, config)
        out["actor_mix"] = mix
        out["in_process_mix"] = {k: inproc.get(k) for k in (
            "generated_tok_s", "ttft_ms", "itl_p50_ms", "itl_p99_ms",
            "ticks", "k5_launches")}
        log(f"runtime: actor mix {mix['generated_tokens']} tokens in "
            f"{mix['wall_s']:.2f} s ({mix['generated_tok_s']:.1f} generated "
            f"tok/s), ITL p50 {mix['itl_p50_ms']:.2f} ms p99 "
            f"{mix['itl_p99_ms']:.2f} ms, TTFT ms {mix['ttft_ms']}; K5 "
            f"launches in the actor {mix['k5_launches']} over "
            f"{mix['ticks']} ticks, K6 {mix['k6_launches']}")
        log(f"runtime: in-process server (same run) "
            f"{inproc['generated_tok_s']:.1f} generated tok/s, ITL p50 "
            f"{inproc['itl_p50_ms']:.2f} ms p99 {inproc['itl_p99_ms']:.2f} "
            f"ms, TTFT ms {inproc['ttft_ms']}")
        # Scheduling: a second one-GPU actor in the same bundle stays
        # pending while the first holds its card, and starts once the
        # first is killed.
        probe = Host.options(num_gpus=1,
                             scheduling_strategy=in_pg).remote("probe")
        waiting = probe.info.remote()
        t0 = time.perf_counter()
        ready, _ = rt.wait([waiting], num_returns=1, timeout=5)
        if ready:
            raise AssertionError("second one-GPU actor started while the "
                                 "first held the card")
        out["second_actor_pending_5s"] = not ready
        t_kill = time.time()
        t1 = time.perf_counter()
        rt.kill(server)
        gone = _wait_gone(info["pid"], 120)
        probe_info = rt.get(waiting, timeout=300)
        out["second_actor_started_after_kill_s"] = time.perf_counter() - t1
        # Where those seconds go, on the host's wall clock: the killed
        # worker's exit, the new worker up to its __init__, torch's
        # import, CUDA's init (the first info() call).
        out["second_actor_start_parts_s"] = parts = {
            "killed_process_exit": gone - t_kill,
            "to_new_init": probe_info["t_init"] - gone,
            "torch_import": probe_info["t_torch"] - probe_info["t_init"],
            "to_cuda_ready": probe_info["t_cuda"] - probe_info["t_torch"]}
        log(f"runtime: second one-GPU actor pending for "
            f"{t1 - t0:.1f} s while the first held the card; started "
            f"{out['second_actor_started_after_kill_s']:.1f} s after the "
            f"kill (CUDA_VISIBLE_DEVICES="
            f"{probe_info['cuda_visible_devices']}); s: " + ", ".join(
                f"{k} {v:.2f}" for k, v in parts.items()))
        # A bf16 CUDA tensor through the object store, both ways.
        shape, seed = (1024, 4096), SEED + 7
        t = _seeded_bf16(torch, shape, seed)
        ref = rt.put(t)
        seen = rt.get(probe.tensor_check.remote(ref, shape, seed), timeout=60)
        back = rt.get(probe.tensor_echo.remote(ref), timeout=60)
        back_equal = bool(back.device.type == "cuda" and torch.equal(
            back.view(torch.int16), t.view(torch.int16)))
        out["tensor"] = dict(seen, back_device=str(back.device),
                             back_bit_equal=back_equal,
                             nbytes=t.numel() * t.element_size())
        log(f"runtime: bf16 {list(shape)} tensor put by the driver, read in "
            f"the actor on {seen['device']}: bit-equal {seen['bit_equal']};"
            f" back on the driver's {back.device}: bit-equal {back_equal}")
        if not (seen["bit_equal"] and back_equal):
            raise AssertionError(f"tensor round trip: {out['tensor']}")
        rt.kill(probe)
        # No fallback: a worker without the card raises.
        try:
            rt.get(rt.remote(this._needs_card).remote(), timeout=120)
        except rt.TaskError as e:
            if "CUDA is not available" not in str(e):
                raise
            out["worker_without_card_raises"] = True
        else:
            raise AssertionError("a worker without a GPU lease reached CUDA")
        log("runtime: a task without a GPU lease asking for CUDA raises")
        # fp32 identity: actor-hosted and in-process 2-layer servers.
        ident = Host.options(num_gpus=1, num_cpus=1, max_concurrency=8,
                             scheduling_strategy=in_pg).remote("identity")
        config2 = llama.LlamaConfig.llama3_8b(n_layers=2,
                                              dtype=torch.float32)
        requests = [dict(prompt=p, max_tokens=16, request_id=f"id-{i}")
                    for i, p in enumerate(_prompts([20, 100, 300],
                                                   config2.vocab_size,
                                                   SEED + 3))]
        # One request at a time on both sides: the same batch
        # compositions, so fp32 rounding is the same.
        actor_tokens = [rt.get(ident.completions.remote(r), timeout=900)[
            "tokens"] for r in requests]
        rt.kill(ident)
        from ray_tpu_torch.llm.serving import LLMServer

        local = LLMServer(_engine_config(config2),
                          params=_runtime_weights(torch, "identity")[1])
        local_tokens = [local.completions(dict(r))["choices"][0]["token_ids"]
                        for r in requests]
        local.close()
        del local
        gc.collect()
        torch.cuda.empty_cache()
        out["fp32_identity_equal"] = actor_tokens == local_tokens
        log(f"runtime: fp32 2-layer greedy tokens, actor == in-process: "
            f"{out['fp32_identity_equal']} ({len(requests)} requests)")
        if actor_tokens != local_tokens:
            raise AssertionError(f"fp32 identity:\n{actor_tokens}\n"
                                 f"{local_tokens}")
        rt.remove_placement_group(pg)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 60
    while True:
        procs = _runtime_processes(session_dir)
        shm = os.path.exists(store_path)
        if not procs and not shm:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"after shutdown: processes {procs}, "
                                 f"store file {store_path} left: {shm}")
        time.sleep(0.5)
    out["clean_after_shutdown"] = True
    log(f"runtime: after shutdown no `python -m ray_tpu_torch` process of "
        f"session {session_dir} and no {store_path} is left")
    RESULTS["runtime"] = out


# ------------------------------------------------------------------ serve

def _counting_server_cls():
    """The serve phase's replica body: LLMServer with the K5/K6 launch
    counts of its process (reset and read) and where it runs. Defined in a
    function, so cloudpickle ships it by value to the replica."""
    from ray_tpu_torch.llm.serving import LLMServer

    class CountingServer(LLMServer):
        def reset_counts(self, _=None) -> None:
            self._stats0 = _reset_counts(self)

        def counts(self, _=None) -> dict:
            return _counts_since(self, self._stats0)

        def where(self, _=None) -> dict:
            import torch

            return {"pid": os.getpid(), "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device_count": torch.cuda.device_count(),
                    "device": str(self.engine.runner.device)}

    return CountingServer


def _openai_app(serving, config, name):
    """build_openai_app with the replicas running _counting_server_cls():
    the module's LLMServer is that subclass while the app is built (the
    deployment binds the class it finds there)."""
    real = serving.LLMServer
    serving.LLMServer = _counting_server_cls()
    try:
        return serving.build_openai_app(config, name)
    finally:
        serving.LLMServer = real


def _post_json(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _http_sse(url, request, record):
    """POST one request as server-sent events (completions_stream) and
    record, at the client, its tokens, TTFT and the arrival time of every
    token event, as `_stream` does in process."""
    req = urllib.request.Request(
        url + "?method=completions_stream&stream=1",
        data=json.dumps(request).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    times, tokens = [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not resp.headers["Content-Type"].startswith("text/event-stream"):
            raise AssertionError(f"SSE content type "
                                 f"{resp.headers['Content-Type']}")
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            ev = json.loads(data)
            if "error" in ev:
                raise AssertionError(f"{request['request_id']}: {ev}")
            if ev["finished"]:
                tokens = ev["token_ids"]
            else:
                times.append(time.perf_counter())
    if tokens is None:
        raise AssertionError(f"{request['request_id']}: no final event")
    record[request["request_id"]] = dict(
        tokens=tokens, ttft_s=times[0] - t0,
        total_s=time.perf_counter() - t0,
        gaps_s=[b - a for a, b in zip(times, times[1:])])


def _http_plain(url, request, record):
    t0 = time.perf_counter()
    out = _post_json(url, request)["result"]
    record[request["request_id"]] = dict(
        tokens=out["choices"][0]["token_ids"],
        total_s=time.perf_counter() - t0)


def _http_mix(url, requests, config, fn):
    """`requests` POSTed concurrently through `fn` (one thread each);
    every request must give 32 valid tokens. Returns (record, wall)."""
    record: dict = {}
    t0 = time.perf_counter()
    threads = [threading.Thread(target=fn, args=(url, r, record))
               for r in requests]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    for r in requests:
        got = record.get(r["request_id"], {}).get("tokens")
        if (got is None or len(got) != 32
                or not all(0 <= t < config.vocab_size for t in got)):
            raise AssertionError(f"HTTP {r['request_id']}: bad output {got}")
    return record, wall


def _serve_identity(torch, serving, url, n_cards):
    """The 2-layer fp32 Llama-3-8B (SEED + 1 weights, as the runtime
    phase's identity) served through build_openai_app: greedy tokens over
    HTTP equal an in-process server's. With 2+ cards the app has two
    one-card replicas: both must answer, each seeing only its own card."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.serving import LLMServer
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    requests = [dict(prompt=p, max_tokens=16)
                for p in _prompts([20, 100, 300], config.vocab_size,
                                  SEED + 3)]
    replicas = 2 if n_cards >= 2 else 1
    out = {"replicas": replicas}
    _openai_app(serving, _engine_config(
        config, seed=SEED + 1, num_replicas=replicas,
        num_gpus_per_replica=1), "identity")
    ident = f"{url.rsplit('/', 1)[0]}/identity"
    # One request at a time: the same batch compositions on both sides,
    # so fp32 rounding is the same; twice over for two replicas.
    http_tokens = [_post_json(ident, r)["result"]["choices"][0]["token_ids"]
                   for r in requests * replicas]
    seen = {}
    if replicas == 2:
        h = serve.get_deployment_handle("identity")
        for _ in range(16):
            w = h.options("where").remote(None).result(timeout=60)
            seen[w["pid"]] = w
        log(f"serve: two one-card replicas: {sorted(seen.values(), key=str)}")
        cards = sorted(w["cuda_visible_devices"] for w in seen.values())
        if (len(seen) != 2 or len(set(cards)) != 2
                or any(w["device_count"] != 1 for w in seen.values())):
            raise AssertionError(f"two-replica leg: {seen}")
        out["two_replicas"] = list(seen.values())
    else:
        log("serve: one card: the two-replica leg (one card each) skipped")
    serve.delete("identity")
    local = LLMServer(_engine_config(config, seed=SEED + 1))
    local_tokens = [local.completions(dict(r))["choices"][0]["token_ids"]
                    for r in requests]
    local.close()
    del local
    gc.collect()
    torch.cuda.empty_cache()
    out["fp32_identity_equal"] = http_tokens == local_tokens * replicas
    log(f"serve: fp32 2-layer greedy tokens, HTTP == in-process: "
        f"{out['fp32_identity_equal']} ({len(http_tokens)} requests over "
        f"{replicas} replica(s))")
    if not out["fp32_identity_equal"]:
        raise AssertionError(f"serve fp32 identity:\n{http_tokens}\n"
                             f"{local_tokens}")
    return out


def phase_serve(torch):
    """Serve on the port's runtime on the card: Llama-3-8B served through
    build_openai_app from a one-GPU replica behind the HTTP proxy."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import api
    from ray_tpu_torch.llm import serving
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import api as serve_api

    out: dict = {}
    inproc = RESULTS.get("server") or _in_process_mix(torch)
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    rt.init(object_store_memory=1 << 30)
    try:
        session_dir = rt.get_runtime_context().session_dir
        store_path = api._head.store_path
        out["init_s"] = time.perf_counter() - t0
        # The deploy, part by part: the controller actor, the HTTP proxy
        # actor, then the app (the controller unpickles the init args,
        # importing torch, then starts the replica and waits for it).
        t0 = time.perf_counter()
        controller = serve_api._get_controller()
        rt.get(controller.global_version.remote(), timeout=120)
        out["controller_up_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host, port = serve.start_http_proxy()
        out["proxy_up_s"] = time.perf_counter() - t0
        config = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
        cfg = _engine_config(config, seed=SEED, num_replicas=1,
                             num_gpus_per_replica=1)
        t0 = time.perf_counter()
        handle = _openai_app(serving, cfg, "v1-completions")
        out["app_deploy_s"] = time.perf_counter() - t0
        (row,) = [d for d in serve.status() if d["name"] == "v1-completions"]
        out["controller_deploy_s"] = row["deploy_s"]
        url = f"http://{host}:{port}/v1-completions"
        where = handle.options("where").remote(None).result(timeout=60)
        log(f"serve: init {out['init_s']:.2f} s; controller up "
            f"{out['controller_up_s']:.2f} s; proxy up "
            f"{out['proxy_up_s']:.2f} s at {host}:{port}; build_openai_app "
            f"{out['app_deploy_s']:.2f} s, of it the controller's init-args "
            f"unpickle {row['deploy_s']['init_args_unpickle']:.2f} s "
            f"(imported torch: {row['deploy_s']['unpickle_imported_torch']})"
            f" and the replica up {row['deploy_s']['replicas_up']:.2f} s; "
            f"replica {where}")
        if where["device_count"] != 1:
            raise AssertionError(f"replica sees {where['device_count']} cards")
        # One request down each route first: the proxy's first request
        # to a deployment looks up its adapter and replicas and opens its
        # connections (timed apart).
        first = {}
        for fn in (_http_plain, _http_sse):
            warm = _mix_requests(config, f"first-{fn.__name__}",
                                 seed=SEED + 13)[0]
            t0 = time.perf_counter()
            fn(url, warm, {})
            first[fn.__name__[1:]] = time.perf_counter() - t0
        out["first_request_s"] = first
        # The mix over HTTP, the counts from 0 just before it: plainly on
        # the in-process mix's prompts, then as server-sent events on
        # prompts of the same lengths from another seed (the first leg's
        # prompts would hit the prefix cache).
        handle.options("reset_counts").remote(None).result(timeout=60)
        plain_record, plain_wall = _http_mix(
            url, _mix_requests(config, "greedy"), config, _http_plain)
        sse_record, sse_wall = _http_mix(
            url, _mix_requests(config, "sse", seed=SEED + 11), config,
            _http_sse)
        counts = handle.options("counts").remote(None).result(timeout=60)
        ticks = counts["ticks"]
        if (counts["k5_launches"] != config.n_layers * ticks or ticks == 0
                or counts["k6_launches"]
                or counts["step_compiles"][0] != counts["step_compiles"][1]):
            raise AssertionError(f"serve mix: {counts} (n_layers "
                                 f"{config.n_layers})")
        n_plain = sum(len(v["tokens"]) for v in plain_record.values())
        out["http_plain"] = dict(
            generated_tokens=n_plain, wall_s=plain_wall,
            generated_tok_s=n_plain / plain_wall,
            total_ms={k: round(v["total_s"] * 1e3, 1)
                      for k, v in plain_record.items()})
        out["http_sse"] = _mix_numbers(sse_record, sse_wall)
        out["replica_counts"] = counts
        out["in_process_mix"] = {k: inproc.get(k) for k in (
            "generated_tok_s", "ttft_ms", "itl_p50_ms", "itl_p99_ms",
            "ticks", "k5_launches")}
        sse = out["http_sse"]
        log(f"serve: first request down each route (s) {first}; HTTP mix, "
            f"plain POSTs {n_plain} tokens in {plain_wall:.2f} s "
            f"({n_plain / plain_wall:.1f} generated tok/s, ms per request "
            f"{out['http_plain']['total_ms']}); as server-sent events {sse['generated_tokens']} tokens"
            f" in {sse_wall:.2f} s ({sse['generated_tok_s']:.1f} generated "
            f"tok/s), ITL p50 {sse['itl_p50_ms']:.2f} ms p99 "
            f"{sse['itl_p99_ms']:.2f} ms, TTFT ms {sse['ttft_ms']}; K5 "
            f"launches in the replica {counts['k5_launches']} over {ticks} "
            f"ticks (= {counts['k5_launches'] / ticks:.1f}/tick), K6 "
            f"{counts['k6_launches']}, step_compiles "
            f"{counts['step_compiles']}")
        log(f"serve: in-process server (same run) "
            f"{inproc['generated_tok_s']:.1f} generated tok/s, ITL p50 "
            f"{inproc['itl_p50_ms']:.2f} ms p99 {inproc['itl_p99_ms']:.2f} "
            f"ms, TTFT ms {inproc['ttft_ms']}")
        t0 = time.perf_counter()
        if not serve.delete("v1-completions"):
            raise AssertionError("serve.delete found no v1-completions")
        out["delete_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        out["identity"] = _serve_identity(torch, serving, url, n_cards)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 60
    while True:
        procs = _runtime_processes(session_dir)
        shm = os.path.exists(store_path)
        if not procs and not shm:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"after shutdown: processes {procs}, "
                                 f"store file {store_path} left: {shm}")
        time.sleep(0.5)
    out["clean_after_shutdown"] = True
    log(f"serve: after serve.shutdown and shutdown no `python -m "
        f"ray_tpu_torch` process of session {session_dir} and no "
        f"{store_path} is left")
    RESULTS["serve"] = out


# ---------------------------------------------------------------- router

def _counting_prefill_cls():
    """The router phase's prefill replica body: PrefillServer with the
    K5/K6 launch counts and the runner's rectangular steps of its process
    (reset and read). Defined in a function, so cloudpickle ships it by
    value to the replica."""
    from ray_tpu_torch.llm.disagg import PrefillServer

    class CountingPrefill(PrefillServer):
        def reset_counts(self, _=None) -> None:
            from ray_tpu_torch.ops import paged_attention as pa

            if not hasattr(self, "_steps"):
                self._steps = _count_runner_steps(self.engine.runner)
            self._steps["steps"] = 0
            pa.ragged_paged_attention_unified.launches = 0
            pa.ragged_paged_attention.launches = 0

        def counts(self, _=None) -> dict:
            from ray_tpu_torch.ops import paged_attention as pa

            return {"k5_launches": pa.ragged_paged_attention_unified.launches,
                    "k6_launches": pa.ragged_paged_attention.launches,
                    "runner_steps": self._steps["steps"]}

    return CountingPrefill


def _routed_app(serving, config, name):
    """build_openai_app (routing="affinity" or disaggregate > 0: the router
    front) with the engine replicas running _counting_server_cls() and the
    prefill replicas _counting_prefill_cls()."""
    from ray_tpu_torch.llm import disagg

    real = disagg.PrefillServer
    disagg.PrefillServer = _counting_prefill_cls()
    try:
        return _openai_app(serving, config, name)
    finally:
        disagg.PrefillServer = real


def _deploy_parts(name):
    """Each tier's deploy_s from the controller (unpickle of the init
    args, replicas up), keyed by deployment."""
    from ray_tpu_torch import serve

    return {d["name"]: d["deploy_s"] for d in serve.status()
            if d["name"] == name or d["name"].startswith(name + "-")}


def _replica_calls(name, method, *args):
    """`method(*args)` on every replica of deployment `name`, in the order
    the router indexes them."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    handles = serve.get_deployment_handle(name).replica_handles()
    return rt.get([h.handle_request.remote(method, list(args), {})
                   for h in handles], timeout=120)


def _check_replica_counts(counts, config, label):
    ticks = counts["ticks"]
    if (counts["k5_launches"] != config.n_layers * ticks or ticks == 0
            or counts["k6_launches"]
            or counts["step_compiles"][0] != counts["step_compiles"][1]):
        raise AssertionError(f"{label}: {counts} (n_layers "
                             f"{config.n_layers})")


def _shared_prefix_leg(url, config, name):
    """3 prompts of 512 tokens, each sent 4 times (a round of the three
    concurrently, four rounds): the router's affinity hits and the engine
    replicas' prefix_tokens_saved over the leg."""
    from ray_tpu_torch import serve

    router = serve.get_deployment_handle(name)
    prompts = _prompts([512] * 3, config.vocab_size, SEED + 17)
    stats0 = router.options("router_stats").remote().result(timeout=60)
    saved0 = sum(s["prefix_tokens_saved"]
                 for s in _replica_calls(f"{name}-engine", "engine_stats"))
    t0 = time.perf_counter()
    for rnd in range(4):
        requests = [dict(prompt=p, max_tokens=8, request_id=f"pfx-{rnd}-{i}")
                    for i, p in enumerate(prompts)]
        record: dict = {}
        threads = [threading.Thread(target=_http_plain, args=(url, r, record))
                   for r in requests]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        for r in requests:
            got = record.get(r["request_id"], {}).get("tokens")
            if got is None or len(got) != 8:
                raise AssertionError(f"shared prefix {r['request_id']}: {got}")
    wall = time.perf_counter() - t0
    stats = router.options("router_stats").remote().result(timeout=60)
    saved = sum(s["prefix_tokens_saved"] for s in _replica_calls(
        f"{name}-engine", "engine_stats")) - saved0
    out = {"affinity_hits": stats["affinity_hits"] - stats0["affinity_hits"],
           "affinity_misses": stats["affinity_misses"]
           - stats0["affinity_misses"],
           "prefix_tokens_saved": saved, "wall_s": wall}
    log(f"router: shared-prefix leg (3 prompts x 512 tokens, 4 rounds) in "
        f"{wall:.2f} s: affinity hits {out['affinity_hits']}, misses "
        f"{out['affinity_misses']}, the engine's prefix_tokens_saved "
        f"{saved}")
    if out["affinity_hits"] < 9 or saved < 9 * 496:
        raise AssertionError(f"shared-prefix leg: {out}")
    return out


def _serving_summary():
    """llm_serving_summary once the replicas' gauges reached the GCS KV
    (flushes are throttled to one a second)."""
    from ray_tpu_torch.state import llm_serving_summary

    deadline = time.monotonic() + 30
    while True:
        summary = llm_serving_summary()
        if summary.get("kv_total_blocks"):
            return summary
        if time.monotonic() > deadline:
            raise AssertionError(f"llm_serving_summary: {summary}")
        time.sleep(0.5)


def _router_identity(torch, serving, disaggregate=0):
    """The 2-layer fp32 Llama-3-8B (SEED + 1 weights) through the router
    front (one one-card engine replica, and with `disaggregate` a one-card
    prefill replica): greedy tokens over HTTP equal an in-process
    server's. With a prefill tier each request prefills there (K6, the
    split path) and decodes on the engine replica (K5), counted in each
    replica from 0."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.serving import LLMServer
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    requests = [dict(prompt=p, max_tokens=16)
                for p in _prompts([20, 100, 300], config.vocab_size,
                                  SEED + 3)]
    name = "router-fp32-disagg" if disaggregate else "router-fp32"
    t0 = time.perf_counter()
    _routed_app(serving, _engine_config(
        config, seed=SEED + 1, num_replicas=1, num_gpus_per_replica=1,
        routing="affinity", disaggregate=disaggregate), name)
    out = {"deploy_s": time.perf_counter() - t0}
    host, port = serve.start_http_proxy()
    url = f"http://{host}:{port}/{name}"
    engine = serve.get_deployment_handle(f"{name}-engine")
    engine.options("reset_counts").remote(None).result(timeout=60)
    if disaggregate:
        prefill = serve.get_deployment_handle(f"{name}-prefill")
        prefill.options("reset_counts").remote(None).result(timeout=60)
    # One request at a time: the same batch compositions on both sides.
    http_tokens = [_post_json(url, r)["result"]["choices"][0]["token_ids"]
                   for r in requests]
    counts = engine.options("counts").remote(None).result(timeout=60)
    _check_replica_counts(counts, config, f"{name} engine replica")
    out["engine_counts"] = counts
    if disaggregate:
        pc = prefill.options("counts").remote(None).result(timeout=60)
        out["prefill_counts"] = pc
        (stats,) = _replica_calls(f"{name}-engine", "engine_stats")
        out["handoffs_adopted"] = stats["handoffs_adopted"]
        if (pc["k5_launches"] or pc["runner_steps"] == 0
                or pc["k6_launches"] != config.n_layers * pc["runner_steps"]
                or stats["handoffs_adopted"] != len(requests)):
            raise AssertionError(f"{name}: prefill replica {pc}, engine "
                                 f"replica adopted {stats['handoffs_adopted']}")
    for n in (name, f"{name}-engine", f"{name}-prefill"):
        serve.delete(n)
    local = LLMServer(_engine_config(config, seed=SEED + 1))
    local_tokens = [local.completions(dict(r))["choices"][0]["token_ids"]
                    for r in requests]
    local.close()
    del local
    gc.collect()
    torch.cuda.empty_cache()
    out["fp32_identity_equal"] = http_tokens == local_tokens
    log(f"router: fp32 2-layer {name}: greedy tokens over HTTP == "
        f"in-process: {out['fp32_identity_equal']}; engine replica "
        f"{counts}" + (f"; prefill replica {out['prefill_counts']}, "
                       f"handoffs adopted {out['handoffs_adopted']}"
                       if disaggregate else ""))
    if not out["fp32_identity_equal"]:
        raise AssertionError(f"{name} fp32 identity:\n{http_tokens}\n"
                             f"{local_tokens}")
    return out


def _router_drain(torch, serving):
    """Two one-card Llama-3-8B bf16 replicas behind the router: five long
    requests POSTed concurrently, then drain_replica on a replica that is
    decoding; its live sessions move with their KV to the other one, every
    client gets a whole answer, and LLM_SESSION_MIGRATED reaches the GCS
    event ring."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.state import list_cluster_events

    config = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
    name = "router-drain"
    t0 = time.perf_counter()
    _routed_app(serving, _engine_config(
        config, seed=SEED, num_replicas=2, num_gpus_per_replica=1,
        routing="affinity"), name)
    out = {"deploy_s": time.perf_counter() - t0}
    host, port = serve.start_http_proxy()
    url = f"http://{host}:{port}/{name}"
    requests = [dict(prompt=p, max_tokens=256, request_id=f"drain-{i}",
                     session_id=f"drain-{i}")
                for i, p in enumerate(_prompts([40, 80, 120, 160, 200],
                                               config.vocab_size,
                                               SEED + 19))]
    record: dict = {}
    threads = [threading.Thread(target=_http_plain, args=(url, r, record))
               for r in requests]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 120
    while True:
        busy = [i for i, s in enumerate(_replica_calls(
            f"{name}-engine", "engine_stats")) if s["running"]]
        if busy:
            break
        if time.monotonic() > deadline:
            raise AssertionError("router drain: no replica decoding")
        time.sleep(0.05)
    t0 = time.perf_counter()
    summary = serve.get_deployment_handle(name).options(
        "drain_replica").remote(busy[0], reason="smoke").result(timeout=120)
    out["drain_s"] = time.perf_counter() - t0
    for th in threads:
        th.join(600)
    for r in requests:
        got = record.get(r["request_id"], {}).get("tokens")
        if got is None or len(got) != 256 or not all(
                0 <= t < config.vocab_size for t in got):
            raise AssertionError(f"router drain {r['request_id']}: {got}")
    deadline = time.monotonic() + 30
    while True:
        events = list_cluster_events(event_type="LLM_SESSION_MIGRATED")
        if events or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    out.update(migrated=summary["migrated"], replayed=summary["replayed"],
               target=summary["target"], drained=busy[0],
               event=events[0]["message"] if events else None)
    log(f"router: drain of replica {busy[0]} mid-decode in "
        f"{out['drain_s']:.2f} s: {len(summary['migrated'])} sessions "
        f"migrated with KV ({summary['migrated']}), "
        f"{len(summary['replayed'])} replayed, to replica "
        f"{summary['target']}; every client got 256 tokens; event "
        f"{out['event']!r}")
    if not summary["migrated"] or not events:
        raise AssertionError(f"router drain: {summary}, events {events}")
    for n in (name, f"{name}-engine"):
        serve.delete(n)
    return out


def _call_replica(handle, method, *args, timeout=300):
    import ray_tpu_torch as rt

    return rt.get(handle.handle_request.remote(method, list(args), {}),
                  timeout=timeout)


def _publish_until(replica, table, chain, config, seed, most=40):
    """Fillers of 700 tokens sent straight to `replica` until the table
    holds every block of `chain` (the replica's host tier demotes its
    parked blocks there); returns (fillers sent, seconds, lookup_owner)."""
    t0 = time.perf_counter()
    for n in range(1, most + 1):
        _call_replica(replica, "completions", dict(
            prompt=_prompts([700], config.vocab_size, seed + n)[0],
            max_tokens=1))
        deadline = time.monotonic() + 0.3
        while time.monotonic() < deadline:
            hit = table.lookup_owner(chain)
            if hit and hit["n_blocks"] == len(chain):
                return n, time.perf_counter() - t0, hit
            time.sleep(0.05)
    raise AssertionError(f"the table holds {table.lookup_owner(chain)} of "
                         f"{len(chain)} blocks after {most} fillers")


def _restart_replica(name, handle):
    """Kill one replica of deployment `name` and have the controller start
    another in its place; returns (seconds to the new replica, its
    handle)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import api as serve_api

    controller = serve_api._get_controller()
    n = len(rt.get(controller.get_replicas.remote(name),
                   timeout=60)["replicas"])
    t0 = time.perf_counter()
    rt.kill(handle)
    rt.get(controller.remove_replica.remote(
        name, bytes(handle._actor_id).hex()), timeout=60)
    rt.get(controller.scale_replicas.remote(name, n), timeout=600)
    new = [h for h in serve.get_deployment_handle(name).replica_handles()
           if h._actor_id != handle._actor_id]
    return time.perf_counter() - t0, new[-1]


def _replica_restart_leg(config, name):
    """(b) On the router phase's app: the engine replica publishes the
    shared-prefix leg's first prompt to the table under fillers, is killed,
    and the controller starts another; that one serves the prompt plus a
    new suffix by adopting its 32 blocks from the table (prefill of the
    suffix alone, K5 counted from 0 all graph replays)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.prefix_store import (ClusterPrefixStore,
                                                cluster_chain)

    engine_name = f"{name}-engine"
    prefix = _prompts([512] * 3, config.vocab_size, SEED + 17)[0]
    suffix = _prompts([16], config.vocab_size, SEED + 70)[0]
    request = dict(prompt=prefix + suffix, max_tokens=8)
    table = ClusterPrefixStore(16)
    chain = cluster_chain(prefix, 16)
    old = serve.get_deployment_handle(engine_name).replica_handles()[0]
    ref = _call_replica(old, "completions", dict(request))["choices"][0][
        "token_ids"]
    fillers, publish_s, hit = _publish_until(old, table, chain, config,
                                             SEED + 71)
    restart_s, new = _restart_replica(engine_name, old)
    _call_replica(new, "reset_counts", None)
    s0 = _call_replica(new, "engine_stats")
    t0 = time.perf_counter()
    got = _call_replica(new, "completions", dict(request))["choices"][0][
        "token_ids"]
    wall = time.perf_counter() - t0
    s1 = _call_replica(new, "engine_stats")
    counts = _call_replica(new, "counts", None)
    out = dict(fillers=fillers, publish_s=publish_s, owner_hint=hit,
               restart_s=restart_s, request_s=wall,
               adopted=(s1["cluster_prefix_adopted_blocks"]
                        - s0["cluster_prefix_adopted_blocks"]),
               computed=(s1["prefill_tokens_computed"]
                         - s0["prefill_tokens_computed"]),
               counts=counts, tokens_equal=sum(
                   a == b for a, b in zip(got, ref)), n_tokens=len(ref))
    log(f"router (b): the replica published the 512-token prompt's "
        f"{len(chain)} blocks after {fillers} fillers ({publish_s:.2f} s); "
        f"killed, a new replica up in {restart_s:.1f} s adopted "
        f"{out['adopted']} blocks and prefilled {out['computed']} tokens "
        f"of {len(request['prompt'])} ({wall * 1e3:.1f} ms for 8 tokens); "
        f"K5 {counts['k5_launches']} over {counts['ticks']} ticks; tokens "
        f"equal to the killed replica's at {out['tokens_equal']}/8")
    _check_replica_counts(counts, config, "router (b) new replica")
    if out["adopted"] != len(chain) or out["computed"] != len(suffix):
        raise AssertionError(f"router (b): {out}")
    return out, chain


def _router_cluster_legs(torch, serving):
    """(c) On 2+ cards: the 8B routed app with two one-card engine
    replicas on the default cluster store. A prompt's owner (the replica
    the router sent it to) publishes it under fillers; the router
    deployment is restarted (its owner LRU empty) and, while the owner is
    the busier replica, its next request on that prompt goes to the owner
    through `_cluster_affinity`; then the owner is killed: the router
    ejects it (blanking its owner hints) and replays the request on the
    survivor, which adopts the prompt from the table."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.prefix_store import (ClusterPrefixStore,
                                                cluster_chain)
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
    name = "router-cluster"
    _routed_app(serving, _engine_config(
        config, seed=SEED, num_replicas=2, num_gpus_per_replica=1,
        routing="affinity", host_prefix_mb=16 * _block_mib(config)), name)
    engine_name = f"{name}-engine"
    prefix = _prompts([512], config.vocab_size, SEED + 72)[0]
    table = ClusterPrefixStore(16)
    chain = cluster_chain(prefix, 16)

    def ask(tag, n_new=8):
        # A new handle each time: it finds the router replica in place now.
        r = dict(prompt=prefix + _prompts([16], config.vocab_size,
                                          SEED + 73 + len(tag))[0],
                 max_tokens=n_new, request_id=f"cluster-{tag}")
        return serve.get_deployment_handle(name).completions.remote(
            r).result(timeout_s=300)["choices"][0]["token_ids"]

    def stats():
        return _replica_calls(engine_name, "engine_stats")

    out: dict = {}
    s0 = stats()
    ask("first")
    s1 = stats()
    owner = max(range(2), key=lambda i: s1[i]["prefill_tokens_computed"]
                - s0[i]["prefill_tokens_computed"])
    other = 1 - owner
    handles = serve.get_deployment_handle(engine_name).replica_handles()
    fillers, publish_s, hit = _publish_until(handles[owner], table, chain,
                                             config, SEED + 74)
    if hit["owner_replica"] != s1[owner]["replica"]:
        raise AssertionError(f"router (c): owner hint {hit} is not "
                             f"replica {owner}'s {s1[owner]['replica']}")
    out.update(owner=owner, fillers=fillers, publish_s=publish_s)
    # A new router (empty owner LRU) while the owner is the busier one:
    # pow2 alone would pick the other replica.
    router_restart_s, _ = _restart_replica(
        name, serve.get_deployment_handle(name).replica_handles()[0])
    busy = threading.Thread(target=_call_replica, args=(
        handles[owner], "completions", dict(
            prompt=_prompts([64], config.vocab_size, SEED + 75)[0],
            max_tokens=400)))
    busy.start()
    deadline = time.monotonic() + 60
    while not stats()[owner]["running"]:
        if time.monotonic() > deadline:
            raise AssertionError("router (c): the owner never got busy")
        time.sleep(0.05)
    time.sleep(0.5)   # past the supervisor's stats TTL
    s2 = stats()
    ask("after-restart")
    s3 = stats()
    busy.join(600)
    routed = [s3[i]["prefill_tokens_computed"]
              - s2[i]["prefill_tokens_computed"] for i in range(2)]
    out.update(router_restart_s=router_restart_s,
               computed_after_restart=routed)
    if not routed[owner] or routed[other]:
        raise AssertionError(f"router (c): after the router's restart the "
                             f"request went elsewhere: prefill tokens "
                             f"computed per replica {routed}")
    # The owner dies: eject, purge of its hints, replay on the survivor,
    # which adopts from the table.
    rt.kill(handles[owner])
    sv0 = _call_replica(handles[other], "engine_stats")
    tokens = ask("after-kill")
    sv1 = _call_replica(handles[other], "engine_stats")
    adopted = (sv1["cluster_prefix_adopted_blocks"]
               - sv0["cluster_prefix_adopted_blocks"])
    hint = table.lookup_owner(chain)
    rstats = serve.get_deployment_handle(name).options(
        "router_stats").remote().result(timeout=60)
    out.update(survivor_adopted=adopted, hint_after=hint,
               router_stats=rstats, tokens=len(tokens))
    log(f"router (c): replica {owner} owned the 512-token prompt, "
        f"published after {fillers} fillers ({publish_s:.2f} s); a new "
        f"router ({router_restart_s:.1f} s) sent the prompt back to it "
        f"through the table's owner hint while it was the busier replica "
        f"(prefill tokens computed per replica {routed}); the owner killed, "
        f"the survivor adopted {adopted} blocks, table hint now "
        f"{hint}; router_stats {rstats}")
    if (adopted != len(chain) or len(tokens) != 8
            or (hint or {}).get("owner_replica") == s1[owner]["replica"]):
        raise AssertionError(f"router (c): {out}")
    for n in (name, engine_name):
        serve.delete(n)
    deadline = time.monotonic() + 30
    while table.lookup_owner(chain) and time.monotonic() < deadline:
        time.sleep(0.2)
    if table.lookup_owner(chain):
        raise AssertionError("router (c): rows left after serve.delete")
    return out


def phase_router(torch):
    """The LLM router front on the port's runtime on the card: Llama-3-8B
    served through build_openai_app(routing="affinity") behind the HTTP
    proxy, the LLMRouter deployment in front of a one-GPU replica."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import api
    from ray_tpu_torch.llm import serving
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import api as serve_api

    out: dict = {}
    inproc = RESULTS.get("server") or _in_process_mix(torch)
    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    rt.init(object_store_memory=1 << 30)
    try:
        session_dir = rt.get_runtime_context().session_dir
        store_path = api._head.store_path
        out["init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        controller = serve_api._get_controller()
        rt.get(controller.global_version.remote(), timeout=120)
        out["controller_up_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host, port = serve.start_http_proxy()
        out["proxy_up_s"] = time.perf_counter() - t0
        config = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16)
        # A host tier of 16 blocks: LLMConfig's default 32 MB at 8B.
        cfg = _engine_config(config, seed=SEED, num_replicas=1,
                             num_gpus_per_replica=1, routing="affinity",
                             host_prefix_mb=16 * _block_mib(config))
        name = "v1-router"
        t0 = time.perf_counter()
        _routed_app(serving, cfg, name)
        out["app_deploy_s"] = time.perf_counter() - t0
        out["deploy_parts"] = _deploy_parts(name)
        url = f"http://{host}:{port}/{name}"
        direct_url = f"http://{host}:{port}/{name}-engine"
        engine = serve.get_deployment_handle(f"{name}-engine")
        where = engine.options("where").remote(None).result(timeout=60)
        parts = out["deploy_parts"]
        log(f"router: init {out['init_s']:.2f} s; controller up "
            f"{out['controller_up_s']:.2f} s; proxy up "
            f"{out['proxy_up_s']:.2f} s; build_openai_app(routing="
            f"'affinity') {out['app_deploy_s']:.2f} s: engine tier "
            f"{parts[name + '-engine']}, router {parts[name]}; replica "
            f"{where}")
        if where["device_count"] != 1:
            raise AssertionError(f"replica sees {where['device_count']} cards")
        # One request down each route first, timed apart: the router
        # resolves its replicas on its first request, and the proxy looks
        # up each deployment once.
        first = {}
        for label, u in (("router", url), ("direct", direct_url)):
            warm = _mix_requests(config, f"first-{label}",
                                 seed=SEED + 13)[0]
            t0 = time.perf_counter()
            _http_plain(u, warm, {})
            first[label] = time.perf_counter() - t0
        out["first_request_s"] = first
        # The mix through the router, counts from 0 just before it; then
        # the same lengths from another seed straight to the engine
        # deployment (direct Serve, one actor hop less) in the same run.
        engine.options("reset_counts").remote(None).result(timeout=60)
        record, wall = _http_mix(url, _mix_requests(config, "greedy"),
                                 config, _http_plain)
        counts = engine.options("counts").remote(None).result(timeout=60)
        _check_replica_counts(counts, config, "router mix")
        direct, direct_wall = _http_mix(
            direct_url, _mix_requests(config, "direct", seed=SEED + 11),
            config, _http_plain)

        def tok_s(rec, w):
            n = sum(len(v["tokens"]) for v in rec.values())
            return dict(generated_tokens=n, wall_s=w,
                        generated_tok_s=n / w,
                        total_ms={k: round(v["total_s"] * 1e3, 1)
                                  for k, v in rec.items()})

        out["http_router"] = tok_s(record, wall)
        out["http_direct"] = tok_s(direct, direct_wall)
        out["replica_counts"] = counts
        out["in_process_mix"] = {k: inproc.get(k) for k in (
            "generated_tok_s", "ttft_ms", "itl_p50_ms", "itl_p99_ms",
            "ticks", "k5_launches")}
        out["serve_phase_http_plain"] = RESULTS.get("serve", {}).get(
            "http_plain", {}).get("generated_tok_s")
        r, d = out["http_router"], out["http_direct"]
        log(f"router: first request down each route (s) {first}; the mix "
            f"through the router {r['generated_tokens']} tokens in "
            f"{r['wall_s']:.2f} s ({r['generated_tok_s']:.1f} generated "
            f"tok/s, ms per request {r['total_ms']}); straight to the "
            f"engine deployment {d['generated_tok_s']:.1f} tok/s (ms per "
            f"request {d['total_ms']}); in-process "
            f"{inproc['generated_tok_s']:.1f} tok/s; K5 launches in the "
            f"replica {counts['k5_launches']} over {counts['ticks']} ticks "
            f"(= {counts['k5_launches'] / counts['ticks']:.1f}/tick), K6 "
            f"{counts['k6_launches']}, step_compiles "
            f"{counts['step_compiles']}")
        out["shared_prefix"] = _shared_prefix_leg(url, config, name)
        out["router_stats"] = serve.get_deployment_handle(name).options(
            "router_stats").remote().result(timeout=60)
        out["llm_serving_summary"] = _serving_summary()
        s = out["llm_serving_summary"]
        log(f"router: router_stats {out['router_stats']}; "
            f"llm_serving_summary: {s.get('replicas_reporting')} replica(s) "
            f"reporting, kv_total_blocks {s.get('kv_total_blocks')}, "
            f"tokens_generated_total {s.get('tokens_generated_total')}, "
            f"ttft_breakdown_ms {s.get('ttft_breakdown_ms')}")
        if s.get("replicas_reporting", 0) < 1:
            raise AssertionError(f"llm_serving_summary: {s}")
        out["restart"], chain = _replica_restart_leg(config, name)
        for n in (name, f"{name}-engine"):
            serve.delete(n)
        from ray_tpu_torch.llm.prefix_store import ClusterPrefixStore

        table = ClusterPrefixStore(16)
        deadline = time.monotonic() + 30
        while table.lookup_owner(chain) and time.monotonic() < deadline:
            time.sleep(0.2)
        left = table.lookup_owner(chain)
        log(f"router (b): after serve.delete the table holds {left} of "
            f"the deployment's rows")
        if left:
            raise AssertionError(f"router (b): rows left: {left}")
        gc.collect()
        torch.cuda.empty_cache()
        out["identity"] = _router_identity(torch, serving)
        if n_cards >= 2:
            out["drain"] = _router_drain(torch, serving)
            out["identity_disagg"] = _router_identity(torch, serving,
                                                      disaggregate=1)
            out["cluster"] = _router_cluster_legs(torch, serving)
        else:
            log("router: one card: the drain leg (two one-card replicas), "
                "the disaggregate=1 leg (a prefill replica beside the "
                "engine replica) and the cluster legs (c) skipped")
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    deadline = time.monotonic() + 60
    while True:
        procs = _runtime_processes(session_dir)
        shm = os.path.exists(store_path)
        if not procs and not shm:
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"after shutdown: processes {procs}, "
                                 f"store file {store_path} left: {shm}")
        time.sleep(0.5)
    out["clean_after_shutdown"] = True
    log(f"router: after serve.shutdown and shutdown no `python -m "
        f"ray_tpu_torch` process of session {session_dir} and no "
        f"{store_path} is left")
    RESULTS["router"] = out


# ------------------------------------------------------------- collective

DDP_STEPS = 3
DDP_BATCH = 4                 # sequences of 2048 tokens, split over ranks
DDP_BUCKET_BYTES = 32 << 20   # reduce_gradients' buckets on the card
_DIGEST_W: dict = {}


def _digest(torch, tensors) -> str:
    """A 128-bit digest of the tensors' bits, computed on their card: each
    element's bit pattern (int16/int32/int64 view, as int64) weighted by
    two seeded random int64 vectors, summed mod 2^64, chunk by chunk and
    tensor by tensor. Two tensors lists of different bits give equal
    digests with probability about 2^-64 per sum."""
    chunk = 1 << 22
    dev = tensors[0].device
    w = _DIGEST_W.get(str(dev))
    if w is None:
        g = torch.Generator(device=dev).manual_seed(SEED + 99)
        w = _DIGEST_W[str(dev)] = torch.randint(
            -(1 << 62), 1 << 62, (2, chunk), generator=g, dtype=torch.int64,
            device=dev)
    views = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    acc = torch.zeros(2, dtype=torch.int64, device=dev)
    for t in tensors:
        bits = t.detach().reshape(-1).view(views[t.element_size()])
        for off in range(0, bits.numel(), chunk):
            part = bits[off:off + chunk].to(torch.int64)
            acc = acc * 1000003 + (part[None, :] * w[:, :part.numel()]).sum(1)
    return "".join(f"{x & (2**64 - 1):016x}" for x in acc.tolist())


class DDPRank:
    """One data-parallel rank of the bench Llama (the collective phase).
    The driver holds rank 0 of leg (a) itself; the other ranks are
    one-GPU actors of this class (pickled by reference: workers import
    this file). Every rank builds the bench cell's state from SEED and the
    seeded 4 x 2048 batch, and trains on its share of the batch."""

    def __init__(self, world: int, rank: int, group: str, backend: str):
        import torch

        from ray_tpu_torch.train.optim import adamw
        from ray_tpu_torch.train.step import init_state

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.torch = torch
        self.world, self.rank, self.group = world, rank, group
        self.backend = backend
        self.config = _bench_train_config(torch)
        self.opt = adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
        self.state = init_state(self.config, self.opt, torch.Generator(
            device="cuda").manual_seed(SEED), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        self.batch = torch.randint(0, self.config.vocab_size,
                                   (DDP_BATCH, self.config.max_seq + 1),
                                   generator=gen, device="cuda")
        per = DDP_BATCH // world
        self.tokens = self.batch[rank * per:(rank + 1) * per]
        self.comm = None
        self.ref = None
        self.plane = None

    def info(self) -> dict:
        torch = self.torch
        return {"pid": os.getpid(), "device": torch.cuda.get_device_name(0),
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count()}

    def join(self) -> bool:
        from ray_tpu_torch import collective as col

        self.comm = col.init_collective_group(self.world, self.rank,
                                              self.backend, self.group)
        return True

    def _params(self):
        from ray_tpu_torch.train.optim import leaves

        return [p for _, p in leaves(self.state["params"])]

    def _grads(self, params, tokens):
        from ray_tpu_torch.models import llama

        loss, _ = llama.loss_fn(self.state["params"], {"tokens": tokens},
                                self.config)
        return loss, self.torch.autograd.grad(loss, params)

    def reference(self) -> dict:
        """One process's step over the whole batch from the same weights
        (a state of its own): its gradients and its parameters after the
        step, kept for step 1's check; then the ms of a second such step,
        the one-card step the data-parallel steps stand beside."""
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.train.optim import leaves
        from ray_tpu_torch.train.step import init_state, make_step

        torch = self.torch
        state = init_state(self.config, self.opt, torch.Generator(
            device="cuda").manual_seed(SEED), device="cuda")
        params = [p for _, p in leaves(state["params"])]
        loss, grads = llama.loss_fn(state["params"], {"tokens": self.batch},
                                    self.config)
        grads = torch.autograd.grad(loss, params)
        self.opt.update(state["params"], grads, state["opt"])
        self.ref = {"grads": [g.detach() for g in grads],
                    "params": [p.detach().clone() for p in params],
                    "loss": loss.item()}
        step = make_step(self.config, self.opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, self.batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        del state, params, grads
        gc.collect()
        torch.cuda.empty_cache()
        return {"loss": self.ref["loss"], "step_ms": ms}

    def _vs_reference(self, grads) -> dict:
        """Step 1 against one process's whole-batch step: each gradient
        leaf by norm, ||got - ref|| / ||ref||, and each parameter leaf by
        its largest difference over the leaf's largest value."""
        torch = self.torch
        g_err = max(((a.float() - b.float()).norm()
                     / b.float().norm().clamp(min=1e-30)).item()
                    for a, b in zip(grads, self.ref["grads"]))
        p_err = max(((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30)).item()
                    for a, b in zip(self._params(), self.ref["params"]))
        self.ref = None
        gc.collect()
        torch.cuda.empty_cache()
        return {"grad_rel_norm_err": g_err, "param_rel_err": p_err}

    def steps(self, n: int) -> dict:
        """n data-parallel steps: loss and gradients of this rank's share
        (flash K1-K4), reduce_gradients over the group (mean), the
        port's AdamW in place. The flash counts start at 0 here; per step
        its launches, ms by part and the digests of the parameters and of
        the whole train state."""
        from ray_tpu_torch.ops import attention as attn
        from ray_tpu_torch.train.backend import reduce_gradients

        torch = self.torch
        for k in FLASH_KERNELS:
            getattr(attn, k).launches = 0
        params = self._params()
        records = []
        for i in range(n):
            before = _flash_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = self._grads(params, self.tokens)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            reduced = reduce_gradients(self.comm, list(grads),
                                       bucket_bytes=DDP_BUCKET_BYTES)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            self.opt.update(self.state["params"], reduced,
                            self.state["opt"])
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            rec = {"loss": loss.item(), "step_ms": (t3 - t0) * 1e3,
                   "grad_ms": (t1 - t0) * 1e3, "reduce_ms": (t2 - t1) * 1e3,
                   "opt_ms": (t3 - t2) * 1e3,
                   "grad_bytes": sum(g.numel() * g.element_size()
                                     for g in grads),
                   "flash": {k: v - before[k]
                             for k, v in _flash_counts().items()},
                   "params_digest": _digest(torch, params),
                   "state_digest": _digest(torch, params
                                           + self.state["opt"]["mu"]
                                           + self.state["opt"]["nu"])}
            if i == 0 and self.ref is not None:
                rec.update(self._vs_reference(reduced))
            del grads, reduced
            records.append(rec)
        return {"records": records, "launches": _flash_counts()}

    def allreduce_ms(self, nbytes: int, iters: int = 3) -> float:
        """ms of one allreduce (sum) of `nbytes` of bf16 on this group, a
        single op (no buckets), after a warm one."""
        torch = self.torch
        buf = torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
        self.comm.allreduce(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            self.comm.allreduce(buf)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    def blocked_allreduce(self):
        """An allreduce that another rank never joins: (time.time() when
        CollectiveAbortError came, its message)."""
        from ray_tpu_torch.core.exceptions import CollectiveAbortError

        try:
            self.comm.allreduce(self.torch.ones(1024, device="cuda"))
        except CollectiveAbortError as e:
            return time.time(), str(e)
        return None, "the allreduce returned"

    def leave(self) -> None:
        from ray_tpu_torch import collective as col

        col.destroy_collective_group(self.group)
        self.comm = None

    def save(self, directory: str, step: int) -> dict:
        """This rank's shard of the train state through a CheckpointPlane
        (replication from cfg().ckpt_replicate), waited for; the handle's
        info and replica, and the replica's ref (in a list, so it
        travels as a ref)."""
        from ray_tpu_torch.checkpoint import CheckpointPlane

        self.plane = CheckpointPlane()
        t0 = time.perf_counter()
        p = self.plane.save_async(self.state, directory, rank=self.rank,
                                  world=self.world, step=step)
        if not p.wait(600) or not p.ok:
            raise AssertionError(f"rank {self.rank} save: {p.info()}")
        refs = list(self.plane._replica_refs)
        return {"info": p.info(), "replica": p.replica,
                "wall_ms": (time.perf_counter() - t0) * 1e3,
                "refs": refs[-1:]}


def _raw_allreduce(rank, world, nbytes, iters):
    """A parallel/launch.spawn rank: ms of torch.distributed.all_reduce of
    `nbytes` of bf16 on the world's NCCL group (the library yardstick)."""
    import torch
    import torch.distributed as dist

    buf = torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
    for _ in range(2):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _all(ranks, method, *args, timeout=900):
    """`method(*args)` on every rank at once: actors' calls launched
    first, the driver's own rank (a DDPRank) run here; results in rank
    order."""
    import ray_tpu_torch as rt

    refs = [(i, getattr(r, method).remote(*args)) for i, r in
            enumerate(ranks) if not isinstance(r, DDPRank)]
    local = {i: getattr(r, method)(*args) for i, r in enumerate(ranks)
             if isinstance(r, DDPRank)}
    got = dict(zip([i for i, _ in refs],
                   rt.get([ref for _, ref in refs], timeout=timeout)))
    return [local[i] if i in local else got[i] for i in range(len(ranks))]


def _ddp_leg(torch, rt, ranks, label, ref_step, config):
    """3 steps on `ranks`; the checks and numbers of a data-parallel leg."""
    L = config.n_layers
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    t0 = time.perf_counter()
    runs = _all(ranks, "steps", DDP_STEPS)
    wall = time.perf_counter() - t0
    for i in range(DDP_STEPS):
        digests = {(r["records"][i]["params_digest"],
                    r["records"][i]["state_digest"]) for r in runs}
        if len(digests) != 1:
            raise AssertionError(f"{label} step {i + 1}: ranks' digests "
                                 f"differ: {digests}")
    first = runs[0]["records"][0]
    tol = GRAD_TOLERANCE["bfloat16"]
    if not (first["grad_rel_norm_err"] <= tol
            and first["param_rel_err"] <= tol):
        raise AssertionError(f"{label} step 1 vs one process's whole-batch "
                             f"step: {first} (tolerance {tol})")
    for r, run in enumerate(runs):
        for i, rec in enumerate(run["records"]):
            if rec["flash"] != per_step or not math.isfinite(rec["loss"]):
                raise AssertionError(f"{label} rank {r} step {i + 1}: {rec}")
    out = {"world": len(ranks), "wall_s": wall,
           "vs_reference": {k: first[k] for k in (
               "grad_rel_norm_err", "param_rel_err")},
           "one_card_step_ms": ref_step["step_ms"],
           "ranks": [], "launches": [run["launches"] for run in runs]}
    for r, run in enumerate(runs):
        recs = run["records"]
        timed = recs[1:]          # step 1 builds buckets and links
        step_ms = sum(x["step_ms"] for x in timed) / len(timed)
        reduce_ms = sum(x["reduce_ms"] for x in timed) / len(timed)
        gbytes = recs[0]["grad_bytes"]
        out["ranks"].append({
            "step_ms": [x["step_ms"] for x in recs],
            "grad_ms": [x["grad_ms"] for x in recs],
            "reduce_ms": [x["reduce_ms"] for x in recs],
            "opt_ms": [x["opt_ms"] for x in recs],
            "loss": [x["loss"] for x in recs], "grad_bytes": gbytes,
            "reduce_gb_s": gbytes / reduce_ms / 1e6,
            "reduce_share": reduce_ms / step_ms,
            "flash_per_step": recs[-1]["flash"]})
        log(f"collective {label} rank {r}: steps "
            + ", ".join(f"{x['step_ms']:.1f}" for x in recs)
            + " ms (grad, reduce, AdamW: " + "; ".join(
                f"{x['grad_ms']:.1f}, {x['reduce_ms']:.1f}, "
                f"{x['opt_ms']:.1f}" for x in recs) + "); "
            f"{gbytes / 1e9:.3f} GB of bf16 gradients a step at "
            f"{gbytes / reduce_ms / 1e6:.2f} GB/s (steps 2-{DDP_STEPS}), "
            f"{reduce_ms / step_ms:.1%} of the step; flash launches a step "
            f"{recs[-1]['flash']}; losses "
            + ", ".join(f"{x['loss']:.4f}" for x in recs))
    log(f"collective {label}: {len(ranks)} ranks' parameter and AdamW "
        f"digests equal after each of {DDP_STEPS} steps; step 1 vs one "
        f"process's whole-batch step: gradients {first['grad_rel_norm_err']:.2e}"
        f" by norm, parameters {first['param_rel_err']:.2e} of each leaf's "
        f"max (tolerance {tol}); one card's whole-batch step "
        f"{ref_step['step_ms']:.1f} ms; {RESULTS.get('nvidia_smi')}")
    return out


def _abort_leg(rt, blocked_rank, group, label, member=False):
    """A rank blocked in an allreduce that another never joins, then
    abort_collective_group from this process (a member of the group, or
    not): seconds from the call to the blocked rank's
    CollectiveAbortError, against 2 watchdog intervals + 0.5 s."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.config import cfg

    waiting = blocked_rank.blocked_allreduce.remote()
    ready, _ = rt.wait([waiting], num_returns=1, timeout=2.0)
    if ready:
        raise AssertionError(f"{label}: the allreduce returned with a rank "
                             f"withheld: {rt.get(waiting)}")
    t_abort = time.time()
    col.abort_collective_group(group, f"{label}: the driver aborts")
    t_raised, msg = rt.get(waiting, timeout=60)
    bound = 2 * cfg().collective_watchdog_interval_s + 0.5
    if t_raised is None or t_raised - t_abort > bound:
        raise AssertionError(f"{label}: {msg} after {t_raised} (abort at "
                             f"{t_abort}, bound {bound} s)")
    log(f"collective {label}: the blocked rank raised CollectiveAbortError "
        f"{t_raised - t_abort:.3f} s after abort_collective_group (bound "
        f"{bound:.1f} s): {msg}")
    return {"abort_to_raise_s": t_raised - t_abort, "bound_s": bound,
            "member": member}


def _replication_leg(torch, rt, ranks, directory, core, node_b):
    """(d) both ranks save the train state at world 2 with replication;
    rows, homes, a restore from the replicas' bytes alone."""
    from ray_tpu_torch.checkpoint import manifest as tman

    t0 = time.perf_counter()
    saves = _all(ranks, "save", directory, DDP_STEPS, timeout=900)
    wall = (time.perf_counter() - t0) * 1e3
    rows = core.io.run(core.gcs.call("list_checkpoint_shards",
                                     path=os.path.abspath(directory)),
                       timeout=60)
    if [r["shard"] for r in rows] != [0, 1]:
        raise AssertionError(f"replication rows: {rows}")
    if not saves[0]["info"]["committed"]:
        raise AssertionError(f"rank 0's save not committed: {saves[0]}")
    out = {"rows": [], "save_wall_ms": wall}
    for row, sv in zip(rows, saves):
        rep = sv["replica"]
        if rep is None or row["oids"] != [rep["oid"]]:
            raise AssertionError(f"rank {row['shard']}: replica {rep} vs "
                                 f"row {row}")
        loc = core.io.run(core.gcs.call("locate_object", oid=bytes.fromhex(
            rep["oid"])), timeout=60)
        if not loc["found"] or loc["node_id"] != node_b:
            raise AssertionError(f"replica of shard {row['shard']} homed "
                                 f"at {loc}, not node B")
        npz = os.path.join(directory, tman.shard_npz("state", row["shard"],
                                                     2))
        info = sv["info"]
        # The persist includes the replication (it runs before the
        # commit): the plane's own write is the rest.
        write_ms = info["persist_ms"] - rep["ms"]
        out["rows"].append({
            "shard": row["shard"], "nbytes": row["nbytes"],
            "replica_ms": rep["ms"], "replica_parts_ms": rep["parts_ms"],
            "persist_ms": info["persist_ms"], "write_ms": write_ms,
            "replica_gb_s": rep["bytes"] / rep["ms"] / 1e6,
            "save_gb_s": os.path.getsize(npz) / write_ms / 1e6,
            "nodes_covered": rep["nodes"]})
    # The shard files go; the replicas' bytes come back through the
    # object plane and are written where the shards were.
    refs = [sv["refs"][0] for sv in saves]
    t0 = time.perf_counter()
    for row in rows:
        os.remove(os.path.join(directory,
                               tman.shard_npz("state", row["shard"], 2)))
    for row, ref in zip(rows, refs):
        data = rt.get(ref, timeout=300)
        with open(os.path.join(directory, tman.shard_npz(
                "state", row["shard"], 2)), "wb") as f:
            f.write(memoryview(data))
    restored = _restored_state(torch, directory)
    torch.cuda.synchronize()
    out["restore_from_replicas_ms"] = (time.perf_counter() - t0) * 1e3
    from ray_tpu_torch.train.optim import leaves

    def tensors(state):
        return leaves({"params": state["params"], "mu": state["opt"]["mu"],
                       "nu": state["opt"]["nu"]})

    saved = ranks[0].state
    want = tensors(saved)
    got = dict(tensors(restored))
    for path, t in want:
        g = got[path]
        if not (g.dtype == t.dtype and torch.equal(
                g.reshape(-1).view(torch.uint8),
                t.detach().reshape(-1).view(torch.uint8))):
            raise AssertionError(f"restored {path} differs from the saved "
                                 "state")
    if restored["opt"]["count"] != saved["opt"]["count"]:
        raise AssertionError(f"restored count {restored['opt']['count']}")
    out["restored_bit_equal"] = True
    del restored
    for r in out["rows"]:
        log(f"collective (d) shard {r['shard']}: {r['nbytes'] / 1e9:.3f} GB "
            f"replicated to {r['nodes_covered']} node(s) in "
            f"{r['replica_ms']:.0f} ms ({r['replica_gb_s']:.3f} GB/s; ms "
            + ", ".join(f"{k} {v:.0f}" for k, v in
                        r["replica_parts_ms"].items())
            + f") beside the plane's own write {r['write_ms']:.0f} ms "
            f"({r['save_gb_s']:.3f} GB/s); row registered, replica homed "
            "on node B")
    log(f"collective (d): with both shard files deleted, the train state "
        f"restored from the replicas' bytes in "
        f"{out['restore_from_replicas_ms']:.0f} ms equals the saved state "
        f"bit for bit ({len(want)} leaves); {RESULTS.get('nvidia_smi')}")
    return out


def phase_collective(torch):
    """The collective group and checkpoint replication on the card
    (ROADMAP queue 1 item 7d): see the module docstring, phase
    `collective`."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster, session_pids
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.parallel.launch import spawn

    import chip_smoke as this   # actor bodies pickled by reference

    _SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    config = _bench_train_config(torch)
    out: dict = {"cards": n_cards}
    # A 2.8 GB shard's relay took 30-35 s on H100 hosts: past half the
    # default 60 s bound (a replication that times out fails silently).
    settings = {"ckpt_replicate": True, "ckpt_replicate_timeout_s": 300.0}
    # The train state is params + AdamW mu and nu in bf16; each rank's
    # shard is half of it, and both shards' replicas sit in node A's store
    # (their puts) and in node B's (the relay).
    state_bytes = 3 * 2 * _n_params(config)
    # Below the raylets' spill watermark (0.85 full) with both shards in.
    store = int(state_bytes * 1.4) + (256 << 20)
    shm = os.statvfs("/dev/shm")
    shm_free = shm.f_bavail * shm.f_frsize
    log(f"collective: train state {state_bytes / 1e9:.3f} GB; two stores "
        f"of {store / 2**30:.2f} GiB in /dev/shm ({shm_free / 2**30:.1f} "
        "GiB free)")
    if shm_free < 2 * store + (2 << 30):
        raise AssertionError("/dev/shm cannot hold two stores of the train "
                             "state")
    cluster = Cluster(system_config=settings)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_collective_")
    ranks = []
    try:
        node_a = cluster.add_node(num_cpus=8, num_gpus=n_cards,
                                  object_store_memory=store)
        node_b = cluster.add_node(num_cpus=1, object_store_memory=store)
        rt.init(address=cluster.address, _system_config=settings)
        cluster.wait_for_nodes(2, timeout=60)
        core = worker_mod.global_worker()
        if core.node_id != node_a.node_id:
            raise AssertionError("the driver is not on node A")
        Rank = rt.remote(this.DDPRank)

        # (a) one card: this process is rank 0, a one-GPU actor rank 1.
        t0 = time.perf_counter()
        actor = Rank.options(num_gpus=1, num_cpus=1).remote(
            2, 1, "ddp-tcp", "tcp")
        local = DDPRank(2, 0, "ddp-tcp", "tcp")
        ranks = [local, actor]
        info = rt.get(actor.info.remote(), timeout=600)
        out["actor_up_s"] = time.perf_counter() - t0
        log(f"collective (a): rank 1 up in {out['actor_up_s']:.1f} s on "
            f"{info['device']} (CUDA_VISIBLE_DEVICES="
            f"{info['cuda_visible_devices']})")
        _all(ranks, "join")
        ref_step = local.reference()
        out["tcp"] = _ddp_leg(torch, rt, ranks, "(a) tcp", ref_step, config)
        # (c) the tcp group: rank 1 blocked, this process aborts it.
        out["abort_tcp"] = _abort_leg(rt, actor, "ddp-tcp", "(c) tcp",
                                      member=True)
        _all(ranks, "leave")
        # (d) replication of both ranks' shards.
        out["replication"] = _replication_leg(
            torch, rt, ranks, os.path.join(tmp, "ckpt"), core,
            node_b.node_id)
        rt.kill(actor)
        ranks = []
        del local
        gc.collect()
        torch.cuda.empty_cache()

        # (b) 2+ cards: the torch backend (NCCL) between one-GPU actors.
        if n_cards >= 2:
            world = 4 if n_cards >= 4 else 2
            t0 = time.perf_counter()
            ranks = [Rank.options(num_gpus=1, num_cpus=1).remote(
                world, r, "ddp-nccl", "torch") for r in range(world)]
            infos = _all(ranks, "info")
            out["nccl_actors_up_s"] = time.perf_counter() - t0
            if len({i["cuda_visible_devices"] for i in infos}) != world:
                raise AssertionError(f"ranks share a card: {infos}")
            _all(ranks, "join")
            ref_step = rt.get(ranks[0].reference.remote(), timeout=900)
            leg = _ddp_leg(torch, rt, ranks, f"(b) nccl x{world}", ref_step,
                           config)
            nbytes = leg["ranks"][0]["grad_bytes"]
            backend_ms = _all(ranks, "allreduce_ms", nbytes)
            raw_ms = spawn(this._raw_allreduce, world, nbytes, 3,
                           device="cuda", timeout=600)
            bus = 2 * (world - 1) / world
            leg["allreduce"] = {
                "bytes": nbytes, "backend_ms": backend_ms, "raw_ms": raw_ms,
                "backend_gb_s": nbytes / max(backend_ms) / 1e6,
                "raw_gb_s": nbytes / max(raw_ms) / 1e6,
                "backend_bus_gb_s": bus * nbytes / max(backend_ms) / 1e6,
                "raw_bus_gb_s": bus * nbytes / max(raw_ms) / 1e6}
            a = leg["allreduce"]
            log(f"collective (b) nccl x{world}: one allreduce of "
                f"{nbytes / 1e9:.3f} GB bf16 {max(backend_ms):.2f} ms "
                f"through the torch backend ({a['backend_gb_s']:.1f} GB/s, "
                f"bus {a['backend_bus_gb_s']:.1f}) beside "
                f"torch.distributed.all_reduce in a spawn world "
                f"{max(raw_ms):.2f} ms ({a['raw_gb_s']:.1f} GB/s, bus "
                f"{a['raw_bus_gb_s']:.1f}); data-parallel step "
                f"{sum(leg['ranks'][0]['step_ms'][1:]) / (DDP_STEPS - 1):.1f}"
                f" ms against one card's whole-batch step "
                f"{ref_step['step_ms']:.1f} ms; {RESULTS.get('nvidia_smi')}")
            out["nccl"] = leg
            out["abort_nccl"] = _abort_leg(rt, ranks[1], "ddp-nccl",
                                           "(c) nccl")
            for r in ranks:
                rt.kill(r)
            ranks = []
        else:
            log(f"collective (b): {n_cards} card(s) on this machine; the "
                "NCCL leg needs 2 or more and did not run")
    finally:
        for r in ranks:
            if not isinstance(r, DDPRank):
                try:
                    rt.kill(r)
                except Exception:
                    pass
        try:
            rt.shutdown()
        finally:
            cluster.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)
    left = session_pids(cluster.session_dir)
    stores = [n for n in (node_a.store_path, node_b.store_path)
              if os.path.exists(n)]
    if left or stores:
        raise AssertionError(f"collective: processes {left}, stores "
                             f"{stores} left after shutdown")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"collective: phase wall {out['wall_s']:.1f} s; no process of the "
        f"session and no store file left; {RESULTS.get('nvidia_smi')}")
    RESULTS["collective"] = out


def _n_params(config) -> int:
    """Parameters of a Llama config, as llama.init_params lays them out."""
    from ray_tpu_torch.models import llama

    d, v, L = config.d_model, config.vocab_size, config.n_layers
    return 2 * v * d + d + L * sum(
        math.prod(shape) for shape, _ in llama.layer_shapes(config).values())


def kernels_line() -> dict:
    """The machine-readable kernel summary, one entry per kernel: headline
    numbers from its bf16 case at the main path's own shape (K5: the
    server tick, tick_136; K6: the split decode, split_decode; the flash
    kernels: the train step's shape, train and train_bwd), worst error
    over all its cases. `launches` is the count of the run that drives the
    kernel's path (server phase for K5, split phase for K6, the bench
    train run for the flash kernels; counts reset to 0 just before each
    run), null when that phase did not run; `launches_tp_per_rank` (K5,
    K6) each rank's count on the tp phase's largest world (the mix for K5,
    the split identity run for K6); `launches_disagg` (K5, K6) each
    tier's count in the disagg phase, the prefill tier's and the decode
    server's runs each from 0; `launches_pipeline` (flash) a step of the
    pipeline phase's bench cell, plain and interleaved; `launches_rlhf`
    (K5) each rollout round of the rlhf loop (replays),
    `launches_runtime_actor` (K5) the runtime phase's mix, counted inside
    the one-GPU actor that serves it, `launches_serve_replica` (K5) the
    serve phase's HTTP mix, counted inside its one-GPU replica,
    `launches_router_replica` (K5) the router phase's mix through the
    LLMRouter, counted inside the engine replica, and with 2+ cards its
    fp32 disaggregated app's counts inside the engine replica
    (`launches_router_disagg_engine`, K5) and the prefill replica
    (`launches_router_prefill`, K6), `launches_prefix_survivor` (K5) the
    prefix_store phase's 8B survivor serving the adopted prompt, counted
    from 0, `launches_rlhf_update` (flash) one learner update,
    `launches_collective` (flash) each rank's launches in one
    data-parallel step of the collective phase, over tcp and NCCL. `ms` is eager, host
    included; `graph_ms` (K5/K6) the device time alone. `cuda_kernel` names the
    `__global__` functions the bf16 case launches, as profiles show them."""
    rows = RESULTS.get("kernel_cases", [])
    train = RESULTS.get("train", {}).get("bench", {}).get("launches", {})

    tp = RESULTS.get("tp", {})
    tp_top = tp.get("serving", {}).get(max(tp.get("sizes") or [0]), {})
    tp_split = tp.get("identity", {}).get(
        f"split_{max(tp.get('sizes') or [0])}_launches")

    tiers = RESULTS.get("disagg", {}).get("launches")
    pipe = RESULTS.get("pipeline", {}).get("bench", {})
    rlhf = RESULTS.get("rlhf", {}).get("loop", {}).get("iterations", [])
    coll = RESULTS.get("collective", {})

    def flash_paths(kernel):
        return {"launches_pipeline": {
            v: pipe[v]["launches_per_step"][kernel] for v in
            ("plain", "interleaved") if "launches_per_step" in pipe.get(
                v, {})} or None,
            "launches_rlhf_update": (rlhf[0]["flash_per_update"][kernel]
                                     if rlhf else None),
            "launches_collective": {
                leg: [r["flash_per_step"][kernel] for r in coll[leg]["ranks"]]
                for leg in ("tcp", "nccl") if leg in coll} or None}

    def entry(kernel, name, cuda_kernel, source, replaces, head_case,
              launches, launches_tp=None, col=None, **paths):
        mine = [r for r in rows if r["kernel"] == kernel]
        head = next((r for r in mine if r["case"] == head_case
                     and r["dtype"] == "bfloat16"), {})
        return {
            "name": name, "route": "cuda", "cuda_kernel": cuda_kernel,
            "source": f"ray_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max((r["max_abs_err"] for r in mine),
                               default=None),
            "ms": head.get("kernel_ms"), "graph_ms": head.get("graph_ms"),
            "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms"),
            "launches_tp_per_rank": launches_tp,
            "launches_disagg": ({"prefill_tier": tiers["prefill"][col],
                                 "decode_server": tiers["decode"][col]}
                                if tiers and col is not None else None),
            **paths}

    attn = "ray_tpu/ops/attention.py"
    return {"kernels": [
        entry("K5", "ragged_paged_attention_unified",
              "rua_tile_kernel (+ rua_merge_kernel when split); fp32: "
              "rua_kernel",
              "paged_attention.cu",
              "ray_tpu/ops/paged_attention.py:177", "tick_136",
              RESULTS.get("server", {}).get("k5_launches"),
              [r[0] for r in tp_top.get("launches_per_rank", [])] or None,
              col=0, launches_rlhf=[it["k5_launches"] for it in rlhf]
              or None, launches_runtime_actor=RESULTS.get(
                  "runtime", {}).get("actor_mix", {}).get("k5_launches"),
              launches_serve_replica=RESULTS.get("serve", {}).get(
                  "replica_counts", {}).get("k5_launches"),
              launches_router_replica=RESULTS.get("router", {}).get(
                  "replica_counts", {}).get("k5_launches"),
              launches_router_disagg_engine=RESULTS.get("router", {}).get(
                  "identity_disagg", {}).get("engine_counts", {}).get(
                  "k5_launches"),
              launches_prefix_survivor=RESULTS.get("prefix_store", {}).get(
                  "survivor_counts", {}).get("k5_launches")),
        entry("K6", "ragged_paged_attention",
              "rpa_tile_kernel (+ rpa_merge_kernel when split); fp32: "
              "rpa_kernel",
              "paged_attention.cu",
              "ray_tpu/ops/paged_attention.py:69", "split_decode",
              RESULTS.get("split", {}).get("k6_launches"),
              [r[1] for r in tp_split] if tp_split else None, col=1,
              launches_router_prefill=RESULTS.get("router", {}).get(
                  "identity_disagg", {}).get("prefill_counts", {}).get(
                  "k6_launches")),
        entry("flash_fwd", "flash_fwd", "flash_fwd_wgmma_kernel",
              "flash_attention.cu",
              f"{attn}:520 (K1), {attn}:553 (K2)", "train",
              train.get("flash_fwd"), **flash_paths("flash_fwd")),
        entry("flash_bwd_dq", "flash_bwd_dq", "flash_bwd_dq_wgmma_kernel",
              "flash_attention.cu",
              f"{attn}:616 (K3 dQ), {attn}:738 (K4 dQ)", "train_bwd",
              train.get("flash_bwd_dq"), **flash_paths("flash_bwd_dq")),
        entry("flash_bwd_dkv", "flash_bwd_dkv", "flash_bwd_dkv_wgmma_kernel",
              "flash_attention.cu",
              f"{attn}:634 (K3 dK/dV), {attn}:771 (K4 dK/dV)", "train_bwd",
              train.get("flash_bwd_dkv"), **flash_paths("flash_bwd_dkv"))]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--out", help="also write all results as JSON here")
    ap.add_argument("--turns", help="comma-separated trees, each holding "
                    "a ray_tpu_torch package: time their bf16 kernels at "
                    + ", ".join(_turn_label(*c) for c in TURN_CASES)
                    + " in this order")
    ap.add_argument("--turn-legs", default="kernels",
                    help="with --turns: comma-separated legs, 'kernels' "
                    "(TURN_CASES), 'server' (the server mix three "
                    "times and decode walls) and/or 'promote' (the host "
                    "tier's promotion), each tree in a new process")
    ap.add_argument("--turn-in", help=argparse.SUPPRESS)
    ap.add_argument("--tp-leg", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import faulthandler

    # A crash (SIGSEGV, SIGABRT) prints every thread's Python stack.
    faulthandler.enable(all_threads=True)
    if args.turn_in:
        sys.path.insert(0, os.path.abspath(args.turn_in))
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    legs = [x for x in args.turn_legs.split(",") if x]
    if set(legs) - {"kernels", "server", "promote"}:
        ap.error(f"unknown turn legs {legs}")

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
        if "kernels" in legs:
            _turn_times(torch)
        if "server" in legs:
            _turn_server(torch)
        if "promote" in legs:
            _turn_promote(torch)
        return 0
    if args.tp_leg:
        name, leg_args, out = json.loads(args.tp_leg)
        with open(out, "w") as f:
            json.dump(globals()[name](torch, *leg_args), f)
        return 0
    if args.turns:
        run_turns(args.turns.split(","), legs)
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
