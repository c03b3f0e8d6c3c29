"""The port's CUDA kernels on the card (marker `cuda`; skips without one).

Run on a machine with an NVIDIA GPU:
    python -m pytest tests/test_torch_cuda.py -q -m cuda
The K5 and K6 kernels (csrc/paged_attention.cu) and the three flash
kernels (csrc/flash_attention.cu) must agree with their plain PyTorch
versions on the same inputs, fp32 rtol = atol = 1e-5 (gradients 1e-4),
bf16 2e-2, K5 and K6 also by norm (||got - ref|| / ||ref|| within half
that), and count their launches; K5 and K6 over GQA groups 1 to 32,
head dims 64 and 128, a page size of 12, tiles that start mid-sequence
and contexts over several key splits, bitwise the same from run to run;
the unified engine goes through K5 on every tick, each tick one replay
of its token bucket's CUDA graph that equals the eager step and counts
its launches, the split engine through K6 on every runner step, and its
decode dispatch never synchronises with the device; a train step
launches the flash kernels once or twice per layer, as its remat policy
says; a head-dim-96 engine runs the plain versions on the card, as the
JAX runner runs its reference there, and attention at head dim 256, where
the JAX rule runs a Pallas kernel the port lacks, raises. A
mixed-adapter LoRA step replays its graph as the eager step computes it,
the split path with adapters gives the unified engine's tokens, a
replay after `load_adapter` or `update_weights` reads the new values,
`resize` captures once, and pages gathered off the card scatter back
byte-exactly. The ring's chunk steps and merges equal whole-sequence
flash attention, and a train step on a one-rank NCCL mesh equals the
single-card step; one process starts and closes tensor-parallel worlds
of 2 and 4 ranks one after another, and a tensor_parallel=2 server takes
live migrations, a prefill handoff and a cluster-table adoption with one
card's tokens. A pipeline with stages on cuda:0 and the last card
equals the single-card step and launches the flash kernels as its
schedule says.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, dtype, q_lens, kv_lens, T, K=2, H=8, hd=64, ps=16,
          max_pages=8):
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    P = 1 + S * max_pages
    tables = rng.permutation(S * max_pages).reshape(S, max_pages) + 1
    cu = np.concatenate([[0], np.cumsum(q_lens)])
    kv = np.asarray(kv_lens)
    qp = np.maximum(kv - np.asarray(q_lens), 0)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    i = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.int32)).to("cuda")
    return (f(T, H, hd), f(K, P, ps, hd), f(K, P, ps, hd), i(tables), i(kv),
            i(qp), i(cu))


def _pages_for(kv_lens, ps):
    return max(1, -(-max(kv_lens) // ps)) + 1


def _assert_paged_close(got, want, tol):
    """Elementwise within tol, and as a whole within tol / 2 in the
    Frobenius norm: where |out| is near tol (contexts of thousands of
    keys) a dropped ring stage can pass elementwise, not by norm."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= tol / 2, rel


# K5 cases: name, (H, K), hd, ps, q_lens, kv_lens, T. G = H/K is 1, 4, 8
# and 32 (bf16 tiles of 64, 16, 8 and 2 query rows); page size 12 is no
# multiple of 16; the 128-row chunk starts at flat row 1, so its 16-row
# tiles straddle flat multiples of 16 and each tile's rows have 16
# different causal limits; 600-1000-key contexts span several 256-key
# splits; in "adjacent" three sequences of 5, 7 and 3 rows lie inside
# what one 16-row tile would cover, and each must get its own tiles.
UNIFIED_CASES = [
    ("base", (8, 2), 64, 16, [1, 0, 37, 5], [600, 0, 37, 300], 48),
    ("g1_hd128", (4, 4), 128, 16, [1, 70, 3], [900, 70, 260], 80),
    ("g8_ps12", (16, 2), 64, 12, [2, 20, 1], [500, 20, 37], 24),
    ("g32_hd128", (32, 1), 128, 16, [3, 1, 4], [300, 1000, 4], 8),
    ("chunk128_ps12", (8, 2), 128, 12, [1, 128, 1], [700, 400, 33], 136),
    ("adjacent", (8, 2), 64, 16, [5, 7, 3], [5, 40, 90], 16),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name,heads,hd,ps,q_lens,kv_lens,T", UNIFIED_CASES,
                         ids=[c[0] for c in UNIFIED_CASES])
def test_kernel_matches_plain_version(cuda, dtype, tol, name, heads, hd, ps,
                                      q_lens, kv_lens, T):
    """K5 against its plain version on the valid rows (elementwise and by
    norm), exact zeros on the padding rows past cu_q_lens[S]."""
    from ray_tpu_torch.ops import paged_attention as pa

    H, K = heads
    args = _case(0, dtype, q_lens, kv_lens, T, K=K, H=H, hd=hd, ps=ps,
                 max_pages=_pages_for(kv_lens, ps))
    n = sum(q_lens)
    before = pa.ragged_paged_attention_unified.launches
    out = pa.ragged_paged_attention_unified(*args)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention_unified.launches == before + 1
    ref = pa.ragged_paged_attention_unified_reference(*args)
    _assert_paged_close(out[:n], ref[:n], tol)
    assert (out[n:] == 0).all()


def test_engine_ticks_launch_kernel(cuda):
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import paged_attention as pa

    config = llama.LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2,
                                    dtype=torch.float32)
    engine = build_engine(LLMConfig(model_config=config, block_size=16,
                                    num_kv_blocks=64, max_batch_size=4,
                                    prefill_chunk=32, device=cuda))
    pa.ragged_paged_attention_unified.launches = 0
    outs = engine.generate([[1, 2, 3] * 20, [7, 8]],
                           SamplingParams(max_tokens=5))
    assert all(len(o.output_token_ids) == 5 for o in outs)
    assert pa.ragged_paged_attention_unified.launches == \
        config.n_layers * engine.ticks


def _runner_pair(cuda, dtype, num_blocks=24):
    """A graphed and an eager (cuda_graphs=False) runner on the same
    seeded weights (head dim 64: K5) whose pools hold the same random
    pages."""
    from ray_tpu_torch.llm.model_runner import ModelRunner
    from ray_tpu_torch.models import llama

    config = llama.LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2,
                                    dtype=dtype)
    params = llama.init_params(config, torch.Generator("cuda").manual_seed(0),
                               "cuda")
    runners = [ModelRunner(config, params, num_blocks=num_blocks,
                           block_size=16, chunk_size=32, device=cuda,
                           cuda_graphs=g) for g in (True, False)]
    gen = torch.Generator("cuda").manual_seed(1)
    for name in ("k", "v"):
        pages = torch.randn(runners[0].cache[name].shape, generator=gen,
                            device="cuda").to(dtype)
        for r in runners:
            r.cache[name].copy_(pages)
    return config, runners


def _mixed_inputs(runner, q_lens, kv_lens, props, T, temps):
    """Host inputs of one mixed step: sequence s has q_lens[s] rows (its
    last token then its proposals props[s], or a prefill chunk) ending at
    kv_lens[s] keys, pages 1 + 4 s onward; S = 4, W = 4."""
    S, W = 4, 4
    rng = np.random.default_rng(sum(q_lens) + T)
    tables = np.zeros((S, runner.max_blocks_per_seq), np.int32)
    cu = np.zeros(S + 1, np.int32)
    out_rows = np.zeros((S, W), np.int32)
    proposals = np.zeros((S, W), np.int32)
    prop_lens = np.zeros(S, np.int32)
    for s, (n, kv) in enumerate(zip(q_lens, kv_lens)):
        tables[s, :4] = np.arange(4) + 1 + 4 * s
        cu[s + 1] = cu[s] + n
        proposals[s, :len(props[s])] = props[s]
        prop_lens[s] = len(props[s])
        out_rows[s] = [cu[s] + min(j, n - 1) for j in range(W)]
    tokens = np.zeros(T, np.int32)
    tokens[:cu[-1]] = rng.integers(0, 256, cu[-1])
    kv = np.asarray(kv_lens, np.int32)
    return (tokens, kv - np.asarray(q_lens, np.int32), kv, cu, tables,
            out_rows, proposals, prop_lens, np.asarray(temps, np.float32),
            np.asarray([0, 20, 0, 5], np.int32),
            np.asarray([1.0, 0.9, 1.0, 1.0], np.float32),
            np.asarray([3, 1, 4, 1], np.int64),
            kv.astype(np.int64) - np.asarray(q_lens) + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_step_mixed_equals_eager(cuda, dtype):
    """The bucket's CUDA graphs against the eager step on the same runner
    state: three ticks in one bucket (T = 32) with 24, 9 and 6 real rows
    (decode, verify with proposals, a prefill chunk; greedy and
    temperature rows, then all greedy: the bucket's second graph). fp32:
    identical accept and samples; bf16: logits within 2e-2, equal tokens
    reported. Every page but the scratch page is byte-identical to the
    eager path's after the ticks."""
    config, (graphed, eager) = _runner_pair(cuda, dtype)
    ticks = [_mixed_inputs(graphed, [4, 1, 16, 3], [60, 33, 16, 50],
                           [[7, 9, 11], [], [], [2, 4]], 32,
                           [0.0, 0.8, 0.0, 1.1]),
             _mixed_inputs(graphed, [1, 1, 4, 3], [61, 34, 20, 52],
                           [[], [], [], [5, 6]], 32, [0.0, 0.0, 0.7, 0.0]),
             _mixed_inputs(graphed, [2, 1, 1, 2], [63, 35, 21, 54],
                           [[8], [], [], [1]], 32, [0.0] * 4)]
    equal = []
    for args in ticks:
        g_acc, g_smp = graphed.step_mixed(*args)
        e_acc, e_smp = eager.step_mixed(*args)
        if dtype == torch.float32:
            assert np.array_equal(g_acc, e_acc)
            assert np.array_equal(g_smp, e_smp)
        torch.testing.assert_close(graphed.last_logits, eager.last_logits,
                                   rtol=2e-2, atol=2e-2)
        equal.append(int((g_smp == e_smp).sum()))
    print(f"{dtype}: graphed == eager samples at {equal} of 16 per tick")
    assert graphed.step_compiles == 2 and len(graphed._graphs) == 2
    n = graphed.num_blocks
    for name in ("k", "v"):
        assert torch.equal(graphed.cache[name][:, :, :n],
                           eager.cache[name][:, :, :n]), name


def test_replays_count_kernel_launches(cuda):
    """A capture launches nothing: warm_mixed captures the bucket's two
    graphs (all greedy, sampled), each adding its eager first-use run's
    n_layers launches and its replay's n_layers; every later tick replays
    a graph and adds n_layers, with no new capture."""
    from ray_tpu_torch.ops import paged_attention as pa

    config, (graphed, _) = _runner_pair(cuda, torch.float32)
    L = config.n_layers
    pa.ragged_paged_attention_unified.launches = 0
    graphed.warm_mixed(32, 4, 4)
    assert pa.ragged_paged_attention_unified.launches == 4 * L
    assert graphed.step_compiles == 2
    for i, temps in enumerate(([0.0] * 4, [0.0, 0.5, 0.0, 0.0],
                               [0.0] * 4)):
        graphed.step_mixed(*_mixed_inputs(
            graphed, [1, 1, 2, 3], [20, 21, 22, 23], [[], [], [1], [1, 2]],
            32, temps))
        assert pa.ragged_paged_attention_unified.launches == (5 + i) * L
    assert graphed.step_compiles == 2


def _lora_runner_pair(cuda, dtype, n_adapters=3):
    """_runner_pair's runners, each with a LoRA manager (4 user slots,
    rank 8, every target) holding the same seeded adapters a0, a1, ..."""
    from ray_tpu_torch.llm import lora

    config, runners = _runner_pair(cuda, dtype)
    adapters = [lora.init_adapter(
        config, f"a{i}", targets=lora.TARGETS, scale=0.5,
        generator=torch.Generator().manual_seed(30 + i))
        for i in range(n_adapters)]
    for r in runners:
        r.lora = lora.LoRAManager(config, n_slots=4, device=cuda)
        for a in adapters:
            r.lora.load_adapter(a)
    return config, runners, adapters


LORA_IDX = np.asarray([0, 1, 2, 3], np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_lora_step_equals_eager(cuda, dtype):
    """A mixed-adapter batch (base, a0, a1, a2) through the bucket's graphs
    against the eager step: fp32 identical samples, bf16 logits within
    2e-2; the adapters move the logits (against all-base slots)."""
    config, (graphed, eager), _ = _lora_runner_pair(cuda, dtype)
    args = _mixed_inputs(graphed, [4, 1, 16, 3], [60, 33, 16, 50],
                         [[7, 9, 11], [], [], [2, 4]], 32,
                         [0.0, 0.8, 0.0, 1.1])
    g_acc, g_smp = graphed.step_mixed(*args, lora_idx=LORA_IDX)
    e_acc, e_smp = eager.step_mixed(*args, lora_idx=LORA_IDX)
    if dtype == torch.float32:
        assert np.array_equal(g_acc, e_acc) and np.array_equal(g_smp, e_smp)
    torch.testing.assert_close(graphed.last_logits, eager.last_logits,
                               rtol=2e-2, atol=2e-2)
    with_lora = eager.last_logits.clone()
    eager.step_mixed(*args, lora_idx=np.zeros(4, np.int32))
    moved = (with_lora - eager.last_logits).abs().amax(dim=-1).view(4, 4)
    assert (moved[0] == 0).all()      # the base slot adds exact zeros
    assert (moved[1:] > 1e-3).all()
    assert graphed.step_compiles == 1


def test_replay_reads_new_adapter_and_new_weights(cuda):
    """A replay after `load_adapter` (a slot's columns rewritten in place)
    and after `update_weights` (every weight copied in place) reads the
    new values: its logits equal an eager runner's that holds the same
    new values, and nothing is captured again."""
    from ray_tpu_torch.llm import lora
    from ray_tpu_torch.llm.engine import LLMEngine

    config, (graphed, eager), adapters = _lora_runner_pair(cuda,
                                                           torch.float32)
    args = _mixed_inputs(graphed, [1, 1, 1, 1], [20, 21, 22, 23],
                         [[], [], [], []], 32, [0.0] * 4)
    graphed.step_mixed(*args, lora_idx=LORA_IDX)
    before = graphed.last_logits.clone()
    fresh = lora.init_adapter(config, "a1", targets=lora.TARGETS, scale=0.5,
                              generator=torch.Generator().manual_seed(99))
    for r in (graphed, eager):
        r.lora.load_adapter(fresh)
    graphed.step_mixed(*args, lora_idx=LORA_IDX)
    eager.step_mixed(*args, lora_idx=LORA_IDX)
    torch.testing.assert_close(graphed.last_logits, eager.last_logits,
                               rtol=1e-5, atol=1e-5)
    delta = (graphed.last_logits - before).abs().amax(dim=-1).view(4, 4)
    assert (delta[2] > 1e-3).all() and (delta[[0, 1, 3]] == 0).all()
    new = {k: v for k, v in graphed.params.items() if k != "layers"}
    new["layers"] = {k: v * 0.9 for k, v in graphed.params["layers"].items()}
    for r in (graphed, eager):
        LLMEngine(r, max_batch_size=4).update_weights(new)
    graphed.step_mixed(*args, lora_idx=LORA_IDX)
    eager.step_mixed(*args, lora_idx=LORA_IDX)
    torch.testing.assert_close(graphed.last_logits, eager.last_logits,
                               rtol=1e-5, atol=1e-5)
    assert (graphed.last_logits - before).abs().amax() > 1e-3
    assert graphed.step_compiles == 1 and len(graphed._graphs) == 1


def test_lora_resize_recaptures_once(cuda):
    """`resize` reallocates the stacks: the next step of a bucket captures
    once (the old epoch's graphs released), later steps replay, and every
    loaded adapter's outputs stay the same."""
    config, (graphed, _), _ = _lora_runner_pair(cuda, torch.float32)
    args = _mixed_inputs(graphed, [1, 1, 1, 1], [20, 21, 22, 23],
                         [[], [], [], []], 32, [0.0] * 4)
    graphed.step_mixed(*args, lora_idx=LORA_IDX)
    before = graphed.last_logits.clone()
    assert graphed.step_compiles == 1
    graphed.lora.resize(7)
    for _ in range(3):
        graphed.step_mixed(*args, lora_idx=LORA_IDX)
        assert graphed.step_compiles == 2 and len(graphed._graphs) == 1
        torch.testing.assert_close(graphed.last_logits, before, rtol=1e-5,
                                   atol=1e-5)


def test_lora_split_path_equals_unified(cuda):
    """Mixed-adapter requests (base, a0, a1) through the split path (K6 on
    every runner step, eager) give the graphed unified engine's greedy
    tokens in fp32, and every pin is released."""
    from ray_tpu_torch.llm import lora
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import paged_attention as pa

    config = llama.LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2,
                                    dtype=torch.float32)
    adapters = [lora.init_adapter(
        config, f"a{i}", targets=lora.TARGETS, scale=0.5,
        generator=torch.Generator().manual_seed(40 + i)) for i in range(2)]
    prompts = [[1, 2, 3] * 20, [7, 8, 9, 10], [5] * 37]
    outs = {}
    for unified in (True, False):
        engine = build_engine(LLMConfig(
            model_config=config, block_size=16, num_kv_blocks=64,
            max_batch_size=4, prefill_chunk=32, device=cuda,
            lora_adapters=adapters, unified_ticks=unified))
        pa.ragged_paged_attention.launches = 0
        for i, (p, name) in enumerate(zip(prompts, (None, "a0", "a1"))):
            engine.add_request(p, SamplingParams(max_tokens=6),
                               request_id=f"r{i}", lora_name=name)
        done = {}
        while engine.has_unfinished():
            done.update({o.request_id: o.output_token_ids
                         for o in engine.step() if o.finished})
        outs[unified] = [done[f"r{i}"] for i in range(3)]
        assert engine.stats()["lora_pinned"] == 0
        assert (pa.ragged_paged_attention.launches > 0) != unified
    assert outs[True] == outs[False]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_scatter_pages_round_trip_on_card(cuda, dtype):
    """Pages gathered off the card (bf16 as uint16 bits) scatter into other
    pages of another runner byte-exactly, in place (the pool tensor is the
    same object), and equal the pool's own bytes."""
    _, (a, b) = _runner_pair(cuda, dtype)
    pool = b.cache["k"].data_ptr()
    src, dst = [3, 7, 1], [10, 2, 20]
    k, v = a.gather_pages(src)
    assert k.shape == (a.config.n_layers, a.config.n_kv_heads, 3, 16, 64)
    b.scatter_pages(dst, k, v)
    assert b.cache["k"].data_ptr() == pool
    for name in ("k", "v"):
        assert torch.equal(b.cache[name][:, :, dst],
                           a.cache[name][:, :, src]), name
    k2, _ = b.gather_pages(dst)
    assert k2.tobytes() == k.tobytes()


def _rect_case(seed, dtype, q_lens, kv_lens, Bq, K=2, H=8, hd=64, ps=16,
               max_pages=40):
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    P = 1 + S * max_pages
    tables = rng.permutation(S * max_pages).reshape(S, max_pages) + 1
    kv = np.asarray(kv_lens)
    qp = np.maximum(kv - np.asarray(q_lens), 0)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    i = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.int32)).to("cuda")
    return (f(S, Bq, H, hd), f(K, P, ps, hd), f(K, P, ps, hd), i(tables),
            i(kv), i(qp))


# K6 cases: name, (H, K), hd, ps, q_lens, kv_lens, Bq. The probes are one
# sequence, one kv head, one tile of 16 rows over one 64-key ring stage.
# A chunk's padding rows (q_lens < Bq) are computed as the TPU kernel
# computes them; kv_len = 0 sequences give exact zeros; G 1, 4, 8, 32;
# page size 12; Bq = 128 chunks whose tiles have 16 causal limits each.
RECT_CASES = [
    ("probe_hd64", (4, 1), 64, 16, [16], [64], 16),
    ("probe_hd128", (4, 1), 128, 16, [16], [64], 16),
    ("base", (8, 2), 64, 16, [8, 0, 5, 1], [600, 0, 37, 300], 8),
    ("g1_hd128_ps12", (4, 4), 128, 12, [128, 50], [900, 50], 128),
    ("g8_ps12", (16, 2), 64, 12, [3, 8, 0], [400, 30, 0], 8),
    ("g32_hd128", (32, 1), 128, 16, [4, 1], [700, 33], 4),
    ("chunk128", (8, 2), 128, 16, [128, 57], [768, 313], 128),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name,heads,hd,ps,q_lens,kv_lens,Bq", RECT_CASES,
                         ids=[c[0] for c in RECT_CASES])
def test_rect_kernel_matches_plain_version(cuda, dtype, tol, name, heads,
                                           hd, ps, q_lens, kv_lens, Bq):
    """K6 against its plain version on every row of a kv_len > 0
    sequence (elementwise and by norm), exact zeros for the kv_len = 0
    sequences."""
    from ray_tpu_torch.ops import paged_attention as pa

    H, K = heads
    args = _rect_case(1, dtype, q_lens, kv_lens, Bq, K=K, H=H, hd=hd, ps=ps,
                      max_pages=_pages_for(kv_lens, ps))
    before = pa.ragged_paged_attention.launches
    out = pa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    ref = pa.ragged_paged_attention_reference(*args)
    live = args[4] > 0
    _assert_paged_close(out[live], ref[live], tol)
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_are_deterministic(cuda, dtype):
    """The same inputs twice give bitwise the same K5 and K6 outputs,
    key splits and their merge included (no atomics)."""
    from ray_tpu_torch.ops import paged_attention as pa

    k5 = _case(2, dtype, [1, 128, 1], [700, 400, 33], 136, hd=128,
               max_pages=_pages_for([700], 16))
    k6 = _rect_case(2, dtype, [128, 57], [768, 313], 128, hd=128,
                    max_pages=_pages_for([768], 16))
    for fn, args in ((pa.ragged_paged_attention_unified, k5),
                     (pa.ragged_paged_attention, k6)):
        first = fn(*args)
        second = fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_split_engine_launches_rect_kernel_per_step(cuda):
    """Every runner step of the split engine is n_layers K6 launches and
    no K5 launch; the decode dispatch runs under sync-debug "error"."""
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import paged_attention as pa

    config = llama.LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2,
                                    dtype=torch.float32)
    engine = build_engine(LLMConfig(model_config=config, block_size=16,
                                    num_kv_blocks=64, max_batch_size=4,
                                    prefill_chunk=32, device=cuda,
                                    unified_ticks=False,
                                    decode_multi_step=2))
    steps = []
    runner = engine.runner
    for name in ("step", "step_sample", "step_verify"):
        real = getattr(runner, name)
        setattr(runner, name, lambda *a, _r=real, **k: (
            steps.append(1), _r(*a, **k))[1])
    multi = runner.step_sample_multi
    runner.step_sample_multi = lambda n, *a, **k: (
        steps.extend([1] * n), multi(n, *a, **k))[1]
    dispatch = engine._dispatch_decode

    def strict(prev):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(prev)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    engine._dispatch_decode = strict
    pa.ragged_paged_attention.launches = 0
    pa.ragged_paged_attention_unified.launches = 0
    outs = engine.generate([[1, 2, 3] * 20, [7, 8]],
                           SamplingParams(max_tokens=7))
    assert all(len(o.output_token_ids) == 7 for o in outs)
    assert steps and pa.ragged_paged_attention.launches == \
        config.n_layers * len(steps)
    assert pa.ragged_paged_attention_unified.launches == 0


# (causal, sq, skv, h, hkv): ragged tails, sq != skv both ways, and rows and
# keys that straddle the bf16 forward's 128-row, 128-key tiles (1, 127, 129,
# 300), at GQA n_rep 1, 2 and 4; the last case walks 64 key tiles per
# CTA, so the bf16 dQ kernel's 4-stage ring of 64-key tiles wraps 16 times
# at a shape where sq != skv.
FLASH_SHAPES = [(True, 100, 100, 4, 2), (True, 70, 130, 4, 2),
                (False, 90, 60, 4, 2), (True, 1, 1, 4, 1),
                (True, 1, 300, 4, 1), (False, 1, 129, 4, 2),
                (True, 127, 127, 4, 1), (True, 129, 129, 4, 1),
                (True, 127, 300, 4, 2), (True, 300, 129, 4, 1),
                (True, 129, 127, 4, 1), (False, 300, 127, 4, 1),
                (True, 300, 300, 8, 2), (False, 2048, 4096, 4, 2)]


@pytest.mark.parametrize("dtype,tol,grad_tol", [(torch.float32, 1e-5, 1e-4),
                                                (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,sq,skv,h,hkv", FLASH_SHAPES)
def test_flash_kernels_match_plain_versions(cuda, dtype, tol, grad_tol, d,
                                            causal, sq, skv, h, hkv):
    """flash_fwd (with and without LSE), flash_bwd_dq and flash_bwd_dkv
    against their plain versions: ragged tails (not multiples of the
    kernels' 64- or 128-row tiles), GQA n_rep 1 to 4, sq != skv both
    ways. Each gradient is also held as a whole, |got − ref| / |ref| <=
    grad_tol / 2 in the Frobenius norm: a stale or skipped ring stage at
    4096 keys moves that by about sqrt(1/64), while its largest element
    error can stay inside atol."""
    from ray_tpu_torch.ops import attention as ta

    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    q, k, v, dout = f(2, sq, h, d), f(2, skv, hkv, d), f(2, skv, hkv, d), \
        f(2, sq, h, d)
    scale = d ** -0.5
    before = {n: getattr(ta, n).launches
              for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out, lse = ta.flash_fwd(q, k, v, causal, scale)
    out_nolse, empty = ta.flash_fwd(q, k, v, causal, scale, with_lse=False)
    ref_out, ref_lse = ta.flash_fwd_reference(q, k, v, causal, scale)
    delta = ((dout.float() * ref_out.float()).sum(-1).transpose(1, 2)
             - torch.from_numpy(rng.standard_normal(
                 (2, h, sq), dtype=np.float32)).cuda()).contiguous()
    args = (q, k, v, dout, ref_lse, delta, causal, scale)
    dq = ta.flash_bwd_dq(*args)
    dk, dv = ta.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert {n: getattr(ta, n).launches - b for n, b in before.items()} == \
        {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert empty.numel() == 0 and torch.equal(out_nolse, out)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)
    for got, want in zip((dq, dk, dv),
                         (ta.flash_bwd_dq_reference(*args),
                          *ta.flash_bwd_dkv_reference(*args))):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=grad_tol,
                                   atol=grad_tol)
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        assert rel <= grad_tol / 2, rel


def test_auto_attention_d256_raises_and_head_dim_96_engine_runs(cuda):
    """attention(impl="auto") at head dim 256 refuses on the card (the JAX
    rule picks its Pallas flash kernel there, the port has none yet) and
    runs flash at head dim 128. A head-dim-96 engine, unified and split,
    runs the plain versions on the card as the JAX runner runs its
    reference: it launches neither K5 nor K6 and decodes greedily as the
    naive forward does."""
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(4)
    for d in (256, 128):
        q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                   .to("cuda", torch.bfloat16)
                   for s in ((1, 300, 4, d), (1, 300, 2, d),
                             (1, 300, 2, d)))
        if d == 256:
            with pytest.raises(ValueError, match="queue 2 D"):
                ta.attention(q, k, v)
            continue
        ta.flash_fwd.launches = 0
        out = ta.attention(q, k, v)
        torch.cuda.synchronize()
        assert ta.flash_fwd.launches == 1
        torch.testing.assert_close(out, ta.mha_reference(q, k, v),
                                   rtol=2e-2, atol=2e-2)
    config = llama.LlamaConfig.tiny(d_model=192, n_heads=2, n_kv_heads=1,
                                    dtype=torch.float32)
    assert config.head_dim == 96
    prompts = [[1, 2, 3] * 10, [7, 8]]
    params = llama.init_params(config, torch.Generator("cuda").manual_seed(0),
                               "cuda")
    want = []
    for p in prompts:
        tokens = list(p)
        for _ in range(5):
            logits = llama.forward(params, torch.tensor([tokens],
                                                        device="cuda"),
                                   config)
            tokens.append(int(torch.argmax(logits[0, -1])))
        want.append(tokens[len(p):])
    for unified in (True, False):
        engine = build_engine(LLMConfig(
            model_config=config, block_size=16, num_kv_blocks=64,
            max_batch_size=4, prefill_chunk=32, device=cuda,
            unified_ticks=unified), params=params)
        pa.ragged_paged_attention.launches = 0
        pa.ragged_paged_attention_unified.launches = 0
        outs = engine.generate(prompts, SamplingParams(max_tokens=5))
        assert [o.output_token_ids for o in outs] == want
        assert pa.ragged_paged_attention.launches == 0
        assert pa.ragged_paged_attention_unified.launches == 0


@pytest.mark.parametrize("policy,fwd_per_layer", [("dots", 2), ("flash", 1)])
def test_train_step_launches_flash_kernels_per_layer(cuda, policy,
                                                     fwd_per_layer):
    """A train step with flash attention launches the forward kernel 2 L
    times under "dots" and L times under "flash", dQ and dK/dV L times;
    the loss falls on a repeated batch."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import init_state, make_step

    config = llama.LlamaConfig.tiny(d_model=256, n_heads=2, n_kv_heads=1,
                                    max_seq=64, attention_impl="flash",
                                    remat_policy=policy,
                                    dtype=torch.bfloat16)
    opt = adamw(1e-3, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    state = init_state(config, opt, torch.Generator("cuda").manual_seed(0))
    step = make_step(config, opt)
    tokens = torch.randint(0, config.vocab_size, (2, 65), device="cuda")
    losses = []
    for _ in range(3):
        ta.flash_fwd.launches = ta.flash_bwd_dq.launches = 0
        ta.flash_bwd_dkv.launches = 0
        state, loss = step(state, tokens)
        losses.append(loss.item())
        L = config.n_layers
        assert (ta.flash_fwd.launches, ta.flash_bwd_dq.launches,
                ta.flash_bwd_dkv.launches) == (fwd_per_layer * L, L, L)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_composition_matches_whole_flash(cuda, dtype):
    """The ring's chunk steps and merges (ring_attention_chunks, 4 chunks
    of 1024 keys, heads 16/8, d 128) against flash attention on the whole
    sequence, forward and backward with cotangents on the output and the
    LSE: fp32 elementwise (1e-5 out and LSE, 1e-4 gradients), bf16 by
    norm (||got - ref|| / ||ref|| <= 1e-2); 10 forward, dQ and dK/dV
    launches (4 diagonal and 6 past chunks; future chunks launch none)."""
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.parallel.ring import ring_attention_chunks

    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, k, v = (randn(1, 4096, n, 128).requires_grad_(True)
               for n in (16, 8, 8))
    g_out, g_lse = randn(1, 4096, 16, 128), randn(1, 16, 4096,
                                                  dt=torch.float32)

    def run(fn):
        out, lse = fn(q, k, v)
        loss = (out.float() * g_out.float()).sum() + (lse * g_lse).sum()
        return [out, lse, *torch.autograd.grad(loss, [q, k, v])]

    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        getattr(ta, name).launches = 0
    got = run(lambda a, b, c: ring_attention_chunks(a, b, c, 4))
    assert (ta.flash_fwd.launches, ta.flash_bwd_dq.launches,
            ta.flash_bwd_dkv.launches) == (10, 10, 10)
    want = run(lambda a, b, c: ta.flash_attention(a, b, c, causal=True,
                                                  return_lse=True))
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            tol = 1e-5 if name in ("out", "lse") else 1e-4
            torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=name)
        else:
            assert ((g - w).norm() / w.norm()).item() <= 1e-2, name


def test_mesh_of_one_step_matches_single_card_step(cuda, tmp_path):
    """fsdp.build_train_step on a one-rank NCCL mesh against train/step.py
    on the same weights and batch over 3 steps (bf16, flash, "dots"):
    losses within 1e-6 relative (the same arithmetic), the same flash
    launches per step."""
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.parallel.fsdp import build_train_step
    from ray_tpu_torch.parallel.launch import init_rank
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.train.optim import adamw
    from ray_tpu_torch.train.step import init_state, make_step

    config = llama.LlamaConfig.tiny(d_model=512, n_heads=4, n_kv_heads=2,
                                    max_seq=512, attention_impl="flash",
                                    remat_policy="dots",
                                    dtype=torch.bfloat16)
    opt = adamw(1e-3, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    tokens = torch.randint(0, config.vocab_size, (2, 513), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    single = init_state(config, opt, torch.Generator("cuda").manual_seed(0))
    step = make_step(config, opt)
    init_rank(0, 1, str(tmp_path / "store"), "cuda")
    try:
        mesh = build_mesh(MeshConfig())
        init_fn, make_mesh_step = build_train_step(
            lambda p, b: llama.loss_fn(p, b, config), opt, mesh,
            llama.param_logical_axes(config), {"tokens": ("batch", None)})
        state, specs = init_fn(llama.init_params(
            config, torch.Generator("cuda").manual_seed(0)))
        mesh_step = make_mesh_step(specs)
        for _ in range(3):
            counts = []
            for run in (lambda: step(single, tokens)[1],
                        lambda: mesh_step(state, {"tokens": tokens})[1][
                            "loss"]):
                ta.flash_fwd.launches = ta.flash_bwd_dq.launches = 0
                ta.flash_bwd_dkv.launches = 0
                counts.append((run().item(), ta.flash_fwd.launches,
                               ta.flash_bwd_dq.launches,
                               ta.flash_bwd_dkv.launches))
            (ls, *cs), (lm, *cm) = counts
            assert cs == cm == [4, 2, 2]
            assert abs(lm - ls) <= 1e-6 * abs(ls)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_handoff_and_migration_on_card(cuda, dtype):
    """A prefill-only engine (K6, no graph) hands a request to a graphed
    decode server over localhost: the adopt's scatter, made on the
    listener's thread, is seen by the next replay (fp32: the tokens equal
    a single unified server's; bf16, whose split-path prefill rounds
    otherwise: a second handoff gives the same tokens) and captures
    nothing; a session migrated mid-decode off the decode server gives
    the unmoved run's tokens on a third server."""
    from ray_tpu_torch.llm.disagg import PrefillServer
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import paged_attention as pa

    config = llama.LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2,
                                    max_seq=512, dtype=dtype)
    params = llama.init_params(config, torch.Generator(
        device=cuda).manual_seed(3), cuda)
    cfg = LLMConfig(model_config=config, block_size=16, num_kv_blocks=64,
                    max_batch_size=4, prefill_chunk=32, device=cuda)
    single = LLMServer(cfg, params=params)
    decode = LLMServer(cfg, params=params)
    target = LLMServer(cfg, params=params)
    prefill = PrefillServer(cfg, params=params)
    try:
        assert not prefill.engine.runner._graphs
        req = {"prompt": [(5 * i + 1) % 256 for i in range(70)],
               "max_tokens": 12, "request_id": "card-1"}
        want = single.completions(dict(req))["choices"][0]["token_ids"]
        compiles = decode.engine_stats()["step_compiles"]
        pa.ragged_paged_attention.launches = 0
        pa.ragged_paged_attention_unified.launches = 0
        res = prefill.prefill(dict(req), decode.handoff_address())
        k6 = pa.ragged_paged_attention.launches
        got = decode.completions_collect(res["rid"])["choices"][0][
            "token_ids"]
        if dtype == torch.float32:
            assert got == want
        again = prefill.prefill(dict(req), decode.handoff_address())
        assert decode.completions_collect(again["rid"])["choices"][0][
            "token_ids"] == got
        assert k6 >= config.n_layers
        assert pa.ragged_paged_attention_unified.launches >= config.n_layers
        assert decode.engine_stats()["step_compiles"] == compiles
        # Migration: decode steps on the source's replays, the gather on
        # the same stream after them.
        long = dict(req, max_tokens=200, request_id="card-2")
        want = single.completions(dict(long))["choices"][0]["token_ids"]
        import threading
        import time

        box = {}
        th = threading.Thread(target=lambda: box.update(
            err=pytest.raises(RuntimeError, decode.completions, dict(long))))
        th.start()
        while True:
            with decode._lock:
                if any(len(r.output) >= 8 for r in decode.engine.running):
                    break
            time.sleep(0.001)
        res = decode.migrate_sessions(target.handoff_address())
        th.join(60)
        assert res["migrated"] == ["card-2"]
        assert target.completions_collect("card-2")["choices"][0][
            "token_ids"] == want
    finally:
        for srv in (single, decode, target, prefill):
            srv.close()


@pytest.mark.parametrize("interleave", [1, 2])
def test_pipeline_stages_on_cards_equal_one_card_step(cuda, interleave):
    """LocalPipeline with its stages on cuda:0 and on the machine's last
    card (cuda:0 again on one card), fp32 flash, no remat, against
    train/step.py on cuda:0 over 3 AdamW steps: losses within 1e-5
    relative; the parameters' movement within 1e-3 by norm and every
    element within 2·lr (an element whose gradient is near Adam's eps
    moves as the order of fp32 sums decides). Per step the forward kernel runs
    for each layer and microbatch in `fwd` (every chunk but the last) and
    again in `bwd`'s re-run, the backward kernels once in `bwd`: K1 =
    (L - L_last)·m + L·m, K3 = L·m."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.parallel.pipeline import (LocalPipeline,
                                                 stage_layer_ranges)
    from ray_tpu_torch.train.optim import adamw, leaves
    from ray_tpu_torch.train.step import init_state, make_step

    config = llama.LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2,
                                    n_layers=4, max_seq=256, remat=False,
                                    attention_impl="flash",
                                    dtype=torch.float32)
    m, L = 4, config.n_layers
    last = f"cuda:{torch.cuda.device_count() - 1}"
    tokens = torch.randint(0, config.vocab_size, (m, 257), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    lr = 1e-3
    opt = adamw(lr)
    state = init_state(config, opt, torch.Generator("cuda").manual_seed(0))
    start = [p.detach().clone() for _, p in leaves(state["params"])]
    pipe = LocalPipeline(config, state["params"], 2, adamw(lr),
                         devices=["cuda:0", last], interleave=interleave)
    step = make_step(config, opt)
    lo, hi = stage_layer_ranges(L, 2 * interleave)[-1]
    for _ in range(3):
        want = step(state, tokens)[1].item()
        ta.flash_fwd.launches = ta.flash_bwd_dq.launches = 0
        ta.flash_bwd_dkv.launches = 0
        got = pipe.train_step(tokens, n_microbatches=m)["loss"]
        assert abs(got - want) <= 1e-5 * abs(want)
        assert ta.flash_fwd.launches == (L - (hi - lo)) * m + L * m
        assert ta.flash_bwd_dq.launches == ta.flash_bwd_dkv.launches == L * m
    merged = [a for _, a in leaves(pipe.merged_params(device="cuda:0"))]
    want = [b.detach() for _, b in leaves(state["params"])]
    moved = torch.cat([(a - s).flatten() for a, s in zip(merged, start)])
    ref = torch.cat([(b - s).flatten() for b, s in zip(want, start)])
    assert ((moved - ref).norm() / ref.norm()).item() <= 1e-3
    assert max((a - b).abs().max().item()
               for a, b in zip(merged, want)) <= 2 * lr


def test_two_tensor_parallel_worlds_in_one_process(cuda):
    """One process holds one NCCL world after another: tensor-parallel
    engines of 2 ranks, then of every card up to 4, each started and
    closed in this process (CUDA graphs on), give one card's greedy
    tokens, and no process group is left after each."""
    import torch.distributed as dist

    from ray_tpu_torch.llm.serving import LLMConfig, build_engine
    from ray_tpu_torch.llm.sampling import SamplingParams
    from ray_tpu_torch.models import llama

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more GPUs (a tensor-parallel world)")
    config = llama.LlamaConfig.tiny(d_model=512, n_heads=8, n_kv_heads=4,
                                    dtype=torch.float32)
    prompts = [[(5 * s + 3 * i) % config.vocab_size for i in range(9 + s)]
               for s in range(3)]
    got = {}
    for tp in (1, 2, min(4, torch.cuda.device_count()), 2):
        engine = build_engine(LLMConfig(
            model_config=config, tensor_parallel=tp, seed=3,
            num_kv_blocks=64, block_size=16, max_batch_size=4,
            prefill_chunk=16, warmup_buckets="light",
            cluster_prefix_store=False))
        try:
            outs = engine.generate(prompts, SamplingParams(max_tokens=8))
        finally:
            engine.runner.close()
        assert not dist.is_initialized()
        got.setdefault(tp, []).append([o.output_token_ids for o in outs])
    assert all(run == got[1][0] for runs in got.values() for run in runs)


def test_handoffs_into_a_tensor_parallel_server(cuda):
    """A tensor_parallel=2 server (rank 0 holds the listener and writes
    the whole pool through the fanned scatter_pages) takes live sessions
    migrated from a one-card server and hands others back, takes a
    prefill tier's handoff, and adopts a prefix another server published
    to the cluster table (a GcsServer reached in process); every move
    gives the one-card server's fp32 greedy tokens."""
    import asyncio
    import threading
    import time

    from ray_tpu_torch.llm.disagg import PrefillServer
    from ray_tpu_torch.llm.prefix_store import (ClusterPrefixStore,
                                                HostPrefixTier,
                                                cluster_chain)
    from ray_tpu_torch.llm.router import (LocalReplica, _migrated_mode,
                                          prefill_with_retry)
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.runtime.gcs.server import GcsServer

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more GPUs (a tensor-parallel world)")
    config = llama.LlamaConfig.tiny(d_model=512, n_heads=8, n_kv_heads=4,
                                    max_seq=512, dtype=torch.float32)
    gcs = GcsServer()

    def bridge(method, m, payload=b""):
        r = asyncio.run(getattr(gcs, f"handle_{method}")(None, m, payload))
        return r.m, r.payload

    def cfg(**kw):
        return LLMConfig(**dict(dict(
            model_config=config, seed=5, num_kv_blocks=128, block_size=16,
            max_batch_size=4, prefill_chunk=32, warmup_buckets="light",
            cluster_prefix_store=False), **kw))

    prompts = [[(7 * s + 3 * i) % config.vocab_size for i in range(40 + s)]
               for s in range(2)]
    system = [(11 * i + 1) % config.vocab_size for i in range(96)]
    adopt = dict(prompt=system + [3, 5, 7], max_tokens=16)

    def ask(srv, p, rid):
        return srv.completions(dict(prompt=p, max_tokens=24,
                                    request_id=rid))["choices"][0][
            "token_ids"]

    def migrate(src, dst, tag):
        got, threads = {}, []

        def consume(i):
            rid = f"{tag}-{i}"
            try:
                out = src.completions(dict(prompt=prompts[i], max_tokens=24,
                                           request_id=rid))
            except Exception as e:
                mode = _migrated_mode(e)
                assert mode is not None, e
                out = (dst.completions_collect(rid) if mode == "kv"
                       else dst.completions(dict(prompt=prompts[i],
                                                 max_tokens=24,
                                                 request_id=rid)))
            got[i] = out["choices"][0]["token_ids"]

        for i in range(len(prompts)):
            threads.append(threading.Thread(target=consume, args=(i,)))
            threads[-1].start()
        deadline = time.monotonic() + 60
        while True:
            with src._lock:
                lens = [len(r.output) for r in src.engine.running]
            if len(lens) == len(prompts) and min(lens) >= 2:
                break
            assert time.monotonic() < deadline, lens
            time.sleep(0.001)
        res = src.migrate_sessions(dst.handoff_address())
        for th in threads:
            th.join(120)
        src.resume_admission()
        assert res["migrated"]
        return [got[i] for i in range(len(prompts))]

    one = LLMServer(cfg())
    tp = LLMServer(cfg(tensor_parallel=2))
    try:
        ref = [ask(one, p, f"ref-{i}") for i, p in enumerate(prompts)]
        ref_adopt = one.completions(dict(adopt))["choices"][0]["token_ids"]
        assert migrate(one, tp, "into") == ref
        assert migrate(tp, one, "outof") == ref
        pre = PrefillServer(cfg())
        try:
            for i, p in enumerate(prompts):
                res = prefill_with_retry(
                    [LocalReplica(pre, name="prefill-0")],
                    dict(prompt=p, max_tokens=24, request_id=f"h-{i}"),
                    tp.handoff_address())
                assert res["handoff"]
                assert tp.completions_collect(res["rid"])["choices"][0][
                    "token_ids"] == ref[i]
        finally:
            pre.close()
        owner = LLMServer(cfg(num_kv_blocks=24, host_prefix_mb=0))
        try:
            owner.engine.attach_prefix_store(
                host_tier=HostPrefixTier(1 << 16, low_watermark=0.2),
                cluster_store=ClusterPrefixStore(16, transport=bridge))
            owner.completions(dict(adopt))
            for s in range(4):
                owner.completions(dict(prompt=[(13 * i + s) % 97
                                               for i in range(200)],
                                       max_tokens=1))
        finally:
            owner.close()
        assert ClusterPrefixStore(16, transport=bridge).lookup_owner(
            cluster_chain(system, 16))["n_blocks"] == 6
        tp.engine.attach_prefix_store(
            cluster_store=ClusterPrefixStore(16, transport=bridge))
        before = tp.engine_stats()
        got = tp.completions(dict(adopt))["choices"][0]["token_ids"]
        after = tp.engine_stats()
        assert got == ref_adopt
        assert after["cluster_prefix_adopted_blocks"] == 6
        assert (after["prefill_tokens_computed"]
                - before["prefill_tokens_computed"]) == 3
    finally:
        tp.close()
        one.close()


def _thread_ranks(classes, fn_per_rank):
    """One thread per rank over an in-memory KV: build classes[r] as rank
    r of a group, run fn_per_rank(comm) on every rank at once; results
    (or the first error) in rank order, with the communicators."""
    import threading

    kv, lock = {}, threading.Lock()

    def put(k, v):
        with lock:
            kv[k] = v

    def get(k):
        with lock:
            return kv.get(k)

    n = len(classes)
    comms, res = [None] * n, [None] * n

    def run(r):
        try:
            comms[r] = classes[r](r, n, f"card-{classes[r].__name__}", put,
                                  get, timeout=60)
            res[r] = ("ok", fn_per_rank(comms[r]))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            res[r] = ("err", e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for c in comms:
        if c is not None:
            c.close()
    for r in res:
        assert r is not None, "rank thread hung"
        if r[0] == "err":
            raise r[1]
    return [r[1] for r in res]


def test_torch_collective_backend_on_nccl(cuda):
    """The torch collective backend over NCCL on 2 cards (rank r on
    cuda:r, one thread each): every op on CUDA tensors gives the tcp
    backend's result on the same arrays (integers equal, floats within
    1e-6) and stays on the rank's card; with rank 0 withheld from an
    allreduce, its abort unblocks rank 1 with CollectiveAbortError
    within two watchdog intervals and a margin (the NCCL communicator is
    aborted, not waited out)."""
    import time

    from ray_tpu_torch import config as tconfig
    from ray_tpu_torch.collective.communicator import REDUCE_OPS
    from ray_tpu_torch.collective.cpu_group import TCPCommunicator
    from ray_tpu_torch.collective.torch_backend import TorchCommunicator
    from ray_tpu_torch.core.exceptions import CollectiveAbortError

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards")
    tconfig.reset_for_testing()
    tconfig.cfg().apply_overrides({"collective_watchdog_interval_s": 0.25})
    rng = np.random.default_rng(17)
    data = {dt: [{"a": (rng.integers(-3, 4, 1003) if dt == "int64" else
                        rng.standard_normal(1003)).astype(dt),
                  "s": [rng.standard_normal(257).astype(dt)
                        for _ in range(2)]} for _ in range(2)]
            for dt in ("float32", "float64", "int64")}

    def script(c, on_card):
        dev = torch.device("cuda", c.rank)
        T = (lambda x: torch.from_numpy(x).to(dev)) if on_card \
            else (lambda x: x)
        out = []
        for cases in data.values():
            d = cases[c.rank]
            for op in REDUCE_OPS:
                out += [c.allreduce(T(d["a"]), op),
                        c.reducescatter([T(s) for s in d["s"]], op)]
        d = data["float32"][c.rank]
        out += [c.allgather(T(d["a"])),
                c.broadcast(T(d["a"]) if (c.rank == 1 or on_card) else None,
                            1),
                c.alltoall([T(s) for s in d["s"]])]
        if c.rank == 0:
            c.send(T(d["a"]), 1)
        else:
            out.append(c.recv((1003,), torch.float32 if on_card
                              else np.float32, 0, **(
                                  {"device": dev} if on_card else {})))
        c.barrier()
        return out

    def flat(x):
        return [y for v in x for y in flat(v)] if isinstance(x, list) \
            else [x]

    try:
        got = _thread_ranks([TorchCommunicator] * 2,
                            lambda c: script(c, True))
        want = _thread_ranks([TCPCommunicator] * 2,
                             lambda c: script(c, False))
        for r in range(2):
            for g, w in zip(flat(got[r]), flat(want[r])):
                assert g.device == torch.device("cuda", r)
                g = g.cpu().numpy()
                assert g.dtype == w.dtype and g.shape == w.shape
                if w.dtype.kind == "i":
                    np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)

        def withheld(c):
            dev = torch.device("cuda", c.rank)
            c.allreduce(torch.ones(4, device=dev))   # the communicator up
            if c.rank == 0:
                time.sleep(1.0)
                t0 = time.monotonic()
                c.abort("rank 0 withheld")
                return t0
            try:
                c.allreduce(torch.ones(1 << 20, device=dev))
            except CollectiveAbortError:
                return time.monotonic()
            raise AssertionError("allreduce returned with a rank withheld")

        t_abort, t_raised = _thread_ranks([TorchCommunicator] * 2, withheld)
        assert t_raised - t_abort < 2 * 0.25 + 1.0, t_raised - t_abort
    finally:
        tconfig.reset_for_testing()
