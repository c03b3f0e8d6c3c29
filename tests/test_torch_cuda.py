"""The port's CUDA kernels on the card (marker `cuda`; skips without one).

Run on a machine with an NVIDIA GPU:
    python -m pytest tests/test_torch_cuda.py -q -m cuda
The K5 and K6 kernels (csrc/paged_attention.cu) and the three flash
kernels (csrc/flash_attention.cu) must agree with their plain PyTorch
versions on the same inputs, fp32 rtol = atol = 1e-5 (gradients 1e-4),
bf16 2e-2, and count their launches; the unified engine goes through K5
on every tick, the split engine through K6 on every runner step, and its
decode dispatch never synchronises with the device; a train step
launches the flash kernels once or twice per layer, as its remat policy
says; a head-dim-96 engine runs the plain versions on the card, as the
JAX runner runs its reference there, and attention at head dim 256, where
the JAX rule runs a Pallas kernel the port lacks, raises.
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version(cuda, dtype, tol):
    from ray_tpu_torch.ops import paged_attention as pa

    # Contexts of 600 and 300 keys span several key splits of the kernel.
    args = _case(0, dtype, [1, 0, 37, 5], [600, 0, 37, 300], 48,
                 max_pages=40)
    before = pa.ragged_paged_attention_unified.launches
    out = pa.ragged_paged_attention_unified(*args)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention_unified.launches == before + 1
    ref = pa.ragged_paged_attention_unified_reference(*args)
    torch.testing.assert_close(out[:43].float(), ref[:43].float(),
                               rtol=tol, atol=tol)
    assert (out[43:] == 0).all()


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_rect_kernel_matches_plain_version(cuda, dtype, tol):
    """K6 with a chunk's padding rows (q_lens < Bq), a kv_len = 0
    sequence (exact zeros) and a 600-key context over several key
    splits."""
    from ray_tpu_torch.ops import paged_attention as pa

    args = _rect_case(1, dtype, [8, 0, 5, 1], [600, 0, 37, 300], 8)
    before = pa.ragged_paged_attention.launches
    out = pa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    ref = pa.ragged_paged_attention_reference(*args)
    live = args[4] > 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               rtol=tol, atol=tol)
    assert (out[~live] == 0).all()


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
