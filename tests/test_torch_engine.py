"""The port's serving stack against the JAX engine, on the CPU.

Both engines run the tiny fp32 config of tests/test_llm_unified.py on the
same weights (JAX `init_params` converted with `params_from_numpy`):
greedy output token ids must be IDENTICAL — mixed prompts, a prefix-cache
hit, and a pool small enough to force preemption — and equal naive greedy
decoding with the port's `forward`. Temperature sampling cannot match
JAX's threefry draws; it is held to replay identity inside the port and to
the filtered softmax in distribution.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import model_runner as tmr
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.models import llama as tl

PROMPTS = [[(7 * i + 3) % 128 for i in range(21)],      # 3 chunks
           [1, 5, 9, 2, 11, 3, 8],                      # 1 chunk
           [(3 * i + 2) % 128 for i in range(13)]]      # 2 chunks


@pytest.fixture(scope="module")
def weights(cpu_jax):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    jconfig = jl.LlamaConfig.tiny(vocab_size=128, max_seq=64,
                                  dtype=jnp.float32)
    jparams = jl.init_params(jconfig, jax.random.key(0))
    tconfig = tl.LlamaConfig.tiny(vocab_size=128, max_seq=64,
                                  dtype=torch.float32)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   tconfig, device="cpu")
    return jconfig, jparams, tconfig, tparams


def _port_engine(tconfig, tparams, num_blocks=64, **kw):
    runner = tmr.ModelRunner(tconfig, tparams, num_blocks=num_blocks,
                             block_size=8, chunk_size=8, device="cpu")
    return LLMEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _jax_engine(jconfig, jparams, num_blocks=64):
    from ray_tpu.llm.engine import LLMEngine as JaxEngine
    from ray_tpu.llm.model_runner import ModelRunner as JaxRunner

    runner = JaxRunner(jconfig, jparams, num_blocks=num_blocks,
                       block_size=8, chunk_size=8)
    return JaxEngine(runner, max_batch_size=4, prefill_chunk=8)


def _jax_generate(engine, prompts, max_tokens):
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    outs = engine.generate(prompts, JaxParams(max_tokens=max_tokens))
    return [o.output_token_ids for o in outs]


def _naive_greedy(tparams, tconfig, prompt, n_steps):
    tokens = list(prompt)
    for _ in range(n_steps):
        logits = tl.forward(tparams, torch.tensor([tokens]), tconfig)
        tokens.append(int(torch.argmax(logits[0, -1])))
    return tokens[len(prompt):]


def test_greedy_matches_jax_engine_and_naive(weights):
    jconfig, jparams, tconfig, tparams = weights
    ref = _jax_generate(_jax_engine(jconfig, jparams), PROMPTS, 6)
    eng = _port_engine(tconfig, tparams)
    outs = eng.generate(PROMPTS, SamplingParams(max_tokens=6))
    assert [o.output_token_ids for o in outs] == ref
    assert eng.stats()["ticks"] > 0
    for p, o in zip(PROMPTS, outs):
        assert o.output_token_ids == _naive_greedy(tparams, tconfig, p, 6)
        assert o.finished and o.finish_reason == "length"


def test_prefix_cache_hit_matches_jax(weights):
    jconfig, jparams, tconfig, tparams = weights
    prompt = PROMPTS[0] + [4, 4, 9]
    jeng = _jax_engine(jconfig, jparams)
    ref = [_jax_generate(jeng, [prompt], 5)[0] for _ in range(2)]
    eng = _port_engine(tconfig, tparams)
    got = [eng.generate([prompt], SamplingParams(max_tokens=5))[0]
           .output_token_ids for _ in range(2)]
    assert eng.block_manager.prefix_tokens_saved > 0
    assert jeng.block_manager.prefix_tokens_saved == \
        eng.block_manager.prefix_tokens_saved
    assert got == ref and got[0] == got[1]


def test_preemption_matches_jax(weights):
    """10 pages of 8 tokens cannot hold three growing sequences (they need
    12 at the end): the newest is preempted and recomputed."""
    jconfig, jparams, tconfig, tparams = weights
    ref = _jax_generate(_jax_engine(jconfig, jparams, num_blocks=10),
                        PROMPTS, 16)
    eng = _port_engine(tconfig, tparams, num_blocks=10)
    outs = eng.generate(PROMPTS, SamplingParams(max_tokens=16))
    assert eng.stats()["preemptions"] > 0
    assert [o.output_token_ids for o in outs] == ref
    assert eng.block_manager.available() == 10


def test_filter_logits_matches_jax(cpu_jax):
    import jax.numpy as jnp

    from ray_tpu.llm.model_runner import ModelRunner as JaxRunner

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 32), dtype=np.float32) * 3
    temps = np.asarray([0.7, 1.0, 1.3, 0.5, 2.0], np.float32)
    top_ks = np.asarray([0, 5, 1, 32, 8], np.int32)
    top_ps = np.asarray([0.9, 1.0, 0.5, 0.3, 1.0], np.float32)
    jr = JaxRunner.__new__(JaxRunner)
    ref = np.asarray(jr._filter_logits(jnp.asarray(logits),
                                       jnp.asarray(temps),
                                       jnp.asarray(top_ks),
                                       jnp.asarray(top_ps)))
    tr = tmr.ModelRunner.__new__(tmr.ModelRunner)
    out = tr._filter_logits(torch.from_numpy(logits),
                            torch.from_numpy(temps),
                            torch.from_numpy(top_ks).long(),
                            torch.from_numpy(top_ps)).numpy()
    assert np.array_equal(out <= -1e29, ref <= -1e29), "kept sets differ"
    kept = ref > -1e29
    np.testing.assert_allclose(out[kept], ref[kept], rtol=1e-6)


def test_seeded_sampling_replays_inside_port(weights):
    _, _, tconfig, tparams = weights
    sp = SamplingParams(max_tokens=8, temperature=0.8, top_k=20)
    runs = []
    for _ in range(2):
        eng = _port_engine(tconfig, tparams)
        for i, p in enumerate(PROMPTS):
            eng.add_request(p, sp, request_id=f"req-{i}")
        done = {}
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    done[o.request_id] = o.output_token_ids
        runs.append(done)
    assert runs[0] == runs[1]
    assert all(len(t) == 8 for t in runs[0].values())


def test_seeded_request_same_alone_and_batched(weights):
    """The draw depends on (seed, counter) only: the same request id gives
    the same tokens alone and in another slot of a mixed batch."""
    _, _, tconfig, tparams = weights
    sp = SamplingParams(max_tokens=10, temperature=0.8, top_k=20)
    runs = []
    for others in ([], PROMPTS):
        eng = _port_engine(tconfig, tparams)
        for i, p in enumerate(others):
            eng.add_request(p, SamplingParams(max_tokens=12),
                            request_id=f"other-{i}")
        eng.add_request([9, 4, 17, 2, 60], sp, request_id="seeded")
        done = {}
        while eng.has_unfinished():
            done.update({o.request_id: o.output_token_ids
                         for o in eng.step() if o.finished})
        runs.append(done["seeded"])
    assert runs[0] == runs[1] and len(runs[0]) == 10


def test_gumbel_noise_is_pure_function_of_seed_and_counter():
    seeds = torch.tensor([7, 7, 99, 123456789], dtype=torch.int64)
    counters = torch.tensor([0, 5, 5, 2 ** 31 + 3], dtype=torch.int64)
    batch = tmr.gumbel_noise(seeds, counters, 50)
    for i in range(4):
        alone = tmr.gumbel_noise(seeds[i:i + 1], counters[i:i + 1], 50)
        assert torch.equal(alone[0], batch[i])
    assert not torch.equal(batch[0], batch[1])
    assert torch.isfinite(batch).all()


def test_sampling_frequencies_match_filtered_softmax():
    """40000 draws over consecutive counters: every token's frequency is
    within 0.012 of the filtered softmax (>= 4.8 standard errors, the
    largest standard error being sqrt(0.25 / 40000) = 0.0025)."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal(16, dtype=np.float32))
    n = 40000
    tr = tmr.ModelRunner.__new__(tmr.ModelRunner)
    rows = logits[None].expand(n, 16).contiguous()
    scaled = tr._filter_logits(rows, torch.full((n,), 0.9),
                               torch.full((n,), 8, dtype=torch.long),
                               torch.full((n,), 0.95))
    noise = tmr.gumbel_noise(torch.full((n,), 1234, dtype=torch.long),
                             torch.arange(n), 16)
    draws = torch.argmax(scaled + noise, dim=-1)
    freq = torch.bincount(draws, minlength=16).double() / n
    target = torch.softmax(scaled[0].double(), dim=-1)
    assert (freq[target == 0] == 0).all(), "filtered token drawn"
    assert (freq - target).abs().max() < 0.012


def test_engine_refuses_unported_features(weights):
    """Nothing of the engine stays refused: the split path, multi-step
    decode, speculation (unified and split), repetition penalty, LoRA,
    weight updates and prefill-only engines run; the disaggregated wire's
    parity tests are tests/test_torch_disagg.py and
    tests/test_torch_migration.py, the cluster prefix tier's
    tests/test_torch_prefix_store.py."""
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer

    _, _, tconfig, tparams = weights
    for kw in ({"unified_ticks": False}, {"decode_multi_step": 4},
               {"speculative_ngram": 2},
               {"speculative_ngram": 2, "unified_ticks": True},
               {"speculative_ngram": 2, "unified_ticks": False},
               {"speculative_ngram": 2, "decode_multi_step": 4},
               {"prefill_only": True}):
        _port_engine(tconfig, tparams, **kw)
    eng = _port_engine(tconfig, tparams)
    # LoRA and weight updates are ported: an engine without adapters
    # says so, and an idle engine takes its own weights back.
    with pytest.raises(ValueError, match="no LoRA manager"):
        eng.add_request([1, 2], lora_name="a")
    assert eng.update_weights(tparams)["version"] == 1
    eng.add_request([1, 2], SamplingParams(repetition_penalty=1.2))
    cfg = LLMConfig(model_config=tconfig, num_kv_blocks=16, block_size=8,
                    device="cpu", warmup_buckets="off")
    with LLMServer(cfg, params=tparams) as server:
        # Collecting a request this server never adopted is an error.
        with pytest.raises(KeyError, match="not adopted"):
            server.completions_collect("r")


def test_llm_server_round_trip(weights):
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer

    _, _, tconfig, tparams = weights
    cfg = LLMConfig(model_config=tconfig, num_kv_blocks=64, block_size=8,
                    max_batch_size=4, prefill_chunk=8, device="cpu")
    ref = _port_engine(tconfig, tparams).generate(
        PROMPTS[:2], SamplingParams(max_tokens=5))
    with LLMServer(cfg, params=tparams) as server:
        resp = server.completions({"prompt": PROMPTS[0], "max_tokens": 5})
        assert resp["choices"][0]["token_ids"] == ref[0].output_token_ids
        assert resp["usage"] == {"prompt_tokens": 21,
                                 "completion_tokens": 5}
        events = list(server.completions_stream(
            {"prompt": PROMPTS[1], "max_tokens": 5, "request_id": "s1"}))
        assert [e["token"] for e in events[:-1]] == ref[1].output_token_ids
        assert events[-1]["finished"] and events[-1]["token_ids"] == \
            ref[1].output_token_ids
        assert server.abort("unknown") is False
        stats = server.engine_stats()
        assert stats["running"] == 0 and stats["ticks"] > 0
        assert stats["free_kv_blocks"] == 64


def test_stream_and_abort(weights):
    _, _, tconfig, tparams = weights
    eng = _port_engine(tconfig, tparams)
    ref = eng.generate([PROMPTS[2]], SamplingParams(max_tokens=4))[0]
    assert list(eng.stream(PROMPTS[2], SamplingParams(max_tokens=4))) == \
        ref.output_token_ids
    rid = eng.add_request(PROMPTS[0], SamplingParams(max_tokens=50))
    eng.step()
    assert eng.stats()["prefilling"] == 1
    assert eng.abort_request(rid) is True
    assert eng.abort_request(rid) is False
    assert not eng.has_unfinished()
    assert eng.block_manager.available() == 64


@pytest.mark.parametrize("params", [
    dict(), dict(temperature=0.7, top_k=5, seed=3),
    dict(temperature=1.2, top_p=0.6, seed=11),
    dict(repetition_penalty=1.3)])
def test_host_sample_matches_jax(cpu_jax, params):
    from ray_tpu.llm import sampling as jsampling
    from ray_tpu_torch.llm import sampling as tsampling

    rng = np.random.default_rng(4)
    logits = rng.standard_normal(40).astype(np.float32) * 2
    prev = np.asarray([3, 7, 7, 21])
    ref = jsampling.sample(logits, jsampling.SamplingParams(**params), prev)
    got = tsampling.sample(logits, tsampling.SamplingParams(**params), prev)
    assert got == ref


def test_server_fails_requests_when_a_step_raises(weights):
    """A failing tick surfaces to the waiting caller and leaves the engine
    empty with every page free; the server keeps serving afterwards."""
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer

    _, _, tconfig, tparams = weights
    cfg = LLMConfig(model_config=tconfig, num_kv_blocks=64, block_size=8,
                    max_batch_size=4, prefill_chunk=8, device="cpu")
    with LLMServer(cfg, params=tparams) as server:
        real_step = server.engine.runner.step_mixed

        def broken(*args, **kwargs):
            raise RuntimeError("injected step failure")

        server.engine.runner.step_mixed = broken
        with pytest.raises(RuntimeError, match="injected"):
            server.completions({"prompt": PROMPTS[1], "max_tokens": 3})
        server.engine.runner.step_mixed = real_step
        stats = server.engine_stats()
        assert stats["free_kv_blocks"] == 64 and stats["waiting"] == 0
        resp = server.completions({"prompt": PROMPTS[1], "max_tokens": 3})
        assert len(resp["choices"][0]["token_ids"]) == 3
