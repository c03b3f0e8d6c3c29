"""The port's split serving path against the JAX package, on the CPU.

Both packages run the tiny fp32 config of tests/test_torch_engine.py on
the same weights. Runner level: the rectangular heads (`step` logits to
1e-4, `step_verify` and `step_sample_multi` greedy ids identical). Engine
level, greedy tokens IDENTICAL to the JAX engine with the same options:
`unified_ticks=False` (mixed prompts, a prefix-cache hit, preemption with
deferred release at pipeline depth 4), `decode_multi_step=4` (max_tokens
not a multiple of 4, a stop token), split speculation
(`speculative_ngram=4, unified_ticks=False`, same accepted count) and a
repetition-penalty request on the default unified engine, which routes it
to the split host-logits path: greedy, and seeded with temperature > 0
(both packages' host sampler draws from np.random.default_rng(seed)).
Inside the port: a seeded request samples alike on the split and unified
paths, warmup(full=True) covers every split shape, and the decode
dispatch calls nothing that synchronises with the device.
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
CYCLIC = [5, 9, 13, 5, 9, 13, 5, 9, 13, 5, 9]           # n-gram friendly


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


def _port_engine(weights, num_blocks=64, **kw):
    _, _, tconfig, tparams = weights
    runner = tmr.ModelRunner(tconfig, tparams, num_blocks=num_blocks,
                             block_size=8, chunk_size=8, device="cpu")
    return LLMEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _jax_engine(weights, num_blocks=64, **kw):
    from ray_tpu.llm.engine import LLMEngine as JaxEngine
    from ray_tpu.llm.model_runner import ModelRunner as JaxRunner

    jconfig, jparams, _, _ = weights
    runner = JaxRunner(jconfig, jparams, num_blocks=num_blocks,
                       block_size=8, chunk_size=8)
    return JaxEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _both(weights, prompts, params, num_blocks=64, **kw):
    """Generate with both packages under the same engine options; returns
    (jax outputs, port outputs, jax engine, port engine)."""
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    jeng = _jax_engine(weights, num_blocks, **kw)
    jouts = jeng.generate(prompts, JaxParams(**params))
    teng = _port_engine(weights, num_blocks, **kw)
    touts = teng.generate(prompts, SamplingParams(**params))
    return jouts, touts, jeng, teng


def _ids(outs):
    return [o.output_token_ids for o in outs]


# ---- runner: the rectangular heads ----------------------------------------

def test_runner_heads_match_jax(weights):
    """A prefill chunk with padding rows and padding sequences (S=4,
    Bq=8), then a verify-width step (Bq=4), then 3 multi-step decode
    tokens: logits to 1e-4, greedy ids identical."""
    from ray_tpu.llm.model_runner import ModelRunner as JaxRunner

    jconfig, jparams, tconfig, tparams = weights
    jr = JaxRunner(jconfig, jparams, num_blocks=32, block_size=8,
                   chunk_size=8)
    tr = tmr.ModelRunner(tconfig, tparams, num_blocks=32, block_size=8,
                         chunk_size=8, device="cpu")
    rng = np.random.default_rng(0)
    tables = np.zeros((4, 8), np.int32)
    tables[0, :4] = [3, 1, 7, 5]
    tables[1, :4] = [2, 9, 4, 6]

    def run(name, *args):
        return (np.asarray(getattr(jr, name)(*args)),
                getattr(tr, name)(*args).numpy())

    tokens = rng.integers(0, 128, (4, 8)).astype(np.int32)
    z = np.zeros(4, np.int32)
    ref, got = run("step", tokens, z, np.asarray([8, 5, 0, 0], np.int32),
                   np.asarray([8, 5, 0, 0], np.int32), tables)
    assert got.dtype == np.float32 and got.shape == (4, 128)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    tokens = rng.integers(0, 128, (4, 4)).astype(np.int32)
    ref, got = run("step_verify", tokens, np.asarray([8, 5, 0, 0], np.int32),
                   np.asarray([12, 7, 0, 0], np.int32),
                   np.asarray([4, 2, 0, 0], np.int32), tables)
    assert np.array_equal(got[:2], ref[:2])

    samp = (np.zeros(4, np.float32), z, np.ones(4, np.float32), z, z + 13)
    ref, got = run("step_sample_multi", 3, got[:, :1].copy(),
                   np.asarray([12, 7, 0, 0], np.int32),
                   np.asarray([13, 8, 0, 0], np.int32),
                   np.asarray([1, 1, 0, 0], np.int32), tables, *samp)
    assert got.shape == (4, 3) and np.array_equal(got[:2], ref[:2])
    assert {k[0] for k in tr._seen_shapes} == {"step", "verify", "multi3"}


# ---- engine: identical greedy tokens with the same options ---------------

def test_split_matches_jax_mixed_prompts_and_naive(weights):
    jouts, touts, _, teng = _both(weights, PROMPTS, dict(max_tokens=10),
                                  unified_ticks=False)
    assert _ids(touts) == _ids(jouts)
    assert teng.ticks == 0 and teng.stats()["inflight_steps"] == 0
    _, _, tconfig, tparams = weights
    unified = _port_engine(weights).generate(
        PROMPTS, SamplingParams(max_tokens=10))
    assert _ids(unified) == _ids(touts)
    assert teng.block_manager.available() == 64


def test_split_prefix_cache_hit_matches_jax(weights):
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    prompt = PROMPTS[0] + [4, 4, 9]
    jeng = _jax_engine(weights, unified_ticks=False)
    teng = _port_engine(weights, unified_ticks=False)
    ref = [jeng.generate([prompt], JaxParams(max_tokens=5))[0]
           .output_token_ids for _ in range(2)]
    got = [teng.generate([prompt], SamplingParams(max_tokens=5))[0]
           .output_token_ids for _ in range(2)]
    assert got == ref and got[0] == got[1]
    assert teng.block_manager.prefix_tokens_saved == \
        jeng.block_manager.prefix_tokens_saved > 0


def test_split_preemption_deferred_release_matches_jax(weights):
    """10 pages of 8 tokens cannot hold three growing sequences: the
    newest is preempted while its decode steps are in flight (pipeline
    depth 4), its pages are released only once they drain."""
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    kw = dict(num_blocks=10, unified_ticks=False)
    ref = _jax_engine(weights, pipeline_depth=4, **kw).generate(
        PROMPTS, JaxParams(max_tokens=16))
    teng = _port_engine(weights, **kw)
    assert teng.pipeline_depth == 4
    deferred = []
    defer = teng._defer_release

    def spy(req):
        if req.dispatched:
            deferred.append(req.id)
        defer(req)

    teng._defer_release = spy
    outs = teng.generate(PROMPTS, SamplingParams(max_tokens=16))
    assert _ids(outs) == _ids(ref)
    assert teng.stats()["preemptions"] > 0 and deferred
    assert teng.block_manager.available() == 10


def test_abort_defers_release_until_flights_drain(weights):
    eng = _port_engine(weights, unified_ticks=False)
    rid = eng.add_request(PROMPTS[1], SamplingParams(max_tokens=30))
    while eng.stats()["inflight_steps"] < 3:
        eng.step()
    held = len(eng.running[0].blocks)
    assert eng.abort_request(rid) is True
    assert len(eng._pending_release) == 1
    assert eng.block_manager.available() == 64 - held
    assert eng.has_unfinished()            # flights still to harvest
    assert eng.drain_flights() == []       # aborted: nothing emitted
    assert eng.block_manager.available() == 64
    assert not eng.has_unfinished()


@pytest.mark.parametrize("max_tokens,stop_at", [(16, None), (7, None),
                                                (16, 2)])
def test_multistep_matches_jax(weights, max_tokens, stop_at):
    """decode_multi_step=4: the default (unified) engine routes it to the
    split path in both packages; max_tokens=7 overshoots within its pages
    and is cut at harvest; a stop token mid-chunk ends the stream."""
    prompts = [[1, 5, 9, 2], [7, 3], [11, 4, 6]]
    params = dict(max_tokens=max_tokens)
    if stop_at is not None:
        probe = _port_engine(weights).generate(
            prompts[:1], SamplingParams(max_tokens=8))[0].output_token_ids
        params["stop_token_ids"] = [probe[stop_at]]
    jouts, touts, _, teng = _both(weights, prompts, params,
                                  decode_multi_step=4)
    assert _ids(touts) == _ids(jouts)
    assert [o.finish_reason for o in touts] == \
        [o.finish_reason for o in jouts]
    assert any(k[0] == "multi4" for k in teng.runner._seen_shapes)
    assert teng.ticks == 0
    if stop_at is None:
        assert all(len(o.output_token_ids) == max_tokens for o in touts)
    else:
        assert touts[0].finish_reason == "stop"
    assert teng.block_manager.available() == 64


def test_split_speculation_matches_jax(weights):
    jouts, touts, jeng, teng = _both(
        weights, [CYCLIC, PROMPTS[1]], dict(max_tokens=12),
        speculative_ngram=4, unified_ticks=False)
    assert _ids(touts) == _ids(jouts)
    s, js = teng.stats(), jeng.stats()
    assert s["spec_tokens_proposed"] > 0
    assert s["spec_tokens_accepted"] == js["spec_tokens_accepted"]
    assert s["spec_tokens_proposed"] == js["spec_tokens_proposed"]
    plain = _port_engine(weights, unified_ticks=False).generate(
        [CYCLIC, PROMPTS[1]], SamplingParams(max_tokens=12))
    assert _ids(plain) == _ids(touts)


@pytest.mark.parametrize("params", [
    dict(max_tokens=8, repetition_penalty=1.3),
    dict(max_tokens=8, repetition_penalty=1.3, temperature=0.8, top_k=20,
         seed=1234)])
def test_repetition_penalty_routes_split_host_logits(weights, params):
    """The default (unified) engine sends a repetition-penalty request down
    the split path (no mixed tick), where the host samples full logits."""
    jouts, touts, _, teng = _both(weights, [PROMPTS[1], PROMPTS[2]], params)
    assert _ids(touts) == _ids(jouts)
    assert teng.ticks == 0
    assert {k[0] for k in teng.runner._seen_shapes} == {"step"}


# ---- inside the port -----------------------------------------------------

def test_seeded_request_same_on_split_and_unified(weights):
    """temperature > 0 with a seed: both paths key each draw on (seed,
    absolute token index), so they sample the same tokens."""
    prompts = [[(5 * i + 1) % 128 for i in range(11)],
               [2, 7, 1, 12, 9, 5, 3, 13]]
    sp = SamplingParams(max_tokens=8, temperature=0.8, top_k=20, seed=1234)
    uni = _port_engine(weights).generate(prompts, sp)
    split = _port_engine(weights, unified_ticks=False).generate(prompts, sp)
    assert _ids(uni) == _ids(split)
    assert all(len(o.output_token_ids) == 8 for o in uni)


def test_warmup_full_covers_split_shapes(weights):
    eng = _port_engine(weights, unified_ticks=False, decode_multi_step=4)
    assert eng.warmup(full=True) > 0
    warm = eng.stats()["step_compiles"]
    eng.generate(PROMPTS + [[4, 4, 8]], SamplingParams(max_tokens=9))
    eng.generate([[9, 1, 1, 2, 3, 5, 8, 13]],
                 SamplingParams(max_tokens=5, temperature=0.9, seed=7))
    eng.generate([PROMPTS[1]], SamplingParams(max_tokens=4,
                                              repetition_penalty=1.2))
    assert eng.stats()["step_compiles"] == warm


def test_dispatch_decode_never_synchronises(weights, monkeypatch):
    """No .item(), .cpu(), .tolist() or host conversion of a tensor inside
    _dispatch_decode: on the card each would wait for the device."""
    eng = _port_engine(weights, unified_ticks=False, decode_multi_step=2)
    inside = []
    for name in ("item", "cpu", "tolist", "numpy", "__array__"):
        real = getattr(torch.Tensor, name)

        def guard(self, *a, _real=real, _name=name, **kw):
            if inside:
                raise AssertionError(f"Tensor.{_name} in _dispatch_decode")
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, guard)
    dispatch = eng._dispatch_decode

    def watched(prev):
        inside.append(1)
        try:
            return dispatch(prev)
        finally:
            inside.pop()

    eng._dispatch_decode = watched
    outs = eng.generate(PROMPTS, SamplingParams(max_tokens=7))
    assert [len(o.output_token_ids) for o in outs] == [7, 7, 7]


def test_llm_server_split_round_trip(weights):
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer

    _, _, tconfig, tparams = weights
    ref = _port_engine(weights).generate(
        PROMPTS[:2], SamplingParams(max_tokens=5, repetition_penalty=1.3))
    cfg = LLMConfig(model_config=tconfig, num_kv_blocks=64, block_size=8,
                    max_batch_size=4, prefill_chunk=8, device="cpu",
                    unified_ticks=False, warmup_buckets="light")
    with LLMServer(cfg, params=tparams) as server:
        resp = server.completions({"prompt": PROMPTS[0], "max_tokens": 5,
                                   "repetition_penalty": 1.3})
        assert resp["choices"][0]["token_ids"] == ref[0].output_token_ids
        events = list(server.completions_stream(
            {"prompt": PROMPTS[1], "max_tokens": 5,
             "repetition_penalty": 1.3}))
        assert events[-1]["token_ids"] == ref[1].output_token_ids
        stats = server.engine_stats()
        assert stats["ticks"] == 0 and not stats["unified_ticks"]
        assert stats["free_kv_blocks"] == 64
    with pytest.raises(ValueError, match="warmup_buckets"):
        LLMServer(LLMConfig(model_config=tconfig, device="cpu",
                            warmup_buckets="some"), params=tparams)
