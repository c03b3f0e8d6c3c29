"""Multi-LoRA serving of the port against the JAX package, on the CPU.

The JAX original and the port run on the same numpy inputs, the same
weights (JAX `init_params` converted with `params_from_numpy`) and the
same adapters (a JAX `init_adapter` result loads into the port's manager
as it is), at the tiny fp32 config of tests/test_torch_spec_unified.py.
Slot tables, stacks, pool-policy decisions, greedy tokens and counters
must be IDENTICAL; deltas agree to fp32 rounding (1e-5).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import engine as te
from ray_tpu_torch.llm import lora as tlora
from ray_tpu_torch.llm import model_runner as tmr
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.models import llama as tl

TOL = 1e-5
# Prompts 0 and 3 are equal and ride different adapters: a shared prefix
# cache across adapters would show in prefill_tokens_computed.
PROMPTS = [[5, 9, 13] * 4 + [5, 9],
           [1, 5, 9, 2, 11, 3, 8],
           [(7 * i + 3) % 128 for i in range(21)],
           [5, 9, 13] * 4 + [5, 9]]
LORAS = [None, "a0", "a1", "a2"]


@pytest.fixture(scope="module")
def weights(cpu_jax):
    import jax
    import jax.numpy as jnp

    from ray_tpu.llm import lora as jlora
    from ray_tpu.models import llama as jl

    jconfig = jl.LlamaConfig.tiny(vocab_size=128, max_seq=64,
                                  dtype=jnp.float32)
    jparams = jl.init_params(jconfig, jax.random.key(0))
    tconfig = tl.LlamaConfig.tiny(vocab_size=128, max_seq=64,
                                  dtype=torch.float32)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   tconfig, device="cpu")
    # Rank 4 is zero-padded to the managers' rank 8.
    adapters = [jlora.init_adapter(jconfig, f"a{i}", rank=4 if i == 1 else 8,
                                   targets=jlora.TARGETS,
                                   key=jax.random.key(10 + i), scale=0.5)
                for i in range(4)]
    return jconfig, jparams, tconfig, tparams, adapters


def _managers(weights, n_slots=4, adapters=3):
    from ray_tpu.llm import lora as jlora

    jconfig, _, tconfig, _, ads = weights
    jm = jlora.LoRAManager(jconfig, n_slots=n_slots, rank=8)
    tm = tlora.LoRAManager(tconfig, n_slots=n_slots, rank=8, device="cpu")
    for a in ads[:adapters]:
        assert jm.load_adapter(a) == tm.load_adapter(a)
    return jm, tm


def _port_engine(weights, manager="default", num_blocks=64, params=None,
                 **kw):
    _, _, tconfig, tparams, _ = weights
    if manager == "default":
        manager = _managers(weights)[1]
    runner = tmr.ModelRunner(tconfig, tparams if params is None else params,
                             num_blocks=num_blocks, block_size=8,
                             chunk_size=8, device="cpu",
                             lora_manager=manager)
    return te.LLMEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _jax_engine(weights, manager="default", num_blocks=64, **kw):
    from ray_tpu.llm.engine import LLMEngine
    from ray_tpu.llm.model_runner import ModelRunner

    jconfig, jparams, _, _, _ = weights
    if manager == "default":
        manager = _managers(weights)[0]
    runner = ModelRunner(jconfig, jparams, num_blocks=num_blocks,
                         block_size=8, chunk_size=8, lora_manager=manager)
    return LLMEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _run(engine, params_cls=SamplingParams, prompts=PROMPTS, loras=LORAS,
         max_tokens=10):
    for i, (p, name) in enumerate(zip(prompts, loras)):
        engine.add_request(p, params_cls(max_tokens=max_tokens),
                           request_id=f"r{i}", lora_name=name)
    done = {}
    while engine.has_unfinished():
        done.update({o.request_id: o.output_token_ids
                     for o in engine.step() if o.finished})
    return [done[f"r{i}"] for i in range(len(prompts))]


def _jax_stacks(jm, t):
    a, b = jm.stacks[t]
    return np.asarray(a), np.asarray(b)


def _port_stacks(tm, t):
    a, b = tm.slot_stacks(t)
    return a.numpy(), b.numpy()


# ---- the delta ------------------------------------------------------------

def test_apply_lora_gathered_matches_jax(cpu_jax):
    """JAX's gathered `apply_lora` against the port's plain version, per
    sequence slot; the base slot (zero factors) adds exact zeros."""
    import jax.numpy as jnp

    from ray_tpu.llm import lora as jlora

    rng = np.random.default_rng(1)
    S, Bq, d_in, r, d_out, n_slots = 5, 3, 24, 4, 20, 4
    x = rng.standard_normal((S, Bq, d_in), dtype=np.float32)
    lA = rng.standard_normal((n_slots, d_in, r), dtype=np.float32)
    lB = rng.standard_normal((n_slots, r, d_out), dtype=np.float32)
    lA[0], lB[0] = 0.0, 0.0
    idx = np.array([0, 2, 1, 3, 2], np.int32)
    ref = np.asarray(jlora.apply_lora(jnp.asarray(x), jnp.asarray(lA),
                                      jnp.asarray(lB), jnp.asarray(idx)))
    got = tlora.apply_lora(*map(torch.from_numpy, (x, lA, lB, idx)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    assert not got[0].any()


@pytest.mark.parametrize("layer", [0, 1])
def test_runner_projection_deltas_match_jax(weights, layer):
    """The runner's form (`ModelRunner._project`: every slot's A of an
    input group at once, other slots' columns masked, one addmm per
    target) adds, per row, JAX's gathered `apply_lora` delta on JAX's
    manager stacks, for every target of every input group."""
    import jax.numpy as jnp

    from ray_tpu.llm import lora as jlora

    jm, tm = _managers(weights)
    runner = _port_engine(weights, manager=tm).runner
    dims = tlora.target_dims(runner.config)
    slots = np.array([0, 2, 1, 3, 3, 0, 1], np.int32)
    rng = np.random.default_rng(layer)
    mask = runner._lora_mask(torch.from_numpy(slots))
    for group in tlora.INPUT_GROUPS:
        h = rng.standard_normal((len(slots), dims[group[0]][0]),
                                dtype=np.float32)
        got = runner._project(torch.from_numpy(h), layer, group, mask)
        for t, out in zip(group, got):
            base = (torch.from_numpy(h)
                    @ runner.params["layers"][t][layer]).numpy()
            a, b = (jnp.asarray(x[layer]) for x in jm.stacks[t])
            ref = np.asarray(jlora.apply_lora(jnp.asarray(h)[:, None], a, b,
                                              jnp.asarray(slots)))[:, 0]
            np.testing.assert_allclose(out.numpy() - base, ref, rtol=TOL,
                                       atol=TOL)
            assert not (out[slots == 0].numpy() - base[slots == 0]).any()


def test_init_adapter_shapes_and_seeding():
    config = tl.LlamaConfig.tiny(dtype=torch.float32)
    a = tlora.init_adapter(config, "x", rank=4, targets=tlora.TARGETS,
                           generator=torch.Generator().manual_seed(3))
    b = tlora.init_adapter(config, "x", rank=4, targets=tlora.TARGETS,
                           generator=torch.Generator().manual_seed(3))
    dims = tlora.target_dims(config)
    for t in tlora.TARGETS:
        assert a.weights[t][0].shape == (config.n_layers, dims[t][0], 4)
        assert a.weights[t][1].shape == (config.n_layers, 4, dims[t][1])
        assert a.weights[t][0].dtype == np.float32
        np.testing.assert_array_equal(a.weights[t][0], b.weights[t][0])
    assert a.scaling == 16.0 / 4


def test_packed_upload_carries_the_slot_index():
    """With a manager, the mixed step's packed int32 upload holds one more
    (S,) field, the slot per sequence, after the base layout's fields;
    without one the layout is the base layout."""
    base, n = tmr.mixed_layout(16, 4, 2, 6)
    layout, size = tmr.mixed_layout(16, 4, 2, 6, lora=True)
    assert "lora_idx" not in base and list(layout)[:-1] == list(base)
    assert layout["lora_idx"] == (n, (4,)) and size == n + 4
    arrays = {name: np.full(shape, 3, np.float32 if name in
                            ("temps", "top_ps") else np.int32)
              for name, (_, shape) in layout.items()}
    arrays["lora_idx"] = np.array([0, 2, 1, 4], np.int32)
    got = tmr.unpack_mixed(torch.from_numpy(
        tmr.pack_mixed(layout, size, arrays)), layout)
    assert got["lora_idx"].tolist() == [0, 2, 1, 4]
    assert got["top_ps"].tolist() == [3.0] * 4


# ---- the manager ----------------------------------------------------------

def test_manager_load_lru_pin_refresh_resize_match_jax(weights):
    """Same slots, same stacks, same counters as JAX's manager through
    loads (a rank-4 adapter padded), an LRU eviction, pins, a refused
    pinned refresh, a refused load with every slot pinned, and resizes
    (grow, then a shrink clamped to the highest loaded slot)."""
    _, _, _, _, ads = weights
    jm, tm = _managers(weights, n_slots=2, adapters=2)

    def same():
        assert jm.loaded == tm.loaded
        assert jm.n_slots == tm.n_slots
        assert (jm.loads, jm.evictions) == (tm.loads, tm.evictions)
        assert dict(jm._pins) == dict(tm._pins)
        for s in range(jm.n_slots):
            assert jm.name_of(s) == tm.name_of(s)
        for t in tlora.TARGETS:
            for ja, ta in zip(_jax_stacks(jm, t), _port_stacks(tm, t)):
                np.testing.assert_allclose(ta, ja, rtol=TOL, atol=TOL)

    same()
    assert jm.slot_of("a0") == tm.slot_of("a0")   # a1 is now the LRU
    assert jm.load_adapter(ads[2]) == tm.load_adapter(ads[2])  # evicts a1
    same()
    for m in (jm, tm):
        m.pin(m.slot_of("a2"))
        with pytest.raises(RuntimeError, match="in-flight"):
            m.load_adapter(ads[2])
        m.pin(m.slot_of("a0"))
        with pytest.raises(RuntimeError, match="all LoRA slots"):
            m.load_adapter(ads[1])
        with pytest.raises(KeyError):
            m.slot_of("a1")
        m.unpin(m.slot_of("a2"))
    same()
    assert jm.resize(5) == tm.resize(5) == 5
    assert jm.load_adapter(ads[1]) == tm.load_adapter(ads[1])
    same()
    assert jm.resize(1) == tm.resize(1) == 3   # clamped: slot 3 is loaded
    same()
    assert tm.epoch == 2
    with pytest.raises(ValueError, match="rank"):
        tm.load_adapter(tlora.LoRAAdapter("big", 16, 1.0, {}))


def test_pool_policy_decisions_match_jax(cpu_jax):
    """One stats/time script through both policies: grow on occupancy,
    grow on eviction, cooldown, shrink only after a quiet window."""
    from ray_tpu.llm import lora as jlora

    cfg = dict(min_slots=1, max_slots=12, cooldown_s=5.0, quiet_s=8.0)
    jp = jlora.LoRAPoolPolicy(jlora.LoRAPoolPolicyConfig(**cfg))
    tp = tlora.LoRAPoolPolicy(tlora.LoRAPoolPolicyConfig(**cfg))
    script = [({"lora_slots": 4, "lora_loaded": 4}, 10.0),
              ({"lora_slots": 6, "lora_loaded": 6}, 12.0),
              ({"lora_slots": 6, "lora_loaded": 3, "lora_evictions": 1},
               16.0),
              ({"lora_slots": 9, "lora_loaded": 2}, 22.0),
              ({"lora_slots": 9, "lora_loaded": 2}, 26.0),
              ({"lora_slots": 9, "lora_loaded": 2}, 31.0),
              ({"lora_slots": 4, "lora_loaded": 3}, 40.0),
              ({"lora_slots": 0}, 50.0)]
    got = [tp.desired(s, t) for s, t in script]
    assert got == [jp.desired(s, t) for s, t in script]
    assert any(g is not None and g > 6 for g in got)
    assert any(g is not None and g < 9 for g in got)


# ---- the engine -----------------------------------------------------------

def test_digest_chain_seeded_with_slot_as_jax(weights, monkeypatch):
    """The prefix digest chain's seed is the LoRA slot as 8 signed
    little-endian bytes, as JAX's: with the same salt, the same chain."""
    from ray_tpu.llm import engine as je

    salt = b"0123456789abcdef"
    monkeypatch.setattr(je, "_PREFIX_CACHE_SALT", salt)
    monkeypatch.setattr(te, "_PREFIX_CACHE_SALT", salt)
    prompt = list(range(40))
    jbm = je.BlockManager(16, 8)
    tbm = te.BlockManager(16, 8)
    chains = {}
    for slot in (0, 3, -1):
        chains[slot] = tbm.prefix_hashes(prompt, slot)
        assert chains[slot] == jbm.prefix_hashes(prompt, slot)
    assert chains[0] != chains[3] != chains[-1]


@pytest.mark.parametrize("kw", [
    {}, {"speculative_ngram": 3}, {"unified_ticks": False},
    {"decode_multi_step": 4}, {"speculative_ngram": 3, "unified_ticks": False},
    {"num_blocks": 10}, {"num_blocks": 10, "unified_ticks": False}],
    ids=["unified", "unified-spec3", "split", "split-multistep",
         "split-spec3", "unified-10-pages", "split-10-pages"])
def test_mixed_adapter_batch_matches_jax(weights, kw):
    """Greedy tokens of one batch over the base model and three adapters
    equal the JAX engine's on the unified tick (speculation off and on)
    and on every split path (plain, multi-step, speculative), also with 10
    pages of 8 tokens (preemption and recompute); prefill_tokens_computed
    equal too (the two equal prompts under different adapters share no
    cached KV), and every pin is released."""
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    jeng = _jax_engine(weights, **kw)
    ref = _run(jeng, JaxParams)
    eng = _port_engine(weights, **kw)
    got = _run(eng)
    assert got == ref
    assert got[0] != got[3]
    stats, jstats = eng.stats(), jeng.stats()
    for key in ("prefill_tokens_computed", "prefix_hits", "lora_slots",
                "lora_loaded", "lora_pinned", "lora_loads", "lora_evictions",
                "spec_tokens_proposed", "spec_tokens_accepted"):
        assert stats[key] == jstats[key], key
    if "num_blocks" not in kw:
        assert stats["prefill_tokens_computed"] == sum(map(len, PROMPTS))
    assert stats["lora_pinned"] == 0


def test_lora_repetition_penalty_matches_jax(weights):
    """A repetition-penalty request on an adapter takes the split
    host-logits path (`runner.step` with the slot index) on both engines:
    the same tokens as JAX's."""
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    outs = []
    for make, cls in ((_jax_engine, JaxParams), (_port_engine,
                                                   SamplingParams)):
        eng = make(weights)
        for i, name in enumerate(("a1", None)):
            eng.add_request(PROMPTS[2], cls(max_tokens=8,
                                            repetition_penalty=1.3),
                            request_id=f"r{i}", lora_name=name)
        done = {}
        while eng.has_unfinished():
            done.update({o.request_id: o.output_token_ids
                         for o in eng.step() if o.finished})
        outs.append(done)
    assert outs[0] == outs[1] and outs[1]["r0"] != outs[1]["r1"]


def test_lora_warmup_full_matches_jax(weights):
    """`warmup(full=True)` of a LoRA engine warms as many shapes as the
    JAX engine's (every step entry point takes the slot stacks), and a
    mixed-adapter batch afterwards adds no step signature. (The port
    counts two signatures per token bucket, all-greedy and sampled, where
    JAX compiles one program.)"""
    jeng, eng = _jax_engine(weights), _port_engine(weights)
    assert eng.warmup(full=True) == jeng.warmup(full=True)
    compiles = eng.runner.step_compiles
    _run(eng)
    assert eng.runner.step_compiles == compiles

def test_adapter_tokens_equal_merged_weights(weights):
    """Each adapter's greedy tokens equal greedy decoding of the naive
    forward with merged weights W + A·B·scaling; base-slot requests on the
    LoRA engine equal the engine without a manager."""
    _, _, tconfig, tparams, ads = weights
    got = _run(_port_engine(weights))
    base = _run(_port_engine(weights, manager=None), prompts=PROMPTS[:1],
                loras=[None])
    assert got[0] == base[0]
    for i, ad in enumerate(ads[:3]):
        merged = {k: v for k, v in tparams.items() if k != "layers"}
        merged["layers"] = dict(tparams["layers"])
        for t, (a, b) in ad.weights.items():
            merged["layers"][t] = merged["layers"][t] + torch.from_numpy(
                np.asarray(a) @ np.asarray(b) * ad.scaling)
        tokens = list(PROMPTS[i + 1])
        for _ in range(10):
            logits = tl.forward(merged, torch.tensor([tokens]), tconfig)
            tokens.append(int(torch.argmax(logits[0, -1])))
        assert got[i + 1] == tokens[len(PROMPTS[i + 1]):], ad.name


def test_lora_requests_pin_and_release(weights):
    """A request pins its slot from add_request to finish, abort or
    export; unknown names raise KeyError; an engine without a manager
    refuses lora_name."""
    eng = _port_engine(weights)
    lm = eng.runner.lora
    with pytest.raises(KeyError):
        eng.add_request([1, 2, 3], lora_name="missing")
    with pytest.raises(ValueError, match="no LoRA manager"):
        _port_engine(weights, manager=None).add_request([1], lora_name="a0")
    eng.add_request(PROMPTS[1], SamplingParams(max_tokens=3),
                    request_id="x", lora_name="a0")
    eng.add_request(PROMPTS[1], SamplingParams(max_tokens=30),
                    request_id="y", lora_name="a1")
    eng.add_request(PROMPTS[1], SamplingParams(max_tokens=30),
                    request_id="z", lora_name="a1")
    assert eng.stats()["lora_pinned"] == 2 and lm._pins[2] == 2
    eng.step()
    assert eng.abort_request("y")
    while "x" in {r.id for r in eng.running + eng.prefilling}:
        eng.step()
    assert lm._pins == {2: 1}
    state = eng.export_request("z")
    assert state["lora_slot"] == 2 and lm._pins == {}
    eng.block_manager.release_blocks(state["blocks"])
    assert not eng.has_unfinished()


def test_resize_recaptures_once_and_load_needs_none(weights):
    """On the CPU the runner counts a new LoRA epoch's mixed step as a
    new signature (the card recaptures): after `resize` the next tick is
    recorded as a recompile and counted once, later ticks are not, and
    every loaded adapter's tokens stay. `load_adapter` (in place) changes
    the next tokens of its adapter with no new count."""
    _, _, _, _, ads = weights
    eng = _port_engine(weights)
    before = _run(eng, max_tokens=6)
    compiles = eng.runner.step_compiles
    eng.runner.lora.resize(6)
    after = _run(eng, max_tokens=6)
    assert after == before
    records = eng.tick_records()
    recaptured = [r for r in records if r.get("recompile")]
    assert eng.runner.step_compiles > compiles
    grown = eng.runner.step_compiles
    assert len(recaptured) >= 1 and records[-1]["recompile"] is False
    assert _run(eng, max_tokens=6) == before
    assert eng.runner.step_compiles == grown
    refreshed = tlora.LoRAAdapter("a0", ads[3].rank, ads[3].alpha,
                                  ads[3].weights)
    eng.runner.lora.load_adapter(refreshed)
    changed = _run(eng, max_tokens=6)
    assert changed[1] != before[1] and changed[2:] == before[2:]
    assert eng.runner.step_compiles == grown


def test_adapter_refresh_drops_its_cached_prefixes(weights):
    """KV cached (on the device or in the host tier) under a slot was
    computed with the adapter that held it: after `load_adapter` puts new
    weights in that slot, a request on the same prompt does not reuse it
    (no prefix hit) and gives the tokens of a fresh engine holding the
    new adapter. Other slots' cached prefixes stay."""
    from ray_tpu_torch.llm.prefix_store import HostPrefixTier

    _, _, _, _, ads = weights
    long = PROMPTS[2]                  # 21 tokens: 2 full blocks cached
    eng = _port_engine(weights)
    eng.attach_prefix_store(host_tier=HostPrefixTier(1 << 20))
    _run(eng, prompts=[long, long], loras=["a0", "a1"])
    tier = eng.host_prefix_tier
    tier.put(b"x", {"lora_slot": 1, "nbytes": 8})
    tier.put(b"y", {"lora_slot": 2, "nbytes": 8})
    slots = sorted(m[0] for m in eng.block_manager.digest_meta.values())
    assert slots == [1, 1, 2, 2]
    refreshed = tlora.LoRAAdapter("a0", ads[3].rank, ads[3].alpha,
                                  ads[3].weights)
    eng.runner.lora.load_adapter(refreshed)
    slots = sorted(m[0] for m in eng.block_manager.digest_meta.values())
    assert slots == [2, 2] and len(tier) == 1 and tier.get(b"y")
    hits = eng.stats()["prefix_hits"]
    got = _run(eng, prompts=[long, long], loras=["a0", "a1"])
    assert eng.stats()["prefix_hits"] == hits + 1      # a1's only
    _, tm = _managers(weights)
    tm.load_adapter(refreshed)
    want = _run(_port_engine(weights, manager=tm), prompts=[long],
                loras=["a0"])
    assert got[0] == want[0]


def test_adapter_evicted_by_lru_leaves_no_prefix_behind(weights):
    """An adapter loaded into a full pool takes the LRU adapter's slot: KV
    cached under that slot by the evicted adapter is dropped, so a
    request of the new adapter on the same prompt gives a fresh engine's
    tokens (with the new adapter loaded alone), not stale KV."""
    _, _, _, _, ads = weights
    long = PROMPTS[2]
    _, tm = _managers(weights, n_slots=2, adapters=2)
    eng = _port_engine(weights, manager=tm)
    _run(eng, prompts=[long], loras=["a0"])
    assert tm.slot_of("a1") == 2          # a0 is now the LRU
    assert tm.load_adapter(ads[2]) == 1   # a2 takes a0's slot
    assert tm.evictions == 1
    assert all(m[0] != 1 for m in eng.block_manager.digest_meta.values())
    got = _run(eng, prompts=[long], loras=["a2"])
    fresh = tlora.LoRAManager(tm.config, n_slots=2, device="cpu")
    fresh.load_adapter(ads[2])
    assert got == _run(_port_engine(weights, manager=fresh), prompts=[long],
                       loras=["a2"])


# ---- the server -----------------------------------------------------------

def test_server_lora_name_load_and_list(weights):
    """LLMServer with preloaded adapters: `lora_name` requests give the
    engine's tokens, `load_lora_adapter` installs one more at run time,
    `list_lora_adapters` lists them; a server without adapters refuses."""
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer

    _, _, tconfig, tparams, ads = weights
    ref = _run(_port_engine(weights))
    cfg = LLMConfig(model_config=tconfig, num_kv_blocks=64, block_size=8,
                    max_batch_size=4, prefill_chunk=8, device="cpu",
                    lora_adapters=ads[:2], max_loras=4, lora_rank=8,
                    warmup_buckets="off")
    with LLMServer(cfg, params=tparams) as server:
        assert server.list_lora_adapters() == {"adapters": ["a0", "a1"]}
        assert server.load_lora_adapter(ads[2]) == {"name": "a2", "slot": 3}
        assert server.list_lora_adapters()["adapters"] == ["a0", "a1", "a2"]
        for i, name in enumerate(LORAS):
            resp = server.completions({"prompt": PROMPTS[i],
                                       "max_tokens": 10, "lora_name": name})
            assert resp["choices"][0]["token_ids"] == ref[i], name
        with pytest.raises(KeyError):
            server.completions({"prompt": [1, 2], "lora_name": "nope"})
        assert server.engine_stats()["lora_pinned"] == 0
    plain = LLMConfig(model_config=tconfig, num_kv_blocks=16, block_size=8,
                      device="cpu", warmup_buckets="off")
    with LLMServer(plain, params=tparams) as server:
        assert server.list_lora_adapters() == {"adapters": []}
        with pytest.raises(ValueError, match="without LoRA"):
            server.load_lora_adapter(ads[0])


def test_server_pool_tick_resizes_under_lock(weights):
    """`lora_autoscale`: the pool tick reads stats through the policy and
    resizes the manager (a full pool grows)."""
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer

    _, _, tconfig, tparams, ads = weights
    cfg = LLMConfig(model_config=tconfig, num_kv_blocks=16, block_size=8,
                    device="cpu", warmup_buckets="off",
                    lora_adapters=ads[:2], max_loras=2, lora_autoscale=True,
                    lora_max_slots=5)
    with LLMServer(cfg, params=tparams) as server:
        mgr = server.engine.runner.lora
        server._lora_pool_tick(1e6)
        assert mgr.n_slots - 1 == 3 and mgr.epoch == 1
        assert server.list_lora_adapters()["adapters"] == ["a0", "a1"]
