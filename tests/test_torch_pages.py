"""The KV page plane of the port against the JAX package, on the CPU.

Pages, the page codec's bytes, request export/adopt, the host prefix tier
and weight hot-swap, each run through the JAX original and the port on
the same numpy inputs and weights (the tiny config of
tests/test_torch_spec_unified.py, fp32 unless a test says bf16). Bytes,
tokens and counters must be IDENTICAL; pages computed by the two packages
agree to fp32 rounding (1e-5).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import engine as te
from ray_tpu_torch.llm import lora as tlora
from ray_tpu_torch.llm import model_runner as tmr
from ray_tpu_torch.llm import prefix_store as tps
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.models import llama as tl

TOL = 1e-5
PROMPT = [(5 * i + 2) % 128 for i in range(29)]
# A 33-token system prompt (4 full blocks of 8) and fillers that push its
# parked blocks out of a 12-page pool.
SYSTEM = [(3 * i + 1) % 128 for i in range(33)]
FILLERS = [[(11 * i + j) % 128 for i in range(60)] for j in range(3)]


def _convert(tree, tconfig):
    import jax

    return tl.params_from_numpy(jax.tree.map(np.asarray, tree), tconfig,
                                device="cpu")


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
    adapters = [jlora.init_adapter(jconfig, f"a{i}", targets=jlora.TARGETS,
                                   key=jax.random.key(20 + i), scale=0.5)
                for i in range(2)]
    return jconfig, jparams, tconfig, _convert(jparams, tconfig), adapters


def _port_engine(weights, num_blocks=64, lora=False, params=None, **kw):
    _, _, tconfig, tparams, ads = weights
    manager = None
    if lora:
        manager = tlora.LoRAManager(tconfig, n_slots=2, device="cpu")
        for a in ads:
            manager.load_adapter(a)
    runner = tmr.ModelRunner(tconfig, tparams if params is None else params,
                             num_blocks=num_blocks, block_size=8,
                             chunk_size=8, device="cpu",
                             lora_manager=manager)
    return te.LLMEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _jax_engine(weights, num_blocks=64, lora=False, params=None, **kw):
    from ray_tpu.llm import lora as jlora
    from ray_tpu.llm.engine import LLMEngine
    from ray_tpu.llm.model_runner import ModelRunner

    jconfig, jparams, _, _, ads = weights
    manager = None
    if lora:
        manager = jlora.LoRAManager(jconfig, n_slots=2)
        for a in ads:
            manager.load_adapter(a)
    runner = ModelRunner(jconfig, jparams if params is None else params,
                         num_blocks=num_blocks, block_size=8, chunk_size=8,
                         lora_manager=manager)
    return LLMEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _params(engine, **kw):
    if engine.__class__.__module__.startswith("ray_tpu_torch"):
        return SamplingParams(**kw)
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    return JaxParams(**kw)


def _finish(engine, rid):
    out = None
    while engine.has_unfinished():
        for o in engine.step():
            if o.request_id == rid and o.finished:
                out = o.output_token_ids
    return out


def _generate(engine, prompt, max_tokens, rid="r", lora_name=None):
    engine.add_request(prompt, _params(engine, max_tokens=max_tokens),
                       request_id=rid, lora_name=lora_name)
    return _finish(engine, rid)


# ---- pages ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_scatter_pages_match_jax_layout(cpu_jax, dtype):
    """The port's runner, after prefilling a prompt, gathers the same
    pages as the JAX runner (layout (L, K, n, ps, hd); bf16 as uint16
    bits); scattering JAX's pages into a fresh port runner and gathering
    them back is byte-exact, and only explicit ids are taken."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.llm.engine import LLMEngine
    from ray_tpu.llm.model_runner import ModelRunner
    from ray_tpu.models import llama as jl

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jconfig = jl.LlamaConfig.tiny(vocab_size=128, max_seq=64, dtype=jdt)
    jparams = jl.init_params(jconfig, jax.random.key(0))
    tconfig = tl.LlamaConfig.tiny(vocab_size=128, max_seq=64, dtype=tdt)
    tparams = _convert(jparams, tconfig)
    jeng = LLMEngine(ModelRunner(jconfig, jparams, num_blocks=16,
                                 block_size=8, chunk_size=8),
                     max_batch_size=4, prefill_chunk=8)
    teng = te.LLMEngine(tmr.ModelRunner(tconfig, tparams, num_blocks=16,
                                        block_size=8, chunk_size=8,
                                        device="cpu"),
                        max_batch_size=4, prefill_chunk=8)
    for eng in (jeng, teng):
        eng.add_request(PROMPT, _params(eng, max_tokens=2), request_id="p")
        while not eng.running:
            eng.step()
    ids = list(teng.running[0].blocks)
    assert ids == list(jeng.running[0].blocks)
    jk, jv = (np.asarray(a) for a in jeng.runner.gather_pages(ids))
    tk, tv = teng.runner.gather_pages(ids)
    assert tk.shape == jk.shape == (jconfig.n_layers, jconfig.n_kv_heads,
                                    len(ids), 8, jconfig.head_dim)
    if dtype == "bfloat16":
        assert tk.dtype == np.uint16
        jk, jv = jk.view(np.uint16), jv.view(np.uint16)
        # Different GEMM libraries round bf16 alike only mostly: compare
        # the values, then hold the scatter round trip byte-exact.
        f = lambda a: (a.astype(np.uint32) << 16).view(np.float32)
        np.testing.assert_allclose(f(tk), f(jk), rtol=2e-2, atol=2e-2)
    else:
        np.testing.assert_allclose(tk, jk, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    fresh = tmr.ModelRunner(tconfig, tparams, num_blocks=16, block_size=8,
                            chunk_size=8, device="cpu")
    dst = [9, 3, 12, 0][:len(ids)]
    fresh.scatter_pages(dst, *jeng.runner.gather_pages(ids))
    gk, gv = fresh.gather_pages(dst)
    assert gk.tobytes() == jk.tobytes() and gv.tobytes() == jv.tobytes()
    untouched = [b for b in range(16) if b not in dst]
    assert not fresh.cache["k"][:, :, untouched].any()
    for bad in ([-1], [16], [2, 17]):
        with pytest.raises(ValueError, match="outside"):
            fresh.gather_pages(bad)
        with pytest.raises(ValueError, match="outside"):
            fresh.scatter_pages(bad, gk[:, :, :len(bad)],
                                gv[:, :, :len(bad)])
    with pytest.raises(ValueError, match="pool takes"):
        fresh.scatter_pages([1], gk, gv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_codec_bytes_equal_jax_and_decode_across(cpu_jax, dtype):
    """`encode_pages` writes JAX's bytes for the same pages (bf16: its
    uint16 bits with kv_dtype "bfloat16", from numpy or from a tensor);
    each side decodes the other's bytes, concatenated blocks decode with
    decode_all, and a truncated buffer raises TruncatedSpillError."""
    import ml_dtypes

    from ray_tpu.llm import prefix_store as jps

    rng = np.random.default_rng(7)
    # Over 1 MiB a side: the arrays cross in several chunk frames.
    shape = (2, 2, 3, 16, 2048)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    meta = {"tokens": [1, 2, 3], "lora_name": "", "weights_version": 4}
    if dtype == "bfloat16":
        jk, jv = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        ref = jps.encode_pages(meta, jk, jv)
        bits = jk.view(np.uint16), jv.view(np.uint16)
        got = tps.encode_pages(meta, *bits, kv_dtype="bfloat16")
        from_tensor = tps.encode_pages(meta, *(
            torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
            for b in bits))
        assert from_tensor == ref
    else:
        jk, jv = k.astype(dtype), v.astype(dtype)
        bits = jk, jv
        ref = jps.encode_pages(meta, jk, jv)
        got = tps.encode_pages(meta, jk, jv)
    assert got == ref
    m, dk, dv = tps.decode_pages(ref)
    assert m == meta
    assert dk.tobytes() == bits[0].tobytes() and dk.dtype == bits[0].dtype
    assert dv.tobytes() == bits[1].tobytes()
    jm, jdk, jdv = jps.decode_pages(got)
    assert jm == meta and jdk.dtype == jk.dtype
    assert jdk.tobytes() == jk.tobytes() and jdv.tobytes() == jv.tobytes()
    blocks = tps.decode_all(got + ref)
    assert len(blocks) == 2 and blocks[1][1].tobytes() == dk.tobytes()
    for cut in (5, len(got) // 2, len(got) - 1):
        with pytest.raises(tps.TruncatedSpillError):
            tps.decode_all(got[:cut])
        with pytest.raises(jps.TruncatedSpillError):
            jps.decode_all(got[:cut])


# ---- request export / adopt ----------------------------------------------

@pytest.mark.parametrize("lora", [None, "a1"], ids=["base", "lora"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_exported_request_continues_in_the_other_package(weights, direction,
                                                         lora):
    """A request decoding on one package's engine is exported after 3
    tokens, its pages gathered, and adopted by the other package's engine,
    which continues it: the whole output equals an undisturbed JAX run.
    The adopter re-registers the prompt's full blocks (a second request
    on the same prompt hits them)."""
    use_lora = lora is not None
    ref = _generate(_jax_engine(weights, lora=use_lora), PROMPT, 12,
                    lora_name=lora)
    make = {"jax": _jax_engine, "torch": _port_engine}
    src_name, dst_name = direction.split("_to_")
    src = make[src_name](weights, lora=use_lora)
    dst = make[dst_name](weights, lora=use_lora)
    src.add_request(PROMPT, _params(src, max_tokens=12), request_id="m",
                    lora_name=lora)
    while not (src.running and len(src.running[0].output) >= 3):
        src.step()
    state = src.export_request("m")
    assert state["lora_slot"] == (2 if use_lora else 0)
    k, v = src.runner.gather_pages(state["blocks"])
    src.block_manager.release_blocks(state["blocks"])
    assert not src.has_unfinished()
    if use_lora:
        assert src.stats()["lora_pinned"] == 0
    assert dst.adopt_request(state, k, v)
    assert _finish(dst, "m") == ref
    assert dst.stats()["prefill_tokens_computed"] == 0
    assert dst.stats().get("lora_pinned", 0) == 0
    _generate(dst, PROMPT, 2, rid="again", lora_name=lora)
    assert dst.stats()["prefix_hits"] == 1


def test_adopt_refuses_torn_or_unplaceable_handoffs(weights):
    """Fewer pages than the context needs is a torn export (ValueError);
    a LoRA slot on an engine without a manager is refused; a pool too
    small returns False with nothing allocated, as JAX's."""
    src = _port_engine(weights)
    src.add_request(PROMPT, SamplingParams(max_tokens=8), request_id="m")
    while not (src.running and len(src.running[0].output) >= 2):
        src.step()
    state = src.export_request("m")
    k, v = src.runner.gather_pages(state["blocks"])
    with pytest.raises(ValueError, match="pages"):
        _port_engine(weights).adopt_request(state, k[:, :, :2], v[:, :, :2])
    with pytest.raises(ValueError, match="no LoRA manager"):
        _port_engine(weights).adopt_request(dict(state, lora_slot=1), k, v)
    for make in (_port_engine, _jax_engine):
        small = make(weights, num_blocks=3)
        assert small.adopt_request(state, k, v) is False
        assert small.block_manager.refcount == {}


@pytest.mark.parametrize("lora", [None, "a1"], ids=["base", "lora"])
def test_export_session_modes_match_jax(weights, lora):
    """A decoding request exports in "kv" mode with its blocks; a queued
    or prefilling one in "replay" mode with prompt, output and seed only;
    an unknown id gives (None, None). States carry JAX's keys; both modes
    release the adapter's pin."""
    states = {}
    for name, make in (("jax", _jax_engine), ("torch", _port_engine)):
        eng = make(weights, num_blocks=64, lora=lora is not None)
        eng.add_request(PROMPT, _params(eng, max_tokens=8),
                        request_id="run", lora_name=lora)
        while not eng.running:
            eng.step()
        eng.add_request(PROMPT[:9], _params(eng, max_tokens=8),
                        request_id="queued", lora_name=lora)
        kv, kv_mode = eng.export_session("run")
        replay, replay_mode = eng.export_session("queued")
        assert eng.export_session("gone") == (None, None)
        assert (kv_mode, replay_mode) == ("kv", "replay")
        eng.block_manager.release_blocks(kv["blocks"])
        assert eng.stats()["free_kv_blocks"] == 64
        assert eng.stats().get("lora_pinned", 0) == 0
        states[name] = (kv, replay)
    for (j, t) in zip(states["jax"], states["torch"]):
        assert sorted(j) == sorted(t)
        for key in ("prompt", "output", "seed", "lora_slot", "params"):
            assert j[key] == t[key], key


# ---- the host prefix tier -------------------------------------------------

@pytest.mark.parametrize("lora", [None, "a0"], ids=["base", "lora"])
def test_host_tier_spill_and_promote_match_jax(weights, lora):
    """With a 12-page pool the system prompt's parked blocks are evicted by
    the fillers and spill to the host tier; the repeated prompt is
    promoted from it. Tokens and every prefix counter equal JAX's."""
    from ray_tpu.llm.prefix_store import HostPrefixTier as JaxTier

    use_lora = lora is not None

    def gen(engine, prompt, n, rid):
        return _generate(engine, prompt, n, rid=rid, lora_name=lora)

    results = []
    for make, tier in ((_jax_engine, JaxTier),
                       (_port_engine, tps.HostPrefixTier)):
        eng = make(weights, num_blocks=12, lora=use_lora)
        eng.attach_prefix_store(host_tier=tier(1 << 20))
        out = [gen(eng, SYSTEM, 4, "s0")]
        out += [gen(eng, f, 4, f"f{i}") for i, f in enumerate(FILLERS)]
        out.append(gen(eng, SYSTEM, 4, "s1"))
        results.append((out, eng.stats()))
    (jout, jstats), (tout, tstats) = results
    assert tout == jout
    assert tout[0] == tout[-1]
    keys = [k for k in jstats if k.startswith("host_prefix_")] + [
        "prefix_hits", "prefix_tokens_saved", "prefill_tokens_computed",
        "free_kv_blocks"]
    assert {k: tstats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert tstats["host_prefix_hits"] == 4
    assert tstats["host_prefix_tokens_saved"] == 32
    assert tstats["host_prefix_spills"] > 0


def test_host_tier_watermark_and_invalid_entries(weights):
    """The tier drops LRU entries down to its low watermark past capacity
    (demotions counted); promotion skips an entry of another weights
    version; `hottest` lists newest first."""
    tier = tps.HostPrefixTier(1000, low_watermark=0.5)
    for i in range(4):
        tier.put(bytes([i]), {"tokens": (i,), "nbytes": 300})
    assert len(tier) == 1 and tier.bytes == 300
    assert tier.stats()["demotions"] == 3 and tier.stats()["spills"] == 4
    tier.put(b"big", {"nbytes": 2000})
    assert tier.get(b"big") is None
    assert [e["tokens"] for e in tier.hottest(5)] == [(3,)]
    assert tier.clear() == 1 and tier.bytes == 0
    eng = _port_engine(weights, num_blocks=12)
    eng.attach_prefix_store(host_tier=tps.HostPrefixTier(1 << 20))
    _generate(eng, SYSTEM, 4, rid="s0")
    for i, f in enumerate(FILLERS):
        _generate(eng, f, 4, rid=f"f{i}")
    eng.weights_version += 1
    _generate(eng, SYSTEM, 4, rid="s1")
    assert eng.stats()["host_prefix_hits"] == 0


@pytest.mark.parametrize("lora", [None, "a0"], ids=["base", "lora"])
def test_prefixes_pushed_between_packages(weights, lora):
    """`export_prefixes` of one package's engine (parked device blocks,
    then host-tier entries) is adopted by the other's `adopt_prefix`
    (an adapter's blocks by its NAME, into the slot that holds it there);
    the adopter's next request on that prompt hits every pushed block."""
    use_lora = lora is not None
    for src_make, dst_make in ((_jax_engine, _port_engine),
                               (_port_engine, _jax_engine)):
        src = src_make(weights, lora=use_lora)
        # Attaching a store (even without a tier) names the adapters of
        # registered blocks: an unnamed adapter's KV is never exported.
        src.attach_prefix_store()
        ref = _generate(src, SYSTEM, 4, lora_name=lora)
        state, k, v = src.export_prefixes(limit=16)
        assert [e["lora"] for e in state["entries"]] == [lora or ""] * 4
        dst = dst_make(weights, lora=use_lora)
        assert dst.adopt_prefix(state, k, v) == 4
        assert dst.adopt_prefix(state, k, v) == 0     # already cached
        assert dst.adopt_prefix(dict(state, weights_version=9), k, v) == 0
        assert _generate(dst, SYSTEM, 4, lora_name=lora) == ref
        assert dst.stats()["prefix_tokens_saved"] == 32


# ---- weight hot-swap ------------------------------------------------------

@pytest.mark.parametrize("lora", [None, "a1"], ids=["base", "lora"])
def test_update_weights_matches_jax(weights, lora):
    """Both engines refuse a malformed payload (structure, shape, dtype)
    and a busy engine with WeightSyncError, return the same version and
    invalidation count, write the new weights into the port's existing
    tensors, and then decode as a fresh engine on the new weights (the
    adapters stay loaded)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.core.exceptions import WeightSyncError as JaxError
    from ray_tpu.llm.prefix_store import HostPrefixTier as JaxTier
    from ray_tpu.models import llama as jl

    jconfig, jparams, tconfig, _, _ = weights
    new_j = jl.init_params(jconfig, jax.random.key(5))
    new_t = _convert(new_j, tconfig)
    use_lora = lora is not None
    jeng = _jax_engine(weights, num_blocks=12, lora=use_lora)
    teng = _port_engine(weights, num_blocks=12, lora=use_lora)
    jeng.attach_prefix_store(host_tier=JaxTier(1 << 20))
    teng.attach_prefix_store(host_tier=tps.HostPrefixTier(1 << 20))
    for eng in (jeng, teng):
        _generate(eng, SYSTEM, 4, rid="s0", lora_name=lora)
        _generate(eng, FILLERS[0], 4, rid="f0")
    bad_j = [
        {k: v for k, v in new_j.items() if k != "lm_head"},
        dict(new_j, embed=new_j["embed"][:-1]),
        dict(new_j, embed=new_j["embed"].astype(jnp.bfloat16))]
    bad_t = [
        {k: v for k, v in new_t.items() if k != "lm_head"},
        dict(new_t, embed=new_t["embed"][:-1]),
        dict(new_t, embed=new_t["embed"].to(torch.bfloat16)),
        dict(new_t, layers=dict(new_t["layers"], wq=[1.0]))]
    for bad in bad_j:
        with pytest.raises(JaxError):
            jeng.update_weights(bad)
    for bad in bad_t:
        with pytest.raises(te.WeightSyncError, match="mismatch"):
            teng.update_weights(bad)
    for eng, new in ((jeng, new_j), (teng, new_t)):
        eng.add_request(PROMPT, _params(eng, max_tokens=2), request_id="b")
        with pytest.raises(Exception, match="unfinished"):
            eng.update_weights(new)
        _finish(eng, "b")
    ptrs = {k: t.data_ptr() for k, t in teng.runner.params["layers"].items()}
    jres = jeng.update_weights(new_j)
    tres = teng.update_weights(new_t)
    assert tres == jres
    assert tres["invalidated_prefix_entries"] > 0
    assert teng.stats()["weights_version"] == 1
    assert teng.stats()["host_prefix_entries"] == 0
    assert {k: t.data_ptr() for k, t in
            teng.runner.params["layers"].items()} == ptrs
    fresh = _generate(_port_engine(weights, params=new_t, lora=use_lora),
                      SYSTEM, 6, lora_name=lora)
    assert _generate(teng, SYSTEM, 6, rid="s2", lora_name=lora) == fresh
    assert _generate(jeng, SYSTEM, 6, rid="s2", lora_name=lora) == fresh
    assert teng.update_weights(new_t, version=7,
                               force=True)["version"] == 7
    # Numpy payloads validate and copy the same way.
    np_payload = {"embed": new_t["embed"].numpy(),
                  "layers": {k: v.numpy() for k, v in
                             new_t["layers"].items()},
                  "final_norm": new_t["final_norm"].numpy(),
                  "lm_head": new_t["lm_head"].numpy()}
    assert teng.update_weights(np_payload)["version"] == 8


# ---- the server -----------------------------------------------------------

def test_server_builds_the_host_tier(weights):
    """LLMServer attaches a HostPrefixTier of `host_prefix_mb` (JAX's
    default 32) with its low watermark; 0 attaches none; the cluster tier
    stays off and stats() show no cluster entry."""
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer

    _, _, tconfig, tparams, _ = weights
    base = dict(model_config=tconfig, num_kv_blocks=16, block_size=8,
                device="cpu", warmup_buckets="off")
    with LLMServer(LLMConfig(**base, host_prefix_low_watermark=0.6),
                   params=tparams) as server:
        tier = server.engine.host_prefix_tier
        assert tier.capacity_bytes == 32 << 20 and tier.low == 0.6
        stats = server.engine_stats()
        assert stats["host_prefix_entries"] == 0
        assert not [k for k in stats if k.startswith("cluster_")]
    with LLMServer(LLMConfig(**base, host_prefix_mb=0),
                   params=tparams) as server:
        assert server.engine.host_prefix_tier is None
        assert "host_prefix_entries" not in server.engine_stats()
