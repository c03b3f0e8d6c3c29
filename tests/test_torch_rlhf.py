"""Parity of the port's RLHF pieces (ray_tpu_torch.rlhf) with the JAX
package's rlhf/ on the tiny fp32 Llama of tests/test_rlhf.py.

The weight meta table of the port's params equals JAX's (paths, shapes,
dtype names, fp32 and bf16), and the leaf validation raises the same
messages; the rollout ledger equals JAX's after the same script; greedy
`run_rollout_round` equals the JAX engine's experience for experience,
and seeded rollouts equal themselves on a re-queue; `LearnerWorker`
at world 1 (the JAX learner's LM carried across as numpy) gives JAX's
update metrics (1e-5 relative) and, after two updates, its LM (1e-4 of
each leaf's largest magnitude); after `colocated_hot_swap` the engine's
greedy tokens equal the learner's and JAX's engine's after JAX's swap;
the runtime halves refuse.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm.engine import LLMEngine, WeightSyncError
from ray_tpu_torch.llm.model_runner import ModelRunner
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.rlhf import rollout as tro
from ray_tpu_torch.rlhf import trainer as ttr
from ray_tpu_torch.rlhf import weight_sync as tws

TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
            n_kv_heads=2, d_ff=64, max_seq=128)
SYSTEM = (2, 3, 5, 7, 11, 13, 17, 19)
PROMPT_LEN, NEW_TOKENS, N_PROMPTS = 4, 6, 4
HYPER = dict(lr=1e-3, clip_eps=0.2, kl_coef=0.05, gamma=0.99, lam=0.95,
             vf_coef=0.5, ent_coef=0.01, ppo_epochs=2, pad_batch=N_PROMPTS,
             pad_tokens=len(SYSTEM) + PROMPT_LEN + NEW_TOKENS,
             prefix=list(SYSTEM))


def _prompts(n, start=0):
    return [ttr.default_prompt_fn(start + i, PROMPT_LEN, TINY["vocab_size"])
            for i in range(n)]


def _jax_engine(config, params):
    from ray_tpu.llm.engine import LLMEngine as JEngine
    from ray_tpu.llm.model_runner import ModelRunner as JRunner

    return JEngine(JRunner(config, params, num_blocks=64, block_size=8),
                   max_batch_size=4)


def _port_engine(params):
    config = tl.LlamaConfig.tiny(dtype=torch.float32, **TINY)
    runner = ModelRunner(config, tl.params_from_numpy(params, config, "cpu"),
                         num_blocks=64, block_size=8, device="cpu")
    return LLMEngine(runner, max_batch_size=4)


@pytest.fixture(scope="module")
def learners(cpu_jax):
    """The JAX learner (world 1, no setup) and the port's, on the JAX
    learner's LM."""
    import jax

    from ray_tpu.rlhf.trainer import LearnerWorker

    jl = LearnerWorker(0, 1, TINY, HYPER, seed=0)
    lm = jax.tree.map(np.asarray, jl.policy["lm"])
    tlw = ttr.LearnerWorker(0, 1, TINY, HYPER, seed=0, lm=lm, device="cpu")
    return jl, tlw, lm


# ---------------------------------------------------------------- meta

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_describe_weights_equals_jax(cpu_jax, dtype):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jlm
    from ray_tpu.rlhf import weight_sync as jws

    jc = jlm.LlamaConfig.tiny(dtype=getattr(jnp, dtype), **TINY)
    params = jlm.init_params(jc, jax.random.key(0))
    tc = tl.LlamaConfig.tiny(dtype=getattr(torch, dtype), **TINY)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params), tc,
                                   "cpu")
    want = jws.describe_weights(params)
    got = tws.describe_weights(tparams)
    assert got == want
    leaves = tws.flatten_weights(tparams, got)
    assert [tuple(t.shape) for t in leaves] == [m["shape"] for m in want]
    back = tws.unflatten_weights(leaves, got)
    assert tws.describe_weights(back) == want
    assert all(a is b for a, b in zip(tws.flatten_weights(back, got),
                                      leaves))


def _jax_error(fn):
    from ray_tpu.core.exceptions import WeightSyncError as JError

    with pytest.raises(JError) as e:
        fn()
    return str(e.value)


def test_mismatch_errors_equal_jax(learners):
    """Leaf count, order, shape and dtype mismatches raise WeightSyncError
    with the JAX package's messages, and a list in the tree is refused."""
    import jax.numpy as jnp

    from ray_tpu.rlhf import weight_sync as jws

    jl, tlw, _ = learners
    jmeta, tmeta = jws.describe_weights(jl.policy["lm"]), tlw.lm_meta
    assert tmeta == jmeta
    jlm, tlm = jl.policy["lm"], tlw.policy["lm"]
    cases = {
        "count": (dict(jlm, extra=jnp.zeros(2)),
                  dict(tlm, extra=torch.zeros(2)), jmeta),
        "order": (jlm, tlm, [dict(m, path=("z",) + tuple(m["path"]))
                             for m in jmeta]),
        "shape": (dict(jlm, final_norm=jnp.zeros(5)),
                  dict(tlm, final_norm=torch.zeros(5)), jmeta),
        "dtype": (dict(jlm, final_norm=jlm["final_norm"].astype(
            jnp.bfloat16)), dict(tlm, final_norm=tlm["final_norm"].to(
                torch.bfloat16)), jmeta),
    }
    for name, (jtree, ttree, meta) in cases.items():
        want = _jax_error(lambda: jws.flatten_weights(jtree, meta))
        with pytest.raises(WeightSyncError) as got:
            tws.flatten_weights(ttree, meta)
        assert str(got.value) == want, name
    want = _jax_error(lambda: jws.unflatten_weights([1], jmeta))
    with pytest.raises(WeightSyncError, match="leaf count mismatch") as got:
        tws.unflatten_weights([1], tmeta)
    assert str(got.value) == want
    with pytest.raises(WeightSyncError, match="must be nested dicts"):
        tws.describe_weights({"layers": [torch.zeros(1)]})


# ------------------------------------------------------------- rollouts

def test_coordinator_ledger_equals_jax():
    from ray_tpu.rlhf import rollout as jro
    from ray_tpu.rlhf import trainer as jtr

    coords = (jro.RolloutCoordinator(), tro.RolloutCoordinator())
    trace = []
    for c, mod in zip(coords, (jro, tro)):
        steps = [c.add_prompts(_prompts(5)), c.take(3), c.requeue([1, 7]),
                 c.take(4)]
        exp = [mod.Experience(s, p, [1, 2, 2], 0.5, 0) for s, p in
               c.take(0) + [(0, _prompts(1)[0]), (2, [9])]]
        steps += [len(c.complete(exp)), len(c.complete(exp[:1])),
                  c.requeue_all_issued(), c.pending_count, c.issued_count,
                  c.round_complete(), c.take(9),
                  len(c.complete([mod.Experience(s, [], [], 0.0, 1)
                                  for s in (1, 3, 4)])),
                  c.round_complete(),
                  [e.seq_no for e in c.drain_done()], c.ledger()]
        trace.append(steps)
    assert trace[0] == trace[1]
    assert trace[1][-1]["dup_completions"] == 1
    for seq in (0, 1, 77, 2 ** 31):
        for base in (0, 11, 2 ** 20):
            assert tro.rollout_seed(base, seq) == jro.rollout_seed(base, seq)
    assert tro.default_reward([1], [4, 4, 5]) == jro.default_reward(
        [1], [4, 4, 5])
    assert ttr.default_prompt_fn(3, 6, 128) == jtr.default_prompt_fn(3, 6,
                                                                     128)


def _round(engine, module, seqs, **kw):
    items = [(s, p) for s, p in zip(seqs, _prompts(len(seqs)))]
    return [dataclasses.asdict(e) for e in module.run_rollout_round(
        engine, items, system_prompt=SYSTEM, max_new_tokens=NEW_TOKENS,
        **kw)]


def test_greedy_rollout_round_equals_jax(learners):
    from ray_tpu.rlhf import rollout as jro

    jl, _, lm = learners
    want = _round(_jax_engine(jl.config, jl.policy["lm"]), jro, range(4),
                  replica="g")
    got = _round(_port_engine(lm), tro, range(4), replica="g")
    assert got == want
    assert len({tuple(e["response"]) for e in got}) > 1


def test_seeded_rollouts_equal_themselves_on_a_requeue(learners):
    """A re-queued prompt regenerates its tokens from (base_seed, seq_no)
    alone: alone, in another batch and in another order."""
    lm = learners[2]
    kw = dict(temperature=0.8, base_seed=11)
    first = _round(_port_engine(lm), tro, [0, 1, 2, 3], **kw)
    coord = tro.RolloutCoordinator()
    coord.add_prompts(_prompts(4))
    coord.take(4)
    coord.requeue([2, 0])
    items = coord.take(2)
    assert [s for s, _ in items] == [0, 2]
    again = [dataclasses.asdict(e) for e in tro.run_rollout_round(
        _port_engine(lm), items[::-1], system_prompt=SYSTEM,
        max_new_tokens=NEW_TOKENS, **kw)]
    assert {e["seq_no"]: e["response"] for e in again} == {
        e["seq_no"]: e["response"] for e in first if e["seq_no"] in (0, 2)}
    greedy = _round(_port_engine(lm), tro, [0, 1, 2, 3])
    assert [e["response"] for e in first] != [e["response"] for e in greedy]


# -------------------------------------------------------------- learner

def _experiences(module, lm_engine, seqs):
    items = [(s, p) for s, p in zip(seqs, _prompts(len(seqs), seqs[0]))]
    return module.run_rollout_round(lm_engine, items, system_prompt=SYSTEM,
                                    max_new_tokens=NEW_TOKENS)


def test_learner_update_and_hot_swap_equal_jax(learners):
    """Two updates on the same experiences as the JAX learner: metrics
    within 1e-5 relative, the LM within 1e-4 of each leaf's largest
    magnitude. Then the colocated hot swap: the engine holds the learner's
    LM bit for bit (and a later update does not reach it), and its greedy
    tokens equal the learner's naive forward and the JAX engine's after
    JAX's swap."""
    from ray_tpu.llm.sampling import SamplingParams as JParams
    from ray_tpu.rlhf import rollout as jro
    from ray_tpu.rlhf import weight_sync as jws

    jl, tlw, lm = learners
    jeng, teng = _jax_engine(jl.config, jl.policy["lm"]), _port_engine(lm)
    for it in range(2):
        seqs = list(range(it * N_PROMPTS, (it + 1) * N_PROMPTS))
        jexp = _experiences(jro, jeng, seqs)
        texp = _experiences(tro, teng, seqs)
        assert [e.response for e in texp] == [e.response for e in jexp]
        want, got = jl.update(jexp), tlw.update(texp)
        assert got["version"] == want["version"] == it + 1
        assert got["n"] == want["n"] == N_PROMPTS
        for k in ("loss", "pg_loss", "vf_loss", "kl", "reward_mean"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        if it == 1:
            assert got["kl"] != 0.0
    jleaves = [np.asarray(x) for x in jws.flatten_weights(
        jl.policy["lm"], jl.lm_meta)]
    for m, g, w in zip(tlw.lm_meta, tlw.lm_leaves(), jleaves):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-4 * float(np.abs(w).max()),
            err_msg=str(m["path"]))
    for (_, t), (_, r) in zip(tws._flatten(tlw.policy["lm"]),
                              tws._flatten(tlw.ref_lm)):
        assert t.data_ptr() != r.data_ptr()

    info = tws.colocated_hot_swap(teng, tlw.policy["lm"], tlw.lm_meta,
                                  version=tlw.version)
    jws.colocated_hot_swap(jeng, jl.policy["lm"], jl.lm_meta,
                           version=jl.version)
    assert info["version"] == teng.weights_version == 2
    assert info["sync_ms"] >= 0
    engine_leaves = [t.numpy().copy() for t in tws.flatten_weights(
        teng.runner.params, tlw.lm_meta)]
    for a, b in zip(engine_leaves, tlw.lm_leaves()):
        np.testing.assert_array_equal(a, b)
    probe = _prompts(1, 40)[0]
    got = teng.generate([probe], SamplingParams(max_tokens=8))[0]
    want = jeng.generate([probe], JParams(max_tokens=8))[0]
    assert list(got.output_token_ids) == tlw.greedy_tokens(probe, 8)
    assert list(got.output_token_ids) == list(want.output_token_ids)
    assert tlw.greedy_tokens(probe, 8) == jl.greedy_tokens(probe, 8)
    # The engine's tensors are its own: a learner step does not move them.
    tlw.update(_experiences(tro, teng, list(range(8, 12))))
    for a, t in zip(engine_leaves, tws.flatten_weights(
            teng.runner.params, tlw.lm_meta)):
        np.testing.assert_array_equal(a, t.numpy())


def test_runtime_halves_refuse(learners):
    tlw = learners[1]
    lm = learners[2]
    for call in (lambda: tlw.setup("g"), tlw.teardown, tlw.publish,
                 lambda: tlw.send_lm_channel(object()), tlw.state_leaves,
                 tlw.state_snapshot):
        with pytest.raises(ValueError, match="item 9.*not ported"):
            call()
    with pytest.raises(ValueError, match="world 2.*not ported"):
        ttr.LearnerWorker(0, 2, TINY, HYPER, seed=0, lm=lm, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        ttr.LearnerWorker(0, 1, TINY, HYPER, seed=0, init_leaves=[1],
                          lm=lm, device="cpu")
    with pytest.raises(ValueError, match="device-channel.*not ported"):
        tws.colocated_hot_swap(_port_engine(lm), tlw.policy["lm"],
                               tlw.lm_meta, channel=object())
