"""Tensor-parallel serving (llm/tp.py, the runner under a tp mesh) against
the JAX runner under its mesh (`ModelRunner(mesh=build_mesh(MeshConfig(
tp=2), devices=jax.devices()[:2]))`, as tests/test_llm_serving_path.py
runs it) and against the port at tp=1.

The test process is rank 0 of one world of 2 gloo ranks (a module
fixture): each case builds its engines on it (rank 1 builds the same
runner on its shards, fp32, 2/1 heads a rank of the tiny config's 4/2;
the next case's build closes rank 1's previous runner). The failing-follower case
breaks the world and closes it; a later case would start another.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import engine as te
from ray_tpu_torch.llm import lora as tlora
from ray_tpu_torch.llm import tp as ttp
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.llm.serving import LLMConfig, LLMServer, build_engine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import launch

PROMPTS = [[(5 * i + 1) % 128 for i in range(11)],
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
    adapters = [jlora.init_adapter(jconfig, f"a{i}", rank=4 if i == 1 else 8,
                                   targets=jlora.TARGETS,
                                   key=jax.random.key(10 + i), scale=0.5)
                for i in range(3)]
    return jconfig, jparams, tconfig, tparams, adapters


class _Worlds:
    """The module's world of 2 gloo ranks, started on first use and again
    after a case broke it (the failing-follower case does)."""

    def __init__(self):
        self.current = None

    def get(self):
        if self.current is not None and self.current.broken is not None:
            self.close()
        if self.current is None:
            self.current = ttp.start_world(2, "cpu")
        return self.current

    def close(self):
        w, self.current = self.current, None
        if w is not None:
            ttp.stop_world(w)
            assert all(not p.is_alive() for p in w._procs)
            assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def worlds():
    holder = _Worlds()
    yield holder
    holder.close()


@pytest.fixture
def world(worlds):
    return worlds.get()


def _spec(tconfig, lora=False, num_blocks=64, source=("broadcast",)):
    return dict(config=tconfig, num_blocks=num_blocks, block_size=8,
                chunk_size=8, cuda_graphs=None, source=source,
                lora=(4, 8, tlora.TARGETS) if lora else None)


def _port_engine(weights, world, lora=False, num_blocks=64, params=None,
                 **kw):
    """The port's engine at tp=2 on `world` (tp=1 when world is None), the
    JAX tests' shapes: 8-token pages and chunks, 4 rows."""
    _, _, tconfig, tparams, ads = weights
    runner = ttp.build_runner(_spec(tconfig, lora, num_blocks), world, "cpu",
                              tparams if params is None else params)
    if lora:
        for a in ads:
            runner.lora.load_adapter(a)
    return te.LLMEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _jax_engine(weights, lora=False, num_blocks=64, **kw):
    import jax

    from ray_tpu.llm import lora as jlora
    from ray_tpu.llm.engine import LLMEngine
    from ray_tpu.llm.model_runner import ModelRunner
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh

    jconfig, jparams, _, _, ads = weights
    manager = None
    if lora:
        manager = jlora.LoRAManager(jconfig, n_slots=4, rank=8)
        for a in ads:
            manager.load_adapter(a)
    mesh = build_mesh(MeshConfig(tp=2), devices=jax.devices()[:2])
    runner = ModelRunner(jconfig, jparams, num_blocks=num_blocks,
                         block_size=8, chunk_size=8, mesh=mesh,
                         lora_manager=manager)
    return LLMEngine(runner, max_batch_size=4, prefill_chunk=8, **kw)


def _run(engine, params_cls=SamplingParams, prompts=PROMPTS, loras=None,
         max_tokens=8, **params):
    loras = loras or [None] * len(prompts)
    for i, (p, name) in enumerate(zip(prompts, loras)):
        engine.add_request(p, params_cls(max_tokens=max_tokens, **params),
                           request_id=f"r{i}", lora_name=name)
    done = {}
    while engine.has_unfinished():
        done.update({o.request_id: o.output_token_ids
                     for o in engine.step() if o.finished})
    return [done[f"r{i}"] for i in range(len(prompts))]


def _closing(engine, fn):
    try:
        return fn(engine)
    finally:
        engine.runner.close()


PATHS = {"unified": {}, "unified-spec3": {"speculative_ngram": 3},
         "split": {"unified_ticks": False},
         "split-multistep": {"decode_multi_step": 4},
         "split-spec3": {"speculative_ngram": 3, "unified_ticks": False}}


class _FakeMesh:
    """The DeviceMesh queries of `sharding.shard` at a tp coordinate."""

    def __init__(self, tp, rank):
        self.tp, self.rank = tp, rank

    def size(self, dim):
        return self.tp if dim == 4 else 1

    def get_local_rank(self, axis):
        return self.rank if axis == "tp" else 0


@pytest.mark.parametrize("keys", [k for k, _ in ttp.param_paths(
    tl.LlamaConfig.tiny())], ids=lambda k: "/".join(k))
def test_rank_shards_equal_jax_serve_placement(weights, keys):
    """Each rank's shard of each parameter (llm/tp.py, SERVE_RULES) is the
    piece the JAX runner places on the device at the same tp coordinate
    (its `shard_tree(..., SERVE_RULES, mesh)`)."""
    import jax

    from ray_tpu.llm.model_runner import ModelRunner
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh

    jconfig, jparams, tconfig, tparams, _ = weights
    mesh = build_mesh(MeshConfig(tp=2), devices=jax.devices()[:2])
    placed = ModelRunner(jconfig, jparams, num_blocks=4, block_size=8,
                         mesh=mesh).params
    leaf, whole = placed, tparams
    for k in keys:
        leaf, whole = leaf[k], whole[k]
    coord = {d.id: idx[-1] for idx, d in np.ndenumerate(mesh.devices)}
    pieces = {coord[p.device.id]: np.asarray(p.data)
              for p in leaf.addressable_shards}
    for rank in range(2):
        got = ttp._local(whole, keys, _FakeMesh(2, rank), "cpu",
                         torch.float32)
        np.testing.assert_array_equal(got.numpy(), pieces[rank])


@pytest.mark.parametrize("path", list(PATHS))
def test_greedy_tokens_equal_jax_tp2_and_port_tp1(weights, world, path):
    """Greedy tokens at tp=2 equal the JAX runner's under its tp=2 mesh and
    the port's at tp=1, on the unified tick (speculation off and on) and
    on the split path (plain, multi-step, speculative); the spec counters
    equal too."""
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    kw = PATHS[path]
    jeng = _jax_engine(weights, **kw)
    ref = _run(jeng, JaxParams)
    eng = _port_engine(weights, world, **kw)
    got = _closing(eng, _run)
    assert got == ref
    one = _closing(_port_engine(weights, None, **kw), _run)
    assert one == ref
    for key in ("spec_tokens_proposed", "spec_tokens_accepted",
                "prefill_tokens_computed"):
        assert eng.stats()[key] == jeng.stats()[key], key
    assert eng.runner.tp == 2 and eng.runner.n_kv_heads == 1
    assert tuple(eng.runner.cache["k"].shape[1:2]) == (1,)


@pytest.mark.parametrize("path", ["unified", "split"])
def test_seeded_sampled_requests_equal_tp1(weights, world, path):
    """Seeded temperature requests draw the same tokens at tp=2 as at
    tp=1: every rank holds the gathered logits and samples alike."""
    kw = PATHS[path]
    sample = dict(temperature=0.8, top_k=20, seed=11)
    got = _closing(_port_engine(weights, world, **kw),
                   lambda e: _run(e, max_tokens=10, **sample))
    want = _closing(_port_engine(weights, None, **kw),
                    lambda e: _run(e, max_tokens=10, **sample))
    assert got == want
    assert len(set(map(tuple, got))) > 1


@pytest.mark.parametrize("path", ["unified", "split", "unified-spec3"])
def test_mixed_adapter_batch_equals_jax_tp2(weights, world, path):
    """A batch over the base model and three adapters (rank 4 zero-padded
    to 8) at tp=2: column targets keep A whole and split B, row targets
    split A and keep B; the tokens equal the JAX runner's under its mesh
    with a LoRAManager."""
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    kw = PATHS[path]
    ref = _run(_jax_engine(weights, lora=True, **kw), JaxParams,
               loras=LORAS)
    eng = _port_engine(weights, world, lora=True, **kw)
    got = _closing(eng, lambda e: _run(e, loras=LORAS))
    assert got == ref and got[0] != got[3]
    assert eng.stats()["lora_pinned"] == 0


def test_lora_load_and_resize_reach_the_other_rank(weights, world):
    """load_adapter and resize on rank 0 reach rank 1 (a slot write, a
    reallocation with its epoch): tokens after both equal tp=1's."""
    _, _, _, _, ads = weights

    def drive(engine):
        lm = engine.runner.lora
        first = _run(engine, loras=LORAS)
        lm.resize(6)
        again = _run(engine, loras=LORAS)
        renamed = tlora.LoRAAdapter("a9", ads[2].rank, ads[2].alpha,
                                    ads[2].weights)
        lm.load_adapter(renamed)
        last = _run(engine, loras=[None, "a9", "a1", "a0"])
        return first, again, last, lm.epoch

    got = _closing(_port_engine(weights, world, lora=True), drive)
    want = _closing(_port_engine(weights, None, lora=True), drive)
    assert got == want and got[0] == got[1] and got[3] == 1


def test_gather_pages_equal_jax_whole_pool(weights, world):
    """After the same prefill, gather_pages at tp=2 returns the whole pool's
    layout (every kv head) with the JAX runner's values under its mesh;
    pages scattered at tp=2 gather back byte for byte, JAX's pages too."""
    import jax.numpy as jnp

    jeng = _jax_engine(weights)
    eng = _port_engine(weights, world)
    try:
        for e in (jeng, eng):
            e.add_request(PROMPTS[2], SamplingParams(max_tokens=2),
                          request_id="p")
            while not e.running:
                e.step()
        ids = list(eng.running[0].blocks)
        assert ids == list(jeng.running[0].blocks)
        jk, jv = (np.asarray(a) for a in jeng.runner.gather_pages(ids))
        tk, tv = eng.runner.gather_pages(ids)
        assert tk.shape == jk.shape == (2, 2, len(ids), 8, 16)
        np.testing.assert_allclose(tk, jk, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
        dst = [40, 41, 42][:len(ids)]
        eng.runner.scatter_pages(dst, jk, jv)
        gk, gv = eng.runner.gather_pages(dst)
        assert gk.tobytes() == jk.tobytes() and gv.tobytes() == jv.tobytes()
        jeng.runner.scatter_pages(dst, jnp.asarray(tk), jnp.asarray(tv))
        back = [np.asarray(a) for a in jeng.runner.gather_pages(dst)]
        assert back[0].tobytes() == tk.tobytes()
        with pytest.raises(ValueError, match="outside"):
            eng.runner.gather_pages([64])
        with pytest.raises(ValueError, match="pool takes"):
            eng.runner.scatter_pages([1], gk, gv)
        eng.abort_request("p")
        # A refused call reached no rank: the world still serves.
        assert _run(eng, prompts=PROMPTS[:1], max_tokens=3)
    finally:
        eng.runner.close()


def test_table_adoption_into_tp2_as_at_tp1(weights, world):
    """A tp=1 engine's host tier publishes a system prompt's blocks into
    a GCS prefix table; a tp=2 engine (the same model: one fingerprint at
    any tp) adopts them, prefills the suffix alone and gives the tp=1
    engine's greedy tokens."""
    import asyncio

    from ray_tpu_torch.llm import prefix_store
    from ray_tpu_torch.runtime.gcs.server import GcsServer

    srv = GcsServer()

    def transport(method, m, payload=b""):
        r = asyncio.run(getattr(srv, f"handle_{method}")(None, m, payload))
        return r.m, r.payload

    def greedy(engine, prompt):
        return engine.generate([prompt], SamplingParams(
            max_tokens=6, temperature=0.0))[0].output_token_ids

    def prompt(seed, n):
        return [(seed * 7 + 3 * i + seed) % 128 for i in range(n)]

    owner = _port_engine(weights, None, num_blocks=16)
    owner_store = prefix_store.ClusterPrefixStore(8, replica="owner",
                                                  transport=transport)
    owner.attach_prefix_store(
        host_tier=prefix_store.HostPrefixTier(48 << 10, low_watermark=0.3),
        cluster_store=owner_store)
    request = prompt(1, 24) + prompt(2, 6)
    ref = greedy(owner, request)
    for s in range(3, 8):
        greedy(owner, prompt(s, 40))
    assert owner_store.published >= 3
    eng = _port_engine(weights, world)
    try:
        eng.attach_prefix_store(cluster_store=prefix_store.ClusterPrefixStore(
            8, replica="tp2", transport=transport))
        assert eng.model_fingerprint == owner.model_fingerprint
        before = eng.prefill_tokens_computed
        assert greedy(eng, request) == ref
        assert eng.cluster_prefix_hits == 3
        assert eng.prefill_tokens_computed - before == len(request) - 24
    finally:
        eng.runner.close()


def test_update_weights_and_checkpoint_loading_as_at_tp1(weights, worlds,
                                                         tmp_path):
    """update_weights at tp=2 (each leaf sent to both ranks, each copying
    its shard in place) decodes as a fresh engine on the new weights;
    LLMConfig.params_checkpoint loads the port's and the JAX package's
    checkpoints at tp=2 to the same tokens as the broadcast weights."""
    import jax

    from ray_tpu.checkpoint import save_sharded as jsave
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.train.checkpoint import Checkpoint

    jconfig, _, tconfig, tparams, _ = weights
    new_j = jax.tree.map(np.asarray, jl.init_params(jconfig,
                                                    jax.random.key(5)))
    new_t = tl.params_from_numpy(new_j, tconfig, device="cpu")
    fresh = _closing(_port_engine(weights, None, params=new_t), _run)
    eng = _port_engine(weights, worlds.get())
    try:
        old = _run(eng)
        ptr = eng.runner.params["layers"]["wq"].data_ptr()
        with pytest.raises(te.WeightSyncError, match="shape mismatch"):
            eng.update_weights(dict(new_t, embed=new_t["embed"][:-1]))
        assert eng.update_weights(new_t)["version"] == 1
        assert eng.runner.params["layers"]["wq"].data_ptr() == ptr
        assert _run(eng) == fresh != old
    finally:
        eng.runner.close()
    Checkpoint.save_pytree(new_t, str(tmp_path / "port"))
    for w in range(2):
        jsave(new_j, str(tmp_path / "jax"), rank=w, world=2)
    # build_engine starts (and the runner's close stops) a world of its
    # own: the module's world leaves first.
    worlds.close()
    for d in ("port", "jax"):
        cfg = LLMConfig(model_config=tconfig, params_checkpoint=str(
            tmp_path / d), tensor_parallel=2, device="cpu",
            num_kv_blocks=64, block_size=8, prefill_chunk=8,
            max_batch_size=4, warmup_buckets="off")
        got = _closing(build_engine(cfg), _run)
        assert got == fresh, d
        assert not torch.distributed.is_initialized()


def test_server_on_tp2_round_trip_and_close(weights, worlds):
    """LLMServer(tensor_parallel=2) starts its world, answers completions
    as tp=1 does, and close() leaves no rank and no process group."""
    _, _, tconfig, tparams, _ = weights
    worlds.close()
    outs = []
    for n in (2, 1):
        cfg = LLMConfig(model_config=tconfig, tensor_parallel=n,
                        device="cpu", num_kv_blocks=64, block_size=8,
                        prefill_chunk=8, warmup_buckets="light")
        with LLMServer(cfg, params=tparams) as server:
            ranks = server.engine.runner.tp
            outs.append([server.completions(
                {"prompt": p, "max_tokens": 6})["choices"][0]["token_ids"]
                for p in PROMPTS[:2]])
        assert ranks == n
        assert not torch.distributed.is_initialized()
    assert outs[0] == outs[1]


def test_refusals_without_the_ranks(weights, monkeypatch):
    """tensor_parallel beyond the machine's cards, or one that does not
    divide the heads, raises before any rank starts. A second NCCL world
    in one process is no longer refused (the card test
    test_two_tensor_parallel_worlds_in_one_process runs two)."""
    _, _, tconfig, tparams, _ = weights
    with pytest.raises(ValueError, match="does not divide"):
        build_engine(LLMConfig(model_config=tconfig, tensor_parallel=3,
                               device="cpu"), params=tparams)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="takes 2 cards.*has 1"):
        build_engine(LLMConfig(model_config=tconfig, tensor_parallel=2,
                               device="cuda"))
    assert not hasattr(launch, "_nccl_worlds")


def test_failing_follower_fails_the_next_call(weights, worlds):
    """A command that raises on rank 1 ends that rank; rank 0's next step
    raises its traceback within seconds instead of hanging in a
    collective, and every call after that raises too."""
    w = worlds.get()
    try:
        eng = _port_engine(weights, w)
        assert _run(eng, prompts=PROMPTS[:1], max_tokens=2)
        eng.runner._call("no_such_entry_point")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 failed"):
            _run(eng, prompts=PROMPTS[:1], max_tokens=2)
        assert time.monotonic() - t0 < 60
        with pytest.raises(RuntimeError, match="world is closed"):
            eng.runner.step_verify(np.zeros((1, 1), np.int32), [0], [1],
                                   [1], np.zeros((1, 8), np.int32))
    finally:
        worlds.close()
