"""The port's own actor runtime, on one module-scoped cluster of its own
(init(num_cpus=2) with two fake GPUs): the scenarios of
tests/test_core_api.py with the values those tests expect (tasks, fan-out,
num_returns, put/get, refs as arguments, failures, wait, get timeouts,
nested tasks, actors and their death), streaming generators, placement
groups, GPU accounting (CUDA_VISIBLE_DEVICES per lease, a pending third
actor), and a tiny LLMServer served from an actor against the JAX
engine's greedy tokens.

No JAX cluster is started here. Remote functions and actor classes are
defined inside the tests, so workers unpickle them by value and never
import this module (nor jax). Every get, wait and start-up wait has a
deadline of at most 60 s; the cluster starts in the fixture, never at
collection, and its teardown kills whatever it started and unlinks its
shared-memory store.
"""

import os
import signal
import time

import numpy as np
import pytest
from torch_cluster import port_cluster

import ray_tpu_torch as rt
from ray_tpu_torch.runtime.scheduling import PlacementGroupStrategy

T = 60  # every deadline in this file


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(num_cpus=2, object_store_memory=128 << 20) as session:
        yield session


# ---- tasks and objects ---------------------------------------------------------

def test_simple_task_and_fanout(cluster):
    @rt.remote
    def echo(x):
        return x

    assert rt.get(echo.remote(42), timeout=T) == 42
    refs = [echo.remote(i) for i in range(50)]
    assert rt.get(refs, timeout=T) == list(range(50))


def test_kwargs_and_num_returns(cluster):
    @rt.remote
    def f(a, b, c=0, d=0):
        return a + b + c + d

    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    assert rt.get(f.remote(1, 2, c=3, d=4), timeout=T) == 10
    assert rt.get(list(three.remote()), timeout=T) == [1, 2, 3]


def test_large_result_put_get_and_refs_as_args(cluster):
    @rt.remote
    def big():
        return np.arange(1 << 20, dtype=np.int64)

    @rt.remote
    def consume(arr):
        return float(arr.sum())

    @rt.remote
    def echo(x):
        return x

    arr = rt.get(big.remote(), timeout=T)
    assert arr.shape == (1 << 20,) and arr[-1] == (1 << 20) - 1
    ref = rt.put({"a": np.ones(100000), "b": "text"})
    out = rt.get(ref, timeout=T)
    assert out["b"] == "text"
    np.testing.assert_array_equal(out["a"], np.ones(100000))
    assert rt.get(consume.remote(rt.put(np.full(50000, 7.0))),
                  timeout=T) == 350000.0
    assert rt.get(echo.remote(echo.remote(5)), timeout=T) == 5


def test_failures_propagate(cluster):
    @rt.remote
    def fail():
        raise ValueError("boom-42")

    @rt.remote
    def echo(x):
        return x

    with pytest.raises(rt.TaskError, match="boom-42"):
        rt.get(fail.remote(), timeout=T)
    with pytest.raises(rt.RayTpuError, match="boom-42"):
        rt.get(echo.remote(fail.remote()), timeout=T)


def test_nested_tasks(cluster):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=60) + 1

    assert rt.get(outer.remote(10), timeout=T) == 21


def test_wait_and_get_timeout(cluster):
    @rt.remote
    def slow(t):
        time.sleep(t)
        return t

    refs = [slow.remote(0.05), slow.remote(3)]
    ready, pending = rt.wait(refs, num_returns=1, timeout=30)
    assert len(ready) == 1 and len(pending) == 1
    assert rt.get(ready[0], timeout=T) == 0.05
    with pytest.raises(rt.GetTimeoutError):
        rt.get(slow.remote(5), timeout=0.5)


def test_task_retry_on_worker_crash(cluster, tmp_path):
    @rt.remote(max_retries=2)
    def crash_once(path):
        if not os.path.exists(path):
            open(path, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return "recovered"

    marker = str(tmp_path / "crashed")
    assert rt.get(crash_once.remote(marker), timeout=T) == "recovered"


def test_cancel_and_free(cluster):
    @rt.remote
    def hang():
        for _ in range(300):   # the interrupt lands between sleeps
            time.sleep(0.1)

    ref = hang.remote()
    time.sleep(0.5)
    assert rt.cancel(ref) is True
    with pytest.raises(rt.TaskCancelledError):
        rt.get(ref, timeout=T)
    big = rt.put(np.ones(1 << 16))
    np.testing.assert_array_equal(rt.get(big, timeout=T), np.ones(1 << 16))
    rt.free([big])
    with pytest.raises(rt.RayTpuError):
        rt.get(big, timeout=2)


def test_raylet_object_chunks_round_trip(cluster):
    """A store-less driver's chunked put and a pull from a node's raylet go
    through the raylet's raw-frame object handlers: a payload of three
    chunks comes back byte for byte, and a freed object is reported lost."""
    from ray_tpu_torch.core.exceptions import ObjectLostError
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.utils.ids import ID_SIZE

    core = global_worker()
    oid = os.urandom(ID_SIZE)
    payload = np.random.default_rng(0).bytes((9 << 20) + 5)
    core._remote_put(oid, payload)
    assert bytes(core._pull_remote(oid, core.node_id)) == payload
    core.io.run(core.raylet.call("free_object", oid=oid), timeout=T)
    with pytest.raises(ObjectLostError):
        core._pull_remote(oid, core.node_id)


def test_async_and_threaded_actors_overlap(cluster):
    @rt.remote(max_concurrency=4)
    class Sleeper:
        def nap(self, t):
            time.sleep(t)
            return t

    @rt.remote
    class AsyncSleeper:
        async def nap(self, t):
            import asyncio

            await asyncio.sleep(t)
            return t

    for cls in (Sleeper, AsyncSleeper):
        actor = cls.remote()
        rt.get(actor.nap.remote(0), timeout=T)
        t0 = time.monotonic()
        assert rt.get([actor.nap.remote(1.0) for _ in range(4)],
                      timeout=T) == [1.0] * 4
        assert time.monotonic() - t0 < 3.0  # four naps overlap
        rt.kill(actor)


def test_cluster_resources(cluster):
    total = rt.cluster_resources()
    assert total["CPU"] == 2.0 and total["GPU"] == 2.0


def test_streaming_generators(cluster):
    @rt.remote(num_returns="streaming")
    def countdown(n):
        for i in range(n):
            yield i

    @rt.remote(num_returns="streaming")
    def flaky():
        yield 1
        raise ValueError("boom")

    @rt.remote
    class Streamer:
        def tokens(self, n):
            for i in range(n):
                yield f"tok{i}"

    gen = countdown.remote(5)
    assert isinstance(gen, rt.ObjectRefGenerator)
    assert [rt.get(r, timeout=T) for r in gen] == list(range(5))
    s = Streamer.remote()
    gen = s.tokens.options(num_returns="streaming").remote(4)
    assert [rt.get(r, timeout=T) for r in gen] == [
        "tok0", "tok1", "tok2", "tok3"]
    gen = flaky.remote()
    assert rt.get(gen.next(timeout=T), timeout=T) == 1
    with pytest.raises(Exception, match="boom"):
        for _ in range(3):
            next(gen)
    rt.kill(s)


# ---- actors ---------------------------------------------------------------------

def _counter():
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def pid(self):
            return os.getpid()

        def fail(self):
            raise RuntimeError("actor-task-fail")

    return rt.remote(Counter)


def test_actor_calls_order_errors_and_names(cluster):
    Counter = _counter()
    c = Counter.remote(10)
    assert rt.get([c.inc.remote() for _ in range(3)], timeout=T) == [
        11, 12, 13]
    refs = [c.inc.remote() for _ in range(20)]
    assert rt.get(refs, timeout=T) == list(range(14, 34))
    with pytest.raises(rt.TaskError, match="actor-task-fail"):
        rt.get(c.fail.remote(), timeout=T)
    assert rt.get(c.inc.remote(), timeout=T) == 34
    Counter.options(name="port-named").remote(100)
    h = rt.get_actor("port-named")
    assert rt.get(h.inc.remote(), timeout=T) == 101
    with pytest.raises(ValueError):
        rt.get_actor("does-not-exist")

    @rt.remote
    def use_actor(handle):
        return rt.get(handle.inc.remote(5), timeout=60)

    assert rt.get(use_actor.remote(c), timeout=T) == 39
    rt.kill(c)
    rt.kill(h)


def test_actor_death_and_restart(cluster):
    Counter = _counter()
    c = Counter.remote(0)
    assert rt.get(c.inc.remote(), timeout=T) == 1
    rt.kill(c)
    time.sleep(1.0)
    with pytest.raises(rt.ActorError):
        rt.get(c.inc.remote(), timeout=30)
    p = Counter.options(max_restarts=1).remote(0)
    pid = rt.get(p.pid.remote(), timeout=T)
    os.kill(pid, signal.SIGKILL)
    deadline = time.time() + T
    while True:
        try:
            new_pid = rt.get(p.pid.remote(), timeout=30)
            break
        except rt.ActorError:
            if time.time() > deadline:
                raise
            time.sleep(0.5)
    assert new_pid != pid
    rt.kill(p)


# ---- GPU accounting and placement groups ---------------------------------------

def _visible():
    class Visible:
        def ids(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    return rt.remote(num_gpus=1)(Visible)


def test_gpu_leases_see_their_cards(cluster):
    """A num_gpus=1 task sees one card id, a task without GPUs sees none;
    two one-GPU actors see different ids and a third stays pending until
    one of them is killed, then takes the freed id."""
    @rt.remote(num_gpus=1)
    def one():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @rt.remote
    def none():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    assert rt.get(one.remote(), timeout=T) in ("0", "1")
    assert rt.get(none.remote(), timeout=T) == ""
    Visible = _visible()
    a, b = Visible.remote(), Visible.remote()
    ids = rt.get([a.ids.remote(), b.ids.remote()], timeout=T)
    assert sorted(ids) == ["0", "1"]
    c = Visible.remote()
    ready, pending = rt.wait([c.ids.remote()], num_returns=1, timeout=3)
    assert ready == [] and len(pending) == 1
    rt.kill(a)
    assert rt.get(pending[0], timeout=T) == ids[0]
    rt.kill(b)
    rt.kill(c)


def test_fractional_gpus_refused(cluster):
    with pytest.raises(ValueError, match="whole number"):
        rt.remote(num_gpus=0.5)(lambda: 1)


def test_placement_group_ready_and_remove(cluster):
    def settled():
        deadline = time.time() + T
        while rt.available_resources().get("GPU", 0) < 2:
            assert time.time() < deadline
            time.sleep(0.2)

    settled()
    pg = rt.placement_group([{"GPU": 1, "CPU": 1}])
    assert pg.wait(T)
    assert pg.table()["state"] == "CREATED"
    actor = _visible().options(
        scheduling_strategy=PlacementGroupStrategy(pg, 0)).remote()
    assert rt.get(actor.ids.remote(), timeout=T) in ("0", "1")
    with pytest.raises(rt.RayTpuError):
        rt.placement_group([{"GPU": 100}], strategy="STRICT_PACK")
    rt.remove_placement_group(pg)
    assert pg.table()["state"] == "REMOVED"
    settled()


def test_unported_options_refuse(cluster):
    with pytest.raises(ValueError, match="not ported"):
        rt.remote(runtime_env={"env_vars": {"A": "1"}})(lambda: 1)
    with pytest.raises(ValueError, match="not ported"):
        rt.init(runtime_env={"env_vars": {"A": "1"}})
    from ray_tpu_torch.core import worker as worker_mod

    core = worker_mod.global_worker()
    with pytest.raises(ValueError, match="not ported"):
        core.io.run(core.gcs.call("list_tasks"), timeout=T)


def test_unported_raylet_handlers_refuse(cluster):
    from ray_tpu_torch.core import worker as worker_mod

    core = worker_mod.global_worker()
    for method in ("dump_stacks", "env_hold", "drain_self"):
        with pytest.raises(ValueError, match="not ported"):
            core.io.run(core.raylet.call(method), timeout=T)
    stats = core.io.run(core.raylet.call("node_stats"), timeout=T)
    assert stats["resources"]["GPU"] == 2.0
    assert os.path.basename(core.store.path).startswith("store_torch_")


# ---- serving from an actor --------------------------------------------------------

def test_tiny_server_in_actor_matches_jax_engine(cluster, cpu_jax):
    """A tiny fp32 LLMServer (device="cpu") built inside an actor from the
    JAX package's seeded weights (params_from_numpy) gives the JAX
    engine's greedy tokens for the same prompts."""
    import jax

    from ray_tpu.llm.serving import LLMConfig as JConfig
    from ray_tpu.llm.serving import LLMServer as JServer
    from ray_tpu.models import llama as jl

    base = dict(num_kv_blocks=64, block_size=8, max_batch_size=4,
                prefill_chunk=8, warmup_buckets="off")
    model = dict(vocab_size=128, max_seq=64)
    jconfig = jl.LlamaConfig.tiny(dtype=jax.numpy.float32, **model)
    np_params = jax.tree.map(np.asarray, jl.init_params(
        jconfig, jax.random.key(0)))

    class Host:
        def __init__(self, np_params, model, base):
            import torch

            from ray_tpu_torch.llm.serving import LLMConfig, LLMServer
            from ray_tpu_torch.models import llama as tl

            config = tl.LlamaConfig.tiny(dtype=torch.float32, **model)
            params = tl.params_from_numpy(np_params, config, device="cpu")
            # Inside a cluster the cluster prefix tier refuses (ROADMAP.md
            # queue 1 item 6.3): the host tier only, as outside one.
            self.server = LLMServer(
                LLMConfig(model_config=config, device="cpu",
                          cluster_prefix_store=False, **base),
                params=params)

        def completions(self, request):
            return self.server.completions(request)

    prompts = [[(7 * s + 3 * i) % 128 for i in range(9 + s)]
               for s in range(3)]
    host = rt.remote(max_concurrency=4)(Host).remote(np_params, model, base)
    refs = [host.completions.remote({"prompt": p, "max_tokens": 8,
                                     "temperature": 0.0})
            for p in prompts]
    got = [r["choices"][0]["token_ids"] for r in rt.get(refs, timeout=T)]
    # The JAX server's loop thread is a daemon that idles once done.
    jserver = JServer(JConfig(model_config=jconfig, **base))
    want = [jserver.completions({"prompt": p, "max_tokens": 8,
                                 "temperature": 0.0})["choices"][0][
                                     "token_ids"] for p in prompts]
    assert got == want
    rt.kill(host)
