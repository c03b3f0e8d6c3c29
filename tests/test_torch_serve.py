"""The port's Serve against the JAX package's, in process, with no cluster:
the scenarios of tests/test_serve_batching_multiplex.py,
tests/test_serve_scale_and_local.py (local testing mode) and the
json_to_ndarray adapter run through both packages on the same inputs and
must give the same results; `serve.run(build_llm_deployment(cfg),
local_testing_mode=True)` in both, on one set of tiny fp32 weights written
as a ray-tpu-ckpt-v1 checkpoint by the JAX writer, gives the same greedy
tokens and stream chunks. Also in process against the JAX package's:
ReplicaActor (the replica's actor body), @deployment/.options/.bind, the
handle's push-first refresh and power-of-two pick, and the controller's
autoscaling decisions on the same queue depths; the LLMConfig deployment
fields and their defaults against JAX's, and the port's refusals of what
it has not ported (the router front and the gRPC ingress).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu import serve as jserve
from ray_tpu.serve import batching as jbatching
from ray_tpu.serve import config_watcher as jwatch
from ray_tpu.serve import handle as jhandle
from ray_tpu.serve import http_adapters as jadapters
from ray_tpu.serve import multiplex as jmultiplex
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.serve import batching as tbatching
from ray_tpu_torch.serve import config_watcher as twatch
from ray_tpu_torch.serve import handle as thandle
from ray_tpu_torch.serve import http_adapters as tadapters
from ray_tpu_torch.serve import multiplex as tmultiplex

BOTH = [(jserve, jbatching, jmultiplex, jadapters),
        (tserve, tbatching, tmultiplex, tadapters)]


def _outcome(fn):
    """A call's value, or its exception's type name and message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


# ---- serve.batch ---------------------------------------------------------

def test_batch_coalesces_concurrent_calls():
    """Eight concurrent calls give the same answers in both packages, and
    each package coalesces some of them into one batch."""
    seen = []
    for _, batching, _, _ in BOTH:
        batch_sizes = []

        @batching.serve_batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        def predict(xs):
            batch_sizes.append(len(xs))
            return [x * 2 for x in xs]

        results = {}

        def call(i):
            results[i] = predict(i)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert max(batch_sizes) > 1
        assert sum(batch_sizes) == 8
        seen.append(results)
    assert seen[0] == seen[1] == {i: 2 * i for i in range(8)}


def test_batch_on_method_errors_and_size_mismatch():
    """A batched method's failure reaches its caller and the queue serves
    the next call; a batch function returning the wrong count raises the
    same error in both packages."""
    seen = []
    for _, batching, _, _ in BOTH:
        class Model:
            def __init__(self):
                self.calls = 0

            @batching.serve_batch(max_batch_size=4, batch_wait_timeout_s=0.01)
            def predict(self, xs):
                self.calls += 1
                if any(x < 0 for x in xs):
                    raise ValueError("negative input")
                return [x + 100 for x in xs]

        @batching.serve_batch(max_batch_size=2, batch_wait_timeout_s=0.001)
        def broken(xs):
            return xs + ["extra"]

        m = Model()
        seen.append([_outcome(lambda: m.predict(1)),
                     _outcome(lambda: m.predict(-1)),
                     _outcome(lambda: m.predict(2)),
                     _outcome(lambda: broken("a")),
                     _outcome(lambda: broken(x="a")), m.calls])
    assert seen[0] == seen[1]
    assert seen[1][:3] == [("ok", 101),
                           ("raised", "ValueError", "negative input"),
                           ("ok", 102)]
    assert seen[1][3][:2] == ("raised", "ValueError")
    assert "results" in seen[1][3][2]


# ---- multiplexing --------------------------------------------------------

def test_multiplexer_lru_and_multiplexed_decorator():
    seen = []
    for _, _, multiplex, _ in BOTH:
        loads, unloads = [], []
        mux = multiplex.Multiplexer(
            lambda mid: loads.append(mid) or f"model-{mid}",
            max_num_models=2, unload_fn=lambda m: unloads.append(m))
        got = [mux.get_model(m) for m in ("a", "b", "a", "c", "b")]

        class Replica:
            def __init__(self):
                self.loaded = []

            @multiplex.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                self.loaded.append(model_id)
                return lambda x: (f"{model_id}:{x}",
                                  multiplex.get_multiplexed_model_id())

            def predict(self, model_id, x):
                return self.get_model(model_id)(x)

        r = Replica()
        preds = [r.predict(m, x) for m, x in
                 (("m1", 5), ("m1", 6), ("m2", 1), ("m3", 1), ("m1", 7))]
        seen.append(dict(got=got, loads=loads, unloads=unloads,
                         resident=sorted(mux.loaded_model_ids()),
                         counts=(mux.load_count, mux.evict_count),
                         preds=preds, loaded=r.loaded))
    assert seen[0] == seen[1]
    assert seen[1]["loads"] == ["a", "b", "c", "b"]
    assert seen[1]["unloads"] == ["model-b", "model-a"]
    assert seen[1]["loaded"] == ["m1", "m2", "m3", "m1"]


# ---- HTTP adapters -------------------------------------------------------

def test_json_to_ndarray_and_registry_equal_jax():
    bodies = [(b'{"array": [[1, 2], [3, 4]]}', {}),
              (b"[1.5, 2.5]", {}),
              (b"[1, 2, 3]", {"dtype": "float32"}),
              (b'{"array": [1, 2], "dtype": "int8"}', {"dtype": "float64"}),
              (b'{"data": [1, 2]}', {})]
    seen = []
    for _, _, _, adapters in BOTH:
        row = []
        for body, query in bodies:
            req = adapters.HTTPRequest(body, "application/json", query)
            out = _outcome(lambda: adapters.json_to_ndarray(req))
            if out[0] == "ok":
                out = ("ok", out[1].tolist(), str(out[1].dtype))
            row.append(out)
        req = adapters.HTTPRequest(b'{"k": 1}', "text/plain", {"a": "b"})
        row.append((adapters.get("json_request")(req),
                    adapters.get("bytes_request")(req), req.text(),
                    sorted(adapters._REGISTRY)))
        row.append(_outcome(lambda: adapters.get("json_to_ndarry")))
        seen.append(row)
    assert seen[0] == seen[1]
    assert seen[1][0] == ("ok", [[1, 2], [3, 4]], "int64")
    assert seen[1][4][:2] == ("raised", "ValueError")


# ---- local testing mode --------------------------------------------------

def test_local_testing_mode_basic():
    seen = []
    for serve, _, _, _ in BOTH:
        @serve.deployment
        class Doubler:
            def __call__(self, x):
                return 2 * x

            def plus(self, x, y=0):
                return x + y

        h = serve.run(Doubler.bind(), local_testing_mode=True)
        try:
            row = [h.remote(21).result(), h.options("plus").remote(
                1, y=2).result(), h.plus.remote(5).result(), serve.status(),
                serve.get_deployment_handle("Doubler").remote(2).result()]
        finally:
            serve.shutdown()
        row.append(_outcome(lambda: h.remote(1)))
        seen.append(row)
    assert seen[0] == seen[1]
    assert seen[1][:3] == [42, 3, 5]
    assert seen[1][3][0]["local_testing_mode"] is True
    assert seen[1][5] == ("raised", "ValueError",
                          "no local deployment named 'Doubler'")


def test_local_testing_mode_composition_and_streaming():
    seen = []
    for serve, _, _, _ in BOTH:
        @serve.deployment
        class Tokenizer:
            def __call__(self, s):
                return s.split()

        @serve.deployment
        class Pipeline:
            def __init__(self, tok):
                self.tok = tok

            def __call__(self, s):
                return len(self.tok.remote(s).result())

            def stream(self, n):
                for i in range(n):
                    yield i * i

            def not_a_generator(self, n):
                return n

        h = serve.run(Pipeline.bind(Tokenizer.bind()),
                      local_testing_mode=True)
        try:
            seen.append([h.remote("a b c").result(),
                         list(h.options("stream").remote_stream(4)),
                         sorted(d["name"] for d in serve.status()),
                         _outcome(lambda: h.options(
                             "not_a_generator").remote_stream(1))])
        finally:
            serve.shutdown()
    assert seen[0] == seen[1]
    assert seen[1][:3] == [3, [0, 1, 4, 9], ["Pipeline", "Tokenizer"]]
    assert seen[1][3][1] == "TypeError"


def test_local_testing_mode_errors_and_timeouts():
    seen = []
    for serve, _, _, _ in BOTH:
        @serve.deployment
        class Slow:
            def __call__(self):
                time.sleep(2)

            def boom(self):
                raise RuntimeError("kaput")

        h = serve.run(Slow.bind(), local_testing_mode=True)
        try:
            slow = h.remote()
            seen.append([_outcome(lambda: h.boom.remote().result()),
                         _outcome(lambda: slow.result(timeout=0.2)),
                         _outcome(lambda: slow.result(timeout=30))])
        finally:
            serve.shutdown()
    assert seen[0] == seen[1]
    assert seen[1] == [("raised", "RuntimeError", "kaput"),
                       ("raised", "TimeoutError",
                        "local deployment call timed out"), ("ok", None)]


# ---- the LLM deployment --------------------------------------------------

PROMPTS = [[(7 * s + 3 * i) % 128 for i in range(9 + s)] for s in range(3)]


@pytest.fixture(scope="module")
def checkpoint(cpu_jax, tmp_path_factory):
    """Tiny fp32 Llama weights from a seed, written by the JAX package's
    checkpoint writer (ray-tpu-ckpt-v1)."""
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu.train.checkpoint import Checkpoint

    jconfig = jl.LlamaConfig.tiny(vocab_size=128, max_seq=64,
                                  dtype=jax.numpy.float32)
    params = jax.tree.map(np.asarray, jl.init_params(jconfig,
                                                     jax.random.key(3)))
    path = str(tmp_path_factory.mktemp("serve_ckpt"))
    Checkpoint.save_pytree(params, path)
    return jconfig, path


def _llm_configs(checkpoint, **kw):
    from ray_tpu.llm.serving import LLMConfig as JConfig
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models import llama as tl

    jconfig, path = checkpoint
    base = dict(params_checkpoint=path, num_kv_blocks=64, block_size=8,
                max_batch_size=4, prefill_chunk=8, warmup_buckets="off", **kw)
    tconfig = tl.LlamaConfig.tiny(vocab_size=128, max_seq=64,
                                  dtype=torch.float32)
    return (JConfig(model_config=jconfig, **base),
            LLMConfig(model_config=tconfig, device="cpu", **base))


def test_llm_deployment_local_mode_equals_jax(checkpoint):
    """serve.run(build_llm_deployment(cfg), local_testing_mode=True) in
    both packages on the same checkpointed weights: the same greedy
    tokens through the handle and the same completions_stream chunks."""
    from ray_tpu.llm.serving import build_llm_deployment as jbuild
    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.serve import local_testing

    seen = []
    for serve, build, cfg in zip((jserve, tserve),
                                 (jbuild, build_llm_deployment),
                                 _llm_configs(checkpoint)):
        h = serve.run(build(cfg, name="tiny-llm"), local_testing_mode=True)
        try:
            outs = [h.remote({"prompt": p, "max_tokens": 8}).result(
                timeout=60) for p in PROMPTS]
            chunks = list(h.options("completions_stream").remote_stream(
                {"prompt": PROMPTS[1], "max_tokens": 5,
                 "request_id": "stream-1"}))
            seen.append(dict(
                tokens=[o["choices"][0]["token_ids"] for o in outs],
                usage=[o["usage"] for o in outs], chunks=chunks,
                status=serve.status()))
        finally:
            if serve is tserve:
                local_testing._local_deployments["tiny-llm"].callable.close()
            serve.shutdown()
    assert seen[0] == seen[1]
    assert [len(t) for t in seen[1]["tokens"]] == [8, 8, 8]
    assert seen[1]["chunks"][-1]["token_ids"] == [
        c["token"] for c in seen[1]["chunks"][:-1]]


def test_llm_config_deployment_fields_and_build_llm_deployment_equal_jax():
    """Every LLMConfig field of the JAX package exists in the port with the
    same default (num_tpus_per_replica is num_gpus_per_replica), and
    build_llm_deployment makes the same deployment: name, replicas, cards
    per replica, max_ongoing_requests = max_batch_size, the config bound
    with deployment_name stamped."""
    from ray_tpu.llm.serving import LLMConfig as JConfig
    from ray_tpu.llm.serving import build_llm_deployment as jbuild
    from ray_tpu.llm.serving import LLMServer as JServer
    from ray_tpu_torch.llm import LLMConfig, LLMServer, build_llm_deployment

    rename = {"num_tpus_per_replica": "num_gpus_per_replica"}
    jfields = {rename.get(f.name, f.name): f.default
               for f in dataclasses.fields(JConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(LLMConfig)}
    assert set(tfields) - set(jfields) == {"device"}
    assert {k: tfields[k] for k in jfields} == jfields
    deps = [build(cls(num_replicas=3, max_batch_size=6,
                      **{key: 2}), name="fleet")
            for build, cls, key in ((jbuild, JConfig, "num_tpus_per_replica"),
                                    (build_llm_deployment, LLMConfig,
                                     "num_gpus_per_replica"))]
    got = [(d.name, d.config.num_replicas, d.config.max_ongoing_requests,
            getattr(d.config, gpu), d.init_args[0].deployment_name,
            d.init_kwargs) for d, gpu in zip(deps, ("num_tpus", "num_gpus"))]
    assert got[0] == got[1] == ("fleet", 3, 6, 2, "fleet", {})
    assert deps[0].func_or_class is JServer
    assert deps[1].func_or_class is LLMServer
    assert "__call__" in vars(LLMServer)


@pytest.mark.parametrize("case", ["grpc"])
def test_unported_serving_fronts_refuse(case):
    """What needs grpcio (queue 1 item 6.4) refuses with the port's
    _unported ValueError before any cluster work. The router front
    (build_routed_app, routing="affinity", disaggregate > 0) is ported:
    tests/test_torch_fleet.py holds it to the JAX package's and
    tests/test_torch_router_cluster.py runs it on the port's runtime."""
    calls = {
        "grpc": (tserve.start_grpc_proxy, r"gRPC ingress .*item 6\.4"),
    }
    fn, pattern = calls[case]
    with pytest.raises(ValueError, match=pattern + ".*not ported"):
        fn()


# ---- replicas, deployments, handles, the autoscaler ----------------------

def _targets():
    """Replica targets: a class with __call__ and a method, a function, a
    class that is not callable, a class whose health check fails."""
    class Model:
        def __init__(self, scale=1):
            self.scale = scale

        def __call__(self, x):
            return x * self.scale

        def add(self, x, y=0):
            return x + y

    def double(x):
        return 2 * x

    class NoCall:
        pass

    class Sick:
        def __call__(self):
            return None

        def check_health(self):
            raise RuntimeError("unhealthy")

    return dict(Model=Model, double=double, NoCall=NoCall, Sick=Sick)


REPLICA_CASES = {
    "call": ("Model", {"scale": 3}, "__call__", (4,), {}),
    "method": ("Model", {}, "add", (1,), {"y": 2}),
    "function": ("double", {}, "__call__", (21,), {}),
    "not_callable": ("NoCall", {}, "__call__", (), {}),
    "missing_method": ("Model", {}, "nope", (), {}),
    "health_check_fails": ("Sick", {}, "health_check", (), {}),
}


@pytest.mark.parametrize("case", sorted(REPLICA_CASES))
def test_replica_actor_in_process_equals_jax(case):
    """ReplicaActor (the replica's actor body), built in process from the
    same cloudpickled target in both packages: the same results and
    errors, and queue_len back at 0."""
    import cloudpickle

    from ray_tpu.serve.deployment import ReplicaActor as JReplica
    from ray_tpu_torch.serve.deployment import ReplicaActor as TReplica

    target, init_kwargs, method, args, kwargs = REPLICA_CASES[case]
    payload = cloudpickle.dumps(_targets()[target])
    seen = []
    for cls in (JReplica, TReplica):
        replica = cls(payload, (), init_kwargs)
        if method == "health_check":
            out = _outcome(replica.health_check)
        else:
            out = _outcome(lambda: replica.handle_request(method, args,
                                                          kwargs))
        seen.append((out, replica.queue_len()))
    assert seen[0] == seen[1]
    assert seen[1][1] == 0
    assert seen[1][0] == {"call": ("ok", 12), "method": ("ok", 3),
                          "function": ("ok", 42)}.get(case, seen[1][0])


def _deployment_view(dep):
    cfg = dataclasses.asdict(dep.config)
    cfg["num_gpus"] = cfg.pop("num_tpus", cfg.get("num_gpus"))
    return (dep.name, cfg, dep.init_args, dep.init_kwargs,
            getattr(dep.func_or_class, "__name__", None))


DEPLOYMENT_CASES = ["decorator_on_class", "decorator_with_args",
                    "options_keep_unset", "bind_leaves_original"]


@pytest.mark.parametrize("case", DEPLOYMENT_CASES)
def test_deployment_options_and_bind_equal_jax(case):
    """@deployment, .options and .bind build the same deployments in both
    packages (num_tpus read as num_gpus)."""
    seen = []
    for serve, gpu_key in ((jserve, "num_tpus"), (tserve, "num_gpus")):
        class Model:
            def __call__(self, x):
                return x

        def fn(x):
            return x

        if case == "decorator_on_class":
            deps = [serve.deployment(Model)]
        elif case == "decorator_with_args":
            deps = [serve.deployment(name="f", num_replicas=2,
                                     max_ongoing_requests=3,
                                     autoscaling_config={"max_replicas": 4},
                                     http_adapter="json_request",
                                     **{gpu_key: 1})(fn)]
        elif case == "options_keep_unset":
            base = serve.deployment(num_replicas=3, **{gpu_key: 1})(Model)
            deps = [base.options(max_ongoing_requests=5),
                    base.options(name="other", num_replicas=1,
                                 resources={"x": 1.0})]
        else:
            base = serve.deployment(Model)
            bound = base.bind(1, k="v")
            deps = [base, bound, bound.options(name="renamed")]
        seen.append([_deployment_view(d) for d in deps])
    assert seen[0] == seen[1]


class _FakeWatcher:
    def __init__(self, healthy, version):
        self.healthy = healthy
        self._version = version

    def ensure_started(self):
        pass

    def version(self, deployment):
        return self._version


REFRESH_CASES = {
    # name: (replicas, watcher healthy, pushed version, seconds since
    #        the last refresh) -> needs a refresh?
    "no_replicas": ([], True, 4, 0.0),
    "push_matches": (["r"], True, 4, 10.0),
    "push_newer": (["r"], True, 5, 0.0),
    "no_push_recent": (["r"], True, None, 0.0),
    "watcher_down_stale": (["r"], False, 4, 10.0),
}


@pytest.mark.parametrize("case", sorted(REFRESH_CASES))
def test_handle_push_first_refresh_equals_jax(case, monkeypatch):
    """DeploymentHandle._needs_refresh: push-first (a healthy watcher's
    version decides), time-based only in the degraded mode; the same
    answer in both packages."""
    import time as time_mod

    replicas, healthy, pushed, age = REFRESH_CASES[case]
    seen = []
    for handle_mod, watch_mod in ((jhandle, jwatch), (thandle, twatch)):
        watcher = _FakeWatcher(healthy, pushed)
        monkeypatch.setattr(watch_mod.ConfigWatcher, "get",
                            classmethod(lambda cls, w=watcher: w))
        h = handle_mod.DeploymentHandle("d")
        h._replicas, h._version = list(replicas), 4
        h._last_refresh = time_mod.monotonic() - age
        seen.append(h._needs_refresh())
    assert seen[0] == seen[1] == {
        "no_replicas": True, "push_matches": False, "push_newer": True,
        "no_push_recent": False, "watcher_down_stale": True}[case]


def test_handle_pick_options_and_attributes_equal_jax():
    """Power-of-two between two replicas takes the one with fewer requests
    in flight; options/attribute access share the routing state and name
    the method; underscore names are not methods."""
    seen = []
    for handle_mod in (jhandle, thandle):
        h = handle_mod.DeploymentHandle("d")
        row = [_outcome(h._pick_replica)]
        h._replicas, h._inflight = ["a", "b"], {0: 3, 1: 0}
        row.append([h._pick_replica() for _ in range(20)])
        h._replicas = ["a"]
        row.append(h._pick_replica())
        shout = h.shout
        row += [shout.method_name, shout._replicas is h._replicas,
                shout._inflight is h._inflight,
                h.options("x").method_name,
                _outcome(lambda: h._private)]
        seen.append(row)
    assert seen[0] == seen[1]
    assert seen[1][:3] == [("raised", "RuntimeError",
                            "deployment 'd' has no replicas"), [1] * 20, 0]


AUTOSCALE_CASES = {
    # name: (pending per replica, autoscaling config, seconds since the
    #        downscale was first wanted or None)
    "scale_up_clamped": ([3, 3], {"min_replicas": 1, "max_replicas": 4,
                                  "target_ongoing_requests": 1}, None),
    "at_min_no_change": ([0], {"min_replicas": 1, "max_replicas": 3}, None),
    "downscale_waits": ([0, 0, 0], {"min_replicas": 1, "max_replicas": 3,
                                    "downscale_delay_s": 5.0}, None),
    "downscale_after_delay": ([0, 0, 0], {
        "min_replicas": 1, "max_replicas": 3,
        "downscale_delay_s": 5.0}, 6.0),
}


@pytest.mark.parametrize("case", sorted(AUTOSCALE_CASES))
def test_controller_autoscale_decisions_equal_jax(case, monkeypatch):
    """ServeController._autoscale_once on the same replica queue depths
    (actor_stats_many faked) makes the same scaling decision in both
    packages: ceil(queued / target) clamped to [min, max], a downscale
    only after downscale_delay_s."""
    import time as time_mod
    import types

    from ray_tpu.core import worker as jworker
    from ray_tpu.serve.controller import ServeController as JController
    from ray_tpu_torch.core import worker as tworker
    from ray_tpu_torch.serve.controller import ServeController as TController

    queues, ac, since = AUTOSCALE_CASES[case]
    seen = []
    for cls, worker_mod in ((JController, jworker), (TController, tworker)):
        stats = [{"pending": q} for q in queues]
        fake = types.SimpleNamespace(
            actor_stats_many=lambda ids, timeout=None, s=stats: s)
        monkeypatch.setattr(worker_mod, "global_worker", lambda f=fake: f)
        controller = cls.__new__(cls)   # no autoscale thread
        controller._lock = threading.Lock()
        d = {"replicas": [types.SimpleNamespace(_actor_id=bytes([i]))
                          for i in range(len(queues))],
             "config": {"autoscaling": ac}, "version": 1}
        if since is not None:
            d["downscale_since"] = time_mod.monotonic() - since
        controller.deployments = {"d": d}
        calls = []
        controller._scale_to = lambda name, n, c=calls: c.append((name, n))
        controller._autoscale_once()
        seen.append((calls, "downscale_since" in d))
    assert seen[0] == seen[1] == {
        "scale_up_clamped": ([("d", 4)], False),
        "at_min_no_change": ([], False),
        "downscale_waits": ([], True),
        "downscale_after_delay": ([("d", 1)], False)}[case]


def test_local_testing_mode_coroutines_and_repeatable_results():
    """An async method's coroutine is run to its value, result() can be
    read again, a target that is not callable refuses __call__."""
    seen = []
    for serve, _, _, _ in BOTH:
        @serve.deployment
        class Async:
            async def get(self, x):
                return x + 1

        @serve.deployment
        class NoCall:
            pass

        h = serve.run([Async.bind(), NoCall.bind()], local_testing_mode=True)
        try:
            resp = h.get.remote(1)
            seen.append([resp.result(), resp.result(timeout_s=5),
                         _outcome(lambda: serve.get_deployment_handle(
                             "NoCall").remote().result())])
        finally:
            serve.shutdown()
    assert seen[0] == seen[1]
    assert seen[1][:2] == [2, 2] and seen[1][2][:2] == ("raised",
                                                        "AttributeError")
