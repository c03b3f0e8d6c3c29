"""The port's Serve on one module-scoped cluster of the port's runtime
(init(num_cpus=2) with two fake GPUs): the scenarios of tests/test_serve.py
apart from gRPC, with the values those tests expect (deploy and call,
method routing, two replicas balanced, redeploy, status and delete, the
HTTP proxy with its health route and 404, composition, the HTTP adapter
and its misconfiguration, push propagation), plus SSE through the proxy
(tests/test_serve_llm_breadth.py), autoscaling up and down
(tests/test_serve_autoscaling.py), a deployment on the default cluster
prefix store (it publishes to the GCS prefix table, a server in the test
process adopts, serve.delete purges its rows), and a tiny fp32
build_openai_app deployment whose greedy tokens over HTTP equal the JAX
package's in-process LLMServer's.

No JAX cluster is started here. Deployments are defined inside the tests,
so replicas unpickle them by value and never import this module (nor jax).
Every get, wait and start-up wait has a deadline of at most 60 s (a
deploy waits twice serve_replica_health_timeout_s, set to 30 s here; the
autoscaler ticks every 0.25 s); the cluster starts in the fixture, never
at collection, and its teardown runs serve.shutdown(), rt.shutdown(),
then kills whatever the session left and unlinks its store.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_cluster import port_cluster

from ray_tpu_torch import serve

T = 60  # every deadline in this file


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(
            num_cpus=2, object_store_memory=128 << 20,
            before_shutdown=serve.shutdown,
            _system_config={"serve_autoscale_interval_s": 0.25,
                            "serve_replica_health_timeout_s": 30}) as s:
        yield s


def _greeter():
    @serve.deployment
    class Greeter:
        def __init__(self, greeting="hello"):
            self.greeting = greeting

        def __call__(self, name):
            return f"{self.greeting} {name}"

        def shout(self, name):
            return f"{self.greeting.upper()} {name.upper()}"

    return Greeter


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=T) as resp:
        return json.loads(resp.read())


def _http_error(url, data):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(urllib.request.Request(
            url, data=data, method="POST"), timeout=T)
    return ei.value.code, json.loads(ei.value.read())


def _sse(url, payload):
    """POST `payload`; the server-sent events' JSON bodies up to [DONE]."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=T) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            body = line[len("data: "):]
            if body == "[DONE]":
                break
            events.append(json.loads(body))
    return events


def _names():
    return {d["name"] for d in serve.status()}


# ---- deployments and handles ---------------------------------------------

def test_deploy_call_and_method_routing(cluster):
    Greeter = _greeter()
    handle = serve.run(Greeter.bind("hey"))
    assert handle.remote("world").result(timeout=T) == "hey world"
    handle = serve.run(Greeter.options(name="shouter").bind("hi"))
    assert handle.shout.remote("bob").result(timeout=T) == "HI BOB"
    assert handle.options("shout").remote("al").result(timeout=T) == "HI AL"
    assert serve.delete("Greeter") and serve.delete("shouter")


def test_two_replicas_balanced_each_on_its_own_card(cluster):
    """Both replicas take traffic, and each one-GPU replica sees only its
    own card (CUDA_VISIBLE_DEVICES of its lease)."""
    @serve.deployment
    class PidProbe:
        def __call__(self, _):
            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    handle = serve.run(PidProbe.options(name="pids", num_replicas=2,
                                        num_gpus=1).bind())
    seen = {tuple(handle.remote(None).result(timeout=T)) for _ in range(16)}
    assert len({pid for pid, _ in seen}) == 2
    assert sorted(cards for _, cards in seen) == ["0", "1"]
    assert serve.delete("pids")


def test_redeploy_status_and_delete(cluster):
    Greeter = _greeter()
    serve.run(Greeter.options(name="re").bind("v1"))
    assert serve.get_deployment_handle("re").remote("x").result(
        timeout=T) == "v1 x"
    serve.run(Greeter.options(name="re").bind("v2"))
    assert serve.get_deployment_handle("re").remote("x").result(
        timeout=T) == "v2 x"
    (re_row,) = [d for d in serve.status() if d["name"] == "re"]
    assert re_row["num_replicas"] == 1 and re_row["version"] >= 2
    serve.run(Greeter.options(name="temp").bind())
    assert "temp" in _names()
    assert serve.delete("temp") and serve.delete("re")
    assert not {"temp", "re"} & _names()
    assert serve.delete("temp") is False


def test_http_proxy_healthz_and_missing_deployment_404(cluster):
    Greeter = _greeter()
    serve.run(Greeter.options(name="http-greeter").bind("yo"))
    host, port = serve.start_http_proxy()
    assert serve.start_http_proxy() == (host, port)
    body = _post(f"http://{host}:{port}/http-greeter",
                 json.dumps("web").encode(),
                 {"Content-Type": "application/json"})
    assert body["result"] == "yo web"
    with urllib.request.urlopen(f"http://{host}:{port}/-/healthz",
                                timeout=T) as resp:
        assert json.loads(resp.read())["status"] == "ok"
    code, body = _http_error(f"http://{host}:{port}/nope", b"{}")
    assert code == 404 and "nope" in body["error"]
    assert serve.delete("http-greeter")


def test_model_composition(cluster):
    @serve.deployment
    class Preprocessor:
        def __call__(self, text):
            return text.strip().lower()

    @serve.deployment
    class Composed:
        """Child deployments bound as init args arrive as handles."""

        def __init__(self, pre, greeter):
            self.pre = pre
            self.greeter = greeter

        def __call__(self, text):
            cleaned = self.pre.remote(text).result(timeout_s=T)
            return self.greeter.remote(cleaned).result(timeout_s=T)

    app = Composed.bind(Preprocessor.bind(),
                        _greeter().options(name="inner_greet").bind("yo"))
    handle = serve.run(app)
    assert handle.remote("  World  ").result(timeout_s=T) == "yo world"
    assert {"Composed", "Preprocessor", "inner_greet"} <= _names()
    for name in ("Composed", "Preprocessor", "inner_greet"):
        serve.delete(name)


def test_http_adapter_and_misconfiguration(cluster):
    """A deployment declaring http_adapter receives the converted value
    from the ingress, handle callers the raw one; adapter failures are 400,
    an unknown adapter name 500 naming it, a wrong-keyed json_to_ndarray
    body 400 naming "array"."""
    @serve.deployment(http_adapter="json_to_ndarray")
    def sum_model(arr):
        assert isinstance(arr, np.ndarray), type(arr)
        return {"sum": float(arr.sum()), "shape": list(arr.shape)}

    @serve.deployment(name="typo_dep", http_adapter="json_to_ndarry")
    def typo_dep(x):
        return x

    handle = serve.run(sum_model.bind())
    serve.run(typo_dep.bind())
    host, port = serve.start_http_proxy()
    url = f"http://{host}:{port}"
    out = _post(f"{url}/sum_model",
                json.dumps({"array": [[1, 2], [3, 4]]}).encode(),
                {"Content-Type": "application/json"})["result"]
    assert out == {"sum": 10.0, "shape": [2, 2]}
    assert handle.remote(np.ones((2, 3))).result(timeout=T)["sum"] == 6.0
    assert _http_error(f"{url}/sum_model", b"not json{")[0] == 400
    code, body = _http_error(f"{url}/typo_dep", b"[1,2]")
    assert code == 500 and "json_to_ndarry" in body["error"]
    code, body = _http_error(f"{url}/sum_model",
                             json.dumps({"data": [1, 2]}).encode())
    assert code == 400 and "array" in body["error"]
    assert serve.delete("sum_model") and serve.delete("typo_dep")


def test_push_config_propagation_no_polling(cluster, monkeypatch):
    """With the time-based refresh effectively off (1 h), a redeploy
    reaches an existing handle through the controller's push, fast."""
    from ray_tpu_torch.config import cfg
    from ray_tpu_torch.serve.config_watcher import ConfigWatcher

    monkeypatch.setattr(cfg(), "serve_handle_refresh_s", 3600.0)
    Greeter = _greeter()
    serve.run(Greeter.options(name="pushy").bind("v1"))
    h = serve.get_deployment_handle("pushy")
    watcher = ConfigWatcher.get()
    # The first call refreshes the empty routing set; later calls start
    # the shared subscription: wait for it on a deadline.
    deadline = time.monotonic() + T
    while True:
        assert h.remote("x").result(timeout=T) == "v1 x"
        if watcher.healthy or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert watcher.healthy
    v_before = watcher.version("pushy")

    serve.run(Greeter.options(name="pushy").bind("v2"))
    t0 = time.monotonic()
    while time.monotonic() < t0 + 2.0:
        v = watcher.version("pushy")
        if v is not None and v != v_before:
            break
        time.sleep(0.002)
    push_latency = time.monotonic() - t0
    assert watcher.version("pushy") != v_before, "push never arrived"
    assert push_latency < 0.5, f"push took {push_latency * 1000:.0f} ms"
    # The SAME handle routes to the new config with no periodic refresh.
    assert h.remote("x").result(timeout=T) == "v2 x"
    assert serve.delete("pushy")


def test_sse_streaming_through_http_proxy(cluster):
    """?stream=1 turns a generator method into server-sent events."""
    class Counter:
        def counts(self, request):
            for i in range(int(request.get("n", 3))):
                yield {"i": i}

    serve.run(serve.deployment(Counter).options(name="counter").bind(),
              http=True)
    host, port = serve.start_http_proxy()
    events = _sse(f"http://{host}:{port}/counter?method=counts&stream=1",
                  {"n": 4})
    assert [e["i"] for e in events] == [0, 1, 2, 3]
    assert serve.delete("counter")


def test_autoscales_up_and_down(cluster):
    @serve.deployment(name="slow", max_ongoing_requests=4,
                      autoscaling_config={"min_replicas": 1,
                                          "max_replicas": 3,
                                          "target_ongoing_requests": 1,
                                          "downscale_delay_s": 2.0})
    class Slow:
        def __call__(self, x):
            time.sleep(1.0)
            return x

    def replicas():
        return next(d["num_replicas"] for d in serve.status()
                    if d["name"] == "slow")

    handle = serve.run(Slow.bind())
    assert replicas() == 1
    # Sustained concurrent load: the queue per replica far above target.
    stop = time.monotonic() + 8
    results = []

    def hammer():
        while time.monotonic() < stop:
            results.append(handle.remote(1).result(timeout=30))

    threads = [threading.Thread(target=hammer) for _ in range(6)]
    for t in threads:
        t.start()
    most = 1
    while time.monotonic() < stop:
        most = max(most, replicas())
        time.sleep(0.25)
    for t in threads:
        t.join(T)
    assert most > 1, "deployment never scaled above 1 replica under load"
    assert results and all(r == 1 for r in results)
    # Idle: back to min_replicas after the downscale delay.
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and replicas() != 1:
        time.sleep(0.25)
    assert replicas() == 1, "did not scale back down"
    assert serve.delete("slow")


# ---- the LLM deployment --------------------------------------------------

PROMPTS = [[(7 * s + 3 * i) % 128 for i in range(9 + s)] for s in range(3)]


def _tiny_config(path=None, **kw):
    import torch

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models import llama as tl

    return LLMConfig(
        model_config=tl.LlamaConfig.tiny(vocab_size=128, max_seq=64,
                                         dtype=torch.float32),
        params_checkpoint=path, device="cpu", num_kv_blocks=64,
        block_size=8, max_batch_size=4, prefill_chunk=8,
        warmup_buckets="off", num_gpus_per_replica=1, **kw)


def test_default_prefix_store_publishes_adopts_and_purges(cluster):
    """A deployment with the default cluster_prefix_store=True deploys and
    serves. Under filler traffic its replica's host tier demotes a hot
    prompt's blocks into the GCS prefix table over the real call_raw path;
    a server in the test process, with no host tier of its own,
    adopts them (the replica's tokens, no prefill for the adopted blocks);
    serve.delete drops the deployment's rows (the controller's
    prefix_purge)."""
    import dataclasses

    from ray_tpu_torch.llm import build_llm_deployment
    from ray_tpu_torch.llm.prefix_store import (ClusterPrefixStore,
                                                cluster_chain)
    from ray_tpu_torch.llm.serving import LLMServer

    cfg = dataclasses.replace(_tiny_config(), num_kv_blocks=16,
                              host_prefix_mb=0.02,
                              host_prefix_low_watermark=0.2)
    assert cfg.cluster_prefix_store
    hot = [(5 * i + 3) % 128 for i in range(24)]
    request = {"prompt": hot + [7, 9, 11], "max_tokens": 6}
    store = ClusterPrefixStore(8)
    chain = cluster_chain(hot, 8)
    handle = serve.run(build_llm_deployment(cfg, name="prefix-pub"))
    try:
        ref = handle.remote(dict(request)).result(timeout=T)[
            "choices"][0]["token_ids"]
        for s in range(6):
            filler = [(11 * i + 17 * s + 1) % 128 for i in range(40)]
            handle.remote({"prompt": filler, "max_tokens": 2}).result(
                timeout=T)
        deadline = time.monotonic() + T
        hit = None
        while time.monotonic() < deadline:
            hit = store.lookup_owner(chain)
            if hit and hit["n_blocks"] == 3:
                break
            time.sleep(0.2)
        assert hit and hit["n_blocks"] == 3, hit
        assert hit["owner_replica"]
        with LLMServer(dataclasses.replace(cfg, host_prefix_mb=0)) as srv:
            assert srv.engine.cluster_store is not None
            before = srv.engine_stats()
            got = srv.completions(dict(request))["choices"][0]["token_ids"]
            after = srv.engine_stats()
        assert got == ref
        assert after["cluster_prefix_hits"] == 3
        assert after["cluster_prefix_adopted_blocks"] == 3
        assert (after["prefill_tokens_computed"]
                - before["prefill_tokens_computed"]) == 3
    finally:
        assert serve.delete("prefix-pub")
    deadline = time.monotonic() + T
    while time.monotonic() < deadline and store.lookup_owner(chain):
        time.sleep(0.2)
    assert store.lookup_owner(chain) is None
    assert "prefix-pub" not in _names()


def test_openai_app_tokens_over_http_equal_jax(cluster, cpu_jax, tmp_path):
    """build_openai_app of a tiny fp32 model (one fake card a replica) on
    weights the JAX package's writer checkpointed: greedy tokens over HTTP,
    plain and streamed as server-sent events, equal the JAX package's
    in-process LLMServer's on the same checkpoint."""
    import jax

    from ray_tpu.llm.serving import LLMConfig as JConfig
    from ray_tpu.llm.serving import LLMServer as JServer
    from ray_tpu.models import llama as jl
    from ray_tpu.train.checkpoint import Checkpoint
    from ray_tpu_torch.llm import build_openai_app

    jconfig = jl.LlamaConfig.tiny(vocab_size=128, max_seq=64,
                                  dtype=jax.numpy.float32)
    Checkpoint.save_pytree(jax.tree.map(np.asarray, jl.init_params(
        jconfig, jax.random.key(3))), str(tmp_path))
    handle = build_openai_app(_tiny_config(str(tmp_path),
                                           cluster_prefix_store=False))
    host, port = serve.start_http_proxy()
    url = f"http://{host}:{port}/v1-completions"
    got = [_post(url, json.dumps({"prompt": p, "max_tokens": 8}).encode())[
        "result"]["choices"][0]["token_ids"] for p in PROMPTS]
    events = _sse(url + "?method=completions_stream&stream=1",
                  {"prompt": PROMPTS[1], "max_tokens": 8,
                   "request_id": "sse-1"})
    direct = handle.remote({"prompt": PROMPTS[0], "max_tokens": 8}).result(
        timeout=T)["choices"][0]["token_ids"]
    # The JAX server's loop thread is a daemon that idles once done.
    jserver = JServer(JConfig(model_config=jconfig,
                              params_checkpoint=str(tmp_path),
                              num_kv_blocks=64, block_size=8,
                              max_batch_size=4, prefill_chunk=8,
                              warmup_buckets="off"))
    want = [jserver.completions({"prompt": p, "max_tokens": 8})[
        "choices"][0]["token_ids"] for p in PROMPTS]
    assert got == want
    assert [e["token"] for e in events[:-1]] == events[-1]["token_ids"] \
        == want[1]
    assert direct == want[0]
    assert serve.delete("v1-completions")
