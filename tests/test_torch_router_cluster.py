"""The port's LLM router front on one module-scoped cluster of the port's
runtime (init(num_cpus=2) with two fake GPUs), on a tiny fp32 model:
build_openai_app(routing="affinity") with two one-card replicas over
HTTP (tokens equal an in-process server's, repeats are affinity hits),
drain_replica moving a live session (LLM_SESSION_MIGRATED in
list_cluster_events, the client's answer whole), llm_serving_summary over
the replicas' pushed gauges, a disaggregate=1 app (a PrefillServer
replica handing off to the engine replica), and nothing of the apps left
after serve.shutdown.

No JAX cluster is started here, and no module-level class is deployed
(replicas unpickle what they run by value). Every get, wait and start-up
has a deadline of at most 60 s; the cluster starts in the fixture and its
teardown runs serve.shutdown(), rt.shutdown(), kills what the session
left and unlinks its store.
"""

import json
import os
import threading
import time
import urllib.request

import pytest
from torch_cluster import port_cluster

import ray_tpu_torch as rt
from ray_tpu_torch import serve

T = 60  # every deadline in this file
PROMPTS = [[(7 * s + 3 * i) % 128 for i in range(17 + s)] for s in range(3)]


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(
            num_cpus=2, object_store_memory=128 << 20,
            before_shutdown=serve.shutdown,
            _system_config={"serve_replica_health_timeout_s": 30}) as s:
        yield s


def _config(**kw):
    import torch

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models import llama as tl

    base = dict(model_config=tl.LlamaConfig.tiny(
        vocab_size=128, max_seq=256, dtype=torch.float32), seed=5,
        device="cpu", num_kv_blocks=128, block_size=8, max_batch_size=4,
        prefill_chunk=8, warmup_buckets="off", num_gpus_per_replica=1,
        cluster_prefix_store=False, stream_timeout_s=T)
    base.update(kw)
    return LLMConfig(**base)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=T) as resp:
        return json.loads(resp.read())["result"]


def _local_tokens(requests):
    """Greedy tokens of an in-process port server on the same weights."""
    from ray_tpu_torch.llm import LLMServer

    local = LLMServer(_config())
    try:
        return [local.completions(dict(r))["choices"][0]["token_ids"]
                for r in requests]
    finally:
        local.close()


def _replica_stats(name):
    """engine_stats of each replica of deployment `name`, in the order the
    router indexes them."""
    handles = serve.get_deployment_handle(name).replica_handles()
    return rt.get([h.handle_request.remote("engine_stats", [], {})
                   for h in handles], timeout=T)


def _wait(pred, what):
    deadline = time.monotonic() + T
    while True:
        got = pred()
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


AFFINITY_APP = ("v1-completions", "v1-completions-engine")


@pytest.fixture(scope="module")
def affinity_app(cluster):
    """The affinity app on both fake cards; the tests after its users
    delete it first (a module fixture outlives its last user)."""
    from ray_tpu_torch.llm import build_openai_app
    from ray_tpu_torch.serve import api as serve_api

    handle = build_openai_app(_config(routing="affinity", num_replicas=2))
    host, port = serve.start_http_proxy()
    yield handle, f"http://{host}:{port}/v1-completions"
    if serve_api._controller is not None:   # else serve.shutdown ran
        for name in AFFINITY_APP:
            serve.delete(name)


def test_affinity_app_over_http_equals_in_process(affinity_app):
    """build_openai_app(routing="affinity") deploys the engine tier and the
    router; POSTs through the HTTP proxy give an in-process server's
    greedy tokens, and each repeated prompt is an affinity hit."""
    handle, url = affinity_app
    requests = [{"prompt": p, "max_tokens": 8} for p in PROMPTS] * 2
    got = [_post(url, r)["choices"][0]["token_ids"] for r in requests]
    assert got == _local_tokens(requests)
    stats = handle.options("router_stats").remote().result(timeout=T)
    assert stats["replicas"] == 2 and stats["healthy_replicas"] == 2
    assert stats["affinity_hits"] >= 3
    assert {d["name"] for d in serve.status()} >= {
        "v1-completions", "v1-completions-engine"}


def test_drain_replica_migrates_a_live_session(affinity_app):
    """drain_replica on the replica decoding a long request moves the
    session with its KV to the other replica: the client's answer is
    whole and equals the in-process server's, and the router's
    LLM_SESSION_MIGRATED event reaches the GCS event ring."""
    from ray_tpu_torch.state import list_cluster_events

    handle, url = affinity_app
    req = {"prompt": PROMPTS[0][:10], "max_tokens": 200,
           "request_id": "live-drain", "session_id": "live"}
    box = {}
    client = threading.Thread(
        target=lambda: box.setdefault("resp", _post(url, req)), daemon=True)
    client.start()
    busy = _wait(lambda: [i for i, s in enumerate(
        _replica_stats("v1-completions-engine")) if s["running"]],
        "the session to decode")
    summary = handle.options("drain_replica").remote(
        busy[0], reason="test").result(timeout=T)
    client.join(T)
    assert not client.is_alive(), "the client never got its answer"
    tokens = box["resp"]["choices"][0]["token_ids"]
    assert tokens == _local_tokens([req])[0] and len(tokens) == 200
    assert summary["migrated"] == ["live-drain"]
    assert summary["target"] == 1 - busy[0]
    ev = _wait(lambda: list_cluster_events(
        event_type="LLM_SESSION_MIGRATED"), "the migration event")
    assert ev[0]["labels"]["from_replica"] == str(busy[0])
    assert ev[0]["labels"]["migrated"] == "1"
    assert ev[0]["source"] == "llm-router"
    stats = handle.options("router_stats").remote().result(timeout=T)
    assert stats["sessions_migrated"] == 1 and stats["routable_replicas"] == 1


def test_llm_serving_summary_reads_replica_gauges(affinity_app):
    """Each replica pushes its gauges (its engine_stats numbers) to the
    GCS KV under metrics:<node>:<pid>; the rollup over the replicas'
    snapshots sums them, and llm_serving_summary counts them."""
    from ray_tpu_torch.state import api, llm_serving_summary

    _, url = affinity_app
    _post(url, {"prompt": PROMPTS[2], "max_tokens": 4})
    pids = [s["replica"].split("-")[0]
            for s in _replica_stats("v1-completions-engine")]

    def snapshots():
        # Flushes are throttled to one a second, so a replica's pushed
        # snapshot may predate its gauges or the request's breakdown:
        # wait for both replicas' gauges and one TTFT observation.
        keys = api._gcs_call("kv_keys", prefix=b"metrics:")["keys"]
        snaps = [json.loads(api._gcs_call("kv_get", key=k)["value"])
                 for k in keys if k.decode().rsplit(":", 1)[1] in pids]
        by_name = [{m["name"]: m for m in snap} for snap in snaps]
        return len(snaps) == 2 and all(
            m["ray_tpu_llm_kv_total_blocks"]["values"] for m in by_name
        ) and any(m["ray_tpu_llm_ttft_breakdown_ms"]["histograms"]
                  for m in by_name) and snaps

    snaps = _wait(snapshots, "both replicas' metrics")
    rolled = api._aggregate_llm_metrics(snaps)
    assert rolled["kv_total_blocks"] == 2 * 128
    assert rolled["replicas_reporting"] == 2
    assert rolled["ttft_breakdown_ms"]["prefill"] >= 0
    summary = llm_serving_summary()
    assert summary["replicas_reporting"] >= 2
    assert summary["kv_total_blocks"] >= 2 * 128


def test_disaggregated_app_equals_in_process(cluster):
    """build_openai_app(disaggregate=1) deploys a PrefillServer replica
    beside the engine replica (one fake card each) and the router; each
    request prefills there, hands its KV over the wire and decodes on the
    engine replica, giving the in-process server's tokens."""
    from ray_tpu_torch.llm import build_openai_app

    for name in AFFINITY_APP:
        serve.delete(name)
    handle = build_openai_app(_config(disaggregate=1), name="disagg")
    try:
        requests = [{"prompt": p, "max_tokens": 6} for p in PROMPTS]
        got = [handle.remote(dict(r)).result(timeout=T)["choices"][0][
            "token_ids"] for r in requests]
        assert got == _local_tokens(requests)
        stats = handle.options("router_stats").remote().result(timeout=T)
        assert stats["prefill_replicas"] == 1
        (engine,) = _replica_stats("disagg-engine")
        assert engine["handoffs_adopted"] == 3
        assert engine["prefill_tokens_computed"] == 0
    finally:
        for name in ("disagg", "disagg-engine", "disagg-prefill"):
            serve.delete(name)


def test_nothing_left_after_serve_shutdown(cluster):
    """serve.shutdown deletes every deployment (the router and the engine
    tier) and kills their replicas: no replica process is left."""
    from ray_tpu_torch.llm import build_openai_app
    from ray_tpu_torch.serve import api as serve_api

    for name in AFFINITY_APP:
        serve.delete(name)
    build_openai_app(_config(routing="affinity"), name="last")
    assert {d["name"] for d in serve.status()} == {"last", "last-engine"}
    pids = [int(s["replica"].split("-")[0])
            for s in _replica_stats("last-engine")]
    serve.shutdown()
    assert serve_api._controller is None
    _wait(lambda: not any(os.path.exists(f"/proc/{p}") for p in pids),
          "the replicas to exit")
