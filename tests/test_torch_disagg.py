"""Disaggregated prefill/decode of the port against the JAX package, on
the CPU: the KV stream's frames, its typed head frame, handoffs across
the two packages both ways, the prefill-only engine and the request
breakdown.

The tiny fp32 configuration of tests/test_llm_router.py on the same
weights in both packages (tests/torch_handoff.py). Bytes and tokens
must be IDENTICAL; no page may leak on either side of the wire; every
socket binds 127.0.0.1 port 0 and every receive has a deadline.
"""

import socket
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.collective import cpu_group as tcg
from ray_tpu_torch.llm import disagg as td
from ray_tpu_torch.llm import engine as te
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.runtime import wire as tw
from ray_tpu_torch.util import tracing as ttr

from torch_handoff import (N_BLOCKS, Recorder, close, counters, free_blocks,
                           make_weights, prefill_server, prompt, server,
                           spliced_tokens)

GREEDY = {"prompt": prompt(1, 21), "max_tokens": 8}
SEEDED = {"prompt": prompt(2, 21), "max_tokens": 8, "temperature": 0.8,
          "top_k": 20, "seed": 1234}


@pytest.fixture(scope="module")
def weights(cpu_jax):
    return make_weights()


@pytest.fixture(scope="module")
def servers(weights):
    """One decode server and one prefill server of each package, and a
    single JAX server whose tokens are the reference."""
    made = {("decode", pkg): server(pkg, weights)
            for pkg in ("jax", "port")}
    made.update({("prefill", pkg): prefill_server(pkg, weights)
                 for pkg in ("jax", "port")})
    made["single"] = server("jax", weights)
    made["single_port"] = server("port", weights)
    yield made
    for srv in made.values():
        close(srv)


def _reference(servers, weights, src, dst, req):
    """A single JAX server's tokens; for a seeded request handed across
    the packages, the in-process handoff of the same request
    (torch_handoff.spliced_tokens), whose first token is the prefill
    package's single server's."""
    single = servers["single"].completions(dict(req))["choices"][0][
        "token_ids"]
    if "seed" not in req or src == dst == "jax":
        return single
    ref = spliced_tokens(weights, src, dst, req)
    if src == "jax":
        assert ref[0] == single[0]
    return ref


# ---- the typed head frame ---------------------------------------------------

MESSAGES = {
    "full": dict(state_json=b'{"id": "r1", "prompt": [1, 2]}',
                 kv_dtype="bfloat16", kv_shape=[2, 2, 3, 8, 16],
                 migrated=True, trace_id=bytes(range(16)),
                 parent_span_id=bytes(range(8))),
    "untraced": dict(state_json=b"{}", kv_dtype="float32",
                     kv_shape=[2, 2, 1, 8, 16], migrated=False,
                     trace_id=b"", parent_span_id=b""),
    "defaults": {},
    "empty_shape": dict(state_json=b'{"prefix": true}', kv_dtype="float16",
                        kv_shape=[]),
}


@pytest.mark.parametrize("case", sorted(MESSAGES))
def test_handoff_msg_encodings_equal_both_ways(cpu_jax, case):
    from ray_tpu.runtime import wire as jw

    fields = MESSAGES[case]
    port = tw.KVHandoffMsg(**fields).encode()
    ref = jw.KVHandoffMsg(**fields).encode()
    assert port == ref
    got_j = jw.KVHandoffMsg.decode(port)
    got_t = tw.KVHandoffMsg.decode(ref)
    for name in tw.KVHandoffMsg._fields:
        assert getattr(got_t, name) == getattr(got_j, name), name
    assert tw.KVHandoffMsg(**fields) == got_t


@pytest.mark.parametrize("case", ["unknown_field", "wire_type_mismatch",
                                  "malformed_payload"])
def test_head_frame_decoder_keeps_jax_evolution_rules(cpu_jax, case):
    """A newer writer's unknown field is skipped, a field sent under
    another wire type or with an unparsable payload keeps its default:
    the port's decoder gives what JAX's gives."""
    from ray_tpu.runtime import wire as jw

    body = jw.KVHandoffMsg(state_json=b"{}", kv_dtype="float32",
                           kv_shape=[1, 2], migrated=True).encode()
    if case == "unknown_field":
        body += jw._encode_field(99, jw.INT, 5)
    elif case == "wire_type_mismatch":
        body += jw._encode_field(2, jw.LIST(jw.INT), [3])
    else:
        body += jw._encode_field(3, jw.LIST(jw.INT), [1]).replace(
            b"\x08\x00\x00\x00", b"\x03\x00\x00\x00", 1)[:-5] + b"\x00" * 3
    got_j = jw.KVHandoffMsg.decode(body)
    got_t = tw.KVHandoffMsg.decode(body)
    for name in tw.KVHandoffMsg._fields:
        assert getattr(got_t, name) == getattr(got_j, name), name


# ---- frames on the wire ------------------------------------------------------

def _exported_state(weights):
    """A real port export of a prefilled request (state and pages)."""
    runner_engine = te.LLMEngine(
        __import__("ray_tpu_torch.llm.model_runner",
                   fromlist=["ModelRunner"]).ModelRunner(
            weights[1], weights[2], num_blocks=N_BLOCKS, block_size=8,
            chunk_size=8, device="cpu"),
        max_batch_size=4, prefill_chunk=8, prefill_only=True)
    rid = runner_engine.add_request(prompt(3, 21),
                                    SamplingParams(max_tokens=4),
                                    request_id="wire-r")
    while not runner_engine.running:
        runner_engine.step()
    state = runner_engine.export_request(rid)
    k, v = runner_engine.runner.gather_pages(state.pop("blocks"))
    return state, k, v


TRACES = {"request": lambda rid: (ttr.request_trace_id(rid), None),
          "explicit": lambda rid: (b"\x01" * 16, b"\x02" * 8),
          "none": lambda rid: (None, None)}


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_send_handoff_writes_jax_bytes(weights, dtype, trace):
    """For one state dict, one pair of pages and one trace context, the
    port's send_handoff and JAX's put the same bytes on the socket (bf16:
    the port's uint16 bits labelled "bfloat16" against ml_dtypes bf16),
    and both read back as the same frames. Both packages' spans run with
    tracing off: on, each handoff span mints a random span id, which the
    frame carries."""
    import ml_dtypes

    from ray_tpu.llm import disagg as jd
    from ray_tpu.util import tracing as jtr

    state, k, v = _exported_state(weights)
    if dtype == "bfloat16":
        rng = np.random.default_rng(7)
        k = rng.integers(0, 1 << 16, size=k.shape, dtype=np.uint16)
        v = rng.integers(0, 1 << 16, size=v.shape, dtype=np.uint16)
    ctx = TRACES[trace](state["id"])
    recorded = {}
    was = (jtr.enabled(), ttr.enabled())
    jtr.set_enabled(False)
    ttr.set_enabled(False)
    try:
        for pkg in ("port", "jax"):
            rec = Recorder()
            if pkg == "port":
                with ttr.trace_context(*ctx):
                    ack = td.send_handoff(
                        rec.address, state, k, v, timeout=10,
                        kv_dtype="bfloat16" if dtype == "bfloat16" else None)
            else:
                jk, jv = ((k.view(ml_dtypes.bfloat16),
                           v.view(ml_dtypes.bfloat16))
                          if dtype == "bfloat16" else (k, v))
                with jtr.trace_context(*ctx):
                    ack = jd.send_handoff(rec.address, state, jk, jv,
                                          timeout=10)
            assert ack["ok"]
            recorded[pkg] = (rec.join(), rec.frames)
    finally:
        jtr.set_enabled(was[0])
        ttr.set_enabled(was[1])
    assert recorded["port"][0] == recorded["jax"][0]
    (_, meta), (_, kflat), (_, vflat) = recorded["port"][1]
    assert meta["kv_dtype"] == dtype
    assert meta["kv_shape"] == list(k.shape)
    assert kflat.tobytes() == np.ascontiguousarray(k).tobytes()
    assert vflat.tobytes() == np.ascontiguousarray(v).tobytes()
    want = ctx[0] is not None
    assert ("_trace" in meta) == want
    if want:
        assert meta["_trace"] == (ctx[0], ctx[1])


# ---- handoffs across the packages -------------------------------------------

@pytest.mark.parametrize("req", [GREEDY, SEEDED], ids=["greedy", "seeded"])
@pytest.mark.parametrize("route", ["jax_to_port", "port_to_jax",
                                   "port_to_port"])
def test_handoff_tokens_equal_reference(servers, weights, route, req):
    """A prefill server of one package hands off to a decode server of
    the other: greedy tokens equal a single JAX server's, seeded ones
    the in-process handoff's (port to port: a single port server's too),
    nothing is pickled on either side (the raw frames count), and no page
    leaks on either side of the wire."""
    src, dst = route.split("_to_")
    prefill = servers[("prefill", src)]
    decode = servers[("decode", dst)]
    adopted0 = decode.engine_stats()["handoffs_adopted"]
    snaps = {pkg: dict(counters(pkg)) for pkg in ("jax", "port")}
    res = prefill.prefill(dict(req), decode.handoff_address())
    assert res["handoff"] and res["ack"]["ok"]
    out = decode.completions_collect(res["rid"])
    deltas = {pkg: {k: counters(pkg)[k] - snaps[pkg].get(k, 0)
                    for k in ("pickle", "deserialize_pickle",
                              "fast_ndarray", "deserialize_fast")}
              for pkg in ("jax", "port")}
    assert out["choices"][0]["token_ids"] == _reference(
        servers, weights, src, dst, req)
    if route == "port_to_port" and "seed" in req:
        assert out["choices"][0]["token_ids"] == servers[
            "single_port"].completions(dict(req))["choices"][0]["token_ids"]
    for pkg in {src, dst}:
        assert deltas[pkg]["pickle"] == 0, (pkg, deltas)
        assert deltas[pkg]["deserialize_pickle"] == 0, (pkg, deltas)
    assert deltas[src]["fast_ndarray"] >= 2
    assert deltas[dst]["deserialize_fast"] >= 2
    assert prefill.engine.block_manager._available() == N_BLOCKS \
        if src == "jax" else prefill.engine.block_manager.available() \
        == N_BLOCKS
    free, total = free_blocks(decode)
    assert free == total
    assert decode.engine_stats()["handoffs_adopted"] == adopted0 + 1


@pytest.mark.parametrize("head", ["json", "msg"])
def test_partial_handoff_stream_discarded(head):
    """A sender dying mid-stream leaves nothing adopted, whichever head
    frame it sent."""
    adopted = []
    srv = td.KVStreamServer(lambda *a: adopted.append(a) or True,
                            timeout=5.0)
    try:
        with socket.create_connection(srv.address, timeout=5) as sock:
            if head == "json":
                td._send_json(sock, {"id": "x", "kv_dtype": "float32",
                                     "kv_shape": [4, 4]})
            else:
                td._send_msg(sock, tw.KVHandoffMsg(
                    state_json=b'{"id": "x"}', kv_dtype="float32",
                    kv_shape=[4, 4]))
            # An array frame promising 16 elements... then gone.
            sock.sendall(tcg._HDR.pack(tcg._AMETA.size + 8, tcg._K_ARRAY))
            sock.sendall(tcg._AMETA.pack(b"<f4", 1, 16, 1, 1, 1, 1, 1, 1, 1,
                                         0, 2))
            sock.sendall(b"\x00" * 8)
        deadline = time.monotonic() + 5
        while srv.handoffs_rejected == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.handoffs_rejected == 1
        assert srv.handoffs_adopted == 0 and not adopted
    finally:
        srv.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_failed_handoff_raises(servers, weights, pkg):
    """A handoff the receiver refuses is an error, never a quiet replay:
    a decode pool too small for the request rejects it (HandoffError), a
    closed listener refuses the connection (OSError); the prefill server
    keeps no page either way."""
    small = server("port", weights, num_kv_blocks=2)
    prefill = servers[("prefill", pkg)]
    try:
        with pytest.raises(Exception, match="HandoffError|rejected"):
            prefill.prefill(dict(GREEDY), small.handoff_address())
        assert small.engine_stats()["handoffs_rejected"] == 1
    finally:
        close(small)
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    address = dead.getsockname()
    dead.close()
    with pytest.raises(OSError):
        prefill.prefill(dict(GREEDY), address)
    bm = prefill.engine.block_manager
    avail = bm._available() if pkg == "jax" else bm.available()
    assert avail == N_BLOCKS


@pytest.mark.parametrize("req", [dict(GREEDY, max_tokens=1),
                                 dict(SEEDED, max_tokens=1)],
                         ids=["greedy", "seeded"])
def test_max_tokens_one_finishes_at_prefill(servers, req):
    """max_tokens=1 finishes at prefill: the response comes back inline,
    nothing is handed off, and it equals the JAX prefill server's (a
    seeded one: a single port server's, the samplers differ)."""
    decode = servers[("decode", "port")]
    adopted0 = decode.engine_stats()["handoffs_adopted"]
    got = servers[("prefill", "port")].prefill(dict(req),
                                               decode.handoff_address())
    ref = servers[("prefill", "jax")].prefill(dict(req),
                                              decode.handoff_address())
    assert not got["handoff"] and not ref["handoff"]
    if "seed" in req:
        ref = {"response": servers["single_port"].completions(dict(req))}
    assert got["response"]["choices"][0] == ref["response"]["choices"][0]
    assert got["response"]["usage"] == ref["response"]["usage"]
    assert decode.engine_stats()["handoffs_adopted"] == adopted0


@pytest.mark.parametrize("warmup", ["off", "light", "full"])
def test_prefill_only_engine_takes_no_decode_tick(weights, warmup):
    """A prefill-only engine runs prefill chunks only, tick for tick as
    the JAX one (kinds, batch rows, chunk buckets), never a decode or a
    unified tick, and its warm-up warms no unified token bucket."""
    from ray_tpu.llm.serving import build_engine as jax_build

    from ray_tpu_torch.llm.serving import build_engine
    from torch_handoff import jax_config, port_config

    engines = {
        "jax": jax_build(jax_config(weights, warmup_buckets=warmup),
                         prefill_only=True),
        "port": build_engine(port_config(weights, warmup_buckets=warmup),
                             weights[2], prefill_only=True)}
    assert not engines["port"]._warm_mixed
    assert not engines["jax"]._warm_mixed
    prompts = [prompt(s, n) for s, n in ((4, 21), (5, 9), (6, 30))]
    for name, eng in engines.items():
        jp = name == "jax"
        if jp:
            from ray_tpu.llm.sampling import SamplingParams as P
        else:
            P = SamplingParams
        for i, p in enumerate(prompts):
            eng.add_request(p, P(max_tokens=8), request_id=f"p{i}")
        for _ in range(12):
            eng.step()
    keys = ("kind", "prefill_rows", "chunk_bucket", "prefill_tokens")
    recs = {n: [{k: r.get(k) for k in keys} for r in e.tick_records()]
            for n, e in engines.items()}
    assert recs["port"] == recs["jax"]
    assert {r["kind"] for r in recs["port"]} == {"prefill"}
    port = engines["port"]
    assert port.ticks == 0 and not port._flights
    assert [len(r.output) for r in port.running] == [1, 1, 1]
    assert [r.output for r in port.running] == \
        [r.output for r in engines["jax"].running]


TIMINGS = {
    "colocated": dict(t_submit=10.0, t_admit=10.5, t_first_token=11.25,
                      t_last_token=13.0, handoff_s=0.0, pause_s=0.0),
    "handoff": dict(t_submit=10.0, t_admit=10.0, t_first_token=10.75,
                    t_last_token=12.5, handoff_s=0.125, pause_s=0.0),
    "migrated": dict(t_submit=1.0, t_admit=None, t_first_token=2.0,
                     t_last_token=9.0, handoff_s=0.25, pause_s=1.5),
    "first_token_only": dict(t_submit=3.0, t_admit=3.5, t_first_token=4.0,
                             t_last_token=None, handoff_s=0.0,
                             pause_s=0.0),
    "not_started": dict(t_submit=3.0, t_admit=None, t_first_token=None,
                        t_last_token=None, handoff_s=0.0, pause_s=0.0),
    "overlapping_stall": dict(t_submit=0.0, t_admit=0.25,
                              t_first_token=0.5, t_last_token=1.0,
                              handoff_s=0.5, pause_s=0.5),
}


@pytest.mark.parametrize("case", sorted(TIMINGS))
def test_request_breakdown_equals_jax(weights, case):
    """request_breakdown gives JAX's numbers for the same timestamps."""
    from ray_tpu.llm import engine as je
    from ray_tpu.llm.sampling import SamplingParams as JaxParams

    port_req = te._Request("b", [1, 2, 3], SamplingParams())
    jax_req = je._Request("b", [1, 2, 3], JaxParams())
    port_req.timing = dict(TIMINGS[case])
    jax_req.timing = dict(TIMINGS[case])
    got = te.LLMEngine.request_breakdown(None, port_req)
    ref = je.LLMEngine.request_breakdown(None, jax_req)
    assert got == ref


def test_decode_server_records_handoff_breakdown(servers):
    """The decode server books the handoff's gap as handoff_s in the
    finished request's breakdown."""
    decode = servers[("decode", "port")]
    res = servers[("prefill", "jax")].prefill(
        dict(GREEDY, request_id="bd-1"), decode.handoff_address())
    decode.completions_collect(res["rid"])
    bd = decode.engine.breakdowns["bd-1"]
    assert bd["handoff_s"] > 0 and bd["stall_s"] == 0.0
    assert set(bd) == {"queue_s", "prefill_s", "handoff_s", "decode_s",
                       "stall_s"}


@pytest.mark.parametrize("route", ["port_to_jax", "jax_to_port"])
def test_bf16_pages_adopted_across_packages(cpu_jax, route):
    """bf16 pages cross the wire labelled "bfloat16" in both directions:
    the port sends its uint16 bits under that name and the JAX receiver
    scatters them as bf16; the port receives JAX's bf16 pages as uint16
    bits. The adopting engine's pages equal the sender's bit for bit."""
    from ray_tpu.llm import disagg as jd

    from torch_handoff import engine, parse

    weights = make_weights("bfloat16")
    src, dst = route.split("_to_")
    pre = engine(src, weights, prefill_only=True)
    dec = engine(dst, weights)
    p, params = parse(src, dict(GREEDY))
    pre.add_request(p, params, request_id="bf16")
    while not pre.running:
        pre.step()
    state = pre.export_request("bf16")
    k, v = pre.runner.gather_pages(state.pop("blocks"))
    got = {}

    def adopt(meta, kp, vp):
        got["dtype"] = (str(kp.dtype), meta.get("migrated", False))
        return dec.adopt_request(meta, kp, vp)

    listener = (td.KVStreamServer if dst == "port"
                else jd.KVStreamServer)(adopt, timeout=10.0)
    try:
        if src == "port":
            ack = td.send_handoff(listener.address, state, k, v,
                                  kv_dtype=pre.runner.kv_dtype_name,
                                  timeout=10)
        else:
            ack = jd.send_handoff(listener.address, state, k, v, timeout=10)
    finally:
        listener.close()
    assert ack["ok"]
    assert got["dtype"][0] == ("uint16" if dst == "port" else "bfloat16")
    req = dec.running[0]
    n = k.shape[2]
    k2, v2 = dec.runner.gather_pages(req.blocks[:n])
    bits = lambda a: np.asarray(a).view(np.uint16)  # noqa: E731
    assert np.array_equal(bits(k2), bits(k))
    assert np.array_equal(bits(v2), bits(v))


def test_listener_counts_concurrent_handoffs():
    """Handoffs arriving at once, each on its own connection thread, are
    all counted (the counts take a lock), with the interpreter switching
    threads as often as it can."""
    import sys
    import threading

    n = 24
    srv = td.KVStreamServer(lambda meta, k, v: meta["id"] % 3 != 0,
                            timeout=10.0)
    pages = np.zeros((2, 2, 1, 8, 16), np.float32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    results = []
    try:
        def send(i):
            try:
                td.send_handoff(srv.address, {"id": i}, pages, pages,
                                timeout=10)
                results.append(True)
            except td.HandoffError:
                results.append(False)

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        srv.close()
    assert len(results) == n
    assert srv.handoffs_adopted == results.count(True) == n - n // 3
    assert srv.handoffs_rejected == results.count(False) == n // 3
