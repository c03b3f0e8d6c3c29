"""Live session migration and the drain plane of the port against the
JAX package, on the CPU: migrate_sessions between servers of either
package, the migration-vs-completion race, a dead target, draining and
resume, and the prefix push.

The tiny fp32 configuration of tests/test_llm_router.py on the same
weights in both packages (tests/torch_handoff.py). A migrated session
resumes with zero re-prefill and the tokens of a single server (greedy:
the JAX one; seeded across the packages: the same move made in process,
since the two packages' samplers differ); no page leaks.
"""

import socket
import threading

import pytest

from ray_tpu_torch.llm import router as trouter
from ray_tpu_torch.llm import serving as tserving

from torch_handoff import (close, make_weights, parse, prompt, server,
                           spliced_tokens, wait_for)

GREEDY = {"prompt": prompt(11, 17), "max_tokens": 40}
SEEDED = {"prompt": prompt(12, 17), "max_tokens": 40, "temperature": 0.8,
          "top_k": 20, "seed": 77}


@pytest.fixture(scope="module")
def weights(cpu_jax):
    return make_weights()


@pytest.fixture(scope="module")
def jax_pair(weights):
    """Two JAX servers (a source and a target) and a single JAX server
    for reference tokens, shared by the module: the JAX server's loop
    thread never stops, so the module makes few of them."""
    made = {name: server("jax", weights) for name in ("a", "b", "single")}
    yield made
    for srv in made.values():
        close(srv)


def _servers(kind, weights, jax_pair, name):
    if kind == "jax":
        srv = jax_pair[name]
        srv.resume_admission()
        return srv
    return server("port", weights)


def _decoding(srv, rid, n):
    with srv._lock:
        return any(r.id == rid and len(r.output) >= n
                   for r in srv.engine.running)


def _consume(srv, req, box):
    try:
        box["out"] = srv.completions(dict(req))
    except Exception as e:  # the source's migrated/replay signal
        box["error"] = e


def _record_adopts(srv):
    """Wrap srv's engine.adopt_request to record each adopted state's
    output length (the tokens decoded before the move)."""
    seen = []
    inner = srv.engine.adopt_request

    def adopt(state, k, v):
        seen.append(len(state["output"]))
        return inner(state, k, v)

    srv.engine.adopt_request = adopt
    return seen


@pytest.mark.parametrize("req", [GREEDY, SEEDED], ids=["greedy", "seeded"])
@pytest.mark.parametrize("route", ["port_to_port", "port_to_jax",
                                   "jax_to_port"])
def test_migrate_sessions_between_packages(weights, jax_pair, route, req):
    """A session migrated mid-decode resumes on the target with zero
    re-prefill: the source's consumer gets SESSION_MIGRATED kv, the
    target's completions_collect the whole completion, equal to the
    reference; both pools end with every page free."""
    src_kind, dst_kind = route.split("_to_")
    src = _servers(src_kind, weights, jax_pair, "a")
    dst = _servers(dst_kind, weights, jax_pair, "b")
    rid = f"mig-{route}-{'seed' in req}"
    try:
        seen = _record_adopts(dst)
        computed0 = dst.engine_stats()["prefill_tokens_computed"]
        box = {}
        th = threading.Thread(target=_consume,
                              args=(src, dict(req, request_id=rid), box))
        th.start()
        wait_for(lambda: _decoding(src, rid, 3), what="decode on source")
        res = src.migrate_sessions(dst.handoff_address(), timeout=10)
        th.join(30)
        assert res["migrated"] == [rid] and not res["replayed"]
        assert trouter._migrated_mode(box["error"]) == "kv"
        out = dst.completions_collect(rid)["choices"][0]["token_ids"]
        assert dst.engine_stats()["prefill_tokens_computed"] == computed0
        assert len(out) == req["max_tokens"] and seen and seen[-1] >= 3
        if "seed" in req and src_kind != dst_kind:
            ref = spliced_tokens(weights, src_kind, dst_kind, req, rid=rid,
                                 at=seen[-1])
        elif "seed" in req:
            ref = server("port", weights)
            try:
                ref = ref.completions(dict(req, request_id=rid))[
                    "choices"][0]["token_ids"]
            finally:
                close(ref)
        else:
            ref = jax_pair["single"].completions(dict(req))["choices"][0][
                "token_ids"]
        assert out == ref
        assert src.engine_stats()["sessions_migrated_out"] >= 1
        for srv in (src, dst):
            wait_for(lambda: not srv.engine_stats()["running"],
                     what="idle engines")
            stats = srv.engine_stats()
            assert stats["free_kv_blocks"] == stats["total_kv_blocks"]
    finally:
        for srv, kind in ((src, src_kind), (dst, dst_kind)):
            srv.engine.__dict__.pop("adopt_request", None)
            if kind == "port":
                close(srv)


def _stopped_port_server(weights, **kw):
    """A port server whose engine loop is stopped: the test steps its
    engine itself, so the migration meets a known state."""
    srv = server("port", weights, **kw)
    srv._stop.set()
    srv._loop.join(10)
    return srv


@pytest.mark.parametrize("path", ["split_flight_finishes", "unified_moves"])
def test_migration_racing_completion_delivers_once(weights, jax_pair, path):
    """On the split path, a request whose last tokens are still in flight
    finishes while migrate_sessions harvests the flights: it is delivered
    once, on the source, and nothing moves. On the unified path a
    request mid-decode moves: its only delivery is the target's."""
    split = path.startswith("split")
    src = _stopped_port_server(weights, unified_ticks=not split)
    dst = server("port", weights)
    req = dict(GREEDY, max_tokens=6 if split else 12, request_id=f"race-{path}")
    try:
        p, params = parse("port", req)
        rid = src._submit(p, params, req["request_id"])
        q = src._streams[rid]
        eng = src.engine
        if split:
            def ready():
                r = next((r for r in eng.running if r.id == rid), None)
                return (r is not None and r.dispatched > 0
                        and len(r.output) + r.dispatched >= 6)
        else:
            def ready():
                return any(r.id == rid and len(r.output) >= 2
                           for r in eng.running)
        for _ in range(50):
            if ready():
                break
            eng.step()
        assert ready()
        res = src.migrate_sessions(dst.handoff_address(), timeout=10)
        ref = jax_pair["single"].completions(
            {k: v for k, v in req.items() if k != "request_id"})[
                "choices"][0]["token_ids"]
        items = []
        while not q.empty():
            items.append(q.get_nowait())
        finals = [o for o in items
                  if not isinstance(o, Exception) and o.finished]
        migrated = [o for o in items if isinstance(o, Exception)]
        if split:
            assert res["finished"] == [rid] and not res["migrated"]
            assert len(finals) == 1 and not migrated
            assert finals[0].output_token_ids == ref
            assert dst.engine_stats()["handoffs_adopted"] == 0
        else:
            assert res["migrated"] == [rid] and not res["finished"]
            assert not finals and len(migrated) == 1
            assert isinstance(migrated[0], tserving.SessionMigratedError)
            out = dst.completions_collect(rid)["choices"][0]["token_ids"]
            assert out == ref
        stats = src.engine_stats()
        assert stats["free_kv_blocks"] == stats["total_kv_blocks"]
    finally:
        close(src)
        close(dst)


def _dead_address():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    address = s.getsockname()
    s.close()
    return address


@pytest.mark.parametrize("req", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_dead_target_falls_back_to_replay(weights, req):
    """A target that refuses the connection: the session is reported
    replayed and send_failed, its consumer gets SESSION_MIGRATED replay,
    its pages are freed, and a re-submission under the same request id
    elsewhere gives the tokens of a run that never moved."""
    src = server("port", weights)
    other = server("port", weights)
    rid = f"dead-{'seed' in req}"
    try:
        box = {}
        th = threading.Thread(target=_consume,
                              args=(src, dict(req, request_id=rid), box))
        th.start()
        wait_for(lambda: _decoding(src, rid, 2), what="decode on source")
        res = src.migrate_sessions(_dead_address(), timeout=5)
        th.join(30)
        assert res["replayed"] == [rid] and res["send_failed"] == [rid]
        assert not res["migrated"]
        assert trouter._migrated_mode(box["error"]) == "replay"
        stats = src.engine_stats()
        assert stats["free_kv_blocks"] == stats["total_kv_blocks"]
        replay = other.completions(dict(req, request_id=rid))
        ref = server("port", weights)
        try:
            want = ref.completions(dict(req, request_id=rid))
        finally:
            close(ref)
        assert replay["choices"][0]["token_ids"] == \
            want["choices"][0]["token_ids"]
    finally:
        close(src)
        close(other)


def test_unprefilled_request_replays(weights):
    """A request not yet prefilled never moves with KV: it is replayed."""
    src = _stopped_port_server(weights)
    dst = server("port", weights)
    try:
        p, params = parse("port", GREEDY)
        rid = src._submit(p, params, "queued")
        res = src.migrate_sessions(dst.handoff_address(), timeout=10)
        assert res["replayed"] == [rid] and not res["migrated"]
        assert trouter._migrated_mode(src._streams[rid].get_nowait()) == \
            "replay"
        assert dst.engine_stats()["handoffs_adopted"] == 0
    finally:
        close(src)
        close(dst)


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_draining_refuses_then_resume_admits(weights, jax_pair, kind):
    """After migrate_sessions a server refuses new requests with
    REPLICA_DRAINING (both packages' routers classify it) and reports
    draining; resume_admission lets requests in again."""
    from ray_tpu.llm import router as jrouter

    srv = _servers(kind, weights, jax_pair, "a")
    target = _servers("port", weights, jax_pair, "b")
    try:
        srv.migrate_sessions(target.handoff_address(), timeout=5)
        assert srv.engine_stats()["draining"] is True
        with pytest.raises(RuntimeError) as err:
            srv.completions({"prompt": prompt(3), "max_tokens": 2})
        assert trouter._is_draining_error(err.value)
        assert jrouter._is_draining_error(err.value)
        if kind == "port":
            assert isinstance(err.value, tserving.ReplicaDrainingError)
        srv.resume_admission()
        assert srv.engine_stats()["draining"] is False
        out = srv.completions({"prompt": prompt(3), "max_tokens": 2})
        assert len(out["choices"][0]["token_ids"]) == 2
    finally:
        if kind == "port":
            close(srv)
        close(target)


SYSTEM = [(3 * i + 1) % 128 for i in range(33)]


@pytest.mark.parametrize("route", ["port_to_jax", "jax_to_port",
                                   "port_to_port"])
def test_push_prefixes_between_packages(weights, jax_pair, route):
    """A server's hot prefix blocks pushed to another server (either
    package): the target adopts them into its prefix cache, its next
    request on that prompt skips their prefill, and the tokens equal the
    source's."""
    src_kind, dst_kind = route.split("_to_")
    src = _servers(src_kind, weights, jax_pair, "a")
    dst = _servers(dst_kind, weights, jax_pair, "b")
    try:
        req = {"prompt": SYSTEM, "max_tokens": 3}
        first = src.completions(dict(req))["choices"][0]["token_ids"]
        res = src.push_prefixes(dst.handoff_address(), timeout=10)
        assert res["pushed"] >= 4, res
        before = dst.engine_stats()
        got = dst.completions(dict(req))["choices"][0]["token_ids"]
        after = dst.engine_stats()
        assert got == first
        assert after["prefix_tokens_saved"] - before["prefix_tokens_saved"] \
            >= 32
        assert after["prefill_tokens_computed"] \
            - before["prefill_tokens_computed"] <= len(SYSTEM) - 32
    finally:
        for srv, kind in ((src, src_kind), (dst, dst_kind)):
            if kind == "port":
                close(srv)


def test_engine_stats_carry_jax_drain_and_handoff_fields(weights, jax_pair):
    """The drain and handoff fields of engine_stats are JAX's, with the
    same values on fresh servers."""
    port = server("port", weights)
    try:
        keys = ("draining", "sessions_migrated_out", "handoffs_adopted",
                "handoffs_rejected")
        jstats = server("jax", weights)
        try:
            want = jstats.engine_stats()
            got = port.engine_stats()
        finally:
            close(jstats)
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        assert got["handoff_address"] == port.handoff_address()
        assert got["handoff_address"][0] == "127.0.0.1"
    finally:
        close(port)
