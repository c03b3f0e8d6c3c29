"""The port's FleetSupervisor against the JAX package's, on the CPU.

Each package's supervisor drives in-process servers of its own package
(LocalReplica over LLMServer / PrefillServer) on one set of tiny fp32
weights: the same seeded request scripts must give the same routing
decisions (which replica took each call), counters, event types and
greedy tokens. The scripts: prefix affinity against pow2 picks, SLO
shedding, failover replay under RpcChaos, a drain that migrates a live
session, node events that drain and eject, scale_tick under a
ReplicaPolicy, and the disaggregated path through a PrefillServer.

The servers are module-scoped (the JAX servers' loops never stop), and
every test starts from idle, admitting servers.
"""

import random
import threading
import time
from types import SimpleNamespace

import pytest

from ray_tpu_torch.llm import replica_policy as tpolicy
from ray_tpu_torch.llm import router as trouter
from ray_tpu_torch.runtime import chaos as tchaos
from ray_tpu_torch.runtime import events as tevents
from ray_tpu_torch.runtime import metric_defs as tmd

from torch_handoff import close, make_weights, prefill_server, prompt, server

PKGS = ("jax", "port")


def _mods(pkg):
    if pkg == "jax":
        from ray_tpu.llm import replica_policy, router
        from ray_tpu.runtime import chaos, events, metric_defs

        return SimpleNamespace(router=router, policy=replica_policy,
                               chaos=chaos, events=events, md=metric_defs)
    return SimpleNamespace(router=trouter, policy=tpolicy, chaos=tchaos,
                           events=tevents, md=tmd)


@pytest.fixture(scope="module")
def fleet(cpu_jax):
    weights = make_weights(max_seq=128)
    out = {pkg: {"servers": [server(pkg, weights) for _ in range(3)],
                 "prefill": [prefill_server(pkg, weights) for _ in range(2)]}
           for pkg in PKGS}
    yield out
    for pkg in PKGS:
        for s in out[pkg]["servers"] + out[pkg]["prefill"]:
            close(s)


def _busy(s):
    st = s.engine_stats()
    return st["running"] + st["waiting"] + st["prefilling"]


@pytest.fixture(autouse=True)
def idle(fleet):
    """Every server admitting and idle before and after each test."""
    def settle():
        for pkg in PKGS:
            for s in fleet[pkg]["servers"]:
                s.resume_admission()
                deadline = time.monotonic() + 30
                while _busy(s):
                    assert time.monotonic() < deadline, "server never idled"
                    time.sleep(0.01)

    settle()
    yield
    for pkg in PKGS:
        _mods(pkg).chaos.reset()
    settle()


@pytest.fixture
def captured(monkeypatch):
    """Every events.emit of either package, recorded per package."""
    recs = {pkg: [] for pkg in PKGS}
    for pkg in PKGS:
        ev = _mods(pkg).events

        def emit(event_type, message, _real=ev.make_event, _out=recs[pkg],
                 **kw):
            rec = _real(event_type, message, **kw)
            _out.append(rec)
            return rec

        monkeypatch.setattr(ev, "emit", emit)
    return recs


LOGGED = ("completions", "completions_collect", "prefill", "migrate_sessions",
          "abort")


def _replicas(pkg, objs, names, log):
    """LocalReplicas of `pkg` that log (name, method) of each call that
    carries work."""
    base = _mods(pkg).router.LocalReplica

    class Logged(base):
        def call(self, method, *args, **kwargs):
            if method in LOGGED:
                log.append((self.name, method))
            return super().call(method, *args, **kwargs)

    return [Logged(o, n) for o, n in zip(objs, names)]


def _count(metric, tags=None):
    """A metric's current value for one tag set (0 when never bumped)."""
    import json

    key = json.dumps(sorted(tags.items())) if tags else "[]"
    return metric.snapshot()["values"].get(key, 0.0)


def _tokens(resp):
    return resp["choices"][0]["token_ids"] if "choices" in resp else resp


def _events(recs):
    return [(e["type"], e["severity"], e["source"], sorted(e["labels"]))
            for e in recs]


def _both(run, *args):
    """run(pkg, *args) for each package; the two records."""
    return {pkg: run(pkg, *args) for pkg in PKGS}


# ---- affinity against pow2 ---------------------------------------------------

def _affinity(pkg, fleet):
    m = _mods(pkg)
    servers = fleet[pkg]["servers"][:2]
    log = []
    core = m.router.RouterCore(2, block_size=8)
    sup = m.router.FleetSupervisor(
        core, _replicas(pkg, servers, ["r0", "r1"], log),
        deployment="fleet-affinity")
    saved0 = sum(s.engine_stats()["prefix_tokens_saved"] for s in servers)
    hits0 = _count(m.md.LLM_ROUTER_AFFINITY, {"outcome": "hit"})
    out = {"tokens": []}
    # pow2: prompts with no common block, so no pick has an owner.
    for i in range(6):
        random.seed(i)
        out["tokens"].append(_tokens(sup.completions(
            {"prompt": prompt(40 + i, 25), "max_tokens": 3,
             "request_id": f"pow2-{i}"})))
    out["pow2_leg"] = (core.affinity_hits, core.affinity_misses)
    # affinity: three prompts of three full blocks, four times each.
    for i in range(12):
        random.seed(100 + i)
        out["tokens"].append(_tokens(sup.completions(
            {"prompt": prompt(31 + i % 3, 25), "max_tokens": 3,
             "request_id": f"aff-{i}"})))
    out["log"] = log
    out["summary"] = sup.stats_summary()
    out["saved"] = sum(s.engine_stats()["prefix_tokens_saved"]
                       for s in servers) - saved0
    out["hit_metric"] = _count(m.md.LLM_ROUTER_AFFINITY,
                               {"outcome": "hit"}) - hits0
    return out


def test_affinity_against_pow2_decides_as_jax(fleet):
    """Over one seeded script, the port's supervisor sends every call to
    the replica JAX's sends it to; prompts without a common block are
    pow2 misses, repeated prompts are affinity hits that land on the
    replica holding their blocks and skip their prefill."""
    got = _both(_affinity, fleet)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["pow2_leg"] == (0, 6)
    assert port["summary"]["affinity_hits"] == 9
    assert port["hit_metric"] == 9.0
    assert port["saved"] >= 9 * 24


# ---- SLO shed ----------------------------------------------------------------

def _shed(pkg, fleet, captured):
    m = _mods(pkg)
    log = []
    core = m.router.RouterCore(2, block_size=8, slo_ttft_s=0.3,
                               prefill_tps=100.0)
    sup = m.router.FleetSupervisor(
        core, _replicas(pkg, fleet[pkg]["servers"][:2], ["r0", "r1"], log),
        deployment="fleet-shed")
    shed0 = _count(m.md.LLM_ROUTER_SHED, {"deployment": "fleet-shed"})
    out = []
    for i, n in enumerate((21, 40, 25, 33)):
        random.seed(i)
        out.append(_tokens(sup.completions(
            {"prompt": prompt(50 + i, n), "max_tokens": 2,
             "request_id": f"shed-{i}"})))
    return {"out": out, "log": log, "shed": core.shed_count,
            "events": _events(captured[pkg]),
            "labels": [e["labels"] for e in captured[pkg]],
            "metric": _count(m.md.LLM_ROUTER_SHED,
                             {"deployment": "fleet-shed"}) - shed0}


def test_slo_shed_as_jax(fleet, captured):
    """A projected TTFT over the SLO sheds with JAX's 429 body, event and
    counters, before any replica sees the request."""
    got = _both(_shed, fleet, captured)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["shed"] == 2 and port["metric"] == 2.0
    assert [o["error"]["code"] for o in port["out"]
            if isinstance(o, dict)] == [429, 429]
    assert {e[0] for e in port["events"]} == {"LLM_REQUEST_SHED"}
    assert len(port["log"]) == 2


# ---- failover replay under RpcChaos -----------------------------------------

def _failover(pkg, fleet, captured, sampling):
    m = _mods(pkg)
    victim, survivor, ref_server = fleet[pkg]["servers"]
    req = {"prompt": prompt(4, 21), "max_tokens": 12,
           "request_id": f"failover-{sampling}", "session_id": "fo"}
    if sampling == "temperature":
        req.update(temperature=0.8, top_k=20)
    ref = _tokens(ref_server.completions(dict(req)))
    log = []
    core = m.router.RouterCore(2, fail_threshold=1)
    sup = m.router.FleetSupervisor(
        core, _replicas(pkg, [victim, survivor], ["victim", "survivor"],
                        log), deployment="fleet-failover")
    core._session_owner["fo"] = 0          # the first pick is the victim
    fo0 = _count(m.md.LLM_FAILOVERS, {"deployment": "fleet-failover"})
    try:
        m.chaos.chaos().add_rule("victim.completions", "fail", 1.0,
                                 max_hits=1)
        resp = sup.completions(dict(req))
    finally:
        m.chaos.reset()
    return {"tokens": _tokens(resp), "ref": ref, "log": log,
            "summary": sup.stats_summary(),
            "healthy": [core.is_healthy(i) for i in range(2)],
            "events": _events(captured[pkg]),
            "metric": _count(m.md.LLM_FAILOVERS,
                             {"deployment": "fleet-failover"}) - fo0}


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_failover_replay_under_chaos_as_jax(fleet, captured, sampling):
    """The first replica's call dies in transport (RpcChaos): the victim
    is ejected, the request replays on the survivor under its request id,
    and the client gets the tokens of an undisturbed run. The decisions,
    counters and events are JAX's; greedy tokens equal JAX's (the two
    samplers differ, so a seeded run is held to its own package's
    undisturbed run)."""
    got = _both(_failover, fleet, captured, sampling)
    for pkg in PKGS:
        assert got[pkg]["tokens"] == got[pkg]["ref"], pkg
        got[pkg].pop("ref")
        if sampling == "temperature":
            got[pkg].pop("tokens")
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["log"] == [("victim", "completions"), ("victim", "abort"),
                           ("survivor", "completions")]
    assert port["summary"]["failovers"] == 1 and port["metric"] == 1.0
    assert port["healthy"] == [False, True]
    assert [e[0] for e in port["events"]] == ["LLM_REPLICA_EJECTED",
                                              "LLM_REQUEST_FAILOVER"]


# ---- drain with session migration -------------------------------------------

def _drain(pkg, fleet, captured):
    m = _mods(pkg)
    a, b, ref_server = fleet[pkg]["servers"]
    req = {"prompt": prompt(10, 33), "max_tokens": 48,
           "request_id": "drain-e2e", "session_id": "de"}
    ref = _tokens(ref_server.completions(dict(req)))
    log = []
    core = m.router.RouterCore(2, fail_threshold=1)
    sup = m.router.FleetSupervisor(
        core, _replicas(pkg, [a, b], ["a", "b"], log),
        deployment="fleet-drain")
    core._session_owner["de"] = 0
    box = {}
    t = threading.Thread(
        target=lambda: box.setdefault("resp", sup.completions(dict(req))),
        daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while not a.engine_stats()["running"]:
        assert time.monotonic() < deadline, "the session never ran"
        time.sleep(0.002)
    b_prefill = b.engine_stats()["prefill_tokens_computed"]
    summary = sup.drain_replica(0, reason="test-drain")
    t.join(30)
    assert not t.is_alive(), "the client never got its answer"
    return {"tokens": _tokens(box["resp"]), "ref": ref,
            "summary": {k: summary[k] for k in ("migrated", "replayed",
                                                "send_failed", "target")},
            "b_reprefill": b.engine_stats()["prefill_tokens_computed"]
            - b_prefill,
            "owner": core._session_owner["de"],
            "counts": (sup.migrated_sessions, sup.failovers),
            "routable": [core.is_routable(i) for i in range(2)],
            "healthy": [core.is_healthy(i) for i in range(2)],
            "log": [x for x in log if x[1] != "abort"],
            "events": _events(captured[pkg])}


def test_drain_migrates_live_session_as_jax(fleet, captured):
    """drain_replica mid-decode moves the live session with its KV to the
    other replica: the client's call returns the undisturbed tokens, the
    target prefills nothing, affinity follows the session, and the
    counters and LLM_SESSION_MIGRATED event are JAX's."""
    got = _both(_drain, fleet, captured)
    for pkg in PKGS:
        assert got[pkg]["tokens"] == got[pkg]["ref"], pkg
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["summary"] == {"migrated": ["drain-e2e"], "replayed": [],
                               "send_failed": [], "target": 1}
    assert port["b_reprefill"] == 0 and port["owner"] == 1
    assert port["counts"] == (1, 0)
    assert port["routable"] == [False, True] and port["healthy"] == [True,
                                                                      True]
    assert [e[0] for e in port["events"]] == ["LLM_SESSION_MIGRATED"]


# ---- node events drive drain and eject --------------------------------------

def _node_events(pkg, fleet):
    m = _mods(pkg)
    ev = m.events
    servers = fleet[pkg]["servers"]
    node_of = {id(s): c * 32 for s, c in zip(servers, "abc")}

    class NodeBound:
        def __init__(self, srv):
            self._server = srv

        def __getattr__(self, name):
            return getattr(self._server, name)

        def engine_stats(self):
            s = self._server.engine_stats()
            s["node_id"] = node_of[id(self._server)]
            return s

    core = m.router.RouterCore(3, fail_threshold=1)
    sup = m.router.FleetSupervisor(
        core, [m.router.LocalReplica(NodeBound(s), n)
               for s, n in zip(servers, "abc")], deployment="fleet-nodes")
    sup.fresh_stats(force=True)              # learn the node map
    state = lambda: [(core.is_healthy(i), core.is_routable(i))  # noqa: E731
                     for i in range(3)]
    out = [sup.check_events(list_events_fn=lambda limit: [])]
    # Events older than the supervisor are never replayed.
    old = [{"type": ev.NODE_DEAD, "node_id": "c" * 32, "time": 1.0}]
    out += [sup.check_events(list_events_fn=lambda limit: old), state()]
    now = time.time()
    feed = [{"type": ev.NODE_DRAINING, "node_id": "a" * 32,
             "time": now + 1.0},
            {"type": ev.NODE_DEAD, "node_id": "b" * 32, "time": now + 2.0},
            {"type": ev.NODE_PREEMPTED, "node_id": "z" * 32,
             "time": now + 3.0}]
    out += [sup.check_events(list_events_fn=lambda limit: feed), state()]
    # The since-cursor advanced: the same events never fire again.
    out += [sup.check_events(list_events_fn=lambda limit: feed),
            sup.replicas_on_node("c" * 32), sup.stats_summary()]
    return out


def test_node_events_drive_drain_and_eject_as_jax(fleet):
    """NODE_DRAINING drains the replicas whose engine_stats report that
    node, NODE_DEAD ejects them; events older than the supervisor and
    events already seen do nothing; as JAX's supervisor does."""
    got = _both(_node_events, fleet)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port[:3] == [0, 0, [(True, True)] * 3]
    assert port[3:5] == [3, [(True, False), (False, False), (True, True)]]
    assert port[5:7] == [0, [2]]


# ---- scale_tick with a ReplicaPolicy ----------------------------------------

def _scale(pkg, fleet, captured):
    m = _mods(pkg)
    servers = fleet[pkg]["servers"]
    hot = {"on": True}

    class Pressured:
        """A server whose KV pool reads full while `hot` is on."""

        def __init__(self, srv):
            self._server = srv

        def __getattr__(self, name):
            return getattr(self._server, name)

        def engine_stats(self):
            s = self._server.engine_stats()
            if hot["on"]:
                s["free_kv_blocks"] = 0
            return s

    log, retired, grown = [], [], []
    reps = _replicas(pkg, [Pressured(s) for s in servers],
                     ["r0", "r1", "r2"], log)
    policy = m.policy.ReplicaPolicy(m.policy.ReplicaPolicyConfig(
        min_replicas=1, max_replicas=3, cooldown_s=0.0,
        scale_down_quiet_s=5.0))
    core = m.router.RouterCore(2, fail_threshold=1)
    sup = None

    def scale_up(delta):
        grown.append(delta)
        for _ in range(delta):
            sup.add_replica(reps[sup.core.n])

    sup = m.router.FleetSupervisor(
        core, reps[:2], deployment="fleet-scale", policy=policy,
        scale_up_fn=scale_up, retire_fn=retired.append)
    actions = []
    for t, is_hot in ((0.0, True), (1.0, True), (2.0, False), (4.0, False),
                      (8.0, False), (9.0, False), (14.0, False),
                      (20.0, False)):
        hot["on"] = is_hot
        sup.fresh_stats(force=True)
        a = sup.scale_tick(now=t)
        if a and "drain" in a:
            a = dict(a, drain={k: a["drain"][k] for k in ("migrated",
                                                          "replayed",
                                                          "target")})
        actions.append(a)
    return {"actions": actions, "grown": grown, "retired": retired,
            "healthy": [core.is_healthy(i) for i in range(core.n)],
            "log": [x for x in log if x[1] == "migrate_sessions"],
            "events": _events(captured[pkg]),
            "labels": [e["labels"] for e in captured[pkg]]}


def test_scale_tick_with_replica_policy_as_jax(fleet, captured):
    """Under a ReplicaPolicy the supervisor scales up while the KV pools
    read full (through the scale-up callback, a fresh slot), and after a
    quiet stretch scales down by draining the least-loaded replica and
    retiring it: JAX's actions, events and retirements, tick for tick."""
    got = _both(_scale, fleet, captured)
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["grown"] == [1]
    assert port["actions"][0] == {"direction": "up", "from": 2, "to": 3}
    downs = [a for a in port["actions"] if a and a["direction"] == "down"]
    assert len(downs) == 2 and port["retired"] == [0, 1]
    assert port["healthy"] == [False, False, True]
    # A retirement drains first (its LLM_SESSION_MIGRATED event), and is
    # no ejection.
    assert [e[0] for e in port["events"]] == [
        "LLM_REPLICAS_SCALED", "LLM_SESSION_MIGRATED", "LLM_REPLICAS_SCALED",
        "LLM_SESSION_MIGRATED", "LLM_REPLICAS_SCALED"]


# ---- the disaggregated path -------------------------------------------------

def _disagg(pkg, fleet):
    m = _mods(pkg)
    decode = fleet[pkg]["servers"][0]
    ref = _tokens(fleet[pkg]["servers"][1].completions(
        {"prompt": prompt(6, 21), "max_tokens": 8, "request_id": "dis-ref"}))
    log = []
    core = m.router.RouterCore(1, block_size=8)
    sup = m.router.FleetSupervisor(
        core, _replicas(pkg, [decode], ["decode"], log),
        prefill_replicas=_replicas(pkg, fleet[pkg]["prefill"],
                                   ["prefill-0", "prefill-1"], log),
        deployment="fleet-disagg")
    adopted0 = decode.engine_stats()["handoffs_adopted"]
    try:
        m.chaos.chaos().add_rule("prefill-0.*", "fail", 1.0, max_hits=1)
        resp = sup.completions({"prompt": prompt(6, 21), "max_tokens": 8,
                                "request_id": "dis-0"})
    finally:
        m.chaos.reset()
    try:
        m.chaos.chaos().add_rule("prefill-*", "fail", 1.0)
        down = sup.completions({"prompt": prompt(7, 21), "max_tokens": 8,
                                "request_id": "dis-1"})
    finally:
        m.chaos.reset()
    one = sup.completions({"prompt": prompt(8, 21), "max_tokens": 1,
                           "request_id": "dis-2"})
    return {"tokens": _tokens(resp), "ref": ref, "log": log,
            "down": down["error"]["code"], "one": len(_tokens(one)),
            "adopted": decode.engine_stats()["handoffs_adopted"] - adopted0,
            "healthy": core.is_healthy(0), "summary": sup.stats_summary()}


def test_disaggregated_path_as_jax(fleet):
    """With a prefill tier the supervisor hands each request to the first
    prefill replica that survives it (a chaos-killed one is skipped), the
    decode replica adopts the pages and returns the single server's
    tokens; a whole-tier outage is a 503 that leaves the decode replica
    healthy; a request that finishes at prefill returns from there."""
    got = _both(_disagg, fleet)
    assert got["port"]["tokens"] == got["port"]["ref"]
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["log"][:4] == [("prefill-0", "prefill"),
                               ("prefill-1", "prefill"),
                               ("decode", "completions_collect"),
                               ("prefill-0", "prefill")]
    assert port["down"] == 503 and port["healthy"]
    assert port["adopted"] == 1 and port["one"] == 1


# ---- health, application errors and drain edge cases -------------------------

def _idle_stats():
    return {"running": 0, "waiting": 0, "prefilling": 0,
            "free_kv_blocks": 64, "total_kv_blocks": 64}


def _fake_fleet(pkg, scenario, captured):
    """One of JAX's cluster-free supervisor scenarios on `pkg`'s
    supervisor over fake replicas; the observable record."""
    m = _mods(pkg)
    r = m.router
    if pkg == "jax":
        from ray_tpu.core.exceptions import TaskError
        from ray_tpu.llm.serving import (RequestTimeoutError,
                                         SessionMigratedError)
    else:
        from ray_tpu_torch.core.exceptions import TaskError
        from ray_tpu_torch.llm.serving import (RequestTimeoutError,
                                               SessionMigratedError)
    core = r.RouterCore(2, fail_threshold=3 if scenario == "stale" else 1)
    if scenario == "stale":
        class Deaf:
            def engine_stats(self):
                raise TimeoutError("probe timed out")

        class Fine:
            def engine_stats(self):
                return _idle_stats()

        sup = r.FleetSupervisor(core, [r.LocalReplica(Deaf(), "deaf"),
                                       r.LocalReplica(Fine(), "fine")])
        health = []
        for _ in range(3):
            sup.fresh_stats(force=True)
            health.append([core.is_healthy(i) for i in range(2)])
        stats = sup.fresh_stats(force=True)
        return {"health": health, "stats": [s is None for s in stats],
                "events": _events(captured[pkg])}
    if scenario == "app_errors":
        out = []
        for exc in (ValueError("string prompt requires a tokenizer"),
                    RequestTimeoutError("no engine output within 30.0s"),
                    TaskError("completions", "Traceback ...\nValueError: x",
                              cause=ValueError("x"))):
            class AppError:
                def engine_stats(self):
                    return _idle_stats()

                def completions(self, request, _exc=exc):
                    raise _exc

            core = r.RouterCore(2, fail_threshold=1)
            sup = r.FleetSupervisor(core, [r.LocalReplica(AppError(), "a"),
                                           r.LocalReplica(AppError(), "b")])
            try:
                sup.completions({"prompt": prompt(2), "max_tokens": 2})
                out.append("no error")
            except Exception as e:
                out.append((type(e).__name__, core.healthy_count(),
                            sup.failovers, core.ejected_count))
        return {"out": out, "events": _events(captured[pkg])}
    if scenario == "send_failed":
        aborted = []

        class Drainee:
            def engine_stats(self):
                return _idle_stats()

            def migrate_sessions(self, target_address):
                return {"migrated": [], "replayed": ["lost-ack"],
                        "send_failed": ["lost-ack"], "finished": []}

        class Target:
            def engine_stats(self):
                return _idle_stats()

            def handoff_address(self):
                return ["127.0.0.1", 9]

            def abort(self, rid):
                aborted.append(rid)
                return True

        sup = r.FleetSupervisor(core, [r.LocalReplica(Drainee(), "d"),
                                       r.LocalReplica(Target(), "t")])
        summary = sup.drain_replica(0, reason="lost-ack-test")
        return {"summary": summary, "aborted": aborted,
                "events": _events(captured[pkg])}
    # "recollect": a migrated stream is the target's in-flight work.
    seen = []

    class Drained:
        def engine_stats(self):
            return _idle_stats()

        def completions(self, request):
            raise SessionMigratedError(request["request_id"], "kv")

    class Adopter:
        def engine_stats(self):
            return _idle_stats()

        def completions_collect(self, rid):
            seen.append(list(core._inflight))
            return {"choices": [{"token_ids": [7], "text": "",
                                 "finish_reason": "stop"}]}

    sup = r.FleetSupervisor(core, [r.LocalReplica(Drained(), "drained"),
                                   r.LocalReplica(Adopter(), "adopter")])
    sup._drain_target[0] = 1
    core._session_owner["kv-acct"] = 0
    resp = sup.completions({"prompt": prompt(4), "max_tokens": 2,
                            "request_id": "kv-acct", "session_id": "kv-acct"})
    return {"resp": resp, "seen": seen, "after": list(core._inflight),
            "summary": sup.stats_summary(), "events": _events(captured[pkg])}


@pytest.mark.parametrize("scenario", ["stale", "app_errors", "send_failed",
                                      "recollect"])
def test_supervisor_edge_cases_as_jax(captured, scenario):
    """JAX's cluster-free supervisor cases on fake replicas, each
    package's supervisor on its own: a replica deaf to fail_threshold
    stats probes is ejected and never probed again; errors a replica
    raised (validation, a request timeout, a TaskError) reach the client
    with no ejection or replay; a migration send that lost its ack aborts
    the possible orphan on the target; re-collecting a migrated stream
    counts on the target's in-flight while it runs."""
    got = _both(_fake_fleet, scenario, captured)
    assert got["port"] == got["jax"]
    port = got["port"]
    if scenario == "stale":
        assert port["health"][-1] == [False, True]
        assert port["stats"] == [True, False]
    elif scenario == "app_errors":
        assert [o[1:] for o in port["out"]] == [(2, 0, 0)] * 3
    elif scenario == "send_failed":
        assert port["aborted"] == ["lost-ack"]
    else:
        assert port["seen"] == [[1, 1]] and port["after"] == [0, 0]


def _transport_errors():
    """(port error, JAX error of the same kind) for the runtime's error
    types: the call never completed, or the replica ran it and raised."""
    from ray_tpu.core import exceptions as jexc
    from ray_tpu.runtime import rpc as jrpc
    from ray_tpu_torch.core import exceptions as texc
    from ray_tpu_torch.runtime import rpc as trpc

    return {
        "actor_died": (texc.ActorDiedError("a1", "connection lost"),
                       jexc.ActorDiedError("a1", "connection lost")),
        "get_timeout": (texc.GetTimeoutError("get() timed out"),
                        jexc.GetTimeoutError("get() timed out")),
        "rpc_lost": (trpc.ConnectionLost("peer gone"),
                     jrpc.ConnectionLost("peer gone")),
        "task_error": (texc.TaskError("completions", "Traceback ...",
                                      cause=ValueError("x")),
                       jexc.TaskError("completions", "Traceback ...",
                                      cause=ValueError("x"))),
        "task_migrated": (texc.TaskError("completions",
                                         "SessionMigratedError: "
                                         "SESSION_MIGRATED kv r1"),
                          jexc.TaskError("completions",
                                         "SessionMigratedError: "
                                         "SESSION_MIGRATED kv r1")),
    }


@pytest.mark.parametrize("name", sorted(["actor_died", "get_timeout",
                                         "rpc_lost", "task_error",
                                         "task_migrated"]))
def test_runtime_errors_classified_as_jax(name):
    """Over the runtime's error types the port classifies a failed
    replica call as JAX does: actor death, a get timeout and a lost RPC
    connection are transport failures (eject and replay); a TaskError is
    the replica's own error, and one that carries SESSION_MIGRATED names
    the migration mode."""
    from ray_tpu.llm import router as jrouter

    port_exc, jax_exc = _transport_errors()[name]
    assert trouter._is_transport_error(port_exc) == \
        jrouter._is_transport_error(jax_exc)
    assert trouter._migrated_mode(port_exc) == jrouter._migrated_mode(jax_exc)
    assert trouter._is_transport_error(port_exc) == (
        name in ("actor_died", "get_timeout", "rpc_lost"))
