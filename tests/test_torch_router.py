"""The port's router core against the JAX package's, on the CPU:
RouterCore's picks, admission and health over seeded request traces,
over in-process port servers, prefill_with_retry under injected faults,
ReplicaPolicy's decisions, the chaos table and the error
classification. Decisions must be IDENTICAL for the same inputs.
"""

import random

import numpy as np
import pytest

from ray_tpu_torch.llm import disagg as td
from ray_tpu_torch.llm import replica_policy as tpolicy
from ray_tpu_torch.llm import router as trouter
from ray_tpu_torch.llm import serving as tserving
from ray_tpu_torch.runtime import chaos as tchaos

from torch_handoff import close, make_weights, prefill_server, prompt, server

# ---- RouterCore over seeded traces ------------------------------------------

SCENARIOS = {
    "pow2_affinity": dict(n=3, ops=("pick",)),
    "sessions": dict(n=3, ops=("pick", "pick", "start", "finish")),
    "eject_remap": dict(n=4, ops=("pick", "pick", "eject", "remap", "add",
                                  "start")),
    "draining": dict(n=3, ops=("pick", "pick", "drain", "start", "finish")),
    "slo_gate": dict(n=2, slo=0.5, ops=("pick", "admit", "observe",
                                        "admit")),
    "health": dict(n=3, fail_threshold=2, ops=("pick", "fail", "success",
                                               "pick", "fail")),
}


def _trace(scenario, seed, length=160):
    """A seeded op list: prompts share prefixes (8-token blocks), some
    requests carry sessions or LoRA names, stats vary."""
    rng = np.random.default_rng(seed)
    spec = SCENARIOS[scenario]
    heads = [rng.integers(0, 128, size=int(n)).tolist()
             for n in rng.integers(8, 40, size=5)]
    ops = []
    n = spec["n"]
    for _ in range(length):
        op = spec["ops"][int(rng.integers(len(spec["ops"])))]
        if op == "pick":
            p = heads[int(rng.integers(5))] + rng.integers(
                0, 128, size=int(rng.integers(0, 20))).tolist()
            stats = None
            if rng.random() < 0.7:
                stats = [{"waiting": int(rng.integers(0, 6)),
                          "prefilling": int(rng.integers(0, 3)),
                          "running": int(rng.integers(0, 8)),
                          "free_kv_blocks": int(rng.integers(0, 65)),
                          "total_kv_blocks": 64}
                         if rng.random() < 0.9 else None
                         for _ in range(n + 2)]
            session = (f"s{int(rng.integers(4))}"
                       if scenario == "sessions" or rng.random() < 0.2
                       else None)
            lora = [None, "a", "b"][int(rng.integers(3))]
            exclude = ({int(rng.integers(n))} if rng.random() < 0.1
                       else None)
            ops.append(("pick", p, session, lora, stats, exclude))
        elif op == "admit":
            ops.append(("admit", int(rng.integers(n)),
                        int(rng.integers(1, 400)),
                        [{"queued_prefill_tokens": int(rng.integers(0, 900))}
                         for _ in range(n)]))
        elif op == "observe":
            ops.append(("observe", int(rng.integers(0, 500)),
                        float(rng.uniform(0.0, 1.0))))
        elif op == "eject" and rng.random() < 0.15:
            ops.append(("eject", int(rng.integers(n + 1))))
        elif op == "remap":
            ops.append(("remap", int(rng.integers(n)), int(rng.integers(n))))
        elif op == "add" and rng.random() < 0.1:
            ops.append(("add",))
            n += 1
        elif op == "drain":
            ops.append(("drain", int(rng.integers(n)), bool(rng.random()
                                                            < 0.5)))
        elif op in ("start", "finish", "success"):
            ops.append((op, int(rng.integers(n))))
        elif op == "fail":
            ops.append(("fail", int(rng.integers(n)),
                        bool(rng.random() < 0.2)))
    return ops


def _replay(mod, scenario, ops, seed):
    """Run `ops` on `mod`'s RouterCore; every decision and counter."""
    spec = SCENARIOS[scenario]
    random.seed(seed)
    core = mod.RouterCore(spec["n"], block_size=8,
                          slo_ttft_s=spec.get("slo", 0.0),
                          fail_threshold=spec.get("fail_threshold", 3))
    out = []
    for op in ops:
        kind = op[0]
        try:
            if kind == "pick":
                _, p, session, lora, stats, exclude = op
                out.append(core.pick(p, session_id=session, lora_name=lora,
                                     stats=stats, exclude=exclude))
            elif kind == "admit":
                out.append(core.admit(*op[1:]))
            elif kind == "observe":
                out.append(core.observe_prefill(*op[1:]))
            elif kind == "eject":
                out.append(core.eject(op[1]))
            elif kind == "remap":
                out.append(core.remap(*op[1:]))
            elif kind == "add":
                out.append(core.add_replica())
            elif kind == "drain":
                out.append(core.set_draining(*op[1:]))
            elif kind == "start":
                out.append(core.start(op[1]))
            elif kind == "finish":
                out.append(core.finish(op[1]))
            elif kind == "success":
                out.append(core.note_success(op[1]))
            elif kind == "fail":
                ejected = core.note_failure(*op[1:])
                out.append(ejected)
                if ejected:
                    out.append(core.eject(op[1]))
        except mod.NoHealthyReplicasError as e:
            out.append(("none", str(e)))
        out.append((core.healthy_count(), core.routable_count(),
                    [core.load_score(i, []) for i in range(core.n)]))
    out.append((core.affinity_hits, core.affinity_misses, core.shed_count,
                core.ejected_count, core.n))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_core_decides_as_jax(cpu_jax, scenario, seed):
    """Over one seeded trace (same global random state), the port's
    RouterCore makes JAX's picks (pow2, session and prefix affinity,
    exclusions), admission decisions, ejections, remaps and health
    transitions, op for op."""
    from ray_tpu.llm import router as jrouter

    ops = _trace(scenario, seed)
    got = _replay(trouter, scenario, ops, seed)
    want = _replay(jrouter, scenario, ops, seed)
    assert got == want
    reasons = {d["reason"] for d in (x[1] for x in got
                                     if isinstance(x, tuple) and len(x) == 2
                                     and isinstance(x[1], dict))}
    assert reasons, "the trace made no pick"


def test_router_core_routes_port_servers_as_jax(cpu_jax):
    """Routing live port servers by their engine_stats: JAX's RouterCore
    and the port's pick the same server for every request of a repeated
    prompt mix; affinity lands every repeat on the server that cached
    it, so the servers save more prefill than round robin does."""
    from ray_tpu.llm import router as jrouter

    weights = make_weights()
    prompts = [prompt(s, 25) for s in (1, 2, 3)]
    order = [prompts[i % 3] for i in range(12)]

    def run(pick_fn):
        servers = [server("port", weights) for _ in range(2)]
        try:
            for n, p in enumerate(order):
                stats = [s.engine_stats() for s in servers]
                idx = pick_fn(n, p, stats)
                servers[idx].completions({"prompt": p, "max_tokens": 2})
            return sum(s.engine_stats()["prefix_tokens_saved"]
                       for s in servers)
        finally:
            for s in servers:
                close(s)

    cores = {"port": trouter.RouterCore(2, block_size=8),
             "jax": jrouter.RouterCore(2, block_size=8)}
    picks = []

    def affinity(n, p, stats):
        random.seed(n)
        a = cores["port"].pick(p, stats=stats)
        random.seed(n)
        b = cores["jax"].pick(p, stats=stats)
        assert a == b
        picks.append(a)
        return a[0]

    saved_affinity = run(affinity)
    saved_rr = run(lambda n, p, stats: n % 2)
    assert saved_affinity > saved_rr
    assert [d["reason"] for _, d in picks[:3]] == ["pow2"] * 3
    assert {d["reason"] for _, d in picks[3:]} == {"prefix"}


# ---- prefill_with_retry under chaos -----------------------------------------

def test_prefill_death_mid_handoff_retries_elsewhere(cpu_jax):
    """RpcChaos kills the first prefill server's call; prefill_with_retry
    re-runs the whole prefill on the second and the request completes.
    With every prefill server down the failure is typed (PrefillTierError),
    never a hang; a request the server itself refuses is not retried."""
    weights = make_weights()
    decode = server("port", weights)
    replicas = [trouter.LocalReplica(prefill_server("port", weights),
                                     name=f"prefill-{i}") for i in range(2)]
    req = {"prompt": prompt(3, 21), "max_tokens": 4}
    try:
        try:
            tchaos.chaos().add_rule("prefill-0.*", "fail", 1.0, max_hits=1)
            res = trouter.prefill_with_retry(replicas, req,
                                             decode.handoff_address())
        finally:
            tchaos.reset()
        assert res["handoff"]
        out = decode.completions_collect(res["rid"])
        assert len(out["choices"][0]["token_ids"]) == 4
        assert replicas[0]._obj.engine.stats()["prefill_tokens_computed"] \
            == 0
        assert replicas[1]._obj.engine.stats()["prefill_tokens_computed"] \
            == 21
        try:
            tchaos.chaos().add_rule("prefill-*", "fail", 1.0)
            with pytest.raises(trouter.PrefillTierError,
                               match="all 2 replicas"):
                trouter.prefill_with_retry(replicas, req,
                                           decode.handoff_address())
        finally:
            tchaos.reset()
        with pytest.raises(ValueError, match="tokenizer"):
            trouter.prefill_with_retry(replicas, {"prompt": "text"},
                                       decode.handoff_address())
        assert replicas[1]._obj.engine.stats()[
            "prefill_tokens_computed"] == 21
        free = decode.engine_stats()
        assert free["free_kv_blocks"] == free["total_kv_blocks"]
    finally:
        close(decode)
        for r in replicas:
            r._obj.close()


def test_local_replica_chaos_delay_and_pattern(cpu_jax):
    """LocalReplica consults the chaos table by "<name>.<method>": a
    delay rule slows only the matching replica's calls, a fail rule
    raises the port's ConnectionLost, a transport error."""
    class Echo:
        def ping(self, x, _timeout=None):
            return x

    a = trouter.LocalReplica(Echo(), name="a")
    b = trouter.LocalReplica(Echo(), name="b")
    try:
        rule = tchaos.chaos().add_rule("a.ping", "delay", 1.0, 0.01)
        assert a.call("ping", 1, _timeout=3) == 1
        assert b.call("ping", 2) == 2
        assert rule.hits == 1
        tchaos.chaos().add_rule("b.*", "fail", 1.0, max_hits=1)
        with pytest.raises(tchaos.ConnectionLost) as err:
            b.call("ping", 3)
        assert trouter._is_transport_error(err.value)
        assert b.call("ping", 4) == 4
    finally:
        tchaos.reset()


# ---- ReplicaPolicy ----------------------------------------------------------

POLICIES = {
    "default": {},
    "windowed": dict(signal_window_s=5.0),
    "tight": dict(min_replicas=2, max_replicas=3, cooldown_s=0.0,
                  scale_down_quiet_s=2.0),
    "depth_fallback": dict(queue_depth_high=2.0, queue_depth_low=1.0,
                           cooldown_s=1.0, scale_down_quiet_s=3.0),
}


def _policy_stats(rng, n, tps):
    return [None if rng.random() < 0.1 else {
        "queued_prefill_tokens": int(rng.integers(0, 3000)),
        "prefill_tokens_per_s": (float(rng.uniform(100, 2000))
                                 if tps and rng.random() < 0.8 else 0),
        "tokens_per_s": 0,
        "waiting": int(rng.integers(0, 5)),
        "prefilling": int(rng.integers(0, 2)),
        "free_kv_blocks": int(rng.integers(0, 65)),
        "total_kv_blocks": 64} for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_replica_policy_decides_as_jax(cpu_jax, name, seed):
    """Over one seeded script of fleet stats and clocks, the port's
    ReplicaPolicy returns JAX's desired count every tick, and its
    signals equal JAX's."""
    from ray_tpu.llm import replica_policy as jpolicy

    rng = np.random.default_rng(seed)
    ticks = []
    now = 0.0
    for i in range(240):
        now += float(rng.uniform(0.2, 2.0))
        calm = (i // 40) % 2 == 1
        stats = _policy_stats(rng, 3, tps=name != "depth_fallback")
        if calm:
            stats = [dict(s, queued_prefill_tokens=0, waiting=0,
                          prefilling=0, free_kv_blocks=60) if s else s
                     for s in stats]
        ticks.append((stats, now))
    runs = {}
    for label, mod in (("port", tpolicy), ("jax", jpolicy)):
        policy = mod.ReplicaPolicy(mod.ReplicaPolicyConfig(**POLICIES[name]))
        current = 1
        out = []
        for stats, t in ticks:
            current = policy.desired(stats, current, t)
            out.append((current, mod.ReplicaPolicy.signals(stats)))
        runs[label] = out
    assert runs["port"] == runs["jax"]
    assert len({c for c, _ in runs["port"]}) > 1, "the script never scaled"


@pytest.mark.parametrize("kw", [dict(min_replicas=0),
                                dict(min_replicas=3, max_replicas=2),
                                dict(signal_window_s=-1.0)])
def test_replica_policy_config_refusals_equal_jax(cpu_jax, kw):
    from ray_tpu.llm import replica_policy as jpolicy

    with pytest.raises(ValueError) as want:
        jpolicy.ReplicaPolicyConfig(**kw)
    with pytest.raises(ValueError) as got:
        tpolicy.ReplicaPolicyConfig(**kw)
    assert str(got.value) == str(want.value)


# ---- the chaos table and error classification -------------------------------

SPECS = ["prefill-0.*=fail:0.5", "a=delay:1:0.2,b=timeout",
         "x.*=fail:1:0:3", " , y=delay", "=fail:1", "a=explode:1",
         "a=fail:2", "a=delay:1:-1", "a=fail:1:0:-2", "a=fail:1:0:1:9"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_as_jax(cpu_jax, spec):
    """A chaos spec gives JAX's rules, or JAX's error message."""
    from ray_tpu.runtime import chaos as jchaos

    def parse(mod):
        table = mod.RpcChaos()
        table.clear()
        try:
            table.configure(spec)
        except ValueError as e:
            # Each names its own package's variable.
            return ("error", str(e).replace("RAY_TPU_TORCH_CHAOS",
                                            "RAY_TPU_CHAOS"))
        return [(r.pattern, r.mode, r.prob, r.param, r.max_hits)
                for r in table._rules]

    assert parse(tchaos) == parse(jchaos)


def _errors():
    return {
        "connection_lost": (tchaos.ConnectionLost("chaos"), True),
        "reset": (ConnectionResetError("peer"), True),
        "refused": (ConnectionRefusedError("closed"), True),
        "socket_timeout": (TimeoutError("timed out"), True),
        "request_timeout": (tserving.RequestTimeoutError("aborted"), False),
        "value": (ValueError("bad request"), False),
        "handoff": (td.HandoffError("rejected"), False),
        "migrated_kv": (tserving.SessionMigratedError("r1", "kv"), False),
        "migrated_replay": (tserving.SessionMigratedError("r2", "replay"),
                            False),
        "draining": (tserving.ReplicaDrainingError("tag"), False),
    }


@pytest.mark.parametrize("name", sorted(_errors()))
def test_error_classification_matches_jax(cpu_jax, name):
    """The port's transport test keeps JAX's OSError branch and its
    request-timeout exclusion; the migrated/draining/handoff markers are
    read from the message as JAX reads them, and JAX reads the port's
    errors the same way."""
    from ray_tpu.llm import router as jrouter

    exc, transport = _errors()[name]
    assert trouter._is_transport_error(exc) == transport
    assert trouter._migrated_mode(exc) == jrouter._migrated_mode(exc)
    assert trouter._is_draining_error(exc) == jrouter._is_draining_error(exc)
    assert bool(trouter._HANDOFF_RETRY_RE.search(repr(exc))) == bool(
        jrouter._HANDOFF_RETRY_RE.search(repr(exc)))
    if name.startswith("migrated"):
        assert trouter._migrated_mode(exc) == name.split("_")[1]
    if name == "draining":
        assert trouter._is_draining_error(exc)
