"""The port's observability against the JAX package's, on the CPU: the
cluster event records (runtime/events.py), the metrics registry
(util/metrics.py: snapshots, Prometheus text, quantiles), the metric
definitions, the LLM rollup (state/api.py `_aggregate_llm_metrics`), the
span ring (util/tracing.py), a request's stitched trace through the
fleet supervisor (`state.request_trace`), the engine's metric bumps, and
the OpenAI router's chat template and model resolution.
"""

import json

import numpy as np
import pytest

from ray_tpu_torch.llm import openai_router as topenai
from ray_tpu_torch.llm import router as trouter
from ray_tpu_torch.runtime import events as tevents
from ray_tpu_torch.runtime import metric_defs as tmd
from ray_tpu_torch.state import api as tstate
from ray_tpu_torch.util import metrics as tmetrics
from ray_tpu_torch.util import tracing as ttr

from torch_handoff import close, make_weights, prompt, server


# ---- events ------------------------------------------------------------------

@pytest.mark.parametrize("event_type", tevents.EVENT_TYPES)
def test_make_event_equals_jax(event_type):
    """For every type of the closed set, the port's record equals JAX's
    field by field apart from its time (bytes ids stored as hex)."""
    from ray_tpu.runtime import events as jevents

    assert tevents.EVENT_TYPES == jevents.EVENT_TYPES
    kw = dict(severity=tevents.WARNING, source="llm-router",
              node_id=b"\x01\x02" * 8, slice_name="s0",
              actor_id="ab" * 8, labels={"replica": "1", "n": "2"})
    got = tevents.make_event(event_type, f"msg {event_type}", **kw)
    want = jevents.make_event(event_type, f"msg {event_type}", **kw)
    assert abs(got.pop("time") - want.pop("time")) < 5.0
    assert got == want
    assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("bad", [("NOT_A_TYPE", "INFO"),
                                 ("NODE_DEAD", "FATAL")])
def test_make_event_refusals_and_emit_equal_jax(bad):
    """Unknown types and severities raise JAX's message; emit outside a
    cluster returns the record (or None for a bad one) and never
    raises."""
    from ray_tpu.runtime import events as jevents

    with pytest.raises(ValueError) as want:
        jevents.make_event(bad[0], "m", severity=bad[1])
    with pytest.raises(ValueError) as got:
        tevents.make_event(bad[0], "m", severity=bad[1])
    assert str(got.value) == str(want.value)
    assert tevents.emit(bad[0], "m", severity=bad[1]) is None
    ev = tevents.emit(tevents.LLM_REQUEST_SHED, "m", labels={"a": "b"})
    assert ev["type"] == "LLM_REQUEST_SHED" and ev["labels"] == {"a": "b"}


# ---- metrics -----------------------------------------------------------------

def _bump(mod, tag):
    """One script of bumps on fresh metrics of `mod`; their snapshots and
    the errors the script's bad calls raise."""
    c = mod.Counter(f"test_obs_counter_{tag}", "a counter",
                    tag_keys=("route", "code"))
    g = mod.Gauge(f"test_obs_gauge_{tag}", "a gauge", tag_keys=("replica",))
    h = mod.Histogram(f"test_obs_hist_{tag}", "a histogram",
                      boundaries=[5, 0.5, 50], tag_keys=("phase",))
    plain = mod.Counter(f"test_obs_plain_{tag}")
    c.set_default_tags({"code": "200"})
    rng = np.random.default_rng(3)
    for i in range(40):
        c.inc(float(rng.integers(1, 4)), tags={"route": f"r{i % 3}"})
        g.set(float(rng.normal()), tags={"replica": 'a"b\\c\nd'})
        h.observe(float(rng.exponential(8.0)),
                  tags={"phase": ["queue", "prefill"][i % 2]})
    c.bind({"route": "bound"}).inc(2.5)
    g.bind({"replica": "x"}).set(7)
    h.bind({"phase": "bound"}).observe(0.25)
    plain.inc()
    errors = []
    for bad in (lambda: c.inc(0), lambda: c.inc(1, tags={"nope": "1"}),
                lambda: g.set_default_tags({"nope": "1"}),
                lambda: mod.Counter("")):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e).replace(tag, "TAG"))
    snaps = [m.snapshot() for m in (c, g, h, plain)]
    return snaps, errors, c.info


def _untag(snaps, tag):
    return json.loads(json.dumps(snaps).replace(tag, "TAG"))


def test_metric_snapshots_and_prometheus_text_equal_jax():
    """The same bumps (default, bound and per-call tags, label values
    that need escaping, unsorted histogram boundaries) give JAX's
    snapshots, errors, info and Prometheus text."""
    from ray_tpu.util import metrics as jmetrics

    got = _bump(tmetrics, "port")
    want = _bump(jmetrics, "jax")
    assert _untag(got[0], "port") == _untag(want[0], "jax")
    assert got[1] == want[1] and len(got[1]) == 4
    assert _untag(got[2], "port") == _untag(want[2], "jax")
    text = tmetrics.prometheus_text(got[0])
    assert text.replace("port", "TAG") == jmetrics.prometheus_text(
        want[0]).replace("jax", "TAG")
    assert 'replica="a\\"b\\\\c\\nd"' in text
    assert text == jmetrics.prometheus_text(got[0])
    names = {s["name"] for s in tmetrics.snapshot_all()}
    assert {f"test_obs_{k}_port" for k in ("counter", "gauge", "hist",
                                           "plain")} <= names


@pytest.mark.parametrize("seed", range(4))
def test_histogram_quantile_equals_jax(seed):
    from ray_tpu.util import metrics as jmetrics

    rng = np.random.default_rng(seed)
    bounds = sorted(rng.uniform(0, 100, size=int(rng.integers(1, 9)))
                    .tolist())
    cases = [([], [], 0.5), (bounds, [0] * (len(bounds) + 1), 0.9)]
    for _ in range(50):
        buckets = rng.integers(0, 5, size=len(bounds) + 1).tolist()
        q = float(rng.choice([0.0, 0.5, 0.9, 0.99, 1.0, 1.5, -0.1]))
        cases.append((bounds, buckets, q))
    for b, k, q in cases:
        assert tmetrics.histogram_quantile(b, k, q) == \
            jmetrics.histogram_quantile(b, k, q)


def test_metric_definitions_equal_jax():
    """Every metric the port defines is JAX's metric of that name: type,
    tag keys and histogram boundaries (the rollup and dashboards read
    both packages' snapshots alike)."""
    from ray_tpu.runtime import metric_defs as jmd

    jax_by_name = {m.info["name"]: m for m in jmd.ALL_METRICS}
    assert len(tmd.ALL_METRICS) == 29
    for m in tmd.ALL_METRICS:
        j = jax_by_name[m.info["name"]]
        assert type(m).__name__ == type(j).__name__
        assert m.info["tag_keys"] == j.info["tag_keys"]
        assert getattr(m, "_boundaries", None) == getattr(j, "_boundaries",
                                                          None)


def _breakdown_snaps(mod_md):
    """Snapshots of fresh breakdown histograms observed as the engine
    observes them, under the metric_defs names and boundaries."""
    hist = type(mod_md.LLM_TTFT_BREAKDOWN_MS)
    out = []
    for name, src in (("ttft", mod_md.LLM_TTFT_BREAKDOWN_MS),
                      ("itl", mod_md.LLM_ITL_BREAKDOWN_MS)):
        h = hist(f"test_obs_{name}_{mod_md.__name__.split('.')[0]}",
                 boundaries=src._boundaries, tag_keys=("phase",))
        rng = np.random.default_rng(len(name))
        for i in range(60):
            h.observe(float(rng.exponential(30.0)),
                      tags={"phase": ["queue", "prefill", "decode"][i % 3]})
        snap = h.snapshot()
        snap["name"] = src.info["name"]
        out.append(snap)
    return out


def test_aggregate_llm_metrics_equals_jax():
    """The rollup of JAX's test_aggregate_llm_metrics_rollup inputs, and of
    breakdown histograms, equals JAX's."""
    from ray_tpu.runtime import metric_defs as jmd
    from ray_tpu.state.api import _aggregate_llm_metrics as jagg

    snapshots = [
        [{"name": "ray_tpu_llm_running", "type": "gauge",
          "values": {'[["replica", "a"]]': 3.0}},
         {"name": "ray_tpu_tasks_submitted_total", "type": "counter",
          "values": {"[]": 99.0}}],
        [{"name": "ray_tpu_llm_running", "type": "gauge",
          "values": {'[["replica", "b"]]': 2.0}},
         {"name": "ray_tpu_llm_tokens_per_s", "type": "gauge",
          "values": {'[["replica", "b"]]': 40.5}}],
    ]
    out = tstate._aggregate_llm_metrics(snapshots)
    assert out == jagg(snapshots)
    assert out["running"] == 5.0 and out["replicas_reporting"] == 2
    assert tstate._aggregate_llm_metrics([]) == jagg([]) == {}
    port, jax = _breakdown_snaps(tmd), _breakdown_snaps(jmd)
    assert port == jax
    both = [snapshots[0] + port, snapshots[1] + port[:1]]
    out = tstate._aggregate_llm_metrics(both)
    assert out == jagg(both)
    assert set(out["ttft_breakdown_ms"]) == {"queue", "prefill", "decode"}
    assert "itl_breakdown_p99_ms" in out


# ---- spans -------------------------------------------------------------------

def _spans(tr):
    """Nested spans and a retroactive one under an explicit context."""
    n0 = len(tr.get_spans())
    with tr.trace_context(b"\x11" * 16, b"\x22" * 8):
        with tr.span("outer", "llm", request_id="r"):
            with tr.span("inner", "llm", k=1):
                pass
            tr.record_span("retro", "llm", 10.0, 12.5, tokens=3)
    with tr.span("root", "task"):
        pass
    tr.record_span("neg", "llm", 5.0, 4.0)
    return tr.get_spans()[n0:]


def test_span_ring_records_as_jax(tmp_path):
    """The port's span records carry JAX's fields and parent links: the
    explicit context's trace and parent, children of the open span, a
    fresh trace at a root; nothing with tracing off; the chrome dump and
    merge_spans lay out as JAX's."""
    from ray_tpu.util import tracing as jtr

    was = (ttr.enabled(), jtr.enabled())
    try:
        ttr.set_enabled(True)
        jtr.set_enabled(True)
        got, want = _spans(ttr), _spans(jtr)

        def shape(spans):
            ids = {}
            for s in spans:
                ids.setdefault(s["args"]["span_id"], s["name"])
            rows = []
            for s in spans:
                a = s["args"]
                rows.append((s["name"], s["cat"], s["ph"], sorted(s),
                             sorted(a), ids.get(a.get("parent_span_id"),
                                                a.get("parent_span_id")),
                             a["trace_id"] if a["trace_id"] == "11" * 16
                             else "fresh", s["dur"] if s["name"] in (
                                 "retro", "neg") else None,
                             {k: v for k, v in a.items() if k not in (
                                 "trace_id", "span_id", "parent_span_id")}))
            return rows

        assert shape(got) == shape(want)
        assert [s["name"] for s in got] == ["inner", "retro", "outer",
                                            "root", "neg"]
        ttr.set_enabled(False)
        n = len(ttr.get_spans())
        with ttr.span("off", "llm"):
            assert ttr.current_span_id() is None
        ttr.record_span("off", "llm", 0.0, 1.0)
        assert len(ttr.get_spans()) == n
    finally:
        ttr.set_enabled(was[0])
        jtr.set_enabled(was[1])
    path = tmp_path / "trace.json"
    ttr.dump_chrome_trace(str(path))
    assert json.loads(path.read_text())["traceEvents"] == ttr.get_spans()
    groups = [("a", got), ("b", got[:2]), ("a", [dict(got[0], pid=1)])]
    assert ttr.merge_spans(groups) == jtr.merge_spans(groups)


# ---- a request's trace through the supervisor --------------------------------

@pytest.fixture(scope="module")
def weights(cpu_jax):
    return make_weights(max_seq=128)


def _trace(pkg, weights):
    if pkg == "jax":
        from ray_tpu.llm import router
        from ray_tpu.state import api
        from ray_tpu.util import tracing as tr
    else:
        router, api, tr = trouter, tstate, ttr
    rid = f"trace-plain-{pkg}"
    srv = server(pkg, weights)
    try:
        sup = router.FleetSupervisor(router.RouterCore(1, block_size=8),
                                     [router.LocalReplica(srv, "r0")])
        was = tr.enabled()
        tr.set_enabled(True)
        try:
            resp = sup.completions({"prompt": prompt(1, 21), "max_tokens": 6,
                                    "request_id": rid})
        finally:
            tr.set_enabled(was)
        trace = api.request_trace(rid)
        recs = srv.flight_records(request_id=rid)
    finally:
        close(srv)
    assert trace["trace_id"] == tr.request_trace_id(rid).hex()
    names = {}
    for s in trace["spans"]:
        names.setdefault(s["name"], []).append(s)
    root = names["llm:request"][0]["args"]
    dec = names["llm:decode"][0]["args"]
    return {"names": sorted(names),
            "root_parent": root.get("parent_span_id"),
            "admit_parent_is_root": names["llm:admit"][0]["args"][
                "parent_span_id"] == root["span_id"],
            "admitted": names["llm:admit"][0]["args"]["admitted"],
            "decode_keys": sorted(dec), "decode_tokens": dec["tokens"],
            "sorted": [s["ts"] for s in trace["spans"]] == sorted(
                s["ts"] for s in trace["spans"]),
            "tokens": resp["choices"][0]["token_ids"],
            "flight": bool(recs) and all(rid in r["emitted"] for r in recs),
            "unknown": api.request_trace("no-such-rid")["spans"]}


def test_request_trace_stitches_router_and_engine_as_jax(weights):
    """A request routed by the supervisor leaves, in this process's ring,
    one trace under its request id: the router's root span, admission as
    its child, the engine's prefill and decode with the breakdown as
    attributes, as JAX's test_request_trace_stitches_router_and_engine
    finds. The cluster-wide trace refuses (its span export is not
    ported)."""
    got = {pkg: _trace(pkg, weights) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert {"llm:request", "llm:admit", "llm:prefill",
            "llm:decode"} <= set(port["names"])
    assert port["root_parent"] is None and port["admit_parent_is_root"]
    assert port["decode_tokens"] == 6 and port["unknown"] == []
    with pytest.raises(ValueError, match="dump_spans.*not ported"):
        tstate.request_trace("x", cluster=True)


# ---- the engine's bumps ------------------------------------------------------

def _engine_bumps(pkg, weights):
    if pkg == "jax":
        from ray_tpu.runtime import metric_defs as md
    else:
        md = tmd

    def counts():
        ttft = md.LLM_TTFT_BREAKDOWN_MS.snapshot()["histograms"]
        itl = md.LLM_ITL_BREAKDOWN_MS.snapshot()["histograms"]
        return {"tokens": md.LLM_TOKENS_GENERATED.snapshot()["values"].get(
                    "[]", 0.0),
                "proposed": md.LLM_SPEC_PROPOSED.snapshot()["values"].get(
                    "[]", 0.0),
                "accepted": md.LLM_SPEC_ACCEPTED.snapshot()["values"].get(
                    "[]", 0.0),
                **{f"ttft_{json.loads(k)[0][1]}": v["count"]
                   for k, v in ttft.items()},
                **{f"itl_{json.loads(k)[0][1]}": v["count"]
                   for k, v in itl.items()}}

    srv = server(pkg, weights, speculative_ngram=3)
    try:
        before = counts()
        for i, p in enumerate(([5, 9, 13] * 4, prompt(2, 21))):
            srv.completions({"prompt": p, "max_tokens": 10,
                             "request_id": f"bumps-{i}"})
        after = counts()
        stats = srv.engine_stats()
    finally:
        close(srv)
    # Only what these requests bumped: a phase an earlier test observed in
    # this process (a JAX handoff, say) stays in the snapshot at a delta
    # of 0 on one package's side alone.
    delta = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    return delta, stats


def test_engine_metric_bumps_equal_jax(weights):
    """The same requests on a speculating server bump JAX's counters by
    the same amounts: tokens, draft tokens proposed and accepted, one
    queue/prefill TTFT and one decode ITL observation per request; the
    gauges a server publishes read its engine_stats."""
    got = {pkg: _engine_bumps(pkg, weights) for pkg in ("jax", "port")}
    assert got["port"][0] == got["jax"][0]
    delta, stats = got["port"]
    assert delta["tokens"] == 20 and delta["proposed"] > 0
    assert delta["ttft_prefill"] == delta["itl_decode"] == 2
    key = json.dumps([["replica", stats["replica"]]])
    assert tmd.LLM_KV_TOTAL_BLOCKS.snapshot()["values"][key] == \
        stats["total_kv_blocks"]


# ---- the OpenAI router -------------------------------------------------------

class _Tok:
    def encode(self, text):
        return list(text.encode())

    def decode(self, ids):
        return bytes(ids).decode(errors="replace")


class _Handle:
    """A deployment handle answering completions with fixed token ids."""

    def __init__(self, name, calls):
        self.name, self._calls, self._method = name, calls, None

    def options(self, method):
        h = _Handle(self.name, self._calls)
        h._method = method
        return h

    def remote(self, req):
        self._calls.append((self.name, self._method, req))
        out = {"choices": [{"token_ids": [104, 105], "text": None,
                            "finish_reason": "length"}],
               "usage": {"prompt_tokens": len(req["prompt"])}}
        return type("R", (), {"result": lambda self, timeout=None: out})()


def _openai(mod, monkeypatch):
    calls = []
    monkeypatch.setattr(mod.serve, "get_deployment_handle",
                        lambda name: _Handle(name, calls))
    tmpl = mod.ChatTemplate(_Tok(), system_default="be brief")
    msgs = [{"role": "user", "content": "hi"},
            {"role": "assistant", "content": "yo"}, {"content": "more"}]
    rendered = [tmpl.render(msgs),
                tmpl.render([{"role": "system", "content": "s"}] + msgs),
                mod.ChatTemplate(_Tok()).render([])]
    out = []
    for models in ({"llama": "engine-a"},
                   {"llama": "engine-a", "qwen": "engine-b"}):
        r = mod.OpenAIRouter(models, tokenizer=_Tok())
        for mid in (None, "llama", "llama:ad1", "qwen", "missing",
                    "missing:x"):
            h, lora, err = r._resolve(mid)
            out.append((getattr(h, "name", None), lora, err))
            body = {"model": mid, "prompt": [1, 2, 3], "max_tokens": 2}
            out.append(r.completions(dict(body)))
            chat = r.chat_completions({"model": mid, "messages": msgs,
                                       "max_tokens": 2, "seed": 1,
                                       "junk": 0})
            out.append({k: v for k, v in chat.items()
                        if k not in ("id", "created")})
            out.append(r({"endpoint": "completions", **body}))
        listing = r.models_list()
        out.append([{k: v for k, v in d.items() if k not in ("owned_by",
                                                              "created")}
                    for d in listing["data"]])
    no_tmpl = mod.OpenAIRouter({"llama": "engine-a"})
    out.append(no_tmpl.chat_completions({"messages": msgs}))
    return rendered, out, calls


def test_chat_template_and_openai_router_resolve_as_jax(monkeypatch):
    """ChatTemplate renders JAX's tokens, and OpenAIRouter resolves model
    ids (a lone model, "base:adapter" to the base engine with
    lora_name, unknown ids to a 404 body) and shapes completions and
    chat responses as JAX's."""
    from ray_tpu.llm import openai_router as jopenai

    got = _openai(topenai, monkeypatch)
    want = _openai(jopenai, monkeypatch)
    assert got == want
    rendered, out, calls = got
    assert rendered[0][:9] == list(b"<|system|")
    assert ("engine-a", "completions") in {(c[0], c[1]) for c in calls}
    assert any(c[2].get("lora_name") == "ad1" for c in calls)


def test_unported_state_and_metrics_history_refuse():
    """What needs the runtime's span export or metrics history refuses
    with the port's _unported ValueError."""
    with pytest.raises(ValueError, match="dump_spans.*not ported"):
        tstate.dump_cluster_spans()
    from ray_tpu_torch.runtime.gcs.server import UNPORTED_HANDLERS

    assert "report_metrics2" in UNPORTED_HANDLERS
    assert "report_events" not in UNPORTED_HANDLERS
    assert "list_events" not in UNPORTED_HANDLERS
