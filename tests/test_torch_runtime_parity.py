"""The port's runtime pieces against the JAX package's, in process, with no
cluster: every wire message, the scheduling decisions, the placement-group
plans and the serialization frames. The same inputs go through both; the
outputs must be EQUAL (bytes equal bytes, no tolerance).
"""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core import serialization as jser
from ray_tpu.runtime import scheduling as jsched
from ray_tpu.runtime import wire as jwire
from ray_tpu.runtime.gcs import placement_groups as jpg
from ray_tpu_torch.core import serialization as tser
from ray_tpu_torch.runtime import scheduling as tsched
from ray_tpu_torch.runtime import wire as twire
from ray_tpu_torch.runtime.gcs import placement_groups as tpg


# ---- wire: the cases of tests/test_wire_schema.py ----------------------------

def _registry(wire):
    """One instance of every message class with non-default values in every
    field, built from `wire` (either package's module)."""
    return {
        "NodeInfoMsg": lambda: wire.NodeInfoMsg(
            node_id=b"n" * 14, host="10.0.0.9", port=7001,
            resources={"CPU": 8.0, "GPU": 4.0}, available={"CPU": 2.0},
            labels={"zone": "a"}, is_head=True, alive=False,
            object_store_path="/dev/shm/x", draining=True,
            drain_deadline=12.5),
        "HeartbeatMsg": lambda: wire.HeartbeatMsg(
            node_id=b"n1", available={"CPU": 3.0}, known_version=17,
            known_epoch="e1", backlog=[{"shape": {"CPU": 1.0}, "count": 2}]),
        "ViewDeltaMsg": lambda: wire.ViewDeltaMsg(
            version=4, epoch="e1", full=[wire.NodeInfoMsg(node_id=b"a")],
            deltas=[wire.NodeInfoMsg(node_id=b"b")], is_full=True),
        "LeaseRequestMsg": lambda: wire.LeaseRequestMsg(
            resources={"GPU": 1.0}, for_actor=True,
            placement_group_id=b"p" * 14, bundle_index=2,
            runtime_env_hash=b"h" * 8, env_key="env-a", req_id=b"r1" * 4),
        "LeaseReplyMsg": lambda: wire.LeaseReplyMsg(
            ok=True, error="e", canceled=True, spillback_host="10.0.0.2",
            spillback_port=7003, spillback_node=b"m" * 14,
            lease_id=b"l" * 8, worker_id=b"w" * 12, worker_host="127.0.0.1",
            worker_port=40001, node_id=b"n" * 14, req_id=b"q" * 8,
            pending=True),
        "TaskSpecMsg": lambda: wire.TaskSpecMsg(
            task_id=b"t" * 14, fn_id=b"f" * 20, name="work",
            payload=([("v", b"x")], [None], None, None, None),
            kwarg_names_v1=[None, "k"], num_returns=2,
            resources={"CPU": 1.0}, max_retries=1, actor_id=b"a" * 14,
            method_name="run", seq_no=7, scheduling_strategy_v1=None,
            placement_group_id=b"p" * 14, placement_group_bundle_index=2,
            runtime_env_v1={"env_vars": {"K": "V"}},
            pinned_oids_v1=[b"o" * 14], trace_id=b"tr" * 8,
            parent_span_id=b"sp" * 4),
        "SliceLostMsg": lambda: wire.SliceLostMsg(
            slice_name="s-a", nodes=[b"n1" * 7, b"n2" * 7],
            origin_node=b"o" * 14, reason="preempted"),
        "TaskReplyMsg": lambda: wire.TaskReplyMsg(
            status="ok", returns=[("v", b"r1")], error=None,
            node_id=b"n" * 14, streamed=3),
        "LeaseBatchRequestMsg": lambda: wire.LeaseBatchRequestMsg(
            entries=[wire.LeaseRequestMsg(resources={"CPU": 1.0},
                                          req_id=b"r1" * 4)]),
        "LeaseBatchReplyMsg": lambda: wire.LeaseBatchReplyMsg(
            entries=[wire.LeaseReplyMsg(ok=True, req_id=b"r1" * 4)],
            pending=[b"r2" * 4], error="partial"),
        "TaskEventMsg": lambda: wire.TaskEventMsg(
            task_id="ab" * 10, name="work", state="RUNNING", actor_id="ac",
            worker="worker:1234", time=12.5, error="boom"),
        "TaskEventBatchMsg": lambda: wire.TaskEventBatchMsg(
            events=[wire.TaskEventMsg(task_id="aa", state="FINISHED")],
            reporter="worker:1234", node_id=b"n" * 14, has_wait_edges=True,
            wait_edges=[{"kind": "object", "oid": "ff" * 10}], dropped=17),
        "MetricsReportMsg": lambda: wire.MetricsReportMsg(
            node="ab" * 8, pid=4242, payload=b"[]"),
        "ObjChunkRequestMsg": lambda: wire.ObjChunkRequestMsg(
            oid=b"o" * 20, offset=4 << 20, length=1 << 20),
        "ObjChunkReplyMsg": lambda: wire.ObjChunkReplyMsg(
            found=True, total=64 << 20, metadata=b"meta", error="e"),
        "ObjPutMsg": lambda: wire.ObjPutMsg(
            oid=b"o" * 20, offset=8, total=128, metadata=b"m", seal=True),
        "AckMsg": lambda: wire.AckMsg(ok=True, error="store full",
                                      existed=True),
        "PrefixEntryMsg": lambda: wire.PrefixEntryMsg(
            digest=b"d" * 16, lora_id="summarizer", weights_version=3,
            block_size=8, n_tokens=16, token_ids=[5, 7, 11, 13],
            nbytes=1 << 20, owner_replica="1234-abcdef", node_id=b"n" * 14,
            deployment="llm"),
        "PrefixLookupMsg": lambda: wire.PrefixLookupMsg(
            digests=[b"a" * 16, b"b" * 16], lora_id="summarizer",
            weights_version=2, block_size=8, want_payload=True,
            replica="5678-fedcba"),
        "PrefixLookupReplyMsg": lambda: wire.PrefixLookupReplyMsg(
            found=True, entries=[wire.PrefixEntryMsg(digest=b"a" * 16,
                                                     n_tokens=8)],
            error="partial"),
        "PrefixPurgeMsg": lambda: wire.PrefixPurgeMsg(
            owner_replica="1234-abcdef", node_id=b"n" * 14,
            deployment="llm", digests=[b"a" * 16], below_weights_version=4,
            clear_owner_only=True),
        "PrefixPurgeReplyMsg": lambda: wire.PrefixPurgeReplyMsg(
            ok=True, purged=3, owners_cleared=2),
        "KVHandoffMsg": lambda: wire.KVHandoffMsg(
            state_json=b'{"id": "req-1"}', kv_dtype="bfloat16",
            kv_shape=[2, 4, 8, 16], migrated=True, trace_id=b"t" * 16,
            parent_span_id=b"s" * 8),
    }


def _declared(wire):
    return {name for name in dir(wire)
            if name.endswith("Msg") and not name.startswith("_")
            and isinstance(getattr(wire, name), type)
            and issubclass(getattr(wire, name), wire.Message)}


def test_wire_declares_the_same_messages():
    assert _declared(twire) == _declared(jwire) == set(_registry(twire))


@pytest.mark.parametrize("name", sorted(_registry(twire)))
def test_wire_message_bytes_equal_both_ways(name):
    """The same field values encode to the same bytes, and each package
    decodes the other's bytes to its own message."""
    jmsg, tmsg = _registry(jwire)[name](), _registry(twire)[name]()
    jb, tb = jmsg.encode(), tmsg.encode()
    assert tb == jb
    assert type(tmsg).decode(jb) == tmsg
    assert type(jmsg).decode(tb) == jmsg


@pytest.mark.parametrize("name", sorted(_registry(twire)))
def test_wire_unknown_fields_skip_both_ways(name):
    """A newer writer's extra field, appended by either package's codec,
    is skipped by the other package's reader (forward compatibility)."""
    jmsg, tmsg = _registry(jwire)[name](), _registry(twire)[name]()
    extra_j = jwire._encode_field(999, jwire.STR, "from-the-future")
    extra_t = twire._encode_field(999, twire.STR, "from-the-future")
    assert extra_t == extra_j
    assert type(tmsg).decode(jmsg.encode() + extra_j) == tmsg
    assert type(jmsg).decode(tmsg.encode() + extra_t) == jmsg


# ---- scheduling: the same node views, the same decisions ---------------------

def _nodes(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(6):
        total = {"CPU": float(rng.integers(1, 9)),
                 "GPU": float(rng.integers(0, 5))}
        avail = {k: float(rng.integers(0, int(v) + 1)) for k, v in
                 total.items()}
        nid = bytes([i]) * 4
        out[nid] = types.SimpleNamespace(
            node_id=nid, alive=bool(rng.random() < 0.9), draining=False,
            labels={"zone": "ab"[i % 2]}, resources=total, available=avail)
    return out


def _strategies(mod, nodes):
    first = next(iter(nodes))
    return {"default": None, "spread": mod.SpreadStrategy(),
            "affinity_hard": mod.NodeAffinityStrategy(first),
            "affinity_soft": mod.NodeAffinityStrategy(b"\xff" * 4, soft=True),
            "labels": mod.NodeLabelStrategy({"zone": ["a"]})}


DEMANDS = {"cpu": {"CPU": 1.0}, "cpu_gpu": {"CPU": 1.0, "GPU": 1.0},
           "two_gpus": {"GPU": 2.0}}


@pytest.mark.parametrize("strategy", ["default", "spread", "affinity_hard",
                                      "affinity_soft", "labels"])
@pytest.mark.parametrize("demand", sorted(DEMANDS))
def test_rank_nodes_for_actor_equal(strategy, demand):
    """Over seeded node views; the policy's random tie-break is seeded
    alike for both."""
    demand = DEMANDS[demand]
    for seed in range(4):
        order = []
        for mod in (jsched, tsched):
            nodes = _nodes(seed)
            spec = types.SimpleNamespace(
                scheduling_strategy=_strategies(mod, nodes)[strategy],
                placement_group_id=None, resources=dict(demand))
            random.seed(seed)
            order.append([n.node_id for n in
                          mod.rank_nodes_for_actor(nodes, spec, None)])
        assert order[0] == order[1], seed


def test_resource_math_equal():
    rng = np.random.default_rng(0)
    for _ in range(50):
        total = {k: float(rng.integers(0, 8)) for k in ("CPU", "GPU", "mem")}
        avail = {k: float(rng.integers(0, int(v) + 1))
                 for k, v in total.items()}
        demand = {k: float(rng.integers(0, 3)) for k in ("CPU", "GPU")}
        assert tsched.fits(avail, demand) == jsched.fits(avail, demand)
        assert (tsched.utilization_score(total, avail, demand)
                == jsched.utilization_score(total, avail, demand))
        a, b = dict(avail), dict(avail)
        tsched.subtract(a, demand), jsched.subtract(b, demand)
        assert a == b
        tsched.add(a, demand), jsched.add(b, demand)
        assert a == b


# ---- placement groups: the same snapshots, the same plans --------------------

def _pg_plan(mod, nodes, bundles, strategy, by_capacity):
    gcs = types.SimpleNamespace(_nodes=nodes)
    mgr = mod.PlacementGroupManager(gcs)
    rec = mod.PlacementGroupRecord(b"pg", [dict(b) for b in bundles],
                                   strategy)
    return mgr._plan(rec, by_capacity=by_capacity)


BUNDLES = {
    "one_gpu": [{"GPU": 1.0, "CPU": 1.0}],
    "gpu_gang": [{"GPU": 1.0}] * 3,
    "mixed": [{"CPU": 2.0}, {"GPU": 2.0, "CPU": 1.0}, {"CPU": 1.0}],
    "too_big": [{"GPU": 8.0}],
}


@pytest.mark.parametrize("strategy", ["PACK", "SPREAD", "STRICT_PACK",
                                      "STRICT_SPREAD"])
@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_placement_group_plans_equal(strategy, name):
    """Over seeded snapshots, against availability and against total
    capacity."""
    bundles = BUNDLES[name]
    for seed in range(3):
        for by_capacity in (False, True):
            plans = [_pg_plan(mod, _nodes(seed), bundles, strategy,
                              by_capacity) for mod in (jpg, tpg)]
            assert plans[0] == plans[1], (seed, by_capacity)


# ---- serialization frames ------------------------------------------------------

VALUES = {
    "ndarray_large": lambda: np.arange(1 << 14, dtype=np.float64),
    "ndarray_small": lambda: np.arange(16, dtype=np.int32),
    "bytes_large": lambda: bytes(range(256)) * 128,
    "bytes_small": lambda: b"abc",
    "nested": lambda: {"a": [1, 2.5, "x"], "b": (np.ones((64, 64)),
                                                 b"\x00" * 20000),
                       "c": {"d": None, "e": True}},
    "ndarray_2d_int8": lambda: np.arange(1 << 15, dtype=np.int8).reshape(
        128, 256),
    "ndarray_bool": lambda: np.arange(1 << 15) % 3 == 0,
    "ndarray_noncontiguous": lambda: np.arange(1 << 16,
                                               dtype=np.float32)[::2],
    "ndarray_empty": lambda: np.zeros((0, 4), dtype=np.float32),
    "list_of_arrays": lambda: [np.full(5000, i, dtype=np.float32)
                               for i in range(3)],
    "text": lambda: "häst " * 1000,
    "scalars": lambda: (7, -1.5, None, True, 2 ** 70),
}


@pytest.mark.parametrize("name", sorted(VALUES))
def test_serialize_segments_equal(name):
    value = VALUES[name]()
    jseg, jtotal = jser.serialize(value)
    tseg, ttotal = tser.serialize(value)
    assert ttotal == jtotal
    tb = tser.join_segments(tseg)
    assert tb == jser.join_segments(jseg)
    back = tser.deserialize(tb)
    if isinstance(value, np.ndarray):
        assert back.dtype == value.dtype
        np.testing.assert_array_equal(back, value)
    elif name == "nested":
        assert back["a"] == value["a"] and back["c"] == value["c"]
        np.testing.assert_array_equal(back["b"][0], value["b"][0])
        assert back["b"][1] == value["b"][1]
    elif name == "list_of_arrays":
        for got, want in zip(back, value):
            np.testing.assert_array_equal(got, want)
    else:
        assert back == value


def _same_values():
    x = np.arange(2 * 3 * 40, dtype=np.float32).reshape(2, 3, 40) / 7.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32",
                                   "int8", "uint8", "bool"])
def test_cpu_tensor_frame_equals_jax_array_frame(dtype):
    """A CPU tensor's whole frame (header, dtype name, shape, payload)
    equals a jax array's of the same values through JAX's _FAST_DEVICE;
    each package reads the other's frame back to equal values."""
    x = (_same_values() * 3).astype(dtype)
    t, a = torch.from_numpy(x.copy()), jnp.asarray(x)
    tb = tser.join_segments(tser.serialize(t)[0])
    jb = jser.join_segments(jser.serialize(a)[0])
    assert tb == jb
    back = tser.deserialize(jb)
    assert back.dtype == getattr(torch, dtype) and torch.equal(back, t)
    jback = jser.deserialize(tb)
    assert str(jback.dtype) == dtype and bool((jback == a).all())


def test_bf16_tensor_payload_and_dtype_name_equal_jax():
    """bf16: the payload bytes and the dtype name equal JAX's _FAST_DEVICE
    view of a jax array of the same values, and JAX's rebuild of the port's
    bytes gives that array back. (JAX's own serialize of a bf16 array
    raises in `memoryview(host)`, a fault of the reference recorded in
    ROADMAP.md §3, so the frame is compared through its parts.)"""
    x = _same_values()
    t = torch.from_numpy(x.copy()).to(torch.bfloat16)
    a = jnp.asarray(x, dtype=jnp.bfloat16)
    host, dtype_name, shape, kind = tser._device_array_view(t)
    jhost, jdtype_name = jser._device_array_view(a)
    assert (dtype_name, shape, kind) == (jdtype_name, jhost.shape,
                                         jser._FAST_DEVICE)
    assert host.tobytes() == jhost.tobytes()
    jback = jser._device_from_raw(memoryview(host.tobytes()), dtype_name,
                                  shape, None)
    assert jback.dtype == jnp.bfloat16 and bool((jback == a).all())
    back = tser.deserialize(tser.join_segments(tser.serialize(t)[0]))
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_tensor_subclasses_and_views_take_the_right_path():
    """A non-contiguous view crosses as its values; an nn.Parameter (a
    subclass) takes the pickle path and keeps its type."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    view = x.t()
    back = tser.deserialize(tser.join_segments(tser.serialize(view)[0]))
    assert torch.equal(back, view) and back.is_contiguous()
    p = torch.nn.Parameter(torch.ones(3))
    assert tser._device_array_view(p) is None
    pback = tser.deserialize(tser.join_segments(tser.serialize(p)[0]))
    assert isinstance(pback, torch.nn.Parameter)
    assert torch.equal(pback.detach(), p.detach())
