"""The port's collective plane against the JAX package's, on the CPU.

Thread groups over an in-memory KV (as tests/test_collective.py builds
them), chunks pinned at 512 bytes so every op runs the multi-chunk path:
the port's TCPCommunicator gives JAX's results bit for bit on every op,
topology and dtype, and a group of two JAX ranks and two port ranks gives
the all-JAX result (the wire is one). The torch backend on gloo matches
the tcp backend (integers exactly, floats at 1e-6), completes its work in
submission order and unblocks a waiting rank on an abort.
`reduce_gradients` equals JAX's on a mixed-dtype tree cut into several
buckets per dtype.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.collective import cpu_group as tcg
from ray_tpu_torch.collective.communicator import REDUCE_OPS
from ray_tpu_torch.collective.torch_backend import TorchCommunicator
from ray_tpu_torch.core.exceptions import CollectiveAbortError

SETTINGS = {"collective_watchdog_interval_s": 0.1,
            "collective_op_timeout_s": 60.0,
            "collective_chunk_bytes": 512}


@pytest.fixture
def ring_cfg():
    """The same settings in both packages' config tables."""
    from ray_tpu import config as jconfig
    from ray_tpu_torch import config as tconfig

    for mod in (jconfig, tconfig):
        mod.reset_for_testing()
        mod.cfg().apply_overrides(SETTINGS)
    yield tconfig.cfg()
    for mod in (jconfig, tconfig):
        mod.reset_for_testing()


def _mem_kv():
    kv, lock = {}, threading.Lock()

    def put(key, value):
        with lock:
            kv[key] = value

    def get(key):
        with lock:
            return kv.get(key)

    return put, get


def _jax_tcp():
    from ray_tpu.collective.cpu_group import TCPCommunicator

    return TCPCommunicator


def _group(name, classes, kv=None, **kw):
    """One communicator per rank, rank r of class classes[r], all built
    at once (rendezvous blocks until every rank is in)."""
    put, get = kv or _mem_kv()
    n = len(classes)
    comms, errs = [None] * n, []

    def build(r):
        try:
            comms[r] = classes[r](r, n, name, put, get, timeout=30, **kw)
        except Exception as e:  # surfaced by the assert below
            errs.append(e)

    threads = [threading.Thread(target=build, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errs and all(comms), errs
    return comms


def _run(comms, fn):
    """fn(comm) on every rank at once; the results in rank order."""
    res = [None] * len(comms)

    def runner(r):
        try:
            res[r] = ("ok", fn(comms[r]))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            res[r] = ("err", e)

    threads = [threading.Thread(target=runner, args=(r,))
               for r in range(len(comms))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for r in res:
        assert r is not None, "rank thread hung"
        if r[0] == "err":
            raise r[1]
    return [r[1] for r in res]


def _close(*groups):
    for comms in groups:
        for c in comms:
            if c is not None:
                c.close()


def _bits(x):
    """A result as (dtype, shape, bytes), lists element by element."""
    if isinstance(x, (list, tuple)):
        return [_bits(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.ascontiguousarray(x)
    return (x.dtype.str, x.shape, x.tobytes())


def _make(rng, dtype, shape):
    if np.dtype(dtype).kind == "i":
        return rng.integers(-3, 4, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _inputs(dtype, world, seed=7):
    """Per rank: an odd 1-D array, an odd 2-D one and `world` shards."""
    rng = np.random.default_rng(seed)
    return [{"a": _make(rng, dtype, 1003), "b": _make(rng, dtype, (7, 13)),
             "shards": [_make(rng, dtype, 201) for _ in range(world)]}
            for _ in range(world)]


def _reduce_script(data):
    def script(c):
        d = data[c.rank]
        out = []
        for op in REDUCE_OPS:
            out += [c.allreduce(d["a"], op), c.allreduce(d["b"], op),
                    c.reducescatter(d["shards"], op)]
        return out
    return script


def _data_script(data):
    def script(c):
        d, w = data[c.rank], c.world_size
        out = [c.allgather(d["b"]),
               c.broadcast(d["a"] if c.rank == 1 else None, 1),
               c.alltoall(d["shards"])]
        c.send(d["b"], (c.rank + 1) % w)
        out.append(c.recv(None, None, (c.rank - 1) % w))
        c.barrier()
        return out
    return script


def _both(name, topology, script, world=4):
    """script on a port group and on a JAX group of `world` ranks."""
    port = _group(f"{name}-port", [tcg.TCPCommunicator] * world,
                  topology=topology)
    jax = _group(f"{name}-jax", [_jax_tcp()] * world, topology=topology)
    try:
        return _run(port, script), _run(jax, script)
    finally:
        _close(port, jax)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
@pytest.mark.parametrize("topology", ["ring", "hub"])
def test_reduce_ops_bitwise_equal_jax(ring_cfg, topology, dtype):
    """allreduce (1-D and 2-D odd shapes) and reducescatter under all five
    reduce ops: the port's results are JAX's bit for bit, dtype included
    (an integer mean is float64 in both)."""
    data = _inputs(np.dtype(dtype), 4)
    port, jax = _both("red", topology, _reduce_script(data))
    assert _bits(port) == _bits(jax)
    ref = np.stack([d["a"] for d in data]).sum(axis=0)
    np.testing.assert_allclose(port[0][0], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("topology", ["ring", "hub"])
def test_data_ops_bitwise_equal_jax(ring_cfg, topology):
    """allgather, a multi-chunk broadcast from rank 1, alltoall, a p2p
    ring of sends and receives and a barrier: JAX's results bit for bit,
    and the values they should be."""
    data = _inputs(np.float32, 4, seed=11)
    port, jax = _both("data", topology, _data_script(data))
    assert _bits(port) == _bits(jax)
    for r, out in enumerate(port):
        for j in range(4):
            np.testing.assert_array_equal(out[0][j], data[j]["b"])
            np.testing.assert_array_equal(out[2][j], data[j]["shards"][r])
        np.testing.assert_array_equal(out[1], data[1]["a"])
        np.testing.assert_array_equal(out[3], data[(r - 1) % 4]["b"])


@pytest.mark.parametrize("topology", ["ring", "hub"])
def test_async_fifo_and_world_one_equal_jax(ring_cfg, topology):
    """Async handles complete in submission order with increasing op ids
    and JAX's values; a world of one reduces and gathers locally."""
    def fifo(c):
        works = [c.allreduce_async(np.full(100, float(i) + c.rank), "sum")
                 for i in range(6)]
        works[-1].wait(30)
        assert all(w.done() for w in works)
        ids = [w.op_id for w in works]
        assert ids == sorted(ids) and len(set(ids)) == len(ids)
        return [w.wait(1) for w in works]

    port, jax = _both("fifo", topology, fifo, world=3)
    assert _bits(port) == _bits(jax)
    np.testing.assert_array_equal(port[0][2], np.full(100, 9.0))

    def solo(c):
        w = c.allreduce_async(np.ones(3), "mean")
        return [c.allreduce(np.arange(5.0), "sum"), w.wait(5),
                c.allgather(np.ones(2)), c.broadcast(np.arange(3), 0)]

    port, jax = _both("solo", topology, solo, world=1)
    assert _bits(port) == _bits(jax)


def test_ring_zero_pickle_steady_state(ring_cfg):
    """Once the p2p links are up, a ring allreduce moves only raw array
    frames (the port's counters, bumped where JAX bumps its serialization
    counters); the hub plane pickles every hop."""
    payload = np.ones(4096, np.float32)   # 16 KiB: 32 chunks of 512 B
    comms = _group("nopickle", [tcg.TCPCommunicator] * 4)
    try:
        _run(comms, lambda c: c.allreduce(payload, "sum"))   # links up
        before = dict(tcg.counters)
        for _ in range(3):
            _run(comms, lambda c: c.allreduce(payload, "sum"))
        delta = {k: tcg.counters[k] - before[k] for k in before}
    finally:
        _close(comms)
    assert delta["pickle"] == delta["deserialize_pickle"] == 0, delta
    assert delta["fast_ndarray"] > 0 and delta["deserialize_fast"] > 0
    hub = _group("hub-pickles", [tcg.TCPCommunicator] * 4, topology="hub")
    try:
        before = dict(tcg.counters)
        _run(hub, lambda c: c.allreduce(payload, "sum"))
        assert tcg.counters["pickle"] > before["pickle"]
    finally:
        _close(hub)


@pytest.mark.parametrize("topology", ["ring", "hub"])
def test_mixed_group_gives_the_all_jax_result(ring_cfg, topology):
    """Ranks 0 and 2 of the JAX package, 1 and 3 of the port, over one KV:
    every op gives the all-JAX group's result (control frames carry only
    ints, strings, tuples, lists and numpy arrays, which both unpickle)."""
    data = _inputs(np.float64, 4, seed=3)

    def script(c):
        return _reduce_script(data)(c) + _data_script(data)(c)

    J, P = _jax_tcp(), tcg.TCPCommunicator
    mixed = _group("mixed", [J, P, J, P], topology=topology)
    alljax = _group("alljax", [J] * 4, topology=topology)
    try:
        got, want = _run(mixed, script), _run(alljax, script)
    finally:
        _close(mixed, alljax)
    assert _bits(got) == _bits(want)


def test_tcp_backend_takes_tensors(ring_cfg):
    """CPU tensors through the tcp backend: results are tensors equal to
    the numpy path's; a bf16 tensor travels as float32 and comes back
    bf16; reduce_gradients' refusing sibling names the Train library."""
    from ray_tpu_torch.train import backend as tbackend

    data = _inputs(np.float32, 3, seed=5)
    comms = _group("tensors", [tcg.TCPCommunicator] * 3)
    try:
        got = _run(comms, lambda c: [
            c.allreduce(torch.from_numpy(data[c.rank]["a"]), "mean"),
            c.allgather(torch.from_numpy(data[c.rank]["b"])),
            c.allreduce(torch.from_numpy(data[c.rank]["a"]).bfloat16())])
        want = _run(comms, lambda c: [
            c.allreduce(data[c.rank]["a"], "mean"),
            c.allgather(data[c.rank]["b"]),
            c.allreduce(torch.from_numpy(data[c.rank]["a"]).bfloat16()
                        .float().numpy())])
    finally:
        _close(comms)
    for g, w in zip(got, want):
        assert isinstance(g[0], torch.Tensor) and g[2].dtype == torch.bfloat16
        assert _bits(g[:2]) == _bits(w[:2])
        assert torch.equal(g[2], torch.from_numpy(w[2]).bfloat16())
    with pytest.raises(ValueError, match="7e"):
        tbackend.allreduce_gradients({"w": np.ones(2)})


# ---------------------------------------------------------------- torch


def _close_enough(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_enough(g, w)
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.dtype == want.dtype and g.shape == want.shape
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(g, want)
    else:
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_torch_backend_on_gloo_matches_tcp(ring_cfg, world):
    """Every op of the torch backend on CPU tensors (gloo) against the tcp
    backend on the same arrays: integer results equal, float ones within
    1e-6, dtypes equal (an integer mean is float64 in both)."""
    cases = {dt: _inputs(np.dtype(dt), world, seed=world)
             for dt in ("float32", "float64", "int64")}
    T = torch.from_numpy

    def torch_script(c):
        out = []
        for data in cases.values():
            d = data[c.rank]
            for op in REDUCE_OPS:
                out += [c.allreduce(T(d["a"]), op),
                        c.reducescatter([T(s) for s in d["shards"]], op)]
        d = cases["float32"][c.rank]
        out += [c.allgather(T(d["b"])),
                c.broadcast(T(d["a"]) if c.rank == 1
                            else torch.zeros(1003), 1),
                c.alltoall([T(s) for s in d["shards"]])]
        # A gloo send returns once received (torch.distributed's send):
        # even ranks send first.
        for turn in (c.rank % 2, 1 - c.rank % 2):
            if turn == 0:
                c.send(T(d["b"]), (c.rank + 1) % world)
            else:
                out.append(c.recv((7, 13), torch.float32,
                                  (c.rank - 1) % world, device="cpu"))
        c.barrier()
        return out

    def tcp_script(c):
        out = []
        for data in cases.values():
            d = data[c.rank]
            for op in REDUCE_OPS:
                out += [c.allreduce(d["a"], op),
                        c.reducescatter(d["shards"], op)]
        d = cases["float32"][c.rank]
        out += [c.allgather(d["b"]),
                c.broadcast(d["a"] if c.rank == 1 else None, 1),
                c.alltoall(d["shards"])]
        c.send(d["b"], (c.rank + 1) % world)
        out.append(c.recv(None, None, (c.rank - 1) % world))
        c.barrier()
        return out

    tor = _group("gloo-ops", [TorchCommunicator] * world)
    tcp = _group("tcp-ops", [tcg.TCPCommunicator] * world)
    try:
        got, want = _run(tor, torch_script), _run(tcp, tcp_script)
    finally:
        _close(tor, tcp)
    for g, w in zip(got, want):
        _close_enough(g, w)


def test_torch_backend_fifo_and_abort(ring_cfg):
    """gloo work completes in submission order; with one rank withheld
    from an allreduce, an abort from that rank unblocks every waiting
    rank with CollectiveAbortError within two watchdog intervals and a
    margin; later ops on the aborted group raise at once."""
    ring_cfg.apply_overrides({"collective_op_timeout_s": 10.0})
    comms = _group("gloo-fifo", [TorchCommunicator] * 3)
    try:
        def fifo(c):
            works = [c.allreduce_async(torch.full((100,), float(i)), "sum")
                     for i in range(6)]
            works[-1].wait(30)
            assert all(w.done() for w in works)
            assert [w.op_id for w in works] == sorted(
                w.op_id for w in works)
            return [w.wait(1) for w in works]

        for res in _run(comms, fifo):
            for i, t in enumerate(res):
                assert torch.equal(t, torch.full((100,), 3.0 * i))

        interval = ring_cfg.collective_watchdog_interval_s

        def withheld(c):
            if c.rank == 0:
                time.sleep(0.3)
                t0 = time.monotonic()
                c.abort("withheld rank gives up")
                return t0
            try:
                c.allreduce(torch.ones(4))
            except CollectiveAbortError as e:
                assert "withheld rank gives up" in str(e)
                return time.monotonic()
            raise AssertionError("allreduce returned with a rank withheld")

        t_abort, *t_raised = _run(comms, withheld)
        assert all(t - t_abort < 2 * interval + 0.5 for t in t_raised), (
            t_abort, t_raised)
        with pytest.raises(CollectiveAbortError):
            comms[1].allreduce(torch.ones(4))
    finally:
        _close(comms)


# ---------------------------------------------------------------- DDP


def _grad_tree(rank):
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.standard_normal((37, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "h": rng.standard_normal(300),
            "n": rng.integers(-50, 50, 9),
            "z": [rng.standard_normal(1000).astype(np.float32),
                  rng.standard_normal((4, 30))]}


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


@pytest.mark.parametrize("form", ["tcp-numpy", "tcp-tensors", "gloo"])
def test_reduce_gradients_equal_jax(ring_cfg, form):
    """A mixed-dtype tree (f32, f64, i64) at a bucket size of 256 bytes,
    several buckets per dtype: the port's reduce_gradients gives JAX's
    leaves in JAX's dtypes and tree places (bit for bit over the tcp
    ring, within 1e-6 over gloo; integers exactly)."""
    from ray_tpu.train.backend import reduce_gradients as jreduce

    from ray_tpu_torch.train.backend import reduce_gradients

    trees = [_grad_tree(r) for r in range(3)]
    jax = _group("ddp-jax", [_jax_tcp()] * 3)
    cls = TorchCommunicator if form == "gloo" else tcg.TCPCommunicator
    port = _group(f"ddp-{form}", [cls] * 3)
    as_tensors = form != "tcp-numpy"

    def port_script(c):
        tree = trees[c.rank]
        if as_tensors:
            tree = {k: ([torch.from_numpy(x) for x in v]
                        if isinstance(v, list) else torch.from_numpy(v))
                    for k, v in tree.items()}
        return reduce_gradients(c, tree, bucket_bytes=256)

    try:
        want = _run(jax, lambda c: jreduce(c, trees[c.rank],
                                           bucket_bytes=256))
        got = _run(port, port_script)
    finally:
        _close(jax, port)
    for g, w in zip(got, want):
        assert isinstance(g["z"], list) and len(g["z"]) == 2
        gl = [x.numpy() if isinstance(x, torch.Tensor) else x
              for x in _tree_leaves(g)]
        wl = [np.asarray(x) for x in _tree_leaves(w)]
        if form == "gloo":
            _close_enough(gl, wl)
        else:
            assert _bits(gl) == _bits(wl)
    mean_w = np.mean([t["w"] for t in trees], axis=0)
    np.testing.assert_allclose(np.asarray(got[0]["w"]), mean_w, rtol=1e-5)


# ---------------------------------------------------------------- knobs


@pytest.mark.parametrize("name", [
    "collective_watchdog_interval_s", "collective_peer_miss_threshold",
    "collective_op_timeout_s", "collective_topology",
    "collective_chunk_bytes", "ddp_bucket_bytes", "broadcast_fanout",
    "ckpt_replicate", "ckpt_replicate_timeout_s"])
def test_config_knob_equals_jax(name):
    """The collective and replication knobs are the JAX config's own:
    same name, type and default."""
    from ray_tpu import config as jconfig
    from ray_tpu_torch import config as tconfig

    assert tconfig._DEFS[name][:2] == jconfig._DEFS[name][:2]


@pytest.mark.parametrize("chunk", [64, 4096])
@pytest.mark.parametrize("world", [2, 3, 5])
def test_ring_allreduce_bitwise_equal_jax_at(ring_cfg, world, chunk):
    """Ring allreduce (sum and mean) and allgather of odd sizes at other
    world sizes and chunk sizes: JAX's results bit for bit."""
    rng = np.random.default_rng(world * chunk)
    data = [rng.standard_normal(777).astype(np.float32)
            for _ in range(world)]

    def script(c):
        return [c.allreduce(data[c.rank], "sum"),
                c.allreduce(data[c.rank], "mean"),
                c.allgather(data[c.rank][:13])]

    port = _group(f"w{world}-port", [tcg.TCPCommunicator] * world,
                  chunk_bytes=chunk)
    jax = _group(f"w{world}-jax", [_jax_tcp()] * world, chunk_bytes=chunk)
    try:
        got, want = _run(port, script), _run(jax, script)
    finally:
        _close(port, jax)
    assert _bits(got) == _bits(want)


def _errors(cls):
    """The error each misuse raises, as (type name, message)."""
    out = []
    comms = _group("err", [cls] * 2)
    cases = [lambda c: c.allreduce(np.ones(3), "median"),
             lambda c: c.reducescatter([np.ones(2)] * 3),
             lambda c: c.alltoall([np.ones(2)] * 3)]
    try:
        for case in cases:
            res = _run(comms, lambda c: _caught(case, c))
            out.append(res[0])
        _close(comms)
        out.append(_caught(lambda c: c.allreduce(np.ones(2)), comms[0]))
    finally:
        _close(comms)
    try:
        cls(0, 1, "bad-topology", *_mem_kv(), topology="star")
    except ValueError as e:
        out.append(("ValueError", str(e)))
    return out


def _caught(fn, c):
    try:
        fn(c)
    except Exception as e:  # noqa: BLE001 - the error is the result
        return (type(e).__name__, str(e))
    return None


def test_misuse_raises_as_jax(ring_cfg):
    """An unknown reduce op, a reducescatter or alltoall with the wrong
    shard count, an op on a closed group and an unknown topology raise
    JAX's errors with JAX's messages."""
    assert _errors(tcg.TCPCommunicator) == _errors(_jax_tcp())


def test_abort_error_is_jax_s_and_pickles():
    """CollectiveAbortError carries the group and reason like JAX's and
    survives a pickle round trip (it crosses the runtime's wire)."""
    import pickle

    from ray_tpu.core.exceptions import CollectiveAbortError as J

    e = pickle.loads(pickle.dumps(CollectiveAbortError("g", "why")))
    assert (e.group_name, e.reason, str(e)) == ("g", "why",
                                                str(J("g", "why")))


@pytest.mark.parametrize("topology", ["ring", "hub"])
def test_collective_metric_bumps_equal_jax(ring_cfg, topology):
    """The collective series (ops, bytes sent and received by op and
    algorithm) move as JAX's do on the same ops."""
    from ray_tpu.runtime import metric_defs as jmd

    from ray_tpu_torch.runtime import metric_defs as tmd

    def counts(md):
        return {m.info["name"]: dict(m.snapshot()["values"])
                for m in (md.COLLECTIVE_OPS, md.COLLECTIVE_BYTES_SENT,
                          md.COLLECTIVE_BYTES_RECV)}

    def delta(before, after):
        return {n: {k: v - before[n].get(k, 0) for k, v in vals.items()
                    if v != before[n].get(k, 0)}
                for n, vals in after.items()}

    data = _inputs(np.float32, 3, seed=9)

    def script(c):
        return [c.allreduce(data[c.rank]["a"]), c.allgather(data[c.rank]["b"]),
                c.broadcast(data[c.rank]["a"] if c.rank == 0 else None, 0),
                c.reducescatter(data[c.rank]["shards"]),
                c.alltoall(data[c.rank]["shards"])]

    got = []
    for md, cls in ((tmd, tcg.TCPCommunicator), (jmd, _jax_tcp())):
        comms = _group(f"metrics-{md.__name__}", [cls] * 3,
                       topology=topology)
        try:
            _run(comms, script)   # links up
            before = counts(md)
            _run(comms, script)
            got.append(delta(before, counts(md)))
        finally:
            _close(comms)
    assert got[0] == got[1] and got[0]["ray_tpu_collective_ops_total"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_dead_peer_aborts_the_group(ring_cfg, package):
    """A rank whose process is gone (its watchdog stops beating) while
    the others wait in an allreduce: after the miss threshold of stale
    beats the waiting ranks raise CollectiveAbortError naming the lost
    peer, in either package."""
    cls = tcg.TCPCommunicator if package == "port" else _jax_tcp()
    comms = _group(f"dead-{package}", [cls] * 3)
    try:
        comms[2]._watchdog.stop()   # rank 2 stops beating and never joins
        t0 = time.monotonic()

        def wait(c):
            if c.rank == 2:
                return None
            try:
                c.allreduce(np.ones(8))
            except Exception as e:  # noqa: BLE001 - checked below
                return type(e).__name__, str(e), time.monotonic() - t0
            return "returned"

        res = _run(comms, wait)
    finally:
        _close(comms)
    for name, msg, seconds in res[:2]:
        assert name == "CollectiveAbortError" and "peer rank 2 lost" in msg
        assert seconds < 10, seconds
