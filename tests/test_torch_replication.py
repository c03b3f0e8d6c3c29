"""Checkpoint shard replication and the collective group on the port's
runtime, against the JAX package.

The GCS's checkpoint shard registry runs in each package's GcsServer on
the same calls (rows and homes equal). One multi-node port cluster
(`ray_tpu_torch.cluster_utils.Cluster`, three nodes on this host) serves
the module: three CPU actors form a tcp collective group and the driver
aborts it from outside; `broadcast_object` puts an object in every
node's store; a replicated save at world 2 registers rows equal to the
JAX GCS's rows for the same registrations, each replica homed on a peer
node, and the state restores bit for bit from the replicas' bytes once
the shard files are gone. No JAX cluster starts; every get and wait is
bounded under 60 s; the cluster is torn down (SIGKILL of the session,
store files unlinked) however the module ends.
"""

import asyncio
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.checkpoint import CheckpointPlane, restore_tree
from ray_tpu_torch.checkpoint import manifest as tman
from ray_tpu_torch.runtime.gcs import server as tgcs


def _gcs_with_nodes(pkg, node_ids, draining=(), dead=()):
    """A GcsServer of `pkg` (not started) whose node table holds
    `node_ids`."""
    if pkg == "jax":
        from ray_tpu.runtime.gcs import server as mod
    else:
        mod = tgcs
    srv = mod.GcsServer()
    for i, nid in enumerate(node_ids):
        rec = mod.NodeRecord(nid, ("127.0.0.1", 1000 + i), {"CPU": 1.0},
                             f"/dev/shm/store_{i}", i == 0, {})
        rec.draining = nid in draining
        rec.alive = nid not in dead
        srv._nodes[nid] = rec
    return srv


def _call(srv, method, **kw):
    return asyncio.run(getattr(srv, f"handle_{method}")(None, **kw))


def _registry_script(pkg):
    """Registrations as checkpoint/plane.py makes them: the writer's
    replica homed on the first live, non-draining peer (the writer itself
    when it is alone), rows listed by path and sorted, locate_object on
    each replica."""
    nodes = [bytes([i]) * 20 for i in range(4)]
    srv = _gcs_with_nodes(pkg, nodes, draining={nodes[1]},
                          dead={nodes[2]})
    out = []
    for shard, (writer, step) in enumerate([(nodes[0], 3), (nodes[3], 3),
                                            (nodes[0], None)]):
        reply = _call(srv, "register_checkpoint_shards",
                      path="/ck/a" if shard < 2 else "/ck/b", name="state",
                      shard=shard % 2, world=2, step=step,
                      nbytes=100 + shard, oids=[bytes([9, shard]) * 10],
                      node_id=writer)
        out.append(reply)
    for path in ("/ck/a", "/ck/b", None):
        rows = _call(srv, "list_checkpoint_shards", path=path)
        out.append([{k: v for k, v in r.items() if k != "time"}
                    for r in rows])
    for shard in range(3):
        out.append(_call(srv, "locate_object", oid=bytes([9, shard]) * 10))
    return out


def test_gcs_shard_registry_equals_jax():
    """register_checkpoint_shards / list_checkpoint_shards /
    locate_object on each package's GCS give equal replies; neither
    handler is a refusal any more."""
    assert not {"register_checkpoint_shards", "list_checkpoint_shards"} & \
        set(tgcs.UNPORTED_HANDLERS)
    port, jax = _registry_script("port"), _registry_script("jax")
    assert port == jax
    assert port[0]["home"] == (bytes([3]) * 20).hex()   # not the writer
    assert len(port[5]) == 3 and port[6]["found"]


def test_failed_replication_never_fails_the_save(tmp_path, monkeypatch):
    """Replication under cfg().ckpt_replicate whose put raises: the save
    commits, the handle has no replica, and nothing is registered."""
    from ray_tpu_torch import config as tconfig
    from ray_tpu_torch.core import api

    def refuse(value):
        raise RuntimeError("store full")

    tconfig.reset_for_testing()
    tconfig.cfg().apply_overrides({"ckpt_replicate": True})
    monkeypatch.setattr(api, "is_initialized", lambda: True)
    monkeypatch.setattr(api, "put", refuse)
    try:
        plane = CheckpointPlane()
        p = plane.save_async({"w": torch.arange(6.0)}, str(tmp_path),
                             step=1)
        assert p.wait(30) and p.ok and p.committed, p.info()
        assert p.replica is None and not plane._replica_refs
        plane.close()
    finally:
        tconfig.reset_for_testing()


# ------------------------------------------------------------- the cluster


@pytest.fixture(scope="module")
def cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    settings = {"collective_watchdog_interval_s": 0.25}
    c = Cluster(system_config=settings)
    try:
        for i in range(3):
            c.add_node(num_cpus=3 if i == 0 else 1,
                       object_store_memory=64 << 20)
        rt.init(address=c.address, _system_config=settings)
        c.wait_for_nodes(3, timeout=30)
        yield c
    finally:
        try:
            rt.shutdown()
        finally:
            c.shutdown()


def test_actor_group_and_abort_from_the_driver(cluster):
    """Three CPU actors form a tcp group through the GCS KV and allreduce;
    with the three blocked in an allreduce that one rank never joins,
    `abort_collective_group` from the driver (no member) unblocks them
    with CollectiveAbortError within two watchdog intervals and a
    margin."""
    from ray_tpu_torch import collective as col

    @rt.remote(num_cpus=0.5)
    class Rank:
        def join(self, world, rank, name):
            from ray_tpu_torch import collective as c

            c.init_collective_group(world, rank, "tcp", name)
            return c.allreduce(np.full(5, float(rank)), name, "sum")

        def blocked(self, name):
            from ray_tpu_torch import collective as c

            try:
                c.allreduce(np.ones(3), name)
            except c.CollectiveAbortError as e:
                return time.time(), str(e)
            return None, "returned"

    ranks = [Rank.remote() for _ in range(3)]
    got = rt.get([r.join.remote(3, i, "pg-a") for i, r in
                  enumerate(ranks)], timeout=60)
    for g in got:
        np.testing.assert_array_equal(g, np.full(5, 3.0))
    waits = [r.blocked.remote("pg-a") for r in ranks[1:]]
    ready, _ = rt.wait(waits, num_returns=1, timeout=1.0)
    assert not ready
    t_abort = time.time()
    col.abort_collective_group("pg-a", "driver stops the group")
    for t, msg in rt.get(waits, timeout=60):
        assert t is not None and "driver stops the group" in msg, msg
        assert t - t_abort < 2 * 0.25 + 1.0, t - t_abort
    for r in ranks:
        rt.kill(r)


def test_broadcast_object_reaches_every_node(cluster):
    """broadcast_object relays a 1 MiB object through the raylets' fanout
    tree: every node's store then holds it, byte for byte."""
    from ray_tpu_torch.runtime.object_store.store import ObjectStore
    from ray_tpu_torch.util.broadcast import broadcast_object

    data = np.random.default_rng(4).integers(0, 255, 1 << 20, np.uint8)
    ref = rt.put(data)
    assert broadcast_object(ref, timeout=30) == 2
    for node in cluster.nodes:
        store = ObjectStore(node.store_path, create=False)
        assert store.contains(ref.binary()), node.node_id.hex()
    assert broadcast_object(ref, timeout=30) == 2   # idempotent relay
    np.testing.assert_array_equal(rt.get(ref, timeout=30), data)


def test_replicated_save_registers_rows_as_jax_and_restores(cluster,
                                                           tmp_path):
    """Two ranks' replicated saves (world 2) register two rows whose
    fields and values equal the JAX GCS's rows for the same registrations,
    each replica homed on a live peer of the writer; with the shard files
    deleted, the state restores bit for bit from the replicas' bytes."""
    from ray_tpu_torch.core import worker as worker_mod

    core = worker_mod.global_worker()
    rng = np.random.default_rng(21)
    tree = {"w": torch.from_numpy(rng.standard_normal((64, 32)).astype(
                np.float32)),
            "h": torch.from_numpy(rng.standard_normal(48)).bfloat16(),
            "n": torch.arange(10)}
    d = str(tmp_path / "ck")
    plane = CheckpointPlane(replicate=True)
    pend = [plane.save_async(tree, d, rank=r, world=2, step=5)
            for r in range(2)]
    for p in pend:
        assert p.wait(30) and p.ok, p.info()
        assert p.replica is not None and p.replica["nodes"] == 2
    assert pend[0].committed
    rows = core.io.run(core.gcs.call("list_checkpoint_shards", path=d),
                       timeout=30)
    assert [r["shard"] for r in rows] == [0, 1]
    for r, p in zip(rows, pend):
        npz = os.path.join(d, tman.shard_npz("state", r["shard"], 2))
        assert r["nbytes"] == os.path.getsize(npz) == p.replica["bytes"]
        assert r["oids"] == [p.replica["oid"]]
        assert r["node_id"] == core.node_id.hex() and r["step"] == 5

    # The same registrations on a JAX GCS with this cluster's node table.
    node_ids = [n["node_id"] for n in rt.nodes()]
    jsrv = _gcs_with_nodes("jax", node_ids)
    homes = []
    for r in rows:
        _call(jsrv, "register_checkpoint_shards", path=r["path"],
              name=r["name"], shard=r["shard"], world=r["world"],
              step=r["step"], nbytes=r["nbytes"],
              oids=[bytes.fromhex(o) for o in r["oids"]],
              node_id=bytes.fromhex(r["node_id"]))
        loc = core.io.run(core.gcs.call(
            "locate_object", oid=bytes.fromhex(r["oids"][0])), timeout=30)
        jloc = _call(jsrv, "locate_object",
                     oid=bytes.fromhex(r["oids"][0]))
        assert loc["found"] and loc["node_id"] != core.node_id, loc
        assert loc["node_id"] == jloc["node_id"]
        homes.append(loc["node_id"])
    jrows = _call(jsrv, "list_checkpoint_shards", path=d)
    drop = lambda rs: [{k: v for k, v in x.items() if k != "time"}  # noqa
                       for x in rs]
    assert drop(rows) == drop(jrows)

    # Restore from the replicas' bytes alone.
    by_oid = {ref.binary().hex(): ref for ref in plane._replica_refs}
    for r in rows:
        npz = os.path.join(d, tman.shard_npz("state", r["shard"], 2))
        os.remove(npz)
    for r in rows:
        data = rt.get(by_oid[r["oids"][0]], timeout=30)
        with open(os.path.join(d, tman.shard_npz("state", r["shard"], 2)),
                  "wb") as f:
            f.write(np.asarray(data, np.uint8).tobytes())
    back = restore_tree(d)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert torch.equal(back[k].reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8)), k
    plane.close()
