"""The port's sharded checkpoints against the JAX package's
`ray-tpu-ckpt-v1` (ray_tpu/checkpoint/, ray_tpu/train/checkpoint.py).

Both directions on the same numpy trees: files the port writes are read
by the JAX package's restore (its bf16 restore is at fault, so those
trees hold no bf16 leaf), files JAX writes are read by the port bit for
bit, bf16 included; the npz entries and JSON tables are compared byte by
byte. The ranks of a world > 1 write their shards one after another in
this process, as the JAX package's own tests do. The mesh case trains on
a spawned world of 4 gloo ranks, saves, and resumes on a world of 2 and
on one rank without a mesh.
"""

from __future__ import annotations

import concurrent.futures
import os
import pickle
import zipfile

import numpy as np
import pytest
import torch

import torch_ranks
from ray_tpu_torch import checkpoint as tck
from ray_tpu_torch.checkpoint import manifest as tman
from ray_tpu_torch.parallel.launch import spawn
from ray_tpu_torch.train import checkpoint as ttc

LR = 1e-4


def _tree(seed=0, bf16=True):
    """A nested tree with every leaf kind the formats meet: fp32 and int32
    arrays (leading dims that do and do not split over 2 and 4), a list,
    a Python int, and optionally a bf16 array."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((8, 3)).astype(np.float32),
            "b": {"ids": rng.integers(-5, 5, (4,)).astype(np.int32),
                  "odd": rng.standard_normal((3, 2)).astype(np.float32),
                  "list": [rng.standard_normal((2,)).astype(np.float32),
                           7]},
            "count": 3}
    if bf16:
        tree["h"] = rng.standard_normal((4, 6)).astype(np.float32)
    return tree


def _jax_tree(tree):
    """The same tree as JAX leaves ("h" in bf16)."""
    import jax.numpy as jnp

    def conv(path, a):
        if isinstance(a, int):
            return a
        return jnp.asarray(a, jnp.bfloat16 if path == "h" else None)

    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return conv(path, node)

    return walk(tree)


def _port_tree(tree):
    """The same tree as port leaves: tensors ("h" in bf16), ints as they
    are."""
    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        if isinstance(node, int):
            return node
        t = torch.from_numpy(node.copy())
        return t.to(torch.bfloat16) if path == "h" else t

    return walk(tree)


def _save_all(save, tree, directory, world, step=None):
    for rank in reversed(range(world)):    # the last writer commits
        save(tree, directory, rank=rank, world=world, step=step)


def _bits(x):
    """A leaf as comparable host bits: bf16 tensors and ml_dtypes arrays as
    uint16, everything else as a numpy array."""
    if isinstance(x, torch.Tensor):
        return tman.host_array(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same(got, want):
    got_flat = tman.flatten_with_paths(got)
    want_flat = tman.flatten_with_paths(want)
    assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
    for (path, g), (_, w) in zip(got_flat, want_flat):
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _npz_entries(path):
    with zipfile.ZipFile(path) as z:
        return {i.filename: z.read(i.filename) for i in z.infolist()}


# ---------------------------------------------------------------- records

def test_leaf_order_and_records_equal_jax(cpu_jax):
    from ray_tpu.checkpoint import manifest as jman

    tree = _tree()
    records, _ = tman.leaf_records(_port_tree(tree), 2)
    want, _ = jman.leaf_records(_jax_tree(tree), 2)
    assert records == want
    assert [tman.path_str(r["path"]) for r in records] == [
        "b/ids", "b/list/0", "b/list/1", "b/odd", "count", "h", "w"]
    for shape in [(), (1,), (3, 2), (4, 5), (8,), (6, 1)]:
        for world in (1, 2, 3, 4):
            assert tman.shard_axis_for(shape, world) == \
                jman.shard_axis_for(shape, world)


# ---------------------------------------------------------------- port -> JAX

@pytest.mark.parametrize("world", [1, 2, 4])
def test_port_checkpoint_restores_in_jax(cpu_jax, tmp_path, world):
    """The port writes (no bf16: JAX's own restore refuses it), JAX's
    restore_tree reads the whole tree and restore_shard each rank's slice
    at 1, 2 and 4 ranks."""
    from ray_tpu.checkpoint import restore_shard, restore_tree

    tree = _tree(world, bf16=False)
    _save_all(tck.save_sharded, _port_tree(tree), str(tmp_path), world,
              step=5)
    _assert_same(restore_tree(str(tmp_path)), tree)
    for m in (1, 2, 4):
        for rank in range(m):
            got = restore_shard(str(tmp_path), rank=rank, world=m)
            want = tck.restore_shard(str(tmp_path), rank=rank, world=m)
            _assert_same(got, want)
    assert tck.read_manifest(str(tmp_path))["step"] == 5


@pytest.mark.parametrize("n,m", [(4, 2), (2, 4), (4, 1), (1, 4)])
def test_reshard_on_restore_across_packages(cpu_jax, tmp_path, n, m):
    """N -> M: a checkpoint of N ranks from either package gives each of M
    ranks the same slice in both packages."""
    from ray_tpu.checkpoint import restore_shard as jrestore_shard
    from ray_tpu.checkpoint import save_sharded as jsave

    tree = _tree(10 + n, bf16=False)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _save_all(tck.save_sharded, _port_tree(tree), port_dir, n)
    _save_all(jsave, _jax_tree(tree), jax_dir, n)
    for rank in range(m):
        want = jrestore_shard(jax_dir, rank=rank, world=m)
        _assert_same(jrestore_shard(port_dir, rank=rank, world=m), want)
        _assert_same(tck.restore_shard(jax_dir, rank=rank, world=m), want)


# ---------------------------------------------------------------- JAX -> port

@pytest.mark.parametrize("world", [1, 2, 4])
def test_jax_checkpoint_restores_in_port_bit_for_bit(cpu_jax, tmp_path,
                                                     world):
    """JAX writes, bf16 included; the port reads every leaf back bit for
    bit (bf16 from its 2-byte values), whole and per rank."""
    from ray_tpu.checkpoint import save_sharded as jsave

    tree = _tree(20 + world)
    jtree = _jax_tree(tree)
    _save_all(jsave, jtree, str(tmp_path), world)
    got = tck.restore_tree(str(tmp_path))
    _assert_same(got, jtree)
    assert got["h"].dtype == torch.bfloat16
    for rank in range(world):
        part = tck.restore_shard(str(tmp_path), rank=rank, world=world)
        per = 8 // world
        np.testing.assert_array_equal(part["w"].numpy(),
                                      tree["w"][rank * per:(rank + 1) * per])


# ---------------------------------------------------------------- bytes

@pytest.mark.parametrize("world", [1, 2, 4])
def test_files_equal_jax_byte_for_byte(cpu_jax, tmp_path, world):
    """Every shard's npz entries (bf16 '<V2' entries included), whole npz
    file, shard JSON and the manifest JSON: the same bytes from both
    packages."""
    from ray_tpu.checkpoint import save_sharded as jsave

    tree = _tree(30 + world)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    _save_all(tck.save_sharded, _port_tree(tree), str(port_dir), world,
              step=9)
    _save_all(jsave, _jax_tree(tree), str(jax_dir), world, step=9)
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in names:
        got, want = (port_dir / name).read_bytes(), (jax_dir / name).read_bytes()
        if name.endswith(".npz"):
            entries = _npz_entries(jax_dir / name)
            assert _npz_entries(port_dir / name) == entries
            if name.startswith("state-shard-00000"):
                assert b"'descr': '<V2'" in b"".join(entries.values())
        assert got == want, name


DTYPES = ["float32", "float64", "float16", "bfloat16", "int8", "int16",
          "int32", "int64", "uint8", "bool"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_leaf_dtype_round_trips_with_jax(cpu_jax, tmp_path, dtype):
    """A leaf of each dtype the port stores: the same npz entry bytes and
    tables as JAX's at world 2, read back by the port bit for bit from
    JAX's files and by JAX from the port's (bf16 excepted: the JAX
    package's own restore refuses it)."""
    import jax.numpy as jnp

    from ray_tpu.checkpoint import restore_tree
    from ray_tpu.checkpoint import save_sharded as jsave

    rng = np.random.default_rng(DTYPES.index(dtype))
    host = (np.abs(rng.standard_normal((4, 5))) * 50).astype(np.float32)
    tleaf = torch.from_numpy(host).to(getattr(torch, dtype))
    # JAX's side as numpy leaves (jax without x64 holds no 64-bit arrays;
    # its save takes numpy as it is), bf16 as an ml_dtypes array.
    jleaf = (np.asarray(jnp.asarray(host, jnp.bfloat16))
             if dtype == "bfloat16" else tleaf.numpy())
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    _save_all(tck.save_sharded, {"x": tleaf, "y": [tleaf[:3]]},
              str(port_dir), 2)
    _save_all(jsave, {"x": jleaf, "y": [jleaf[:3]]}, str(jax_dir), 2)
    for name in sorted(os.listdir(jax_dir)):
        if name.endswith(".npz"):
            assert _npz_entries(port_dir / name) == \
                _npz_entries(jax_dir / name)
        else:
            assert (port_dir / name).read_bytes() == \
                (jax_dir / name).read_bytes()
    got = tck.restore_tree(str(jax_dir))
    assert got["x"].dtype == tleaf.dtype
    assert torch.equal(got["x"], tleaf) and torch.equal(got["y"][0],
                                                        tleaf[:3])
    if dtype != "bfloat16":
        _assert_same(restore_tree(str(port_dir)),
                     {"x": jleaf, "y": [jleaf[:3]]})


# ---------------------------------------------------------------- failures

def test_missing_shard_is_not_committed_in_both(cpu_jax, tmp_path):
    from ray_tpu.checkpoint import CheckpointNotCommitted as JNotCommitted
    from ray_tpu.checkpoint import has_manifest, restore_tree
    from ray_tpu.checkpoint import save_sharded as jsave

    tree = _tree(40, bf16=False)
    port = tck.save_sharded(_port_tree(tree), str(tmp_path / "p"), rank=0,
                            world=2)
    jax = jsave(_jax_tree(tree), str(tmp_path / "j"), rank=0, world=2)
    assert port["committed"] is jax["committed"] is False
    for d in ("p", "j"):
        assert not tck.has_manifest(str(tmp_path / d))
        assert not has_manifest(str(tmp_path / d))
        with pytest.raises(tck.CheckpointNotCommitted, match="no committed"):
            tck.restore_tree(str(tmp_path / d))
        with pytest.raises(JNotCommitted):
            restore_tree(str(tmp_path / d))
    # The last shard commits, and a second commit is refused (None).
    assert tck.save_sharded(_port_tree(tree), str(tmp_path / "p"), rank=1,
                            world=2)["committed"]
    assert tman.try_commit(str(tmp_path / "p"), "state", 2) is None
    _assert_same(tck.restore_tree(str(tmp_path / "p")), tree)


def test_disagreeing_tables_and_lost_shard_raise(cpu_jax, tmp_path):
    from ray_tpu.checkpoint import CheckpointError as JError
    from ray_tpu.checkpoint import restore_tree
    from ray_tpu.checkpoint import save_sharded as jsave

    tree, other = _tree(50, bf16=False), _tree(51, bf16=False)
    other["extra"] = np.zeros(2, np.float32)
    tck.save_sharded(_port_tree(tree), str(tmp_path / "p"), rank=0, world=2)
    with pytest.raises(tck.CheckpointError, match="disagree"):
        tck.save_sharded(_port_tree(other), str(tmp_path / "p"), rank=1,
                         world=2)
    jsave(_jax_tree(tree), str(tmp_path / "j"), rank=0, world=2)
    with pytest.raises(JError, match="disagree"):
        jsave(_jax_tree(other), str(tmp_path / "j"), rank=1, world=2)
    # A committed checkpoint whose shard file went missing.
    _save_all(tck.save_sharded, _port_tree(tree), str(tmp_path / "q"), 2)
    os.remove(tmp_path / "q" / tman.shard_npz("state", 1, 2))
    with pytest.raises(tck.CheckpointError, match="shard file missing"):
        tck.restore_tree(str(tmp_path / "q"))
    with pytest.raises(JError, match="shard file missing"):
        restore_tree(str(tmp_path / "q"))


def test_legacy_layout_refused_and_replication_unported(cpu_jax, tmp_path):
    """The JAX package's retired layout (pickled treedef) needs jax: the
    port names it and refuses; JAX reads it. (Peer replication is ported:
    tests/test_torch_replication.py holds it against JAX.)"""
    import jax

    from ray_tpu.train.checkpoint import Checkpoint as JCheckpoint

    tree = _tree(60, bf16=False)
    leaves, treedef = jax.tree.flatten(tree)
    np.savez(tmp_path / "state.npz",
             **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})
    with open(tmp_path / "state.treedef.pkl", "wb") as f:
        pickle.dump(treedef, f)
    _assert_same(JCheckpoint(str(tmp_path)).load_pytree(), tree)
    with pytest.raises(tck.CheckpointError, match="treedef"):
        ttc.Checkpoint(str(tmp_path)).load_pytree()
    with pytest.raises(tck.CheckpointNotCommitted):
        ttc.Checkpoint(str(tmp_path / "none")).load_pytree()


# ---------------------------------------------------------------- plane

def test_plane_async_saves_commit_once_and_reuse_buffers(cpu_jax, tmp_path):
    """Two ranks' async saves through one plane: the snapshot isolates the
    tree (changed after save_async), rank 0's handle sees the commit that
    rank 1 lands, the second interval reuses the staging buffers."""
    plane = tck.CheckpointPlane()
    tree = _port_tree(_tree(70, bf16=False))
    want = _tree(70, bf16=False)
    done = []
    for interval in range(2):
        d = str(tmp_path / f"step{interval}")
        p0 = plane.save_async(tree, d, rank=0, world=2, step=interval,
                              on_done=done.append)
        tree["w"].add_(1.0)          # after the snapshot: not in the file
        p1 = plane.save_async(tree, d, rank=1, world=2, step=interval)
        assert plane.flush(timeout=30)
        assert p0.ok and p1.ok and p0.committed
        assert p0.info()["bytes"] + p1.info()["bytes"] == \
            tck.read_manifest(d)["nbytes"]
        got = tck.restore_tree(d)
        w = want["w"] + float(interval)
        np.testing.assert_array_equal(got["w"].numpy()[:4], w[:4])
        np.testing.assert_array_equal(got["w"].numpy()[4:], w[4:] + 1.0)
    assert [i["committed"] for i in done] == [True, True]
    assert plane._pool.allocated < plane._pool.acquired
    sync = plane.save_sync(tree, str(tmp_path / "sync"), step=7)
    assert sync.committed and tck.read_manifest(
        str(tmp_path / "sync"))["step"] == 7
    plane.close()
    with pytest.raises(tck.CheckpointError, match="closed"):
        plane.save_async(tree, str(tmp_path / "late"))


def test_template_restore_and_checkpoint_manager(cpu_jax, tmp_path):
    """A template restores tuples and Python scalars; Checkpoint round
    trips and the manager keeps the same top-K directories as JAX's."""
    from ray_tpu.train.checkpoint import CheckpointManager as JManager

    tree = {"a": (torch.arange(4.0), torch.ones(2, dtype=torch.int32)),
            "n": 3}
    ck = ttc.Checkpoint.save_pytree(tree, str(tmp_path / "ck"))
    got = ck.load_pytree(template=tree)
    assert isinstance(got["a"], tuple) and got["n"] == 3
    assert torch.equal(got["a"][0], tree["a"][0])
    with pytest.raises(tck.CheckpointError, match="template has"):
        ck.load_pytree(template={"a": (torch.zeros(4),), "n": 0})
    kept = []
    for cls, sub in ((ttc.CheckpointManager, "port"), (JManager, "jax")):
        mgr = cls(str(tmp_path / sub), num_to_keep=2,
                  score_attribute="acc", score_order="max")
        for acc in (0.5, 0.9, 0.1, 0.7):
            mgr.register(str(tmp_path / "ck"), {"acc": acc})
        kept.append((sorted(os.listdir(tmp_path / sub)),
                     os.path.basename(mgr.best_checkpoint.path),
                     os.path.basename(mgr.latest_checkpoint.path)))
    assert kept[0] == kept[1]


# ---------------------------------------------------------------- mesh state

MESH_CONFIG = dict(max_seq=16)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One world of 4 gloo ranks trains the tiny Llama on MeshConfig(fsdp=2,
    tp=2) for 2 steps, saves, and takes the uninterrupted third step; then
    one world of 2 ranks resumes from the files on MeshConfig(tp=2)."""
    import jax

    from ray_tpu.models import llama as jl

    import jax.numpy as jnp

    config = jl.LlamaConfig.tiny(dtype=jnp.float32, **MESH_CONFIG)
    tree = jax.tree.map(np.asarray, jl.init_params(config, jax.random.key(3)))
    tokens = np.random.default_rng(4).integers(
        0, config.vocab_size, (4, config.max_seq + 1)).astype(np.int32)
    directory = str(tmp_path_factory.mktemp("mesh_state"))
    common = dict(config=MESH_CONFIG, tree=tree, tokens=tokens, lr=LR)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        save = pool.submit(spawn, torch_ranks.mesh_checkpoint, 4,
                           dict(fsdp=2, tp=2), MESH_CONFIG, tree, tokens, LR,
                           2, directory, device="cpu", timeout=240)
        saved = save.result()
        resumed = pool.submit(spawn, torch_ranks.mesh_resume, 2,
                              dict(tp=2), MESH_CONFIG, tree, tokens, LR,
                              directory, device="cpu",
                              timeout=240).result()
    yield dict(saved=saved, resumed=resumed, directory=directory, **common)


def test_mesh_state_resumes_on_two_ranks_and_on_one(mesh_runs):
    """The next step's loss after restoring the 4-rank (fsdp=2, tp=2) state
    on 2 ranks (tp=2) and on one rank without a mesh (train/step.py)
    equals the uninterrupted run's within 1e-6 relative."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.optim import adamw, leaves
    from ray_tpu_torch.train.step import make_step

    saved, resumed = mesh_runs["saved"], mesh_runs["resumed"]
    want = saved[0]["losses"][-1]
    assert all(r["losses"] == saved[0]["losses"] for r in saved)
    assert sum(r["saved"]["committed"] for r in saved) >= 1
    for r in resumed:
        assert r["step"] == 2 and r["count"] == 3
        assert abs(r["loss"] - want) <= 1e-6 * abs(want)
    config = llama.LlamaConfig.tiny(dtype=torch.float32, **MESH_CONFIG)
    state = tck.restore_tree(mesh_runs["directory"])
    assert sorted(state) == ["opt", "params", "step"]
    state["opt"]["count"] = int(state["opt"]["count"])
    for _, p in leaves(state["params"]):
        p.requires_grad_(True)
    _, loss = make_step(config, adamw(LR))(
        state, torch.from_numpy(mesh_runs["tokens"]))
    assert abs(loss.item() - want) <= 1e-6 * abs(want)
    # The files hold the global state: JAX's restore reads them whole.
    from ray_tpu.checkpoint import restore_tree as jrestore

    got = jrestore(mesh_runs["directory"])
    np.testing.assert_array_equal(
        got["params"]["embed"], tck.restore_tree(
            mesh_runs["directory"])["params"]["embed"].numpy())
