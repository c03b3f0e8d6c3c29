"""Parity of the port's in-program parallelism with the JAX package.

The port runs in a world of 4 gloo ranks spawned once per module
(`ray_tpu_torch.parallel.launch.spawn`, FileStore rendezvous under a
temporary directory; the rank side is tests/torch_ranks.py and imports
only the port); the JAX package runs in this process on 4 of the 8
virtual CPU devices, meanwhile. Same numpy inputs and weights on both
sides, fp32 throughout. Tolerances: ring and Ulysses outputs and
gradients atol 2e-4 (the JAX package's own e2e tolerance); the first
train step's loss, grad_norm and every gradient rtol 1e-4 (atol 1e-6
for gradients near zero), which pins a fault before Adam's
normalisation hides it; parameters after two steps atol 1e-4.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import torch_ranks
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.parallel.launch import spawn

WORLD = 4
LR = 1e-4


def _attn_inputs(seed=0, b=2, s=64, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(q=f(b, s, h, d), k=f(b, s, hkv, d), v=f(b, s, hkv, d),
                cot=f(b, s, h, d))


ATTN_CASES = [(impl, causal) for impl in ("ring", "ulysses")
              for causal in (True, False)]
# name: (family, mesh, config overrides, batch, seq)
TRAIN_CASES = {
    "fsdp2_tp2": ("llama", dict(fsdp=2, tp=2), dict(max_seq=32), 4, 32),
    "dp2_sp2_ring": ("llama", dict(dp=2, sp=2),
                     dict(max_seq=32, attention_impl="ring"), 4, 32),
    # __graft_entry__.dryrun_multichip(4): tp 2, sp 2 (ring), then its
    # expert-parallel leg on MeshConfig.auto(4, ep=2).
    "dryrun_llama": ("llama", dict(sp=2, tp=2),
                     dict(n_heads=4, n_kv_heads=2, max_seq=64,
                          attention_impl="ring"), 4, 64),
    "dryrun_moe": ("moe", dict(fsdp=2, ep=2),
                   dict(n_experts=4, top_k=2, max_seq=64, remat=False), 4,
                   32),
    # Ulysses through the model (the JAX Llama has only the ring).
    "dp2_sp2_ulysses": ("llama", dict(dp=2, sp=2),
                        dict(max_seq=32, attention_impl="ulysses"), 4, 32),
}


def _tree(family, config, seed):
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu.models import moe as jm

    mod = jl if family == "llama" else jm
    return jax.tree.map(np.asarray, mod.init_params(config, jax.random.key(
        seed)))


def _jax_config(family, overrides):
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.models import moe as jm

    cls = jl.LlamaConfig if family == "llama" else jm.MoEConfig
    return cls.tiny(dtype=jnp.float32, **overrides)


def train_case(name, cases=TRAIN_CASES, seed=0):
    """(jax config, numpy params, tokens, rank-side job) of a train case."""
    family, mesh, overrides, batch, seq = cases[name]
    config = _jax_config(family, overrides)
    tree = _tree(family, config, seed)
    tokens = np.random.default_rng(seed + 1).integers(
        0, config.vocab_size, (batch, seq + 1)).astype(np.int32)
    job = (name, "train", dict(family=family, mesh=mesh, config=overrides,
                               tree=tree, tokens=tokens, lr=LR, steps=2))
    return config, tree, tokens, job


def _jobs():
    jobs = [("mesh", "mesh_info", dict(mesh=dict(fsdp=2, tp=2))),
            ("collectives", "collectives", {})]
    for impl, causal in ATTN_CASES:
        jobs.append((f"{impl}_{causal}", "attention",
                     dict(impl=impl, causal=causal, **_attn_inputs())))
    jobs += [train_case(name)[3] for name in TRAIN_CASES]
    return jobs


def run_world(jobs):
    """Start one spawned world on `jobs` in the background; yields a
    function that returns (or fails on) one job's rank-0 result."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(spawn, torch_ranks.run_jobs, WORLD, jobs,
                             device="cpu", timeout=300)

        def get(name):
            ok, value = future.result()[0][name]
            if not ok:
                pytest.fail(f"rank-side job {name} failed:\n{value}")
            return value

        yield get


@pytest.fixture(scope="module")
def world(cpu_jax):
    """The port's side of every case, computed by one spawned world while
    the tests compute the JAX side."""
    yield from run_world(_jobs())


# ---------------------------------------------------------------- mesh

def test_mesh_config_and_refusals():
    from ray_tpu.parallel import mesh as jmesh

    assert tmesh.AXES == jmesh.AXES
    assert tmesh.batch_axes() == jmesh.batch_axes()
    cfg = tmesh.MeshConfig.auto(8, tp=2)
    assert cfg.fsdp == 4 and cfg.num_devices == 8
    assert cfg == tmesh.MeshConfig(**vars(jmesh.MeshConfig.auto(8, tp=2)))
    with pytest.raises(ValueError):
        tmesh.MeshConfig.auto(6, tp=4)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(tmesh.MeshConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.build_mesh(tmesh.MeshConfig())


@pytest.mark.parametrize("n,kw", [(8, dict(tp=2)), (8, dict(tp=2, sp=2)),
                                  (4, dict(ep=2)), (8, dict(dp=2, sp=2))])
def test_mesh_config_auto_matches_jax(n, kw):
    from ray_tpu.parallel import mesh as jmesh

    want = jmesh.MeshConfig.auto(n, **kw)
    got = tmesh.MeshConfig.auto(n, **kw)
    assert got.axis_sizes() == want.axis_sizes()
    assert got.num_devices == want.num_devices == n


def test_mesh_build(world):
    """Each rank's coordinates are its device's position in the JAX
    package's mesh of the same shape over devices 0-3 (tp innermost), and
    its group along each axis holds the ranks torch's init_device_mesh
    puts there."""
    import jax

    from ray_tpu.parallel import mesh as jmesh

    cfg = jmesh.MeshConfig(fsdp=2, tp=2)
    jm = jmesh.build_mesh(cfg, devices=jax.devices()[:WORLD])
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    infos = world("mesh")
    for rank, info in enumerate(infos):
        sizes = tuple(info[a][0] for a in tmesh.AXES)
        coords = tuple(info[a][1] for a in tmesh.AXES)
        assert sizes == cfg.axis_sizes()
        assert coords == where[jax.devices()[rank].id], rank
        assert "wants 5 devices, have 4" in info["wrong_world"]
        for axis, (got, ref) in info["groups"].items():
            assert got == ref, (rank, axis)
        assert tuple(info["coordinates"][0]) == tuple(
            info["coordinates"][1]) == coords


COLLECTIVE_CHECKS = {
    "all_gather": "all-gather over fsdp; backward = reduce-scatter (sum)",
    "copy_to_reduce_from": "Megatron f and g over tp, both directions",
    "ring_shift": "rank r gets r-1's block; the gradient goes back",
    "all_to_all": "JAX's tiled all_to_all; backward = the inverse",
    "gather_tree": "gather_tree inverts shard_tree (multi-axis specs)",
    "global_norm": "optax.global_norm of the global tensors from shards",
    "reduce_gradients": "sums over replicated batch axes only (not tp)",
}


@pytest.mark.parametrize("check", list(COLLECTIVE_CHECKS))
def test_collective_semantics(world, check):
    """Each collective and reduction on the (fsdp=2, tp=2) and (sp=4)
    meshes of the world against values from the global tensors, on every
    rank (see torch_ranks.collectives)."""
    bad = [r[check] for r in world("collectives") if r[check] is not None]
    assert not bad, f"{COLLECTIVE_CHECKS[check]}: {bad}"


def test_rope_tables_and_seq_shard_take_this_ranks_positions():
    """Under sp the RoPE rows and the sequence chunk are this rank's
    global positions [r·s, (r+1)·s)."""
    from ray_tpu_torch.ops.layers import rope_frequencies
    from ray_tpu_torch.parallel.mesh import use_mesh

    config = tl.LlamaConfig.tiny(dtype=torch.float32)
    cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                config.rope_theta)
    x = torch.arange(2 * 32).reshape(2, 32)
    for r in range(4):
        fake = _FakeMesh((1, 1, 4, 1, 1), (0, 0, r, 0, 0))
        with use_mesh(fake, tsh.TRAIN_RULES):
            c, s = tl.rope_tables(config, 8, "cpu")
            got = tsh.seq_shard(x)
        assert torch.equal(c, cos[8 * r:8 * r + 8])
        assert torch.equal(s, sin[8 * r:8 * r + 8])
        assert torch.equal(got, x[:, 8 * r:8 * r + 8])


def _norm_spec(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def test_sharding_rules():
    from ray_tpu.models import llama as jl
    from ray_tpu.models import moe as jm
    from ray_tpu.parallel import sharding as js

    assert tsh.TRAIN_RULES == js.TRAIN_RULES
    assert tsh.SERVE_RULES == js.SERVE_RULES
    assert tsh.spec_for(("batch", "seq"), tsh.TRAIN_RULES) == (
        ("dp", "fsdp", "ep"), ("sp",))
    assert tsh.spec_for(("layers", "embed", "heads"), tsh.TRAIN_RULES) == (
        (), ("fsdp",), ("tp",))
    for port, jax_mod in ((tl, jl), (tmoe, jm)):
        cfg = jax_mod.MoEConfig.tiny() if jax_mod is jm \
            else jl.LlamaConfig.tiny()
        assert port.param_logical_axes() == jax_mod.param_logical_axes(cfg)
        for rules in ("TRAIN_RULES", "SERVE_RULES"):
            import jax

            want = jax.tree.leaves(
                js.tree_specs(jax_mod.param_logical_axes(cfg),
                              getattr(js, rules)),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            got = [s for _, s in sorted(_flat(tsh.tree_specs(
                port.param_logical_axes(), getattr(tsh, rules))).items())]
            assert got == [tuple(_norm_spec(e) for e in spec)
                           for spec in want]
    with pytest.raises(KeyError):
        tsh.spec_for(("no_such_axis",), tsh.TRAIN_RULES)


class _FakeMesh:
    """The two DeviceMesh queries `sharding.shard` makes, at given sizes
    and coordinates (no process group needed)."""

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, dim):
        return self.sizes[dim]

    def get_local_rank(self, axis):
        return self.coords[tmesh.AXES.index(axis)]


SHARD_CASES = [
    (dict(fsdp=2, tp=2), ("vocab", "embed"), (8, 12), "TRAIN_RULES"),
    (dict(fsdp=2, tp=2), ("layers", "embed", "heads"), (2, 8, 12),
     "TRAIN_RULES"),
    (dict(dp=2, fsdp=2), ("batch", None), (8, 5), "TRAIN_RULES"),
    (dict(dp=2, sp=2), ("batch", "seq"), (4, 8), "TRAIN_RULES"),
    (dict(fsdp=2, ep=2), ("layers", "expert", "embed", "mlp"), (2, 4, 8, 6),
     "TRAIN_RULES"),
    (dict(ep=2, tp=2), ("layers", "expert", "mlp", "embed"), (2, 4, 6, 8),
     "TRAIN_RULES"),
    (dict(dp=2, fsdp=2, ep=2), ("batch", None), (16, 3), "TRAIN_RULES"),
    (dict(dp=2, tp=2), ("vocab", "embed"), (8, 6), "SERVE_RULES"),
]


@pytest.mark.parametrize("mesh_kw,axes,shape,rules", SHARD_CASES)
def test_shard_equals_named_sharding(cpu_jax, mesh_kw, axes, shape, rules):
    """`sharding.shard` gives each rank the chunk that the JAX package's
    NamedSharding places on the device at the same mesh coordinates
    (multi-axis entries flattened outermost first)."""
    import jax
    from jax.sharding import NamedSharding

    from ray_tpu.parallel import mesh as jmesh
    from ray_tpu.parallel import sharding as js

    cfg = jmesh.MeshConfig(**mesh_kw)
    jm = jmesh.build_mesh(cfg, devices=jax.devices()[:cfg.num_devices])
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    arr = jax.device_put(x, NamedSharding(jm, js.spec_for(
        axes, getattr(js, rules))))
    spec = tsh.spec_for(axes, getattr(tsh, rules))
    for piece in arr.addressable_shards:
        fake = _FakeMesh(cfg.axis_sizes(), where[piece.device.id])
        got = tsh.shard(torch.from_numpy(x), spec, fake)
        np.testing.assert_array_equal(got.numpy(), np.asarray(piece.data))


def test_constrain_outside_a_mesh_and_refusals():
    """Outside a mesh `constrain` and the collectives return their input;
    a layout change that is not a gather raises; ring attention needs a
    mesh, as in the JAX package."""
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel.mesh import use_mesh

    x = torch.ones(4, 6)
    assert tsh.constrain(x, ("embed", "mlp"), (None, "mlp")) is x
    assert col.copy_to(x, None, "tp") is x
    assert col.reduce_from(x, None, ("dp", "fsdp")) is x
    fake = _FakeMesh((1, 2, 1, 1, 2), (0, 0, 0, 0, 0))
    with use_mesh(fake, tsh.TRAIN_RULES):
        with pytest.raises(ValueError, match="not a gather"):
            tsh.constrain(x, (None, "mlp"), ("embed", "mlp"))
    config = tl.LlamaConfig.tiny(dtype=torch.float32, attention_impl="ring")
    params = tl.init_params(config, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="ambient mesh"):
        tl.forward(params, torch.zeros(1, 8, dtype=torch.long), config)


def test_spawn_reports_a_failing_rank():
    """A rank that raises fails the whole world with its traceback, and
    every rank is gone when spawn returns."""
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*planted failure"):
        spawn(torch_ranks.fail_on, 2, 1, device="cpu", timeout=120)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------- attention

def _jax_attention(impl, causal, q, k, v, cot):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel import ring

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    fn = ring.ring_attention if impl == "ring" else ring.ulysses_attention
    f = jax.shard_map(
        lambda a, b, c: fn(a, b, c, axis_name="sp", causal=causal),
        mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
        check_vma=False)

    def loss(a, b, c):
        out = f(a, b, c)
        return (out * cot).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *grads)]


@pytest.mark.parametrize("impl,causal", ATTN_CASES)
def test_sequence_parallel_attention_matches_jax(world, impl, causal):
    """sp = 4, GQA 4/2 with K/V unrepeated on the ring (Ulysses repeats
    them to 4 heads, as hkv % sp demands): output, dq, dk, dv."""
    inputs = _attn_inputs()
    want = _jax_attention(impl, causal, **inputs)
    got = world(f"{impl}_{causal}")
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_chunks", [2, 4])
def test_ring_schedule_on_one_device_matches_flash(causal, n_chunks):
    """ring_attention_chunks (the ring's chunk steps and merges on one
    device, what chip_smoke.py holds on the card) equals whole-sequence
    flash attention, output, LSE and gradients through both."""
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel.ring import ring_attention_chunks

    inputs = _attn_inputs(seed=3, s=96)
    g_lse = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 4, 96)).astype(np.float32))
    res = []
    for fn in (lambda q, k, v: ring_attention_chunks(
            q, k, v, n_chunks, causal=causal),
            lambda q, k, v: flash_attention(
                q, k, v, causal=causal, return_lse=True)):
        q, k, v = (torch.from_numpy(inputs[n]).requires_grad_(True)
                   for n in "qkv")
        out, lse = fn(q, k, v)
        loss = (out * torch.from_numpy(inputs["cot"])).sum() \
            + (lse * g_lse).sum()
        res.append([out, lse, *torch.autograd.grad(loss, [q, k, v])])
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *res):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-5, msg=name)


# ---------------------------------------------------------------- training

_JAX_CACHE = {}


def jax_train(name, cases=TRAIN_CASES, steps=True):
    """The JAX package's first-step loss and gradients (value_and_grad of
    loss_fn; sharding does not change them beyond rounding) and two steps
    of its build_train_step on the same mesh shape (with `steps`)."""
    if (name, steps) in _JAX_CACHE:
        return _JAX_CACHE[name, steps]
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import llama as jl
    from ray_tpu.models import moe as jm
    from ray_tpu.parallel.fsdp import build_train_step
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh, use_mesh
    from ray_tpu.parallel.sharding import TRAIN_RULES

    family, mesh_kw = cases[name][:2]
    mod = jl if family == "llama" else jm
    config, tree, tokens, _ = train_case(name, cases)
    params = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": jnp.asarray(tokens)}
    mesh = build_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:WORLD])
    init_fn, make_step = build_train_step(
        lambda p, b: mod.loss_fn(p, b, config), optax.adamw(LR), mesh,
        mod.param_logical_axes(config), {"tokens": ("batch", None)},
        TRAIN_RULES)
    # The first step's gradients unsharded, on reference attention: the
    # ring computes the same function (a second interpret-mode compile of
    # the ring would only cost time).
    plain = dataclasses.replace(config, attention_impl="reference")
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: mod.loss_fn(p, batch, plain), has_aux=True))(params)
    out = dict(loss=float(loss), grads=jax.tree.map(np.asarray, grads),
               grad_norm=float(optax.global_norm(grads)),
               metrics={k: float(v) for k, v in metrics.items()})
    if steps:
        state, shardings = init_fn(params)
        step = make_step(shardings)
        out["history"] = []
        with use_mesh(mesh):
            for _ in range(2):
                state, m = step(state, batch)
                out["history"].append({k: float(v) for k, v in m.items()})
        out["params"] = jax.tree.map(np.asarray, state["params"])
    _JAX_CACHE[name, steps] = out
    return out


def assert_trees_close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for path in sorted(want):
        assert got[path].shape == want[path].shape, path
        np.testing.assert_allclose(got[path], want[path].astype(np.float32),
                                   err_msg=path, **tol)


LLAMA_CASES = ["fsdp2_tp2", "dp2_sp2_ring"]


@pytest.mark.parametrize("name", LLAMA_CASES)
def test_llama_first_step_matches_jax(world, name):
    want = jax_train(name)
    got = world(name)["first"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"]["tokens"],
                               want["metrics"]["tokens"])
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    assert_trees_close(got["grads"], want["grads"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", LLAMA_CASES)
def test_llama_train_steps_match_jax(world, name):
    """Two steps of fsdp.build_train_step against the JAX package's on the
    same mesh shape: each step's loss, tokens and grad_norm, and every
    parameter gathered back."""
    want = jax_train(name)
    got = world(name)
    assert got["step"] == 2
    for g, w in zip(got["history"], want["history"]):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
    assert_trees_close(got["params"], want["params"], atol=1e-4, rtol=0)


def port_unsharded(name, cases=TRAIN_CASES, steps=2):
    """The same steps on one device through the port without a mesh
    (loss_fn, the gradients' global norm, adamw): what the sharded step
    must equal. The single-device path is held against the JAX package by
    tests/test_torch_train.py and tests/test_torch_moe.py."""
    from ray_tpu_torch.train.optim import adamw, leaves

    family, _, overrides = cases[name][:3]
    # Ring attention over one device is causal flash attention.
    overrides = dict(overrides, attention_impl="flash")
    mod = tl if family == "llama" else tmoe
    config = (tl.LlamaConfig if family == "llama" else tmoe.MoEConfig).tiny(
        dtype=torch.float32, **overrides)
    _, tree, tokens, _ = train_case(name, cases)
    params = mod.params_from_numpy(tree, config, device="cpu")
    flat = [p.requires_grad_(True) for _, p in leaves(params)]
    opt = adamw(LR)
    state = opt.init(params)
    history = []
    for _ in range(steps):
        loss, metrics = mod.loss_fn(params, {"tokens": torch.from_numpy(
            tokens)}, config)
        grads = torch.autograd.grad(loss, flat)
        history.append({k: v.item() for k, v in metrics.items()})
        history[-1]["grad_norm"] = torch.sqrt(sum(
            g.square().sum() for g in grads)).item()
        opt.update(params, grads, state)
    return history, torch_ranks._np(params)


def test_ulysses_model_step_matches_one_device(world):
    """attention_impl="ulysses" on (dp=2, sp=2): two steps' metrics and
    every gathered parameter equal the same steps on one device."""
    history, params = port_unsharded("dp2_sp2_ulysses")
    got = world("dp2_sp2_ulysses")
    for g, w in zip(got["history"], history):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
    assert_trees_close(got["params"], params, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["dryrun_llama", "dryrun_moe"])
def test_dryrun_multichip_counterpart(world, name):
    """__graft_entry__.dryrun_multichip(4) on the port: the full step
    (fwd + bwd + adamw) on tp 2 x sp 2 with ring attention, and the MoE
    step with a real ep axis (MeshConfig.auto(4, ep=2)); losses plausible
    and, with every gathered parameter, equal to the same two steps on
    one device."""
    history, params = port_unsharded(name)
    got = world(name)
    for g, w in zip(got["history"], history):
        assert 0.0 < g["loss"] < 20.0
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
    assert_trees_close(got["params"], params, atol=1e-4, rtol=0)
