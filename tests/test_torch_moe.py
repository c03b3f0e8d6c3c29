"""Parity of the port's MoE model (ray_tpu_torch/models/moe.py) with the
JAX package's, after tests/test_moe.py.

The block against the JAX package's moe_block and a naive dense-per-
expert reference (fp32, rtol = atol = 1e-4, 2e-5 for one expert), the
dispatch and combine masks equal to the JAX package's exactly on the
same routes (tiny ones, and layer 0's routes of the full-width default
configuration on 2048 tokens), the loss and every gradient of a tiny model against
`jax.value_and_grad` (rtol 1e-4, atol 1e-6), and the expert-parallel
train step on 4 gloo ranks against the JAX package's build_train_step on
the same mesh shape (see tests/test_torch_parallel.py for the world and
its tolerances).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.ops.layers import swiglu
from ray_tpu_torch.train.optim import leaves
from test_torch_parallel import (assert_trees_close, jax_train,
                                 port_unsharded, run_world, train_case)

MOE_CASES = {
    # tests/test_moe.py's EP case (capacity 8: nothing dropped).
    "fsdp2_ep2": ("moe", dict(fsdp=2, ep=2),
                  dict(n_experts=4, top_k=2, capacity_factor=8.0,
                       remat=False), 8, 32),
    # Expert width over tp, default capacity (routes dropped), remat.
    "ep2_tp2": ("moe", dict(ep=2, tp=2), dict(n_experts=4, top_k=2), 4, 32),
    # The sequence over sp (ring): every shard fills the global queue.
    "sp2_ep2_ring": ("moe", dict(sp=2, ep=2),
                     dict(n_experts=4, top_k=2, max_seq=32,
                          attention_impl="ring"), 4, 32),
}


@pytest.fixture(scope="module")
def world(cpu_jax):
    yield from run_world([train_case(name, MOE_CASES)[3]
                          for name in MOE_CASES])


def _configs(**kw):
    import jax.numpy as jnp

    from ray_tpu.models import moe as jm

    return (jm.MoEConfig.tiny(dtype=jnp.float32, **kw),
            tmoe.MoEConfig.tiny(dtype=torch.float32, **kw))


def _block_inputs(config, seed, b, s):
    rng = np.random.default_rng(seed)
    d, f, E = config.d_model, config.d_ff, config.n_experts

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (n(b, s, d), n(d, E, scale=0.5), n(E, d, f, scale=d ** -0.5),
            n(E, d, f, scale=d ** -0.5), n(E, f, d, scale=f ** -0.5))


def _both_blocks(seed, b, s, **kw):
    """(jax out, jax aux, port out, port aux, port config, inputs)."""
    import jax.numpy as jnp

    from ray_tpu.models import moe as jm

    jc, tc = _configs(**kw)
    arrays = _block_inputs(tc, seed, b, s)
    jout, jaux = jm.moe_block(jc, *(jnp.asarray(a) for a in arrays))
    tout, taux = tmoe.moe_block(tc, *(torch.from_numpy(a) for a in arrays))
    return np.asarray(jout), jaux, tout, taux, tc, arrays


def _naive(config, x, router, wg, wu, wd):
    """Every expert densely, combined with the renormalised top-k gates."""
    probs = torch.softmax(x @ router, dim=-1)
    gates, idx = torch.topk(probs, config.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    ys = torch.stack([swiglu(x @ wg[e], x @ wu[e]) @ wd[e]
                      for e in range(config.n_experts)], dim=2)
    picked = ys.gather(2, idx[..., None].expand(*idx.shape, x.shape[-1]))
    return (gates[..., None] * picked).sum(2)


def test_config_counts_match_jax():
    from ray_tpu.models import moe as jm

    for name in ("__call__", "mixtral_8x7b", "tiny"):
        make_j = jm.MoEConfig if name == "__call__" \
            else getattr(jm.MoEConfig, name)
        make_t = tmoe.MoEConfig if name == "__call__" \
            else getattr(tmoe.MoEConfig, name)
        jc, tc = make_j(), make_t()
        assert tc.num_params() == jc.num_params()
        assert tc.active_params() == jc.active_params()
        assert tc.flops_per_token(2048) == jc.flops_per_token(2048)
        assert tc.capacity(2048) == jc.capacity(2048)
    # The default configuration chip_smoke.py trains at full width.
    assert tmoe.MoEConfig().capacity(2048) == 640
    assert round(tmoe.MoEConfig().num_params() / 1e9, 2) == 3.55


def test_single_expert_is_dense_mlp():
    jout, jaux, out, aux, tc, (x, _, wg, wu, wd) = _both_blocks(
        0, 2, 16, n_experts=1, top_k=1, capacity_factor=4.0)
    x, wg, wu, wd = (torch.from_numpy(a) for a in (x, wg, wu, wd))
    torch.testing.assert_close(out, swiglu(x @ wg[0], x @ wu[0]) @ wd[0],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), jout, rtol=2e-5, atol=2e-5)
    assert aux["dropped_frac"].item() == pytest.approx(0.0, abs=1e-6)


def test_matches_naive_reference_when_capacity_ample():
    jout, jaux, out, aux, tc, arrays = _both_blocks(
        2, 2, 32, n_experts=4, top_k=2, capacity_factor=8.0)
    want = _naive(tc, *(torch.from_numpy(a) for a in arrays))
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-4, atol=1e-4)
    assert aux["dropped_frac"].item() == pytest.approx(0.0, abs=1e-6)
    for key in ("balance_loss", "router_z_loss"):
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=1e-5)


def test_capacity_drops_are_masked_not_garbage():
    jout, jaux, out, aux, _, _ = _both_blocks(
        4, 1, 64, n_experts=4, top_k=2, capacity_factor=0.25)
    assert torch.isfinite(out).all()
    assert 0.0 < aux["dropped_frac"].item() < 1.0
    np.testing.assert_allclose(aux["dropped_frac"].item(),
                               float(jaux["dropped_frac"]), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-4, atol=1e-4)


class _EinsumRecorder:
    """Stands in for `jnp` inside the JAX package's moe module and keeps
    each einsum's operands and result by its spec."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.calls = {}

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def einsum(self, spec, *operands, **kw):
        out = self._jnp.einsum(spec, *operands, **kw)
        self.calls[spec] = (operands, out)
        return out


def _masks_equal_jax(monkeypatch, logits, capacity_factor):
    """The port's dispatch and combine masks equal those the JAX package's
    moe_block builds, exactly, on router `logits` (b, s, E) (they enter
    both blocks as x with an identity router, so both route on the same
    numbers); the port's own routing picks the same experts and gates, and
    its block drops the same share of routes. Returns that share."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jm

    s, E = logits.shape[1], logits.shape[2]
    kw = dict(d_model=E, d_ff=8, n_experts=E, top_k=2,
              capacity_factor=capacity_factor)
    jc = jm.MoEConfig(dtype=jnp.float32, **kw)
    tc = tmoe.MoEConfig(dtype=torch.float32, **kw)
    rng = np.random.default_rng(4)
    experts = [rng.standard_normal(shape).astype(np.float32) * 0.3
               for shape in ((E, E, 8), (E, E, 8), (E, 8, E))]
    eye = np.eye(E, dtype=np.float32)
    rec = _EinsumRecorder(jnp)
    monkeypatch.setattr(jm, "jnp", rec)
    _, jaux = jm.moe_block(jc, *(jnp.asarray(a) for a in
                                 (logits, eye, *experts)))
    jdispatch = np.asarray(rec.calls["bsec,bsd->ebcd"][0][0])
    jgates = np.array(rec.calls["bsk,bskec->bsec"][0][0])
    jcombine = np.asarray(rec.calls["bsk,bskec->bsec"][1])
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), 2)
    jidx = np.array(jidx)

    dispatch, combine = tmoe.dispatch_masks(
        tc, torch.from_numpy(jidx).long(), torch.from_numpy(jgates), s)
    assert np.array_equal(dispatch.numpy(), jdispatch)
    assert np.array_equal(combine.numpy(), jcombine)
    _, gates, idx = tmoe._route(tc, torch.from_numpy(logits))
    assert np.array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(gates.numpy(), jgates, rtol=1e-5, atol=1e-7)
    _, aux = tmoe.moe_block(tc, *(torch.from_numpy(a) for a in
                                  (logits, eye, *experts)))
    dropped = aux["dropped_frac"].item()
    assert dropped == pytest.approx(float(jaux["dropped_frac"]), abs=1e-7)
    return dropped


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_dispatch_and_combine_masks_equal_jax(monkeypatch, capacity_factor):
    """On tiny routes (4 experts, 2 x 32 tokens), the port's masks equal
    the JAX package's exactly; routes drop only at the small capacity."""
    _, tc = _configs(n_experts=4, top_k=2)
    x, router = _block_inputs(tc, 5, 2, 32)[:2]
    dropped = _masks_equal_jax(monkeypatch, x @ router, capacity_factor)
    assert (dropped > 0) == (capacity_factor < 1)


def _full_width_logits(seed):
    """Router logits of layer 0 of the default MoEConfig (d 2048, heads
    16/8, 8 experts top-2) on a 2048-token sequence, from the port's init
    (fp32, reference attention). Layer 0's router input does not depend
    on the experts' width, so d_ff is cut to 8 to spare memory."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.layers import rms_norm

    tc = tmoe.MoEConfig(n_layers=1, d_ff=8, dtype=torch.float32,
                        attention_impl="reference")
    params = tmoe.init_params(tc, torch.Generator().manual_seed(seed),
                              device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, tc.vocab_size, (1, tc.max_seq)))
    p = {k: v[0] for k, v in params["layers"].items()}
    with torch.no_grad():
        cos, sin = llama.rope_tables(tc, tc.max_seq, torch.device("cpu"))
        x = llama.embed(params["embed"], tokens, tc)
        x = llama.attention_sublayer(tc, x, p, cos, sin)
        h = rms_norm(x, p["mlp_norm"], tc.norm_eps)
        return (h.float() @ p["router"]).numpy()


def test_masks_equal_jax_on_full_width_routes(monkeypatch):
    """On layer 0's routes of the default MoEConfig (2048 tokens; capacity
    640 at factor 1.25, 256 at 0.5), the port's dispatch and combine masks
    equal the JAX package's exactly and both blocks drop the same share
    of routes. One test for both factors: the logits take a full-width
    layer to make."""
    assert tmoe.MoEConfig().capacity(2048) == 640
    assert tmoe.MoEConfig(capacity_factor=0.5).capacity(2048) == 256
    logits = _full_width_logits(3)
    dropped = [_masks_equal_jax(monkeypatch, logits, cf)
               for cf in (1.25, 0.5)]
    assert 0.0 <= dropped[0] < dropped[1]


def test_loss_and_grads_match_jax(cpu_jax):
    """A tiny MoE (2 layers, remat) on the port's flash attention against
    jax.value_and_grad of the JAX package's loss_fn: loss, every aux loss
    and every gradient; the router gets a gradient (it only sees the loss
    through the gates and the aux losses)."""
    import jax

    from ray_tpu.models import moe as jm

    jc, tc = _configs()
    tc = dataclasses.replace(tc, attention_impl="flash")
    tree = jax.tree.map(np.asarray, jm.init_params(jc, jax.random.key(0)))
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 33)).astype(np.int32)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, {"tokens": tokens}, jc), has_aux=True))(tree)

    params = tmoe.params_from_numpy(tree, tc, device="cpu")
    flat = [p.requires_grad_(True) for _, p in leaves(params)]
    loss, metrics = tmoe.loss_fn(params, {"tokens": torch.from_numpy(
        tokens)}, tc)
    grads = torch.autograd.grad(loss, flat)
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(metrics[key].item(), float(value),
                                   rtol=1e-5, err_msg=key)
    assert metrics["balance_loss"].item() >= 1.0 - 1e-3
    assert all(torch.isfinite(g).all() for g in grads)
    got = {path: g for (path, _), g in zip(leaves(params), grads)}
    assert got["layers/router"].abs().sum() > 0
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert set(got) == set(want)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("preset", ["tiny", "default"])
def test_init_params_match_jax_layouts(cpu_jax, preset):
    """The port's init_params has the JAX package's tree, shapes and
    dtypes (the router in fp32), checked without materialising the
    default model (jax.eval_shape; the port's tiny model on the CPU, the
    default one on the meta device)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import moe as jm

    if preset == "default":
        jc, tc = jm.MoEConfig(dtype=jnp.bfloat16), tmoe.MoEConfig()
    else:
        jc, tc = jm.MoEConfig.tiny(dtype=jnp.bfloat16), tmoe.MoEConfig.tiny()
    want = jax.eval_shape(lambda k: jm.init_params(jc, k), jax.random.key(0))
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_leaves_with_path(want)}
    if preset == "tiny":
        got = tmoe.init_params(tc, torch.Generator().manual_seed(0),
                               device="cpu")
    else:
        got = _meta_init(tc)
    got = dict(leaves(got))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
    assert sum(t.numel() for t in got.values()) == tc.num_params()


def _meta_init(config):
    """init_params' tree on the meta device (no memory, no values)."""
    import unittest.mock as mock

    from ray_tpu_torch.models import llama as tl

    def dense(shape, fan_in, cfg, generator, dev):
        return torch.empty(shape, dtype=cfg.dtype, device="meta")

    meta = torch.device("meta")
    with mock.patch.object(tl, "_dense", dense), \
            mock.patch.object(tmoe, "resolve_device", lambda d: meta), \
            mock.patch.object(torch, "randn", lambda shape, **k: torch.empty(
                shape, dtype=k.get("dtype"), device="meta")):
        return tmoe.init_params(config, None)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    config = tmoe.MoEConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmoe.init_params(config, torch.Generator())
    params = tmoe.init_params(config, torch.Generator().manual_seed(0),
                              device="cpu")
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["w_gate"].shape == (2, 4, 64, 96)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_ep_first_step_matches_jax(world, name):
    """The first step's loss, aux losses, grad_norm and every gradient
    against the JAX package's (value_and_grad of its loss_fn)."""
    want = jax_train(name, MOE_CASES, steps=name == "fsdp2_ep2")
    got = world(name)["first"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for key, value in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], value, rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    assert_trees_close(got["grads"], want["grads"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_ep_train_steps_match(world, name):
    """Two steps of fsdp.build_train_step: on (fsdp=2, ep=2) against the
    JAX package's build_train_step on that mesh shape; on the other
    shapes against the same steps on one device (whose first step the
    test above holds against JAX)."""
    if name == "fsdp2_ep2":
        want = jax_train(name, MOE_CASES)
        history, params = want["history"], want["params"]
    else:
        history, params = port_unsharded(name, MOE_CASES)
    got = world(name)
    assert got["step"] == 2
    for g, w in zip(got["history"], history):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-7,
                                       err_msg=key)
    assert_trees_close(got["params"], params, atol=1e-4, rtol=0)
