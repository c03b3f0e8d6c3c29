"""Parity of the port's training surface with the JAX package.

`llama.loss_fn` and its gradients against `jax.value_and_grad` of the JAX
package's `loss_fn` with flash attention (Pallas in interpret mode), the
remat policies, `adamw` against `optax.adamw`, and one bench-style train
step against its JAX twin, on a small fp32 Llama with weights from the
JAX package's `init_params`. Tolerances: loss 1e-5, gradients 1e-5
absolute on top of 1e-4 relative (fp32 sums in another order); adamw on
given gradients 1e-6 in fp32 and two bf16 ulps in bf16; parameters after
train steps 2·lr absolute, since Adam scales every update to about lr
and an element whose gradient is rounding noise on both sides may step
either way.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import attention as ta
from ray_tpu_torch.train import optim, step as tstep

SEQ = 32


def _configs(**kw):
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, attention_impl="flash",
                             **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, attention_impl="flash",
                             **kw)
    return jc, tc


@pytest.fixture(scope="module")
def tiny(cpu_jax):
    import jax

    from ray_tpu.models import llama as jl

    jc, tc = _configs()
    params = jl.init_params(jc, jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab_size, (2, SEQ + 1)).astype(np.int32)
    mask = (rng.random((2, SEQ + 1)) < 0.7).astype(np.int32)
    return jc, tc, params, jax.tree.map(np.asarray, params), tokens, mask


def _flat(tree):
    return {path: t for path, t in optim.leaves(tree)}


def _jax_flat(tree):
    import jax

    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_tree_close(got, want, rtol=1e-4, atol=1e-5):
    got, want = _flat(got), _jax_flat(want)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path].detach().float().numpy(),
                                   want[path].astype(np.float32), rtol=rtol,
                                   atol=atol, err_msg=path)


def _torch_params(tree, tc):
    params = tl.params_from_numpy(tree, tc, device="cpu")
    for _, p in optim.leaves(params):
        p.requires_grad_(True)
    return params


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_gradients_match_jax(tiny, masked):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    jc, tc, params, tree, tokens, mask = tiny
    jbatch = {"tokens": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    if masked:
        jbatch["mask"] = jnp.asarray(mask)
        tbatch["mask"] = torch.from_numpy(mask)
    (loss_j, aux_j), grads_j = jax.value_and_grad(
        jl.loss_fn, has_aux=True)(params, jbatch, jc)
    tparams = _torch_params(tree, tc)
    loss, aux = tl.loss_fn(tparams, tbatch, tc)
    grads = torch.autograd.grad(loss, [p for _, p in
                                       optim.leaves(tparams)])
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert aux["tokens"].item() == float(aux_j["tokens"]) == 2 * SEQ
    got = {path: g for (path, _), g in zip(optim.leaves(tparams), grads)}
    _assert_tree_close(got, grads_j)


@pytest.mark.parametrize("policy,fwd_per_layer", [
    (None, 1), ("full", 2), ("dots", 2), ("flash", 1)])
def test_remat_policies_keep_gradients_and_count_forwards(
        tiny, monkeypatch, policy, fwd_per_layer):
    """Every policy gives the loss and gradients of no remat; the flash
    forward runs 2 L times per step under "full" and "dots" (its output
    is no aten.mm) and L times under "flash", which saves out and LSE."""
    _, tc, _, tree, tokens, _ = tiny
    calls = []
    real = ta.flash_fwd_reference
    monkeypatch.setattr(ta, "flash_fwd_reference",
                        lambda *a: calls.append(1) or real(*a))

    def run(config):
        params = _torch_params(tree, config)
        loss, _ = tl.loss_fn(params, {"tokens": torch.from_numpy(tokens)},
                             config)
        return loss, torch.autograd.grad(
            loss, [p for _, p in optim.leaves(params)])

    base_loss, base_grads = run(dataclasses.replace(tc, remat=False))
    calls.clear()
    config = (dataclasses.replace(tc, remat=False) if policy is None
              else dataclasses.replace(tc, remat_policy=policy))
    loss, grads = run(config)
    assert len(calls) == fwd_per_layer * tc.n_layers
    assert loss.item() == base_loss.item()
    for g, b in zip(grads, base_grads):
        torch.testing.assert_close(g, b, rtol=1e-6, atol=1e-7)


def test_no_grad_forward_is_not_checkpointed(tiny, monkeypatch):
    """The serving path's naive forward under torch.no_grad runs the
    layers as they are: no checkpoint wrapper, same logits."""
    _, tc, _, tree, tokens, _ = tiny
    params = tl.params_from_numpy(tree, tc, device="cpu")
    inputs = torch.from_numpy(tokens[:, :-1])
    with torch.no_grad():
        ref = tl.forward(params, inputs,
                         dataclasses.replace(tc, remat=False))

    def refuse(*a, **k):
        raise AssertionError("checkpoint under no_grad")

    monkeypatch.setattr(tl, "checkpoint", refuse)
    with torch.no_grad():
        out = tl.forward(params, inputs, tc)
    assert torch.equal(out, ref)


def _optax_run(params_np, grads_np, dtype):
    import jax
    import jax.numpy as jnp
    import optax

    opt = optax.adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=jnp.bfloat16)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params_np)
    state = opt.init(params)
    for g in grads_np:
        g = jax.tree.map(lambda a: jnp.asarray(a, dtype), g)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params, state[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(cpu_jax, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    shapes = {"embed": (6, 4), "layers": {"wq": (2, 4, 4),
                                          "attn_norm": (2, 4)}}

    def tree(scale):
        return {"embed": rng.standard_normal(shapes["embed"]) * scale,
                "layers": {k: rng.standard_normal(s) * scale
                           for k, s in shapes["layers"].items()}}

    params_np = tree(1.0)
    grads_np = [tree(0.1) for _ in range(3)]
    ref_params, ref_state = _optax_run(params_np, grads_np,
                                       getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    conv = lambda t: {k: conv(v) if isinstance(v, dict)  # noqa: E731
                      else torch.tensor(v, dtype=torch.float32).to(tdt)
                      for k, v in t.items()}
    params = conv(params_np)
    opt = optim.adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    state = opt.init(params)
    for g in grads_np:
        opt.update(params, [t for _, t in optim.leaves(conv(g))], state)
    assert state["count"] == int(ref_state.count) == 3
    paths = [p for p, _ in optim.leaves(params)]
    mu = dict(zip(paths, state["mu"]))
    nu = dict(zip(paths, state["nu"]))
    ref_mu, ref_nu = _jax_flat(ref_state.mu), _jax_flat(ref_state.nu)
    for path in paths:
        assert mu[path].dtype == torch.bfloat16
        assert str(nu[path].dtype).split(".")[1] == \
            str(ref_nu[path].dtype) == dtype
    if dtype == "float32":
        _assert_tree_close(params, ref_params, rtol=1e-6, atol=1e-6)
        tol = dict(rtol=1e-6, atol=1e-7)
    else:
        # Two bf16 ulps: XLA may round a fused chain once where eager
        # torch rounds after each op.
        tol = dict(rtol=2 ** -7, atol=1e-6)
        _assert_tree_close(params, ref_params, **tol)
    _assert_tree_close(nu, ref_state.nu, **tol)
    _assert_tree_close(mu, ref_state.mu, rtol=2 ** -7, atol=1e-6)


def test_train_step_matches_jax_bench_step(tiny):
    """Two steps of make_step against the JAX package's bench step
    (value_and_grad of loss_fn, optax.adamw, apply_updates) on the same
    weights and tokens."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import llama as jl

    jc, tc, params, tree, tokens, _ = tiny
    jopt = optax.adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=jnp.bfloat16)

    @jax.jit
    def jstep(state, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: jl.loss_fn(p, {"tokens": tokens}, jc)[0])(
                state["params"])
        updates, opt_state = jopt.update(grads, state["opt"],
                                         state["params"])
        return {"params": optax.apply_updates(state["params"], updates),
                "opt": opt_state}, loss

    jstate = {"params": params, "opt": jopt.init(params)}
    opt = optim.adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    tparams = _torch_params(tree, tc)
    state = {"params": tparams, "opt": opt.init(tparams)}
    step = tstep.make_step(tc, opt)
    for _ in range(2):
        jstate, loss_j = jstep(jstate, jnp.asarray(tokens))
        state, loss = step(state, torch.from_numpy(tokens))
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _assert_tree_close(state["params"], jstate["params"], atol=2 * 1e-4)


@pytest.mark.parametrize("preset", ["bench", "llama3_8b"])
def test_flops_per_token_and_num_params_match_jax(cpu_jax, preset):
    from ray_tpu.models import llama as jl

    if preset == "bench":   # the JAX package's bench training config
        kw = dict(vocab_size=32000, d_model=2048, n_layers=14, n_heads=16,
                  n_kv_heads=8, d_ff=7168, max_seq=2048,
                  remat_policy="dots")
        j, t = jl.LlamaConfig(**kw), tl.LlamaConfig(**kw)
    else:
        j, t = jl.LlamaConfig.llama3_8b(), tl.LlamaConfig.llama3_8b()
    assert t.num_params() == j.num_params()
    for seq in (2048, 16384):
        assert t.flops_per_token(seq) == j.flops_per_token(seq)
    assert (t.remat, t.remat_policy) == (j.remat, j.remat_policy)


def test_auto_attention_is_the_reference_on_cpu(monkeypatch):
    """"auto" picks flash only for CUDA tensors; on the CPU it stays the
    reference even where the JAX rule's shape test passes."""
    def refuse(*a, **k):
        raise AssertionError("flash on a CPU tensor")

    monkeypatch.setattr(ta, "flash_attention", refuse)
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 256, 2, 128)).astype(
        np.float32))
    out = ta.attention(q, q, q, impl="auto")
    assert torch.equal(out, ta.mha_reference(q, q, q))
