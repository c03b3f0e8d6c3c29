"""Parity of the port's PPO (ray_tpu_torch.rl.ppo) with the JAX package's
rl/ppo.py on the same seeded numpy inputs and the JAX policy carried
across (`policy_from_numpy`).

Forward quantities (policy_forward, compute_gae, token_logprobs,
kl_from_logprobs, masked_mean, ppo_loss and its parts) within 1e-5;
gradients and parameters after Adam steps within 1e-4 of each leaf's
largest magnitude. `make_update_fn` is held at minibatches=1, where the
permutation (jax.random in JAX, a torch.Generator here) only reorders the
terms of a mean; one minibatch step is held on given indices.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl import ppo as tp
from ray_tpu_torch.train import optim

CONFIG = dict(obs_dim=6, n_actions=3, hidden=(16, 8), lr=1e-2, epochs=2)


@pytest.fixture(scope="module")
def setup(cpu_jax):
    import jax

    from ray_tpu.rl import ppo as jp

    jc = jp.PPOConfig(**CONFIG)
    tc = tp.PPOConfig(**CONFIG)
    params = jp.init_policy(jc, jax.random.key(0))
    rng = np.random.default_rng(0)
    n = 32
    batch = {"obs": rng.standard_normal((n, 6)).astype(np.float32),
             "actions": rng.integers(0, 3, (n,)).astype(np.int32),
             "logp_old": (np.log(1 / 3) + 0.1 * rng.standard_normal(n)
                          ).astype(np.float32),
             "advantages": rng.standard_normal(n).astype(np.float32),
             "returns": rng.standard_normal(n).astype(np.float32)}
    return jc, tc, params, jax.tree.map(np.asarray, params), batch


def _port(tree):
    return tp.policy_from_numpy(tree, device="cpu")


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_tree(got, want, rel):
    import jax

    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    got = {p: t.detach().numpy() for p, t in optim.leaves(got)}
    assert set(got) == set(want)
    for k in want:
        tol = rel * max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_init_policy_layout_and_scales():
    import jax

    from ray_tpu.rl import ppo as jp

    jc = jp.PPOConfig(**CONFIG)
    want = jax.tree.map(np.asarray, jp.init_policy(jc, jax.random.key(0)))
    got = tp.init_policy(tp.PPOConfig(**CONFIG),
                         torch.Generator().manual_seed(0), device="cpu")
    assert [p for p, _ in optim.leaves(got)] == [
        p for p, _ in optim.leaves(_port(want))]
    for (p, a), (_, b) in zip(optim.leaves(got), optim.leaves(_port(want))):
        assert a.shape == b.shape and a.dtype == torch.float32, p
    assert got["layers"][0]["b"].abs().sum() == 0


def test_policy_forward_equal_jax(setup):
    from ray_tpu.rl import ppo as jp

    _, _, params, tree, batch = setup
    wl, wv = jp.policy_forward(params, batch["obs"])
    gl, gv = tp.policy_forward(_port(tree), torch.from_numpy(batch["obs"]))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


@pytest.mark.parametrize("T,N", [(1, 3), (16, 4), (33, 2)])
def test_compute_gae_equal_jax(T, N):
    from ray_tpu.rl import ppo as jp

    rng = np.random.default_rng(T)
    rewards, values = (rng.standard_normal((T, N)).astype(np.float32)
                       for _ in range(2))
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    last = rng.standard_normal(N).astype(np.float32)
    wa, wr = jp.compute_gae(rewards, values, dones, last, 0.99, 0.95)
    ga, gr = tp.compute_gae(*(torch.from_numpy(a) for a in
                              (rewards, values, dones, last)), 0.99, 0.95)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=1e-5)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-5)


def test_token_logprobs_kl_and_masked_mean_equal_jax():
    from ray_tpu.rl import ppo as jp

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    ref = rng.standard_normal((2, 5, 11)).astype(np.float32)
    tokens = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    wlp = np.asarray(jp.token_logprobs(logits, tokens))
    glp = tp.token_logprobs(torch.from_numpy(logits),
                            torch.from_numpy(tokens))
    np.testing.assert_allclose(glp.numpy(), wlp, atol=1e-5)
    wref = np.asarray(jp.token_logprobs(ref, tokens))
    gkl = tp.kl_from_logprobs(glp, torch.from_numpy(wref))
    np.testing.assert_allclose(
        gkl.numpy(), np.asarray(jp.kl_from_logprobs(wlp, wref)), atol=1e-5)
    for m in (mask, np.zeros_like(mask)):
        np.testing.assert_allclose(
            tp.masked_mean(gkl, torch.from_numpy(m)).item(),
            float(jp.masked_mean(np.asarray(gkl.numpy()), m)), atol=1e-6)


def test_ppo_loss_and_gradients_equal_jax(setup):
    import jax

    from ray_tpu.rl import ppo as jp

    jc, tc, params, tree, batch = setup
    (wl, wm), wg = jax.value_and_grad(jp.ppo_loss, has_aux=True)(
        params, batch, jc)
    p = _port(tree)
    flat = [t.requires_grad_(True) for _, t in optim.leaves(p)]
    gl, gm = tp.ppo_loss(p, _tb(batch), tc)
    grads = torch.autograd.grad(gl, flat)
    np.testing.assert_allclose(gl.item(), float(wl), rtol=1e-5)
    for k in ("pi_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(gm[k].item(), float(wm[k]), rtol=1e-5,
                                   atol=1e-7)
    it = iter(grads)
    gtree = {"layers": [{"b": next(it), "w": next(it)} for _ in
                        p["layers"]],
             "pi": {"b": next(it), "w": next(it)},
             "vf": {"b": next(it), "w": next(it)}}
    _close_tree(gtree, wg, 1e-4)


def test_minibatch_step_equal_jax_on_given_indices(setup):
    import jax
    import optax

    from ray_tpu.rl import ppo as jp

    jc, tc, params, tree, batch = setup
    idx = np.array([3, 17, 5, 30, 11, 0, 22, 9])
    mini = {k: v[idx] for k, v in batch.items()}
    opt = optax.adam(jc.lr)
    grads = jax.grad(lambda p: jp.ppo_loss(p, mini, jc)[0])(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = optax.apply_updates(params, updates)
    p = _port(tree)
    adam = optim.AdamW(tc.lr, weight_decay=0.0)
    state = adam.init(p)
    metrics = tp.minibatch_step(p, state, _tb(mini), tc, adam)
    assert state["count"] == 1 and set(metrics) == {"pi_loss", "vf_loss",
                                                    "entropy"}
    _close_tree(p, want, 1e-4)


@pytest.mark.parametrize("epochs", [1, 3])
def test_update_equals_jax_at_one_minibatch(setup, epochs):
    import dataclasses

    import jax
    import optax

    from ray_tpu.rl import ppo as jp

    jc, tc, params, tree, batch = setup
    jc = dataclasses.replace(jc, minibatches=1, epochs=epochs)
    tc = dataclasses.replace(tc, minibatches=1, epochs=epochs)
    opt = optax.adam(jc.lr)
    want, _, wm = jp.make_update_fn(jc, opt)(params, opt.init(params),
                                             batch, jax.random.key(5))
    p = _port(tree)
    adam = optim.AdamW(tc.lr, weight_decay=0.0)
    state = adam.init(p)
    got, _, gm = tp.make_update_fn(tc, adam)(
        p, state, _tb(batch), torch.Generator().manual_seed(5))
    assert got is p and state["count"] == epochs
    for k in wm:
        np.testing.assert_allclose(gm[k].item(), float(wm[k]), rtol=1e-5,
                                   atol=1e-6)
    _close_tree(got, want, 1e-4)


def test_update_draws_its_permutations_from_the_generator(setup):
    """Four minibatches: the same seed gives the same parameters, another
    seed other ones; every minibatch steps Adam."""
    _, tc, _, tree, batch = setup

    def run(seed):
        p = _port(tree)
        adam = optim.AdamW(tc.lr, weight_decay=0.0)
        state = adam.init(p)
        tp.make_update_fn(tc, adam)(p, state, _tb(batch),
                                    torch.Generator().manual_seed(seed))
        assert state["count"] == tc.epochs * tc.minibatches
        return torch.cat([t.flatten() for _, t in optim.leaves(p)])

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
