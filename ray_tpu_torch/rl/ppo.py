"""PPO: policy/value model, GAE, clipped objective (port of the JAX
package's rl/ppo.py).

The update runs on the port's AdamW (`optax.adam` is
`AdamW(lr, weight_decay=0)`), in place; its minibatch permutations come
from an explicit `torch.Generator`. The policy is a dict of fp32 tensors
with the JAX package's keys ({"layers": [{"w", "b"}, ...], "pi", "vf"}),
so a JAX policy carries across through `policy_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops import resolve_device, to_torch
from ray_tpu_torch.train.optim import AdamW, leaves


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    env: str = "CartPole-v1"
    obs_dim: int = 4
    n_actions: int = 2
    hidden: Tuple[int, ...] = (64, 64)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 3e-4
    rollout_length: int = 128
    num_env_runners: int = 2
    envs_per_runner: int = 8
    epochs: int = 4
    minibatches: int = 4
    iterations: int = 10


def init_policy(config: PPOConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """The JAX package's initialisation (He-normal hidden layers, pi
    N(0, 0.01²), vf N(0, 1), zero biases), drawn from `generator`, which
    must live on `device`."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    sizes = (config.obs_dim,) + tuple(config.hidden)
    layers = [{"w": normal(sizes[i], sizes[i + 1])
               * math.sqrt(2.0 / sizes[i]),
               "b": torch.zeros(sizes[i + 1], device=dev)}
              for i in range(len(sizes) - 1)]
    return {"layers": layers,
            "pi": {"w": normal(sizes[-1], config.n_actions) * 0.01,
                   "b": torch.zeros(config.n_actions, device=dev)},
            "vf": {"w": normal(sizes[-1], 1) * 1.0,
                   "b": torch.zeros(1, device=dev)}}


def policy_from_numpy(tree: Dict, device="cuda") -> Dict:
    """A JAX policy (`jax.tree.map(np.asarray, init_policy(...))`) as the
    port's fp32 tensors on `device`."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return to_torch(np.asarray(node, np.float32)).to(dev, copy=True)

    return conv(tree)


def policy_forward(params: Dict, obs: torch.Tensor):
    x = obs
    for layer in params["layers"]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """rewards/values/dones: (T, N). Returns (advantages, returns): the
    JAX package's reverse scan as a reversed loop over T."""
    next_adv = torch.zeros_like(last_value)
    next_value = last_value
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        next_adv = delta + gamma * lam * nonterminal * next_adv
        next_value = values[t]
        advs[t] = next_adv
    advs = torch.stack(advs)
    return advs, advs + values


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log p(token) under `logits`: (..., T, V) float logits and (..., T)
    int token ids -> (..., T)."""
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, tokens[..., None].long())[..., 0]


def kl_from_logprobs(logp: torch.Tensor,
                     logp_ref: torch.Tensor) -> torch.Tensor:
    """Per-token sampled KL estimate (the k1 estimator) between the policy
    that produced the tokens and a reference policy."""
    return logp - logp_ref


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `x` over positions where `mask` is 1."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def ppo_loss(params, batch, config: PPOConfig):
    logits, values = policy_forward(params, batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"][..., None].long())[..., 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    # jnp.std is the biased (population) deviation.
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - config.clip, 1 + config.clip) * adv
    pi_loss = -torch.minimum(unclipped, clipped).mean()
    vf_loss = 0.5 * ((values - batch["returns"]) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pi_loss + config.vf_coef * vf_loss - config.entropy_coef * entropy
    return total, {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy}


def minibatch_step(params, opt_state, mini, config: PPOConfig,
                   optimizer: AdamW) -> Dict[str, torch.Tensor]:
    """One PPO step on one minibatch, in place; returns its metrics."""
    flat = [p for _, p in leaves(params)]
    for p in flat:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = ppo_loss(params, mini, config)
        grads = torch.autograd.grad(loss, flat)
    optimizer.update(params, grads, opt_state)
    return {k: v.detach() for k, v in metrics.items()}


def make_update_fn(config: PPOConfig, optimizer: AdamW):
    """update(params, opt_state, batch, generator) -> (params, opt_state,
    mean metrics): `config.epochs` passes over the batch, each in
    `config.minibatches` minibatches of a permutation drawn from
    `generator` (on the batch's device)."""

    def update(params, opt_state, batch, generator: torch.Generator):
        n = batch["obs"].shape[0]
        mb = n // config.minibatches
        metrics = []
        for _ in range(config.epochs):
            perm = torch.randperm(n, generator=generator,
                                  device=batch["obs"].device)
            for i in range(config.minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                mini = {k: v[idx] for k, v in batch.items()}
                metrics.append(minibatch_step(params, opt_state, mini,
                                              config, optimizer))
        mean = {k: torch.stack([m[k] for m in metrics]).mean()
                for k in metrics[0]}
        return params, opt_state, mean

    return update
