"""RLHF learner at world 1 (port of the JAX package's rlhf/trainer.py
`LearnerWorker`, and `default_prompt_fn`).

The learner holds the policy (a Llama LM plus a scalar value head), the
frozen reference LM that anchors the KL penalty, and Adam; `update` runs
one PPO update over a batch of experiences on the flash-attention train
path. The gang half (world > 1 over a TCP collective group, object-plane
publishing, the device channel, placement-switch state hand-off) and the
`RLHFTrainer` loop need the runtime and refuse (ROADMAP.md queue 1
item 9).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.core.exceptions import _unported
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import resolve_device, to_numpy
from ray_tpu_torch.rl import ppo
from ray_tpu_torch.rlhf import weight_sync
from ray_tpu_torch.rlhf.rollout import Experience
from ray_tpu_torch.train.optim import AdamW, leaves


def default_prompt_fn(index: int, length: int, vocab: int) -> List[int]:
    """Deterministic synthetic prompt stream (tokens in [1, vocab))."""
    return [1 + (3 + 7 * index + 11 * j) % (vocab - 1) for j in range(length)]


def _runtime(feature: str) -> ValueError:
    return _unported(f"{feature} (the learner gang, ROADMAP.md queue 1 "
                     "item 9)")


class LearnerWorker:
    """One PPO learner at world 1.

    `hyper` holds the JAX trainer's keys: lr, clip_eps, kl_coef, gamma,
    lam, vf_coef, ent_coef, ppo_epochs, pad_batch, pad_tokens, prefix (the
    system prompt). The LM is `lm` (the port's params, or the JAX
    package's as numpy, e.g. a JAX learner's `policy["lm"]`), else random
    weights from `seed`; the policy and the reference LM are two copies of
    it on `device`, so the engine's weights, the policy and the reference
    never share storage."""

    def __init__(self, rank: int, world: int, model_kwargs: dict,
                 hyper: dict, seed: int, init_leaves=None,
                 start_version: int = 0, *, lm: Optional[Dict] = None,
                 device="cuda"):
        if world != 1 or rank != 0:
            raise _runtime(f"a learner of world {world}")
        if init_leaves is not None:
            raise _runtime("restoring a learner's state leaves")
        self.rank, self.world = 0, 1
        self.hyper = dict(hyper)
        self.version = int(start_version)
        self.device = resolve_device(device)
        kwargs = dict(model_kwargs)
        kwargs.setdefault("dtype", torch.float32)
        self.config = llama.LlamaConfig.tiny(**kwargs)
        if lm is None:
            lm = llama.init_params(self.config, torch.Generator(
                device=self.device).manual_seed(seed), self.device)
        elif not isinstance(lm["embed"], torch.Tensor):
            lm = llama.params_from_numpy(lm, self.config, self.device)

        def copy(tree):
            return {k: copy(v) if isinstance(v, dict)
                    else v.detach().to(self.device, copy=True)
                    for k, v in tree.items()}

        self.ref_lm = copy(lm)
        d = self.config.d_model
        self.policy = {"lm": copy(lm),
                       "vf": {"w": torch.zeros((d, 1), device=self.device),
                              "b": torch.zeros((1,), device=self.device)}}
        for _, p in leaves(self.policy):
            p.requires_grad_(True)
        # optax.adam: AdamW without weight decay.
        self.optimizer = AdamW(self.hyper["lr"], weight_decay=0.0)
        self.opt_state = self.optimizer.init(self.policy)
        self.lm_meta = weight_sync.describe_weights(self.policy["lm"])

    # -- the PPO math ----------------------------------------------------
    def _logits_values(self, policy, tokens):
        hidden = llama.backbone(policy["lm"], tokens, self.config)
        h32 = hidden.float()
        logits = h32 @ policy["lm"]["lm_head"].float()
        values = (h32 @ policy["vf"]["w"])[..., 0] + policy["vf"]["b"]
        return logits, values

    @torch.no_grad()
    def _stats(self, tokens, resp_mask, rewards, valid):
        """Behavior logprobs (a constant for the PPO ratio), KL-shaped
        per-token rewards, GAE advantages and returns."""
        hp = self.hyper
        logits, values = self._logits_values(self.policy, tokens)
        logp = ppo.token_logprobs(logits[:, :-1], tokens[:, 1:])
        ref_logits = llama.forward(self.ref_lm, tokens, self.config)
        ref_logp = ppo.token_logprobs(ref_logits[:, :-1], tokens[:, 1:])
        m = resp_mask[:, 1:] * valid[:, None]
        kl = ppo.kl_from_logprobs(logp, ref_logp) * m
        term = m * (1.0 - torch.cat([m[:, 1:], torch.zeros_like(m[:, :1])],
                                    dim=1))
        r = -hp["kl_coef"] * kl + rewards[:, None] * term
        v = values[:, :-1] * m
        adv_t, ret_t = ppo.compute_gae(r.T, v.T, term.T,
                                       torch.zeros_like(rewards),
                                       hp["gamma"], hp["lam"])
        adv, ret = adv_t.T, ret_t.T
        mean = ppo.masked_mean(adv, m)
        var = ppo.masked_mean((adv - mean) ** 2, m)
        adv = (adv - mean) / torch.sqrt(var + 1e-8)
        return logp, adv * m, ret, m, ppo.masked_mean(kl, m)

    def _loss(self, tokens, old_logp, adv, ret, m):
        hp = self.hyper
        clip = hp["clip_eps"]
        logits, values = self._logits_values(self.policy, tokens)
        logp = ppo.token_logprobs(logits[:, :-1], tokens[:, 1:])
        ratio = torch.exp(logp - old_logp)
        clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
        pg = -ppo.masked_mean(torch.minimum(ratio * adv, clipped * adv), m)
        vloss = ppo.masked_mean((values[:, :-1] - ret) ** 2, m)
        logp_all = torch.log_softmax(logits[:, :-1], dim=-1)
        ent = ppo.masked_mean(-(torch.exp(logp_all) * logp_all).sum(-1), m)
        total = pg + hp["vf_coef"] * vloss - hp["ent_coef"] * ent
        return total, (pg, vloss, ent)

    # -- gang lifecycle (the runtime's) ----------------------------------
    def setup(self, group_name: str) -> int:
        raise _runtime("the learner's collective group")

    def teardown(self) -> None:
        raise _runtime("the learner's collective group")

    # -- PPO update ------------------------------------------------------
    def _batch(self, experiences: Sequence[Experience]):
        prefix = list(self.hyper["prefix"])
        B = self.hyper["pad_batch"]
        T = self.hyper["pad_tokens"]
        shard = sorted(experiences, key=lambda e: e.seq_no)
        if len(shard) > B:
            raise ValueError(
                f"rank {self.rank} shard {len(shard)} exceeds pad_batch {B}")
        tokens = np.zeros((B, T), np.int32)
        resp_mask = np.zeros((B, T), np.float32)
        valid = np.zeros((B,), np.float32)
        rewards = np.zeros((B,), np.float32)
        for i, e in enumerate(shard):
            seq = (prefix + list(e.prompt) + list(e.response))[:T]
            tokens[i, :len(seq)] = seq
            lo = min(len(prefix) + len(e.prompt), T)
            resp_mask[i, lo:len(seq)] = 1.0
            valid[i] = 1.0
            rewards[i] = e.reward
        return tokens, resp_mask, valid, rewards, len(shard)

    def update(self, experiences: Sequence[Experience]) -> dict:
        """One PPO update over a batch of experiences (sorted by seq_no),
        `ppo_epochs` Adam steps on the same statistics."""
        tokens, resp_mask, valid, rewards, n = self._batch(experiences)
        tokens, resp_mask, valid, rewards = (
            torch.from_numpy(a).to(self.device)
            for a in (tokens.astype(np.int64), resp_mask, valid, rewards))
        old_logp, adv, ret, m, kl = self._stats(tokens, resp_mask, rewards,
                                                valid)
        params = [p for _, p in leaves(self.policy)]
        loss = pg = vloss = torch.zeros(())
        for _ in range(self.hyper["ppo_epochs"]):
            loss, (pg, vloss, _ent) = self._loss(tokens, old_logp, adv, ret,
                                                 m)
            grads = torch.autograd.grad(loss, params)
            self.optimizer.update(self.policy, grads, self.opt_state)
        self.version += 1
        loss, pg, vloss = (t.detach() for t in (loss, pg, vloss))
        return {"version": self.version, "loss": float(loss),
                "pg_loss": float(pg), "vf_loss": float(vloss),
                "kl": float(kl),
                "reward_mean": float(rewards.sum() / max(1, n)),
                "n": n}

    # -- weight sync / introspection -------------------------------------
    def get_lm_meta(self) -> List[dict]:
        return self.lm_meta

    def publish(self, broadcast: bool = True, node_ids=None):
        raise _runtime("publishing weights through the object plane")

    def send_lm_channel(self, channel) -> int:
        raise _runtime("the device-channel weight swap")

    def state_leaves(self):
        raise _runtime("the placement-switch state hand-off")

    def state_snapshot(self, directory: Optional[str] = None):
        raise _runtime("the placement-switch state hand-off")

    def lm_leaves(self) -> List[np.ndarray]:
        """LM leaves (meta order) as host arrays (bf16 as uint16 bits)."""
        return [to_numpy(t) for t in
                weight_sync.flatten_weights(self.policy["lm"], self.lm_meta)]

    @torch.no_grad()
    def greedy_tokens(self, prompt, max_new_tokens: int = 8) -> List[int]:
        """Greedy continuation via the naive (non-paged) forward: the
        learner's half of the engine/learner identity probe."""
        tokens = list(prompt)
        for _ in range(max_new_tokens):
            logits = llama.forward(
                self.policy["lm"],
                torch.tensor([tokens], dtype=torch.long, device=self.device),
                self.config)
            tokens.append(int(torch.argmax(logits[0, -1])))
        return tokens[len(prompt):]

    def ping(self) -> int:
        return self.rank
