"""The single-device Llama train step (the counterpart of the JAX
package's bench step: `llama.loss_fn` -> `jax.value_and_grad` ->
`optax.adamw`).

    opt = adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=torch.bfloat16)
    state = init_state(config, opt, torch.Generator("cuda").manual_seed(0))
    step = make_step(config, opt)
    state, loss = step(state, tokens)      # tokens: (b, seq + 1) int

Runs on the card by default; `device="cpu"` runs the plain versions.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.train.optim import AdamW, leaves
from ray_tpu_torch.util.tracing import profile_range


def init_state(config: llama.LlamaConfig, opt: AdamW,
               generator: torch.Generator, device="cuda") -> Dict:
    """Random parameters (llama.init_params) that require grad, and the
    optimizer state for them."""
    params = llama.init_params(config, generator, device)
    for _, p in leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": opt.init(params)}


def make_step(config: llama.LlamaConfig,
              opt: AdamW) -> Callable[[Dict, torch.Tensor],
                                      Tuple[Dict, torch.Tensor]]:
    """step(state, tokens) -> (state, loss): the loss of the parameters
    before the update, then one optimizer update in place."""

    def step(state: Dict, tokens: torch.Tensor):
        params = state["params"]
        loss, _ = llama.loss_fn(params, {"tokens": tokens}, config)
        grads = torch.autograd.grad(loss, [p for _, p in leaves(params)])
        with profile_range("optimizer"):
            opt.update(params, grads, state["opt"])
        return state, loss.detach()

    return step
