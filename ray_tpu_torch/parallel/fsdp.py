"""The sharded training step (port of ray_tpu/parallel/fsdp.py):
DP/FSDP/TP/SP/EP by the rule table.

    init_fn, make_step = build_train_step(
        lambda p, b: llama.loss_fn(p, b, config), adamw(1e-4), mesh,
        llama.param_logical_axes(config), {"tokens": ("batch", None)})
    state, specs = init_fn(global_params)      # this rank's shards
    step = make_step(specs)
    state, metrics = step(state, {"tokens": global_tokens})

The JAX package jits one step with NamedShardings and lets XLA insert the
collectives; here the model issues them itself under `use_mesh` (see
models/llama.py), and the step adds the two reductions GSPMD derives from
the shardings: each gradient is summed over the batch axes its parameter
is replicated on (`reduce_gradients`; the fsdp factor of a gathered weight
was summed by the gather's reduce-scatter), and the global norm sums each
leaf's squares over the axes it is sharded on (`global_norm`). AdamW then
runs elementwise on the local shards.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import sharding as sharding_mod
from ray_tpu_torch.parallel.mesh import batch_axes, use_mesh
from ray_tpu_torch.train.optim import AdamW, leaves


def init_train_state(params, optimizer: AdamW) -> Dict:
    """{"params", "opt_state", "step"}; params require grad."""
    for _, p in leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": 0}


def flat_specs(specs) -> List[Tuple]:
    """A tree of specs as a list in `optim.leaves` order (sorted keys)."""
    if not isinstance(specs, dict):
        return [specs]
    return [s for key in sorted(specs) for s in flat_specs(specs[key])]


def state_specs(param_specs) -> Dict:
    """The state's specs: the AdamW moments mirror their parameters (the
    counterpart of the JAX package's `_spec_like_params`), scalars are
    replicated."""
    flat = flat_specs(param_specs)
    return {"params": param_specs,
            "opt_state": {"count": (), "mu": list(flat), "nu": list(flat)},
            "step": ()}


def _sharded_on(spec) -> Tuple[str, ...]:
    return tuple(a for axes in spec for a in axes)


def reduce_gradients(grads: Sequence[torch.Tensor], specs: Sequence, mesh
                     ) -> List[torch.Tensor]:
    """Sum each gradient over the batch axes its parameter is replicated
    on (the other ranks there saw other tokens)."""
    out = []
    for g, spec in zip(grads, specs):
        axes = [a for a in batch_axes() if a not in _sharded_on(spec)]
        out.append(col.all_reduce(g, mesh, axes))
    return out


def global_norm(grads: Sequence[torch.Tensor], specs: Sequence, mesh
                ) -> torch.Tensor:
    """optax.global_norm of the global gradient from local shards: each
    leaf's sum of squares (fp32) is summed over the axes the leaf is
    sharded on, never over those it is replicated on."""
    by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, spec in zip(grads, specs):
        key = tuple(sorted(set(_sharded_on(spec))))
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        by_axes[key] = by_axes[key] + sq if key in by_axes else sq
    total = sum(col.all_reduce(sq, mesh, axes)
                for axes, sq in sorted(by_axes.items()))
    return torch.sqrt(total)


def build_train_step(
    loss_fn: Callable[[Any, Any], Tuple[torch.Tensor, Dict]],
    optimizer: AdamW,
    mesh,
    param_axes,
    batch_axes_tree,
    rules: Optional[Dict] = None,
) -> Tuple[Callable, Callable]:
    """Returns (init_fn, make_step).

    - loss_fn(params, batch) -> (loss, metrics), run under
      use_mesh(mesh, rules) on this rank's shards
    - param_axes / batch_axes_tree: trees of logical-axis tuples
    - init_fn(global_params) -> (state of this rank's shards, state specs)
    - make_step(specs) -> step(state, global_batch) -> (state, metrics),
      updating the state in place; metrics are loss_fn's (detached) and
      "grad_norm", equal on every rank
    """
    rules = rules or sharding_mod.TRAIN_RULES
    param_specs = sharding_mod.tree_specs(param_axes, rules)

    def init_fn(params):
        local = sharding_mod.shard_tree(params, param_axes, rules, mesh)
        return init_train_state(local, optimizer), state_specs(param_specs)

    def make_step(specs):
        specs_list = flat_specs(specs["params"])

        def step(state, batch):
            params = state["params"]
            flat = [p for _, p in leaves(params)]
            local = sharding_mod.shard_tree(batch, batch_axes_tree, rules,
                                            mesh)
            with use_mesh(mesh, rules):
                loss, metrics = loss_fn(params, local)
                grads = torch.autograd.grad(loss, flat)
            grads = reduce_gradients(grads, specs_list, mesh)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = global_norm(grads, specs_list, mesh)
            optimizer.update(params, grads, state["opt_state"])
            state["step"] += 1
            return state, metrics

        return step

    return init_fn, make_step
