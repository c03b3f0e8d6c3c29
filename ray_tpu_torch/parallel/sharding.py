"""Logical-axis sharding rules (port of ray_tpu/parallel/sharding.py).

Models name their array dimensions logically ("embed", "heads", ...); a
rule table maps logical names to mesh axes. One model definition runs as
DDP, FSDP, TP, SP, EP or any mix by swapping the table. A spec here is
what a PartitionSpec is in the JAX package: one entry per dimension, each
a tuple of mesh axes (outermost first; empty = replicated). A rank holds
the chunk of each dimension at its flattened index along that entry's
axes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.ops import to_torch
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import current_mesh, current_rules

MeshAxis = Union[str, Tuple[str, ...], None]
Rules = Dict[str, MeshAxis]
Spec = Tuple[Tuple[str, ...], ...]

# Default rule set for transformer training (the JAX package's FSDP recipe):
#  - params shard their embed dim over fsdp, their width dims over tp
#  - batch shards over all data-ish axes; sequence over sp (ring attention)
TRAIN_RULES: Rules = {
    "batch": ("dp", "fsdp", "ep"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    # Batch axis of expert-dispatched activations (e, b, cap, d): the ep
    # component of "batch" moves to the expert dim, so batch keeps (dp, fsdp).
    "moe_batch": ("dp", "fsdp"),
    "layers": None,
    "conv_io": None,
}

# Inference: params replicated over the (absent) fsdp axis, TP over heads/mlp,
# batch over dp, kv-cache pages over dp.
SERVE_RULES: Rules = {
    "batch": "dp",
    "seq": None,
    "embed": None,
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "moe_batch": None,
    "layers": None,
    "pages": "dp",
}


def mesh_axes(name: Optional[str], rules: Rules) -> Tuple[str, ...]:
    """The mesh axes one logical axis name maps to (empty: replicated)."""
    if name is None:
        return ()
    if name not in rules:
        raise KeyError(f"no sharding rule for logical axis {name!r}")
    return col.as_axes(rules[name])


def spec_for(logical_axes: Sequence[Optional[str]], rules: Rules) -> Spec:
    """logical axis names (None = unsharded dim) -> per-dim mesh axes."""
    return tuple(mesh_axes(name, rules) for name in logical_axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _map(fn, tree, *rest):
    """Apply fn leaf by leaf over nested dicts/lists, `tree` deciding the
    structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def _map_axes(fn, logical_tree, *rest):
    """Like _map, with the logical-axis tuples as the leaves."""
    if _is_axes(logical_tree):
        return fn(logical_tree, *rest)
    if isinstance(logical_tree, dict):
        return {k: _map_axes(fn, logical_tree[k], *(r[k] for r in rest))
                for k in logical_tree}
    raise TypeError(f"not a logical-axis tree: {logical_tree!r}")


def tree_specs(logical_tree, rules: Rules):
    """Map a tree of logical-axis tuples to a tree of specs."""
    return _map_axes(lambda axes: spec_for(axes, rules), logical_tree)


def shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's chunk of the global tensor `x` (a view)."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} does not fit shape {tuple(x.shape)}")
    for dim, axes in enumerate(spec):
        n = col.axes_size(mesh, axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible "
                             f"by {n} ({axes})")
        size = x.shape[dim] // n
        x = x.narrow(dim, col.linear_index(mesh, axes) * size, size)
    return x


def shard_tree(tree, logical_tree, rules: Rules, mesh, device=None,
               dtype=None):
    """This rank's shards of a tree of global tensors, as contiguous
    copies on `device` (default: the mesh's) in `dtype` (default: each
    leaf's own)."""
    from ray_tpu_torch.parallel.mesh import mesh_device

    dev = mesh_device(mesh) if device is None else torch.device(device)

    def one(axes, x):
        local = shard(x, spec_for(axes, rules), mesh)
        return local.to(device=dev, dtype=dtype or local.dtype,
                        copy=True).contiguous()

    return _map_axes(one, logical_tree, tree)


def shard_from_numpy(tree, logical_axes, rules: Rules, mesh, device=None,
                     dtype=None):
    """The weight carry: slice a tree of host arrays (`jax.tree.map(
    np.asarray, params)` of the JAX package) to this rank's shards, so both
    packages start from the same weights."""
    def host(axes, a):
        return to_torch(np.asarray(a))

    return shard_tree(_map_axes(host, logical_axes, tree), logical_axes,
                      rules, mesh, device, dtype)


def gather_tree(tree, specs, mesh):
    """The global tensors back from every rank's shards (outside autograd;
    every rank gets them). `specs` is a tree of specs, as `tree_specs`
    returns."""
    def one(x, spec):
        for dim, axes in enumerate(spec):
            x = col.gather_global(x.detach(), mesh, dim, axes)
        return x

    return _map(one, tree, specs)


def constrain(x: torch.Tensor, have: Sequence[Optional[str]],
              want: Sequence[Optional[str]], rules: Optional[Rules] = None):
    """Re-lay `x` from the logical layout `have` to `want` under the ambient
    mesh and rules: each mesh axis that shards a dim in `have` but not in
    `want` is all-gathered (the backward reduce-scatters). These are the
    explicit layout changes of the models (the FSDP weight gather, the
    embedding table's and lm_head's fsdp factor); a no-op outside a mesh,
    so model code calls it unconditionally. Sharding a dim further is not
    a layout change the models make and raises."""
    mesh = current_mesh()
    rules = rules if rules is not None else current_rules()
    if mesh is None or rules is None:
        return x
    for dim, (h, w) in enumerate(zip(spec_for(have, rules),
                                     spec_for(want, rules))):
        if h[:len(w)] != w:
            raise ValueError(f"constrain: dim {dim} {h} -> {w} is not a "
                             f"gather")
        x = col.all_gather(x, mesh, dim, h[len(w):])
    return x


def axes_of(name: str) -> Tuple[str, ...]:
    """The mesh axes a logical name maps to under the ambient rules; empty
    outside a mesh."""
    rules = current_rules()
    if current_mesh() is None or rules is None:
        return ()
    return mesh_axes(name, rules)


def seq_shard(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of `x` along its sequence dim under the ambient
    mesh and rules (x itself outside a mesh or when seq is unsharded)."""
    mesh, axes = current_mesh(), axes_of("seq")
    n = col.axes_size(mesh, axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"sequence {x.shape[dim]} not divisible by the "
                         f"{n} ranks of {axes}")
    size = x.shape[dim] // n
    return x.narrow(dim, col.linear_index(mesh, axes) * size, size)
