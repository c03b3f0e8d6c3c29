"""RLHF weight sync, its in-process half (port of the JAX package's
rlhf/weight_sync.py): the path-based meta table of a weight tree, leaves
in meta order and back, and the colocated hot swap into an engine.

The tree structure is described once (`describe_weights`): dict keys in
sorted order, as `jax.tree_util.tree_flatten_with_path` visits them, so
the table of the port's Llama params equals the JAX package's for the
same model (paths, shapes, numpy dtype names such as "float32" and
"bfloat16"). The object-plane broadcast (`publish_weights`,
`assemble_weights`) and the device-channel pair need the runtime and are
not ported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.core.exceptions import _unported
from ray_tpu_torch.llm.engine import WeightSyncError


def _dtype_name(leaf) -> str:
    """numpy's name of a tensor's or array's dtype ("bfloat16" for
    torch.bfloat16, as ml_dtypes names JAX's)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.dtype(leaf.dtype))


def _flatten(tree, path: Tuple = ()) -> List[Tuple[Tuple, object]]:
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        raise WeightSyncError(
            f"weight tree must be nested dicts; found a {type(tree).__name__}"
            f" at {path}")
    return [(path, tree)]


def describe_weights(params) -> List[dict]:
    """One-time structure table: [{"path", "shape", "dtype"}, ...] in
    flatten order."""
    return [{"path": path, "shape": tuple(leaf.shape),
             "dtype": _dtype_name(leaf)} for path, leaf in _flatten(params)]


def flatten_weights(params, meta: Sequence[dict]) -> List:
    """Leaves in meta order, validated against the meta table."""
    flat = _flatten(params)
    if len(flat) != len(meta):
        raise WeightSyncError(
            f"leaf count mismatch: payload {len(flat)}, meta {len(meta)}")
    leaves = []
    for (keys, leaf), m in zip(flat, meta):
        if keys != tuple(m["path"]):
            raise WeightSyncError(
                f"leaf order mismatch: payload {keys}, meta {m['path']}")
        if tuple(leaf.shape) != tuple(m["shape"]):
            raise WeightSyncError(
                f"shape mismatch at {keys}: payload {tuple(leaf.shape)}, "
                f"meta {tuple(m['shape'])}")
        if _dtype_name(leaf) != m["dtype"]:
            raise WeightSyncError(
                f"dtype mismatch at {keys}: payload {_dtype_name(leaf)}, "
                f"meta {m['dtype']}")
        leaves.append(leaf)
    return leaves


def unflatten_weights(leaves: Sequence, meta: Sequence[dict]) -> Dict:
    """Rebuild the nested-dict tree from leaves in meta order."""
    if len(leaves) != len(meta):
        raise WeightSyncError(
            f"leaf count mismatch: {len(leaves)} leaves, {len(meta)} meta")
    tree: Dict = {}
    for leaf, m in zip(leaves, meta):
        node = tree
        path = m["path"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def colocated_hot_swap(engine, params, meta: Sequence[dict], *,
                       version=None, channel=None) -> dict:
    """In-place hot swap for the colocated mode: the learner's params land
    in the engine's tensors through `update_weights` (its validation and
    prefix-cache invalidation), with no copy kept in between. The engine's
    captured graphs replay the new values with no recapture. A device
    channel between processes is the runtime's (`channel` refuses)."""
    if channel is not None:
        raise _unported("the device-channel weight swap (ROADMAP.md queue "
                        "1 item 9)")
    t0 = time.perf_counter()
    with torch.no_grad():
        info = engine.update_weights(params, version=version)
    info["sync_ms"] = (time.perf_counter() - t0) * 1e3
    return info
