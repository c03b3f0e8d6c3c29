"""Train backends: how a worker group becomes a distributed compute group
(port of ray_tpu/train/backend.py).

Reference analog: train/torch/config.py:36,153 (_TorchBackend wiring
init_process_group over NCCL) and backend_executor's rank/env plumbing.

  * TorchBackend — a named collective group on the torch backend (NCCL
    for CUDA tensors, gloo for CPU ones; collective/torch_backend.py), in
    place of the JAX package's JaxBackend (jax.distributed). Gradients
    stay on the card.
  * CollectiveBackend — the tcp collective group (collective/cpu_group.py),
    the CPU-testable data-parallel path: each worker computes gradients
    and allreduces them through the host.

`reduce_gradients` is the data-parallel gradient sync both run.
`allreduce_gradients` books its time to the Train session's step phase,
so it comes with the Train library.
"""

from __future__ import annotations

from typing import Dict, Optional


class Backend:
    backend_name = "base"

    def on_start(self, rank: int, world_size: int, group_name: str):
        """Runs INSIDE each train worker before the user function."""

    def on_shutdown(self, rank: int, world_size: int, group_name: str):
        pass


class CollectiveBackend(Backend):
    """A collective group (the tcp backend by default) for out-of-program
    data-parallel gradient sync."""

    backend_name = "collective"
    collective_backend = "tcp"

    def __init__(self):
        self.comm = None

    def on_start(self, rank: int, world_size: int, group_name: str):
        from ray_tpu_torch.collective.collective import init_collective_group

        global _active_group
        self.comm = init_collective_group(
            world_size, rank, backend=self.collective_backend,
            group_name=group_name)
        _active_group = group_name

    def on_shutdown(self, rank: int, world_size: int, group_name: str):
        from ray_tpu_torch.collective.collective import \
            destroy_collective_group

        try:
            destroy_collective_group(group_name)
        except Exception:
            pass
        self.comm = None


class TorchBackend(CollectiveBackend):
    """The worker group as a torch collective group: NCCL between the
    workers' cards (each worker holds its card as cuda:0, the raylet's
    CUDA_VISIBLE_DEVICES), gloo for CPU tensors."""

    backend_name = "torch"
    collective_backend = "torch"


BACKENDS = {"torch": TorchBackend, "collective": CollectiveBackend,
            "none": Backend}

# The collective group name of the train job running in this worker
# process (set by a backend's on_start).
_active_group: Optional[str] = None


def make_backend(name_or_backend) -> Backend:
    if isinstance(name_or_backend, Backend):
        return name_or_backend
    return BACKENDS[name_or_backend or "none"]()


def _flatten(tree, out: list):
    """Leaves of nested dicts (keys sorted, as jax.tree_util orders them),
    lists and tuples, appended to `out`; returns a function that rebuilds
    the structure from a list of new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k], out) for k in keys]
        return lambda it: {k: p(it) for k, p in zip(keys, parts)}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x, out) for x in tree]
        kind = type(tree)
        return lambda it: kind(p(it) for p in parts)
    out.append(tree)
    return lambda it: next(it)


def _dtype_key(leaf) -> str:
    dt = leaf.dtype
    return dt.str if hasattr(dt, "str") else str(dt)


def reduce_gradients(comm, grads, bucket_bytes: Optional[int] = None):
    """Bucketed, overlapped mean-allreduce of a tree of gradients over
    `comm` (a group of either backend).

    Reference analog: torch DDP's gradient-bucketing Reducer. Leaves
    (tensors on any device, or numpy arrays) are grouped by dtype (never
    concatenated across dtypes) and coalesced into flat buckets of about
    `bucket_bytes` (cfg().ddp_bucket_bytes by default). Each bucket's
    allreduce launches asynchronously THE MOMENT the bucket fills, so the
    reduction of early buckets overlaps the flatten work of later ones,
    and the group's FIFO order pipelines them back to back. The handles
    are then waited in launch order and the leaves scattered back in
    their tree positions and dtypes (an integer mean comes back float64
    and is cast back, as JAX's)."""
    import numpy as np

    from ray_tpu_torch.config import cfg

    if bucket_bytes is None:
        bucket_bytes = cfg().ddp_bucket_bytes
    bucket_bytes = max(1, int(bucket_bytes))

    leaves: list = []
    rebuild = _flatten(grads, leaves)
    tensors = [hasattr(x, "detach") for x in leaves]
    arrs = [x.detach() if t else np.asarray(x)
            for x, t in zip(leaves, tensors)]
    out: list = [None] * len(arrs)

    open_buckets: Dict[str, list] = {}
    open_bytes: Dict[str, int] = {}
    launched: list = []   # (Work, dtype key, [(leaf idx, shape, size)])

    def nbytes(a) -> int:
        return a.numel() * a.element_size() if hasattr(a, "numel") \
            else a.nbytes

    def _flush(dt: str):
        entries = open_buckets.pop(dt, None)
        open_bytes.pop(dt, None)
        if not entries:
            return
        views = [v for _, v in entries]
        if hasattr(views[0], "numel"):
            import torch

            flat = torch.cat(views) if len(views) > 1 else views[0]
        else:
            flat = np.concatenate(views) if len(views) > 1 \
                else np.ascontiguousarray(views[0])
        meta = [(i, tuple(arrs[i].shape), int(np.prod(arrs[i].shape)))
                for i, _ in entries]
        launched.append((comm.allreduce_async(flat, op="mean"), dt, meta))

    for i, a in enumerate(arrs):
        dt = _dtype_key(a)
        open_buckets.setdefault(dt, []).append((i, a.reshape(-1)))
        open_bytes[dt] = open_bytes.get(dt, 0) + nbytes(a)
        if open_bytes[dt] >= bucket_bytes:
            _flush(dt)
    for dt in list(open_buckets):
        _flush(dt)

    for work, dt, meta in launched:
        reduced = work.wait()
        i0 = meta[0][0]
        if _dtype_key(reduced) != dt:   # integer mean comes back float64
            reduced = reduced.to(arrs[i0].dtype) if tensors[i0] \
                else np.asarray(reduced).astype(np.dtype(dt))
        offset = 0
        for i, shape, size in meta:
            out[i] = reduced[offset:offset + size].reshape(shape)
            offset += size
    return rebuild(iter(out))


def allreduce_gradients(grads, group_name: Optional[str] = None,
                        bucket_bytes: Optional[int] = None):
    """The Train library's DDP helper (JAX: reduce_gradients inside the
    session's "collective" step phase). Refused until the Train library's
    session is ported; call `reduce_gradients` on a group instead."""
    from ray_tpu_torch.core.exceptions import _unported

    raise _unported("allreduce_gradients (it books its time to the Train "
                    "session's step phase, ROADMAP queue 1 item 7e)")
