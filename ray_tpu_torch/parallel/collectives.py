"""Autograd-aware collectives: the port's counterpart of what GSPMD
inserts for the JAX package.

Each takes the mesh axes it runs over (a name or a tuple of names, the
first the outermost, as a rule-table entry) and skips axes of size 1, so
a mesh of one rank runs no collective and adds no autograd node. Pairs of
forward and backward:

  all_gather     all-gather along a dim   <->  reduce-scatter (sum)
  copy_to        identity                 <->  all-reduce (sum)   Megatron f
  reduce_from    all-reduce (sum)         <->  identity           Megatron g
  ring_shift     send to next, recv prev  <->  send to prev, recv next
  all_to_all     split one dim, concat another <-> the inverse all-to-all

Conventions of the sharded models: an activation replicated over `tp`
carries its full gradient on every tp rank (copy_to before a
column-parallel product, reduce_from after a row-parallel one); a
parameter replicated over a data axis carries its rank's partial
gradient, which `fsdp.reduce_gradients` sums (all_gather's reduce-scatter
does it for the fsdp factor). Every rank issues the same collectives in
the same order: the models take the same code path on every rank.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import AXES

Axes = Union[str, Sequence[str], None]

# torch 2.13 renamed the single-tensor collectives; earlier ones have only
# the old names.
_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def as_axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def live_axes(mesh, axes: Axes) -> Tuple[str, ...]:
    """The axes of `axes` that have more than one rank."""
    if mesh is None:
        return ()
    return tuple(a for a in as_axes(axes) if mesh.size(AXES.index(a)) > 1)


def linear_index(mesh, axes: Axes) -> int:
    """This rank's index along the flattened `axes`, the first outermost
    (a PartitionSpec entry's order)."""
    idx = 0
    for a in as_axes(axes):
        idx = idx * mesh.size(AXES.index(a)) + mesh.get_local_rank(a)
    return idx


def axes_size(mesh, axes: Axes) -> int:
    n = 1
    for a in as_axes(axes):
        n *= 1 if mesh is None else mesh.size(AXES.index(a))
    return n


# ---------------------------------------------------------------- raw ops

def _gather(x, dim, group):
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    _gather_single(out, src, group=group)
    return out.movedim(0, dim)


def _scatter(x, dim, group):
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    _scatter_single(out, src, group=group)
    return out.movedim(0, dim)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce(x: torch.Tensor, mesh, axes: Axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce outside autograd (metrics, gradients, maxima), over each
    live axis in turn."""
    for a in live_axes(mesh, axes):
        x = _all_reduce(x, mesh.get_group(a), op)
    return x


def gather_global(x: torch.Tensor, mesh, dim: int, axes: Axes):
    """All-gather along `dim` over `axes` outside autograd, innermost axis
    first, so that the chunks land in the order of the flattened index."""
    for a in reversed(live_axes(mesh, axes)):
        x = _gather(x, dim, mesh.get_group(a))
    return x


# ---------------------------------------------------------------- autograd

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x, mesh, dim: int, axes: Axes):
    """Sharded over `axes` along `dim` -> whole along `dim`; the backward
    reduce-scatters (sums the ranks' partial gradients)."""
    for a in reversed(live_axes(mesh, axes)):
        x = _AllGather.apply(x, dim, mesh.get_group(a))
    return x


def copy_to(x, mesh, axes: Axes):
    """Megatron's f: identity forward, all-reduce of the gradient."""
    for a in live_axes(mesh, axes):
        x = _CopyTo.apply(x, mesh.get_group(a))
    return x


def reduce_from(x, mesh, axes: Axes):
    """Megatron's g: all-reduce forward, identity backward."""
    for a in live_axes(mesh, axes):
        x = _ReduceFrom.apply(x, mesh.get_group(a))
    return x


def _shift(tensors, group, offset):
    """Send each tensor `offset` ranks on along the group's ring and
    receive the one from `offset` ranks back."""
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    to = dist.get_global_rank(group, (me + offset) % n)
    frm = dist.get_global_rank(group, (me - offset) % n)
    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, to, group),
                dist.P2POp(dist.irecv, out, frm, group)]
        outs.append(out)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(_shift(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(grads, ctx.group, -1))


def ring_shift(tensors, mesh, axis: str):
    """Every rank passes `tensors` to the next rank along `axis` and gets
    the previous rank's; the backward sends the gradients the other way."""
    if not live_axes(mesh, axis):
        return tuple(tensors)
    return _RingShift.apply(mesh.get_group(axis), *tensors)


def _a2a(x, split_dim, concat_dim, group):
    n = dist.get_world_size(group)
    parts = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _a2a(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """Chunk j of `split_dim` goes to rank j of `axis`; the chunks
    received are concatenated along `concat_dim` in rank order (JAX's
    tiled `lax.all_to_all`). The backward is the inverse all-to-all."""
    if not live_axes(mesh, axis):
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, mesh.get_group(axis))
