"""Device mesh construction and axis conventions (port of
ray_tpu/parallel/mesh.py).

One `torch.distributed.device_mesh.DeviceMesh` whose five named axes
carry every in-program strategy:

  axis   | strategy
  -------+-----------------------------------
  dp     | data parallel (pure replication)
  fsdp   | data parallel + parameter sharding
  sp     | sequence/context parallel (ring or Ulysses attention)
  ep     | expert parallel
  tp     | tensor parallel

Axis order is outer-to-inner by communication intensity, as in the JAX
package: `tp` innermost, so its ranks are adjacent (consecutive ranks,
which on one host share the fastest links), `dp` outermost.

The caller initialises the default process group (torchrun, or
`parallel.launch.spawn`): NCCL for a mesh on CUDA, gloo for a mesh on the
CPU. `build_mesh` never picks a backend itself and never falls back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

AXES = ("dp", "fsdp", "sp", "ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.sp * self.ep * self.tp

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.fsdp, self.sp, self.ep, self.tp)

    @staticmethod
    def auto(num_devices: int, *, tp: int = 1, sp: int = 1, ep: int = 1,
             dp: Optional[int] = None) -> "MeshConfig":
        """Fill the fsdp axis with whatever tp/sp/ep/dp leave over."""
        used = tp * sp * ep * (dp or 1)
        if num_devices % used != 0:
            raise ValueError(
                f"{num_devices} devices not divisible by tp*sp*ep*dp={used}")
        return MeshConfig(dp=dp or 1, fsdp=num_devices // used, sp=sp, ep=ep,
                          tp=tp)


_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


def build_mesh(config: MeshConfig, device="cuda"):
    """The named DeviceMesh over the default process group's ranks, in
    rank order with `tp` innermost, made from one process group per axis
    (`_axis_groups`). Raises when the world size is not
    `config.num_devices`, when CUDA is asked for but missing, or when the
    process group lacks the backend for `device` (NCCL for CUDA, gloo for
    the CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch.ops import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised default process "
                           "group (torchrun or parallel.launch.spawn)")
    n = dist.get_world_size()
    if config.num_devices != n:
        raise ValueError(
            f"mesh config wants {config.num_devices} devices, have {n}")
    want = _BACKEND_FOR[dev.type]
    if want not in str(dist.get_backend()):
        raise RuntimeError(
            f"a mesh on {dev.type} needs the {want} backend; the process "
            f"group runs {dist.get_backend()!r}")
    sizes = config.axis_sizes()
    layout = torch.arange(n).reshape(sizes)
    return DeviceMesh.from_group(_axis_groups(layout), dev.type,
                                 mesh=layout, mesh_dim_names=AXES)


def _axis_groups(layout: torch.Tensor) -> list:
    """This rank's process group along each axis of `layout` (global
    ranks in mesh order). Every rank makes every group, axis by axis and
    slice by slice in one order (new_group is collective); an axis that
    spans the whole world takes the default group. init_device_mesh
    builds these through `split_group` instead, which on H100s (torch
    2.11, CUDA 12.8) crashed the second NCCL world of a process."""
    import torch.distributed as dist

    me = dist.get_rank()
    groups = []
    for axis in range(layout.dim()):
        slices = layout.movedim(axis, -1).reshape(-1, layout.shape[axis])
        mine = None
        for ranks in slices.tolist():
            group = (dist.group.WORLD if len(ranks) == layout.numel()
                     else dist.new_group(ranks))
            if me in ranks:
                mine = group
        groups.append(mine)
    return groups


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


_CURRENT_MESH = None
_CURRENT_RULES = None


class use_mesh:
    """Context manager installing `mesh` (and optionally the active
    logical-axis `rules`) as ambient state. Model code reads it to issue
    its collectives; outside it the models run their single-device path."""

    def __init__(self, mesh, rules=None):
        self.mesh = mesh
        self.rules = rules
        self._prev = None

    def __enter__(self):
        global _CURRENT_MESH, _CURRENT_RULES
        self._prev = (_CURRENT_MESH, _CURRENT_RULES)
        _CURRENT_MESH = self.mesh
        if self.rules is not None:
            _CURRENT_RULES = self.rules
        return self.mesh

    def __exit__(self, *exc):
        global _CURRENT_MESH, _CURRENT_RULES
        _CURRENT_MESH, _CURRENT_RULES = self._prev
        return False


def current_mesh():
    return _CURRENT_MESH


def current_rules():
    return _CURRENT_RULES


def batch_axes() -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return ("dp", "fsdp", "sp", "ep")


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def data_parallel_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in batch_axes())
