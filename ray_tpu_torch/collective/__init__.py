"""The out-of-program collective plane: named groups of actors over the
port's runtime (collective.py), with a tcp ring backend (cpu_group.py,
whose frame layer the KV stream shares) and a torch backend
(torch_backend.py: NCCL for CUDA tensors, gloo for CPU tensors).
Importing this package loads no torch."""

from ray_tpu_torch.collective.collective import (  # noqa: F401
    abort_collective_group,
    allgather,
    allreduce,
    allreduce_async,
    alltoall,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    recv,
    reducescatter,
    send,
)
from ray_tpu_torch.collective.communicator import Communicator, Work  # noqa: F401
from ray_tpu_torch.core.exceptions import CollectiveAbortError  # noqa: F401
