"""Collective API over named groups (port of
ray_tpu/collective/collective.py).

Reference analog: python/ray/util/collective/collective.py
(init_collective_group:123, allreduce:268, barrier:308, broadcast:383,
allgather:433, reducescatter:482, send:541, recv:604). Rendezvous goes
through the GCS KV of the port's runtime.

Backends:
  * "tcp"   — TCPCommunicator (collective/cpu_group.py): chunked ring
              algorithms over per-rank p2p links with zero-pickle raw
              frames (cfg().collective_topology selects "ring"/"hub"),
              the JAX package's wire byte for byte. Takes numpy arrays
              and tensors (copied to the host). Async handles complete in
              FIFO order on a per-group op thread.
  * "torch" — TorchCommunicator (collective/torch_backend.py): NCCL for
              CUDA tensors, gloo for CPU tensors, results on the input's
              device; the port's counterpart of the JAX "jax" backend.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ray_tpu_torch.collective.communicator import Communicator, abort_key
from ray_tpu_torch.collective.cpu_group import TCPCommunicator

_groups: Dict[str, Communicator] = {}


def _gcs_kv():
    from ray_tpu_torch.core.worker import global_worker

    core = global_worker()

    def kv_put(key: str, value: str):
        core.io.run(core.gcs.call("kv_put", key=key.encode(),
                                  value=value.encode()))

    def kv_get(key: str) -> Optional[str]:
        reply = core.io.run(core.gcs.call("kv_get", key=key.encode()))
        return reply["value"].decode() if reply["value"] is not None \
            else None

    return kv_put, kv_get


def init_collective_group(world_size: int, rank: int, backend: str = "tcp",
                          group_name: str = "default") -> Communicator:
    if group_name in _groups:
        raise ValueError(f"collective group {group_name!r} already "
                         "initialized")
    kv_put, kv_get = _gcs_kv()
    if backend == "tcp":
        comm = TCPCommunicator(rank, world_size, group_name, kv_put, kv_get)
    elif backend == "torch":
        from ray_tpu_torch.collective.torch_backend import TorchCommunicator

        comm = TorchCommunicator(rank, world_size, group_name, kv_put,
                                 kv_get)
    else:
        raise ValueError(f"unknown collective backend {backend!r}")
    _groups[group_name] = comm
    return comm


def abort_collective_group(group_name: str = "default",
                           reason: str = "aborted") -> None:
    """Abort a group's in-flight and future ops everywhere.

    Writes the group's KV abort flag: every member rank's watchdog picks
    it up within one `collective_watchdog_interval_s` and raises
    CollectiveAbortError out of any blocked op. Callable from ANY process
    that can reach the GCS, not only from group members. If this process
    holds the group, it is also aborted locally (at once, no watchdog
    latency).
    """
    comm = _groups.get(group_name)
    if comm is not None:
        comm.abort(reason)
        try:
            kv_put, _ = _gcs_kv()
            kv_put(abort_key(group_name), reason or "aborted")
        except Exception:
            pass  # no GCS reachable: the local abort still happened
        return
    kv_put, _ = _gcs_kv()
    kv_put(abort_key(group_name), reason or "aborted")


def destroy_collective_group(group_name: str = "default"):
    comm = _groups.pop(group_name, None)
    if comm is not None:
        # Unblocks any thread still inside a collective (it exits with
        # CollectiveAbortError) before the links close.
        comm.close()


def get_group(group_name: str = "default") -> Communicator:
    if group_name not in _groups:
        raise ValueError(f"collective group {group_name!r} is not "
                         "initialized")
    return _groups[group_name]


def get_rank(group_name: str = "default") -> int:
    return get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return get_group(group_name).world_size


def allreduce(array, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(array, op)


def allreduce_async(array, group_name: str = "default", op: str = "sum"):
    """Launch an allreduce and return a Work handle; `.wait()` for the
    result. Handles on one group complete in submission (FIFO) order."""
    return get_group(group_name).allreduce_async(array, op)


def allgather(array, group_name: str = "default") -> List:
    return get_group(group_name).allgather(array)


def reducescatter(arrays: Sequence, group_name: str = "default",
                  op: str = "sum"):
    return get_group(group_name).reducescatter(arrays, op)


def broadcast(array, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(array, src_rank)


def alltoall(arrays: Sequence, group_name: str = "default"):
    return get_group(group_name).alltoall(arrays)


def send(array, dst_rank: int, group_name: str = "default"):
    get_group(group_name).send(array, dst_rank)


def recv(shape, dtype, src_rank: int, group_name: str = "default", **kw):
    return get_group(group_name).recv(shape, dtype, src_rank, **kw)


def barrier(group_name: str = "default"):
    get_group(group_name).barrier()
