"""The torch collective backend ("torch"): tensors stay on their device.

The port's counterpart of ray_tpu/collective/jax_backend.py, which
bootstraps jax.distributed and stages host arrays through shard_map
collectives. Here a group of actors (or threads) becomes a pair of
torch process groups of its own:

  * rendezvous through the same GCS KV as the tcp backend: rank 0 starts
    a `TCPStore` on a free port and publishes "host:port" under
    `collective:{group}:torch_store`; the other ranks connect to it;
  * each group is a process-group object over `PrefixStore(group, store)`,
    never the default group: `init_process_group` may run once a process,
    and a GPU actor may hold a tensor-parallel world (parallel/launch.py)
    and several named groups at once;
  * NCCL for CUDA tensors, gloo for CPU tensors, each made at the first
    op on that kind of tensor (every rank issues the same ops in the same
    order). Results stay on the input's device: nothing is staged through
    the host. gloo runs one thread a group, NCCL one stream, so async
    handles complete in submission order;
  * `mean` is a SUM then a division, as the tcp ring does it: a floating
    result keeps its dtype, an integer one comes back float64. (NCCL's
    AVG exists for floating types only.)

Abort: the group's CollectiveWatchdog (heartbeats and the KV abort flag,
communicator.py) or `abort()` sets the flag and aborts the NCCL
communicator, since a running NCCL kernel cannot be interrupted the way
a socket tick can; a waiting `Work` then raises CollectiveAbortError. A
gloo op waiting on a withheld peer is left to its own timeout
(`collective_op_timeout_s`, the groups' timeout) while `Work.wait()`
raises at once. `close()` shuts the communicators down within
parallel/launch.py's LEAVE_TIMEOUT_S and aborts them past it.
"""

from __future__ import annotations

import datetime
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.collective.communicator import (
    CollectiveWatchdog, Communicator, Work, abort_key)
from ray_tpu_torch.core.exceptions import CollectiveAbortError

_OPS = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
        "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
        "mean": dist.ReduceOp.SUM}


def _timeout() -> datetime.timedelta:
    from ray_tpu_torch.config import cfg

    return datetime.timedelta(seconds=cfg().collective_op_timeout_s)


class TorchWork(Work):
    """A Work backed by torch's own work handle. The group's waiter thread
    waits on the handle (in submission order); `wait()` waits for that,
    observing the group's abort flag, then runs the op's epilogue (the
    mean's division, a numpy input's conversion back)."""

    __slots__ = ("_comm", "_handle", "_post", "_t0", "_op", "_nbytes",
                 "_ready", "_wait_error")

    def __init__(self, comm: "TorchCommunicator", op_id: int, handle,
                 post: Callable, op: str, nbytes: int):
        super().__init__(op_id, comm.group_name, rank=comm.rank,
                         world_size=comm.world_size)
        self._comm, self._handle, self._post = comm, handle, post
        self._op, self._nbytes = op, nbytes
        self._t0 = time.perf_counter()
        self._ready = threading.Event()
        self._wait_error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set() or self._ready.is_set()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.is_set():
            from ray_tpu_torch.core import blocked as blocked_mod

            with blocked_mod.blocked_on(
                    blocked_mod.COLLECTIVE_OP, group=self.group_name,
                    op_id=self.op_id, rank=self.rank,
                    world_size=self.world_size):
                self._complete(timeout)
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, timeout: Optional[float]) -> None:
        # While a rank waits, the watchdog also checks its peers' beats.
        comm = self._comm
        with comm._op_lock:
            comm._active_ops += 1
        try:
            self._await(timeout)
        finally:
            with comm._op_lock:
                comm._active_ops -= 1

    def _await(self, timeout: Optional[float]) -> None:
        comm = self._comm
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._ready.wait(0.02):
            if comm.aborted:
                self._finish(error=CollectiveAbortError(
                    comm.group_name, comm._abort_reason))
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective op {self.op_id} on group "
                    f"{self.group_name!r} not done after {timeout}s")
        try:
            if self._wait_error is not None:
                raise self._wait_error
            if self._op.endswith(":nccl"):
                # This thread's stream after NCCL's (a gloo handle is
                # waited once, by the waiter: a second wait of a gloo
                # send blocks).
                self._handle.wait()
            result = self._post()
        except BaseException as e:  # noqa: BLE001 - delivered at wait()
            if comm.aborted:
                e = CollectiveAbortError(comm.group_name, comm._abort_reason)
            self._finish(error=e)
            return
        comm._observe(self._op, time.perf_counter() - self._t0,
                      self._nbytes)
        self._finish(result=result)


def _wait_loop(comm: "TorchCommunicator", q: "queue.SimpleQueue") -> None:
    """The group's waiter thread: each op's handle in submission order. A
    gloo handle's `wait()` blocks until the op ends (its
    `is_completed()` stays False for some ops); an NCCL handle's `wait()`
    does not block the host, so it is polled, and given up once the
    group is aborted."""
    while True:
        work = q.get()
        if work is None:
            return
        try:
            if work._op.endswith(":nccl"):
                pause = 5e-5
                while not work._handle.is_completed():
                    if comm.aborted:
                        raise CollectiveAbortError(comm.group_name,
                                                   comm._abort_reason)
                    time.sleep(pause)
                    pause = min(2 * pause, 1e-3)
            else:
                work._handle.wait()
        except BaseException as e:  # noqa: BLE001 - delivered at wait()
            work._wait_error = e
        work._ready.set()


def _hold(pgs: list, last: TorchWork) -> None:
    last._ready.wait()


class _Done:
    """A torch work handle for an op with nothing to send (world 1)."""

    def is_completed(self) -> bool:
        return True

    def wait(self) -> bool:
        return True


class TorchCommunicator(Communicator):
    """A named group over torch process groups (NCCL for CUDA tensors,
    gloo for CPU tensors). Inputs are tensors or numpy arrays (numpy goes
    through gloo and comes back numpy)."""

    def __init__(self, rank: int, world_size: int, group_name: str,
                 kv_put: Callable[[str, str], None],
                 kv_get: Callable[[str], Optional[str]],
                 timeout: float = 120.0):
        super().__init__(rank, world_size, group_name)
        self._kv_put = kv_put
        self._kv_get = kv_get
        self._pgs: Dict[str, object] = {}
        self._devices: Dict[str, torch.device] = {}
        self._pg_lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._op_seq = 0
        self._last: Optional[TorchWork] = None
        self._closed = False
        self._waits: "queue.SimpleQueue" = queue.SimpleQueue()
        self._waiter = threading.Thread(
            target=_wait_loop, args=(self, self._waits), daemon=True,
            name=f"collective-wait-{group_name}-{rank}")
        self._waiter.start()
        key = f"collective:{group_name}:torch_store"
        wait = datetime.timedelta(seconds=timeout)
        if rank == 0:
            # Clear a stale abort flag of an earlier group of this name
            # before peers can see the store's address.
            kv_put(abort_key(group_name), "")
            self._store = dist.TCPStore("127.0.0.1", 0, world_size, True,
                                        timeout=wait,
                                        wait_for_workers=False)
            kv_put(key, f"127.0.0.1:{self._store.port}")
        else:
            deadline = time.monotonic() + timeout
            addr = kv_get(key)
            while not addr:   # "" is a closed group's
                if time.monotonic() > deadline:
                    raise TimeoutError(f"rendezvous for {group_name} timed "
                                       "out")
                time.sleep(0.02)
                addr = kv_get(key)
            host, port = addr.rsplit(":", 1)
            self._store = dist.TCPStore(host, int(port), world_size, False,
                                        timeout=wait)
        if world_size > 1:
            self._watchdog = CollectiveWatchdog(self, kv_put, kv_get).start()

    # ---- process groups ----------------------------------------------------

    def _pg(self, device: torch.device):
        kind = "nccl" if device.type == "cuda" else "gloo"
        with self._pg_lock:
            pg = self._pgs.get(kind)
            if pg is None:
                self.check_abort()
                store = dist.PrefixStore(f"{self.group_name}/{kind}",
                                         self._store)
                if kind == "nccl":
                    torch.cuda.set_device(device)
                    opts = dist.ProcessGroupNCCL.Options()
                    opts._timeout = _timeout()
                    pg = dist.ProcessGroupNCCL(store, self.rank,
                                               self.world_size, opts)
                else:
                    opts = dist.ProcessGroupGloo._Options()
                    opts._devices = [dist.ProcessGroupGloo.create_device(
                        hostname="127.0.0.1")]
                    opts._timeout = _timeout()
                    opts._threads = 1   # one op at a time: FIFO completion
                    pg = dist.ProcessGroupGloo(store, self.rank,
                                               self.world_size, opts)
                self._pgs[kind] = pg
                self._devices[kind] = device
        return pg, kind

    def _launch(self, op: str, device, start: Callable, post: Callable,
                nbytes: int) -> TorchWork:
        """Run `start(pg)` (which returns torch's work handle) in this
        group's submission order and wrap it."""
        self.check_abort()
        with self._submit_lock:
            self._op_seq += 1
            self._current_op_id = self._op_seq
            pg, kind = self._pg(torch.device(device))
            handle = start(pg) if self.world_size > 1 else _Done()
            work = TorchWork(self, self._op_seq, handle, post,
                             f"{op}:{kind}", nbytes)
            self._waits.put(work)
            self._last = work
            return work

    def _observe(self, op: str, seconds: float, nbytes: int) -> None:
        try:
            from ray_tpu_torch.collective.cpu_group import _op_metrics

            opname, algo = op.split(":")
            m = _op_metrics(opname, algo)
            m["ops"].inc()
            m["latency"].observe(seconds)
            if nbytes:
                m["sent"].inc(nbytes)
                m["recv"].inc(nbytes)
        except Exception:
            pass  # metrics must never break the data plane

    def _ring_bytes(self, nbytes: int) -> int:
        """Bytes a rank moves each way in a ring allreduce of `nbytes`."""
        w = self.world_size
        return 2 * (w - 1) * nbytes // w

    # ---- abort -------------------------------------------------------------

    def abort(self, reason: str = "aborted", propagate: bool = True) -> None:
        """Set the abort flag, write the group's KV abort key (so every
        other rank's watchdog aborts within one interval) and abort the
        NCCL communicator, so a collective waiting on a withheld or dead
        peer ends now instead of at the NCCL timeout."""
        first = not self.aborted
        super().abort(reason)
        if not first:
            return
        for pg in list(self._pgs.values()):
            fn = getattr(pg, "abort", None)
            if fn is not None and isinstance(pg, getattr(
                    dist, "ProcessGroupNCCL", ())):
                try:
                    fn()
                except Exception:
                    pass
        if propagate and self.world_size > 1:
            try:
                self._kv_put(abort_key(self.group_name), reason or "aborted")
            except Exception:
                pass
            try:
                from ray_tpu_torch.runtime import events as events_mod

                events_mod.emit(
                    events_mod.COLLECTIVE_ABORT,
                    f"collective group {self.group_name!r} aborted at rank "
                    f"{self.rank}: {reason}",
                    severity=events_mod.ERROR, source="collective",
                    labels={"group": self.group_name,
                            "rank": str(self.rank)})
            except Exception:
                pass

    # ---- ops ---------------------------------------------------------------

    @staticmethod
    def _tensor(x):
        """(tensor, back): a numpy input becomes a CPU tensor and results
        go back to numpy."""
        if isinstance(x, torch.Tensor):
            return x.detach(), lambda r: r
        arr = np.ascontiguousarray(np.asarray(x))

        def back(r):
            if isinstance(r, list):
                return [back(t) for t in r]
            return r.numpy()

        return torch.from_numpy(arr), back

    def _mean(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_floating_point():
            return t.div_(self.world_size)
        return t.to(torch.float64) / self.world_size

    def allreduce_async(self, tensor, op: str = "sum") -> TorchWork:
        if op not in _OPS:
            raise ValueError(f"unknown reduce op {op!r}")
        t, back = self._tensor(tensor)
        buf = t.contiguous().clone()
        opts = dist.AllreduceOptions()
        opts.reduceOp = _OPS[op]

        def post():
            return back(self._mean(buf) if op == "mean" else buf)

        return self._launch(
            "allreduce", buf.device, lambda pg: pg.allreduce([buf], opts),
            post, self._ring_bytes(buf.numel() * buf.element_size()))

    def allgather_async(self, tensor) -> TorchWork:
        t, back = self._tensor(tensor)
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.world_size)]
        if self.world_size == 1:
            outs[0] = t
        return self._launch(
            "allgather", t.device, lambda pg: pg.allgather([outs], [t]),
            lambda: back(outs),
            (self.world_size - 1) * t.numel() * t.element_size())

    def reducescatter_async(self, tensors: Sequence, op: str = "sum"
                            ) -> TorchWork:
        if len(tensors) != self.world_size:
            raise ValueError(f"reducescatter needs {self.world_size} shards,"
                             f" got {len(tensors)}")
        if op not in _OPS:
            raise ValueError(f"unknown reduce op {op!r}")
        pairs = [self._tensor(x) for x in tensors]
        ins = [p[0].contiguous() for p in pairs]
        back = pairs[0][1]
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = _OPS[op]
        # gloo's reduce_scatter never reports its work completed: on CPU
        # tensors (and for shards of different shapes) one allreduce of
        # all the shards, then this rank's part.
        same = ins[0].device.type == "cuda" and all(
            x.shape == ins[0].shape and x.dtype == ins[0].dtype for x in ins)
        if same:
            out = ins[self.rank].clone()
            start = (lambda pg: pg.reduce_scatter([out], [ins], opts))
        else:
            flat = torch.cat([x.reshape(-1) for x in ins])
            aopts = dist.AllreduceOptions()
            aopts.reduceOp = _OPS[op]
            start = (lambda pg: pg.allreduce([flat], aopts))

        def post():
            if same:
                res = out
            else:
                off = sum(x.numel() for x in ins[:self.rank])
                res = flat[off:off + ins[self.rank].numel()].reshape(
                    ins[self.rank].shape)
            return back(self._mean(res) if op == "mean" else res)

        nbytes = sum(x.numel() * x.element_size() for x in ins)
        return self._launch("reducescatter", ins[0].device, start, post,
                            nbytes * (self.world_size - 1)
                            // self.world_size)

    def broadcast_async(self, tensor, src_rank: int = 0) -> TorchWork:
        """Every rank passes a tensor of the broadcast's shape and dtype
        (the source its data, the others a buffer to fill, as
        torch.distributed.broadcast takes it); each gets a new tensor."""
        if tensor is None:
            raise ValueError("the torch backend's broadcast takes a tensor "
                             "of the result's shape and dtype on every rank")
        t, back = self._tensor(tensor)
        buf = t.contiguous().clone()
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        return self._launch(
            "broadcast", buf.device, lambda pg: pg.broadcast([buf], opts),
            lambda: back(buf), buf.numel() * buf.element_size())

    def allreduce(self, tensor, op: str = "sum"):
        return self.allreduce_async(tensor, op).wait()

    def allgather(self, tensor) -> List:
        return self.allgather_async(tensor).wait()

    def reducescatter(self, tensors: Sequence, op: str = "sum"):
        return self.reducescatter_async(tensors, op).wait()

    def broadcast(self, tensor, src_rank: int = 0):
        return self.broadcast_async(tensor, src_rank).wait()

    def alltoall(self, tensors: Sequence) -> List:
        """Shards of one shape and dtype; rank r's shard j lands on rank j
        at index r."""
        if len(tensors) != self.world_size:
            raise ValueError(f"alltoall needs {self.world_size} shards, got "
                             f"{len(tensors)}")
        pairs = [self._tensor(x) for x in tensors]
        ins = [p[0].contiguous() for p in pairs]
        back = pairs[0][1]
        flat_in = torch.cat([x.reshape(-1) for x in ins])
        flat_out = torch.empty_like(flat_in)
        if self.world_size == 1:
            flat_out = flat_in
        sizes = [x.numel() for x in ins]

        def post():
            return back([c.reshape(ins[0].shape)
                         for c in torch.split(flat_out, sizes)])

        return self._launch(
            "alltoall", flat_in.device,
            lambda pg: pg.alltoall_base(flat_out, flat_in, sizes, sizes,
                                        dist.AllToAllOptions()),
            post, flat_in.numel() * flat_in.element_size()).wait()

    def send(self, tensor, dst_rank: int) -> None:
        """Returns once `dst_rank` has received it (torch.distributed's
        send; the tcp backend's returns once the bytes are on the socket),
        so a ring of sends orders them, as the default alltoall does."""
        t, _ = self._tensor(tensor)
        t = t.contiguous()
        self._launch("send", t.device, lambda pg: pg.send([t], dst_rank, 0),
                     lambda: None, t.numel() * t.element_size()).wait()

    def recv(self, shape, dtype, src_rank: int, device="cuda"):
        """A tensor of `shape` and `dtype` (a torch or numpy dtype) from
        `src_rank`, on `device` (the card unless the caller asks for the
        CPU; a numpy dtype on the CPU gives a numpy array)."""
        from ray_tpu_torch.ops import resolve_device

        dev = resolve_device(device)
        as_numpy = not isinstance(dtype, torch.dtype)
        tdt = dtype if not as_numpy else torch.from_numpy(
            np.empty(0, np.dtype(dtype))).dtype
        buf = torch.empty(tuple(shape), dtype=tdt, device=dev)
        return self._launch(
            "recv", dev, lambda pg: pg.recv([buf], src_rank, 0),
            lambda: buf.numpy() if as_numpy and dev.type == "cpu" else buf,
            buf.numel() * buf.element_size()).wait()

    def barrier(self) -> None:
        """Every earlier op of this rank done, then every rank here: a
        one-element allreduce on the group's first process group (gloo
        when it has none)."""
        kind = next(iter(self._pgs), "gloo")
        device = self._devices.get(kind, torch.device("cpu"))
        self.allreduce(torch.zeros(1, dtype=torch.int32, device=device))

    def close(self) -> None:
        """Leave the group on this rank: stop the watchdog, shut the NCCL
        communicator down (bounded by LEAVE_TIMEOUT_S, then aborted), and
        fail every later op with CollectiveAbortError."""
        if self._closed:
            return
        self._closed = True
        if self._watchdog is not None:
            self._watchdog.stop()
        self._waits.put(None)
        from ray_tpu_torch.parallel.launch import LEAVE_TIMEOUT_S, _within

        for kind, pg in list(self._pgs.items()):
            if kind != "nccl" or self.aborted:
                continue
            try:
                torch.cuda.synchronize()
                _within(LEAVE_TIMEOUT_S, pg.shutdown,
                        f"closing collective group {self.group_name}")
            except Exception:
                try:
                    pg.abort()
                except Exception:
                    pass
        if self.aborted and self._last is not None:
            # A gloo op of an aborted group may still wait on a withheld
            # peer until the group's timeout: dropping its process group
            # would block until then (and at interpreter exit, abort the
            # process). A daemon thread holds the groups until the last
            # op ended; a process that exits first never frees them.
            threading.Thread(target=_hold, args=(
                list(self._pgs.values()), self._last), daemon=True,
                name=f"collective-hold-{self.group_name}").start()
        self._pgs.clear()
        Communicator.abort(self, "collective group closed")
        if self.rank == 0:
            try:
                self._kv_put(f"collective:{self.group_name}:torch_store", "")
            except Exception:
                pass
