"""Start a world of ranks on one host (the CPU tests' gloo helper, the
multi-card legs of chip_smoke.py on NCCL, and tensor-parallel serving).

    from ray_tpu_torch.parallel.launch import spawn, World
    results = spawn(fn, 4, arg, device="cpu")   # fn(rank, world, arg)

    world = World(2, loop, arg, device="cpu")   # the caller is rank 0
    world.channel.send(...)                     # loop(rank, world, channel,
    world.close()                               #      arg) on rank 1

Each rank is a fresh process (`spawn` start method) that joins the
default process group through a FileStore in a temporary directory, so
no TCP port is needed. CUDA ranks take card `rank` and NCCL; CPU ranks
take gloo and one thread each. `fn` must be importable by name (a module
function) and return something picklable. Under torchrun, call
`torch.distributed.init_process_group` instead and skip this module.

`spawn` runs a function to completion on every rank. A `World` keeps
ranks 1..n-1 alive behind the caller, which becomes rank 0: each runs a
loop that takes rank 0's commands from a `Channel` until `close()`. A
follower's traceback, or its death, breaks the world: rank 0's next
command raises it (a monitor thread also aborts the NCCL communicator,
so a collective in flight errors out instead of waiting for a dead
peer), and every later one raises too; a world never carries on with
fewer ranks.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue
import tempfile
import threading
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_rank(rank: int, world: int, store_path: str, device: str = "cuda",
              timeout_s: float = 120.0) -> None:
    """Join the default process group: NCCL on card `rank` for "cuda",
    gloo for "cpu". Raises on a CUDA request without a card."""
    from ray_tpu_torch.ops import resolve_device

    dev = resolve_device(device)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        kwargs["device_id"] = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def _entry(fn, rank, world, store_path, device, results, args):
    try:
        init_rank(rank, world, store_path, device)
        results.put((rank, True, fn(rank, world, *args)))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device: str = "cuda",
          timeout: float = 300.0) -> List:
    """Run fn(rank, world, *args) on `world` ranks; returns the results in
    rank order. Raises RuntimeError with the tracebacks when a rank fails
    or dies, and TimeoutError after `timeout` seconds; either way every
    rank is killed before it returns."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_world_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_entry, daemon=True,
                             args=(fn, r, world, os.path.join(tmp, "store"),
                                   device, results, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, failed = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"{world} ranks: no result from ranks "
                                       f"{missing} after {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        failed.append(f"ranks {dead} exited without a "
                                      f"result")
                    continue
                got[rank] = value
                if not ok:
                    failed.append(f"rank {rank}:\n{value}")
        finally:
            for p in procs:   # let finished ranks leave their group first
                p.join(timeout=30 if len(got) == world and not failed
                       else 0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------- persistent

class Channel:
    """Rank 0's commands to the other ranks of a world, in order. A message
    is a (kind, args) header of int64 over a gloo group (the default group
    on the CPU, a side group beside NCCL), then, for a pickled payload, its
    bytes over the same group, then its tensors over the default group
    (NCCL on cards), each moved to `device` first. Every rank calls
    `Channel(device)` at the same point after joining the world."""

    HEADER = 10     # int64 slots: kind, payload bytes, n tensors, 7 args

    def __init__(self, device, check: Optional[Callable[[], None]] = None):
        self.device = torch.device(device)
        self.group = (None if dist.get_backend() == "gloo"
                      else dist.new_group(backend="gloo"))
        self.check = check or (lambda: None)

    def _bcast(self, t):
        dist.broadcast(t, src=0, group=self.group)

    @contextlib.contextmanager
    def guard(self):
        """Rank 0's side of a command: an error inside (a collective whose
        peer died) becomes the world's own error, the follower's traceback,
        once the world notices it (within 10 s)."""
        try:
            yield
        except Exception as e:
            deadline = time.monotonic() + 10
            while True:
                try:
                    self.check()
                except RuntimeError as broken:
                    raise broken from e
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)

    def send(self, kind: int, args=(), payload=None, tensors=()) -> None:
        """Rank 0: one message. `args` are up to 5 ints; `payload` any
        picklable object; `tensors` are broadcast to every rank."""
        self.check()
        data = b"" if payload is None else pickle.dumps(payload)
        tensors = [t.to(self.device) for t in tensors]
        head = torch.zeros(self.HEADER, dtype=torch.int64)
        head[:3] = torch.tensor([kind, len(data), len(tensors)])
        head[3:3 + len(args)] = torch.tensor(list(args), dtype=torch.int64)
        self._bcast(head)
        if data:
            self._bcast(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        if tensors:
            self._bcast(torch.tensor(
                [[t.dim()] + list(t.shape) + [0] * (8 - t.dim())
                 for t in tensors], dtype=torch.int64))
            self._bcast(torch.tensor([_DTYPES.index(t.dtype)
                                      for t in tensors], dtype=torch.int64))
            for t in tensors:
                dist.broadcast(t.contiguous(), src=0)

    def recv(self):
        """Ranks 1..n-1: the next message as (kind, args, payload,
        tensors)."""
        head = torch.empty(self.HEADER, dtype=torch.int64)
        self._bcast(head)
        kind, n_bytes, n_tensors = (int(x) for x in head[:3])
        payload = None
        if n_bytes:
            buf = torch.empty(n_bytes, dtype=torch.uint8)
            self._bcast(buf)
            payload = pickle.loads(buf.numpy().tobytes())
        tensors = []
        if n_tensors:
            shapes = torch.empty((n_tensors, 9), dtype=torch.int64)
            self._bcast(shapes)
            dtypes = torch.empty(n_tensors, dtype=torch.int64)
            self._bcast(dtypes)
            for row, d in zip(shapes.tolist(), dtypes.tolist()):
                t = torch.empty(row[1:1 + row[0]], dtype=_DTYPES[d],
                                device=self.device)
                dist.broadcast(t, src=0)
                tensors.append(t)
        return kind, [int(x) for x in head[3:]], payload, tensors


_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32,
           torch.int64, torch.bool, torch.uint8, torch.int16]


def _abort_default_group() -> None:
    """Abort an NCCL world's communicators, so a collective waiting on a
    dead peer raises instead of waiting for the group's timeout (gloo
    raises by itself once the peer's sockets close)."""
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if abort is None or not dist.is_initialized() \
            or dist.get_backend() != "nccl":
        return
    try:
        abort()
    except Exception:  # the group may already be gone
        pass


# An NCCL world's teardown that takes longer than this raises: a hang there
# must not outlive the caller's own time limit.
LEAVE_TIMEOUT_S = 60.0


def _within(seconds: float, fn: Callable[[], None], what: str) -> None:
    """Run fn in a daemon thread; raise RuntimeError if it has not returned
    within `seconds` (the thread is then left behind), or fn's error."""
    errors: list = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors.append(e)

    t = threading.Thread(target=run, daemon=True, name=what)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise RuntimeError(f"{what} did not finish within {seconds} s")
    if errors:
        raise errors[0]


def _leave() -> None:
    """Leave a world whose work is done, on every rank at once (NCCL's
    communicator destroy is collective across a node's ranks). Every CUDA
    graph that captured the world's collectives must be released first:
    NCCL destroys a communicator only once no graph refers to it, and
    until then `destroy_process_group` waits, on every rank (a 4-card
    world did, once). A teardown that outlasts LEAVE_TIMEOUT_S raises
    instead of hanging."""
    def leave():
        if dist.get_backend() == "nccl":
            torch.cuda.synchronize()
        dist.destroy_process_group()

    _within(LEAVE_TIMEOUT_S, leave, "leaving the world")


def _follower_entry(target, rank, world, store_path, device, errors, args):
    try:
        init_rank(rank, world, store_path, device)
        channel = Channel(device)
        target(rank, world, channel, *args)
        _leave()
    except BaseException:  # noqa: BLE001 - reported to rank 0, which raises
        errors.put((rank, traceback.format_exc()))
        errors.close()
        errors.join_thread()
        # Leave at once: the open sockets close, so rank 0's gloo
        # collectives fail instead of waiting for this rank.
        os._exit(1)


class World:
    """The caller as rank 0 of a world of `size` ranks whose others run
    `target(rank, size, channel, *args)` until it returns (on a command of
    rank 0's choosing). `channel` sends rank 0's commands; `check()`
    raises a follower's traceback or death; `close(stop)` sends the stop
    command through `stop(channel)`, joins the followers (killing any that
    do not leave within a minute) and leaves the world. A process may hold
    one world after another (a mesh is built from per-axis groups,
    parallel/mesh.py `_axis_groups`)."""

    def __init__(self, size: int, target: Callable, *args,
                 device: str = "cuda"):
        from ray_tpu_torch.ops import resolve_device

        self.size = size
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if torch.cuda.device_count() < size:
                raise ValueError(f"a world of {size} ranks takes {size} "
                                 f"cards; this machine has "
                                 f"{torch.cuda.device_count()}")
        self.broken: Optional[str] = None
        self._stopping = False      # the followers were told to leave
        self._closing = False
        self._threads = torch.get_num_threads()
        self._tmp = tempfile.TemporaryDirectory(prefix="ray_tpu_torch_world_")
        store = os.path.join(self._tmp.name, "store")
        ctx = mp.get_context("spawn")
        self._errors = ctx.Queue()
        self._procs = [ctx.Process(
            target=_follower_entry, daemon=True,
            args=(target, r, size, store, self.device.type, self._errors,
                  args)) for r in range(1, size)]
        for p in self._procs:
            p.start()
        try:
            init_rank(0, size, store, self.device.type)
            dev = (torch.device("cuda", 0) if self.device.type == "cuda"
                   else self.device)
            self.channel = Channel(dev, self.check)
        except BaseException:
            self._kill()
            raise
        self._monitor = threading.Thread(target=self._watch, daemon=True,
                                         name="world-monitor")
        self._monitor.start()

    def _poll(self) -> Optional[str]:
        msgs = []
        while True:
            try:
                rank, tb = self._errors.get_nowait()
            except queue.Empty:
                break
            msgs.append(f"rank {rank} failed:\n{tb}")
        dead = [r + 1 for r, p in enumerate(self._procs)
                if p.exitcode is not None]
        if dead and not msgs:
            # Its traceback may still be on its way: give it a moment.
            try:
                rank, tb = self._errors.get(timeout=2.0)
                msgs.append(f"rank {rank} failed:\n{tb}")
            except queue.Empty:
                msgs.append(f"ranks {dead} died without a traceback "
                            "(exit codes "
                            f"{[self._procs[r - 1].exitcode for r in dead]})")
        return "\n".join(msgs) or None

    def _watch(self) -> None:
        while not self._stopping and self.broken is None:
            msg = self._poll()
            if msg is not None and not self._stopping:
                self.broken = msg
                _abort_default_group()
                return
            time.sleep(0.2)

    def check(self) -> None:
        """Raise if a follower failed or died: the world is broken for
        good."""
        if self.broken is None and not self._stopping:
            msg = self._poll()
            if msg is not None:
                self.broken = msg
        if self.broken is not None:
            raise RuntimeError(f"a rank of the {self.size}-rank world "
                               f"failed; the world is closed:\n"
                               f"{self.broken}")
        if self._closing:
            raise RuntimeError("the world is closed")

    def _kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)

    def close(self, stop: Optional[Callable] = None) -> None:
        """Stop the followers (through `stop(channel)` while the world is
        whole), leave the world and remove its files. Idempotent."""
        if self._closing:
            return
        self._stopping = True
        try:
            if self.broken is None and stop is not None:
                stop(self.channel)
        except Exception:
            pass
        self._closing = True
        try:
            if self.broken is None:
                # With the followers, not after them.
                _leave()
            else:
                # No collective may wait on a dead or failed rank.
                _within(LEAVE_TIMEOUT_S, _abort_default_group,
                        "aborting the broken world")
                self._kill()
                if dist.is_initialized():
                    try:
                        dist.destroy_process_group()
                    except Exception:   # a broken world's group may refuse
                        pass
        finally:
            deadline = time.monotonic() + 60
            for p in self._procs:
                p.join(timeout=max(0.0, deadline - time.monotonic()))
            self._kill()
            torch.set_num_threads(self._threads)
            self._tmp.cleanup()
