"""TCP collective backend: chunked ring data plane over per-rank p2p links.

The port's copy of ray_tpu/collective/cpu_group.py. Reference analog:
python/ray/util/collective/collective_group/gloo_collective_group.py:184
GLOOGroup, rebuilt around bandwidth-optimal ring algorithms. Two planes:

  * ring (default): allreduce = ring reduce-scatter + ring all-gather;
    allgather / reducescatter / broadcast ride the same neighbor links.
    Large arrays move as fixed-size chunks (``collective_chunk_bytes``),
    so transfers pipeline across hops and per-op scratch memory stays at
    one chunk. Array bodies cross the wire as RAW-BUFFER frames (a 97-byte
    binary header carries dtype/shape/offset; the body is the ndarray
    buffer): nothing is pickled on the steady-state path, which `counters`
    shows (``fast_ndarray``/``deserialize_fast`` per raw frame,
    ``pickle``/``deserialize_pickle`` per control frame).
  * hub (``topology="hub"``): rank 0 gathers pickled payloads, reduces,
    scatters. Kept for barriers, exotic dtypes, and as the baseline the
    ring is measured against.

The wire is byte for byte the JAX package's, control frames included
(they pickle only ints, strings, tuples, lists and numpy arrays), so a
group may mix ranks of both packages; the KV stream of llm/disagg.py and
llm/prefix_store.py shares the frame layer.

A frame is

    [u64 body length][u8 frame kind][body]

and an array travels as kind-1 frames, each a 97-byte `_AMETA` header
(dtype string, rank, 8 dims of the WHOLE array, element offset, element
count) followed by that chunk's raw bytes, sent straight from and
received straight into the array's buffer.

Every op runs on a per-group op thread in FIFO submission order, which is
what makes the async handles (`allreduce_async(...) -> Work`) safe: ranks
submitting the same op stream execute it in the same order over the same
sockets. Chunk sends run on a separate tx thread so a rank can sink its
outgoing chunk while blocked receiving the incoming one: full-duplex
neighbor links with no ring-wide send deadlock whatever the chunk size.
Every socket tick observes the group abort flag and the per-op deadline,
and a mid-ring peer failure (EOF / reset) aborts the group with
propagation, so every rank unblocks with CollectiveAbortError within
about one watchdog interval.

Inputs are numpy arrays or torch tensors. A tensor (on any device) is
copied to the host for the op and the result comes back as a tensor on
its device; a bf16 tensor travels and reduces as float32 (numpy has no
bfloat16) and comes back as bf16. torch is never imported here: a tensor
is recognised by its type's module.
"""

from __future__ import annotations

import pickle
import queue
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch.core.exceptions import CollectiveAbortError
from ray_tpu_torch.collective.communicator import (
    Communicator, CollectiveWatchdog, Work, abort_key, reduce_arrays)

# Wire: [u64 body length][u8 frame kind][body]
_HDR = struct.Struct("<QB")
_K_CTRL = 0    # body = pickled control object (rendezvous, hub plane)
_K_ARRAY = 1   # body = _AMETA header + raw ndarray chunk bytes

# Array-chunk header: dtype str (NUL-padded), ndim, 8 dims of the FULL
# array this chunk belongs to, element offset of the chunk, chunk elements.
_AMETA = struct.Struct("<16sB8QQQ")
_MAX_DIMS = 8

# The port's copy of the serialization counters this transport bumps.
counters: Dict[str, int] = {
    "pickle": 0, "fast_ndarray": 0, "deserialize_pickle": 0,
    "deserialize_fast": 0}


# ---------------------------------------------------------------------------
# Low-level socket IO: every tick observes the abort check + op deadline.
# ---------------------------------------------------------------------------


def _sock_send(sock: socket.socket, view: memoryview,
               check: Optional[Callable] = None,
               deadline: Optional[float] = None) -> None:
    if check is None and deadline is None:
        sock.sendall(view)
        return
    # Poll-timeout sockets: a partial send to a slow peer must not surface
    # as a spurious socket.timeout — retry each tick, observing abort flag
    # and per-op deadline just like the receive side.
    while view.nbytes:
        try:
            sent = sock.send(view)
        except socket.timeout:
            if check is not None:
                check()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("collective op deadline exceeded")
            continue
        except OSError:
            if check is not None:
                check()
            raise
        view = view[sent:]


def _sock_recv_into(sock: socket.socket, view: memoryview,
                    check: Optional[Callable] = None,
                    deadline: Optional[float] = None) -> None:
    got, total = 0, view.nbytes
    while got < total:
        try:
            n = sock.recv_into(view[got:], min(1 << 20, total - got))
        except socket.timeout:
            if check is None and deadline is None:
                raise  # legacy blocking behavior (rendezvous paths)
            if check is not None:
                check()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("collective op deadline exceeded")
            continue
        except OSError:
            # close() sets the abort flag then closes sockets; the abort is
            # the real story, not the EBADF it causes.
            if check is not None:
                check()
            raise
        if n == 0:
            if check is not None:
                check()
            raise ConnectionError("collective peer disconnected")
        got += n


def _read_hdr(sock, check, deadline) -> Tuple[int, int]:
    hdr = bytearray(_HDR.size)
    _sock_recv_into(sock, memoryview(hdr), check, deadline)
    length, kind = _HDR.unpack(hdr)
    return length, kind


def _read_ameta(sock, check, deadline):
    """Read + parse one _AMETA array-chunk header; returns
    (dtype, full_shape, offset_elems, chunk_elems)."""
    raw = bytearray(_AMETA.size)
    _sock_recv_into(sock, memoryview(raw), check, deadline)
    fields = _AMETA.unpack(raw)
    dtype = np.dtype(fields[0].rstrip(b"\x00").decode())
    ndim = fields[1]
    shape = tuple(fields[2:2 + ndim])
    offset, nelems = fields[10], fields[11]
    return dtype, shape, offset, nelems


def _frame_views(chunk: np.ndarray, full_shape=None, offset: int = 0) -> List:
    """Build the wire views for one raw array chunk: [header+meta, payload].

    The payload view aliases the caller's buffer — zero copies on the send
    path. `full_shape` is the shape of the array the chunk belongs to
    (defaults to the chunk's own shape for standalone frames)."""
    shape = tuple(full_shape) if full_shape is not None else tuple(chunk.shape)
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"array rank {len(shape)} exceeds wire max {_MAX_DIMS}")
    dims = list(shape) + [0] * (_MAX_DIMS - len(shape))
    meta = _AMETA.pack(chunk.dtype.str.encode().ljust(16, b"\x00"),
                       len(shape), *dims, offset, chunk.size)
    payload = memoryview(chunk).cast("B")
    head = _HDR.pack(_AMETA.size + payload.nbytes, _K_ARRAY) + meta
    counters["fast_ndarray"] += 1
    return [memoryview(head), payload]


def _ctrl_views(obj) -> List:
    # Array payloads ride raw _K_ARRAY frames; control frames carry rank
    # ids and op tags (and the hub plane's payloads).
    body = pickle.dumps(obj, protocol=5)
    counters["pickle"] += 1
    return [memoryview(_HDR.pack(len(body), _K_CTRL) + body)]


def _send_msg(sock: socket.socket, obj, check: Optional[Callable] = None,
              deadline: Optional[float] = None) -> None:
    """Send one control frame (pickled body). Array bodies never go through
    here on the ring path — they ride raw frames via _frame_views."""
    for view in _ctrl_views(obj):
        _sock_send(sock, view, check, deadline)


def _recv_msg(sock: socket.socket, check: Optional[Callable] = None,
              deadline: Optional[float] = None):
    """Receive one logical message: a pickled control object, or a raw
    array (reassembled across its chunk frames, received straight into the
    destination buffer). With `check`/`deadline` set (and the socket on a
    short poll timeout), each timeout tick runs `check()` — which raises
    CollectiveAbortError once the group's abort flag is set — and enforces
    the per-op deadline, so a blocked receive unblocks within one poll tick
    of an abort instead of the full socket timeout."""
    length, kind = _read_hdr(sock, check, deadline)
    if kind == _K_CTRL:
        body = bytearray(length)
        _sock_recv_into(sock, memoryview(body), check, deadline)
        counters["deserialize_pickle"] += 1
        # Steady-state ring traffic is all raw frames (_frame_views).
        return pickle.loads(bytes(body))
    if kind != _K_ARRAY:
        raise RuntimeError(f"collective protocol error: unknown frame kind {kind}")
    dtype, shape, offset, nelems = _read_ameta(sock, check, deadline)
    out = np.empty(shape, dtype)
    flat = out.reshape(-1)
    total = flat.size
    got = 0
    while True:
        if nelems:
            _sock_recv_into(sock, memoryview(flat[offset:offset + nelems]).cast("B"),
                            check, deadline)
            got += nelems
        counters["deserialize_fast"] += 1
        if got >= total:
            return out
        length, kind = _read_hdr(sock, check, deadline)
        if kind != _K_ARRAY:
            raise RuntimeError("collective protocol error: truncated array stream")
        _, _, offset, nelems = _read_ameta(sock, check, deadline)


# ---------------------------------------------------------------------------
# Reduction helpers.
# ---------------------------------------------------------------------------

_REDUCE_INPLACE = {
    "sum": np.add, "prod": np.multiply, "min": np.minimum, "max": np.maximum,
}


def _reduce_into(dst: np.ndarray, src: np.ndarray, op: str) -> None:
    _REDUCE_INPLACE[op](dst, src, out=dst)


def _mean_div(flat: np.ndarray, world_size: int) -> np.ndarray:
    if np.issubdtype(flat.dtype, np.inexact):
        flat /= world_size
        return flat
    # Integer mean mirrors the hub's np.stack(...).mean: float64 result.
    return flat / world_size


def _same(result):
    return result


def _is_tensor(x) -> bool:
    return type(x).__module__.startswith("torch") and hasattr(x, "detach")


def _host(x):
    """(numpy array, back) for an op's input. A numpy array (or anything
    np.asarray takes) goes as it is and `back` returns results as they
    are. A torch tensor is copied to the host, a bf16 one as float32;
    `back` turns a result (an array or a list of them) into tensors on
    the input's device, bf16 again where the input was bf16."""
    if not _is_tensor(x):
        return np.asarray(x), _same
    t = x.detach()
    device, bf16 = t.device, str(t.dtype) == "torch.bfloat16"
    arr = (t.float() if bf16 else t).cpu().numpy()

    def back(result):
        if isinstance(result, list):
            return [back(r) for r in result]
        import torch

        out = torch.from_numpy(np.ascontiguousarray(result)).to(device)
        if bf16 and out.dtype == torch.float32:
            out = out.to(torch.bfloat16)
        return out

    return arr, back


class _StagedWork(Work):
    """A Work whose result the waiting thread turns back into tensors
    (`_host`'s `back`), so the op thread goes on to the next op while the
    caller uploads this one's result."""

    __slots__ = ("_post", "_post_lock")

    def __init__(self, *args, post=None, **kw):
        super().__init__(*args, **kw)
        self._post = post
        self._post_lock = threading.Lock()

    def wait(self, timeout: Optional[float] = None):
        result = super().wait(timeout)
        with self._post_lock:
            if self._post is not None:
                self._result = result = self._post(result)
                self._post = None
        return result


def _ring_wire_ok(arr: np.ndarray) -> bool:
    """Raw frames carry fixed-itemsize buffers only; object/datetime dtypes
    and rank > 8 fall back to the pickled hub plane."""
    return (not arr.dtype.hasobject and arr.dtype.kind not in "OMm"
            and arr.ndim <= _MAX_DIMS)


def _segments(n: int, w: int) -> List[Tuple[int, int]]:
    base, rem = divmod(n, w)
    out, off = [], 0
    for i in range(w):
        size = base + (1 if i < rem else 0)
        out.append((off, size))
        off += size
    return out


def _chunks(off: int, size: int, chunk_elems: int):
    end = off + size
    while off < end:
        n = min(chunk_elems, end - off)
        yield off, n
        off += n


# ---------------------------------------------------------------------------
# Tx thread: decouples chunk sends from the op thread's receives so the
# all-ranks-send-right/recv-left ring step can never deadlock on full
# socket buffers, whatever the chunk size.
# ---------------------------------------------------------------------------


class _TxJob:
    __slots__ = ("event", "error", "nbytes")

    def __init__(self, nbytes: int):
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.nbytes = nbytes


class _TxThread:
    def __init__(self, comm: "TCPCommunicator"):
        self._comm = comm
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"collective-tx-{comm.group_name}-{comm.rank}")
        self._thread.start()

    def submit(self, sock, views: List, deadline: float) -> _TxJob:
        job = _TxJob(sum(v.nbytes for v in views))
        self._q.put((job, sock, views, deadline))
        return job

    def stop(self):
        self._q.put(None)

    def join(self, timeout: float = 2.0):
        self._thread.join(timeout)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            job, sock, views, deadline = item
            try:
                for view in views:
                    _sock_send(sock, view, self._comm.check_abort, deadline)
            except BaseException as e:  # noqa: BLE001 - recorded + surfaced
                job.error = e
                # A failed ring send is a group failure: abort (with KV
                # propagation) so the op thread's blocked receive — and
                # every peer's — unblocks instead of stranding the ring.
                if not isinstance(e, CollectiveAbortError):
                    self._comm.abort(f"ring send failed: {e!r}")
            finally:
                job.event.set()


# ---------------------------------------------------------------------------


class TCPCommunicator(Communicator):
    """Ring-topology process group over TCP (hub plane retained).

    Rendezvous: rank 0 binds an ephemeral port and publishes "host:port"
    through `kv_put(key, value)`; other ranks poll `kv_get(key)`. Every
    rank additionally listens on a p2p port; neighbor/pairwise links form
    lazily on first use and carry the raw-frame data plane.
    """

    def __init__(self, rank: int, world_size: int, group_name: str,
                 kv_put: Callable[[str, str], None],
                 kv_get: Callable[[str], Optional[str]],
                 timeout: float = 120.0,
                 topology: Optional[str] = None,
                 chunk_bytes: Optional[int] = None):
        super().__init__(rank, world_size, group_name)
        from ray_tpu_torch.config import cfg

        self._timeout = timeout
        self._kv_put = kv_put
        self._kv_get = kv_get
        self._topology = topology or cfg().collective_topology
        if self._topology not in ("ring", "hub"):
            raise ValueError(f"unknown collective topology {self._topology!r}")
        self._chunk_override = chunk_bytes
        # Poll granularity for blocking receives: abort flags and deadlines
        # are observed once per tick, so it tracks the watchdog interval.
        self._poll_s = max(0.05, min(cfg().collective_watchdog_interval_s,
                                     1.0))
        # Direct p2p plane: every rank listens; connections form lazily.
        self._p2p_listener = socket.create_server(("127.0.0.1", 0))
        self._p2p_listener.settimeout(self._poll_s)
        kv_put(f"collective:{group_name}:p2p:{rank}",
               f"127.0.0.1:{self._p2p_listener.getsockname()[1]}")
        self._p2p_out: Dict[int, socket.socket] = {}   # dst rank -> socket
        self._p2p_in: Dict[int, socket.socket] = {}    # src rank -> socket
        self._conn_lock = threading.Lock()
        self._accept_lock = threading.Lock()
        # FIFO op plane: all collectives execute on one thread per group in
        # submission order; Work handles complete in that same order.
        self._submit_lock = threading.Lock()
        self._op_seq = 0
        self._op_queue: Optional["queue.SimpleQueue"] = None
        self._op_thread: Optional[threading.Thread] = None
        self._tx: Optional[_TxThread] = None
        key = f"collective:{group_name}"
        if world_size == 1:
            self._peers = []
            return
        if rank == 0:
            # Clear any stale abort flag from a previous same-named group
            # BEFORE publishing the root address (peers only proceed once
            # the address appears, so they can't observe the stale value).
            kv_put(abort_key(group_name), "")
            self._listener = socket.create_server(("127.0.0.1", 0))
            port = self._listener.getsockname()[1]
            kv_put(key, f"127.0.0.1:{port}")
            self._peers: List[Optional[socket.socket]] = [None] * world_size
            deadline = time.monotonic() + timeout
            self._listener.settimeout(timeout)
            connected = 0
            while connected < world_size - 1:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"collective group {group_name}: only {connected + 1}/"
                        f"{world_size} ranks joined")
                sock, _ = self._listener.accept()
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                peer_rank = _recv_msg(sock)
                sock.settimeout(self._poll_s)
                self._peers[peer_rank] = sock
                connected += 1
        else:
            deadline = time.monotonic() + timeout
            addr = None
            while addr is None:
                addr = kv_get(key)
                if addr is None:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"rendezvous for {group_name} timed out")
                    time.sleep(0.02)
            host, port = addr.rsplit(":", 1)
            self._root = socket.create_connection((host, int(port)), timeout=timeout)
            self._root.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_msg(self._root, rank)
            self._root.settimeout(self._poll_s)
        self._tx = _TxThread(self)
        self._op_queue = queue.SimpleQueue()
        self._op_thread = threading.Thread(
            target=self._op_loop, daemon=True,
            name=f"collective-op-{group_name}-{rank}")
        self._op_thread.start()
        # Liveness/abort watchdog: a dead peer or a KV-set abort flag
        # surfaces CollectiveAbortError in seconds, not the socket timeout.
        self._watchdog = CollectiveWatchdog(self, kv_put, kv_get).start()

    # ---- abort -----------------------------------------------------------

    def abort(self, reason: str = "aborted", propagate: bool = True) -> None:
        """Abort the group: local flag + (by default) the group's KV abort
        key, so every OTHER rank's watchdog aborts within one interval."""
        first = not self.aborted
        super().abort(reason)
        if first and propagate and self.world_size > 1:
            try:
                self._kv_put(abort_key(self.group_name), reason or "aborted")
            except Exception:
                pass
            # First local observation of a real abort (close() passes
            # propagate=False): record it on the cluster event bus so the
            # group-wide unwind is attributable after the fact.
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

    def _op_deadline(self) -> float:
        from ray_tpu_torch.config import cfg

        return time.monotonic() + cfg().collective_op_timeout_s

    def _chunk_elems(self, itemsize: int) -> int:
        from ray_tpu_torch.config import cfg

        chunk_bytes = (self._chunk_override if self._chunk_override is not None
                       else cfg().collective_chunk_bytes)
        return max(1, int(chunk_bytes) // max(1, itemsize))

    def _ring_fail(self, opname: str, exc: BaseException) -> None:
        """A broken neighbor link mid-op means the group is broken: abort
        (propagating over the KV so ranks NOT adjacent to the failure
        unblock within one watchdog interval) and surface the abort."""
        if not self.aborted:
            self.abort(f"{opname}: ring peer failure ({exc!r})")
        self.check_abort()
        raise ConnectionError(f"{opname}: ring peer failure") from exc

    # ---- FIFO op thread + async handles ----------------------------------

    def _submit(self, fn, post=None) -> Work:
        """Queue fn on the op thread; `post` (a tensor input's `back`)
        runs on the result in the thread that waits for it."""
        self.check_abort()  # closed/aborted groups reject new ops eagerly
        with self._submit_lock:
            self._op_seq += 1
            work = (Work if post in (None, _same) else _StagedWork)(
                self._op_seq, self.group_name, rank=self.rank,
                world_size=self.world_size,
                **({} if post in (None, _same) else {"post": post}))
            if self._op_queue is not None:
                self._op_queue.put((work, fn))
                return work
        # world_size == 1: no op thread; complete inline.
        try:
            work._finish(result=fn())
        except BaseException as e:
            work._finish(error=e)
        return work

    def _op_loop(self):
        while True:
            item = self._op_queue.get()
            if item is None:
                return
            work, fn = item
            self._current_op_id = work.op_id  # blocked-on attribution
            try:
                work._finish(result=fn())
            except BaseException as e:  # noqa: BLE001 - delivered at wait()
                work._finish(error=e)

    def _drain(self, jobs: List[_TxJob], deadline: float) -> int:
        """Wait for outstanding tx jobs, observing abort + deadline; returns
        bytes sent and re-raises the first tx error."""
        nbytes = 0
        for job in jobs:
            while not job.event.wait(self._poll_s):
                self.check_abort()
                if time.monotonic() > deadline:
                    raise TimeoutError("collective op deadline exceeded")
            if job.error is not None and not isinstance(job.error,
                                                        CollectiveAbortError):
                raise job.error
            nbytes += job.nbytes
        self.check_abort()
        return nbytes

    # ---- p2p link management ---------------------------------------------

    def _out_sock(self, dst_rank: int, deadline: float) -> socket.socket:
        sock = self._p2p_out.get(dst_rank)
        if sock is not None:
            return sock
        with self._conn_lock:
            sock = self._p2p_out.get(dst_rank)
            if sock is not None:
                return sock
            key = f"collective:{self.group_name}:p2p:{dst_rank}"
            addr = None
            while addr is None:
                self.check_abort()
                addr = self._kv_get(key)
                if addr is None:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"p2p rendezvous with rank {dst_rank}")
                    time.sleep(0.02)
            host, port = addr.rsplit(":", 1)
            sock = socket.create_connection((host, int(port)),
                                            timeout=self._timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_msg(sock, self.rank)  # identify ourselves
            sock.settimeout(self._poll_s)
            self._p2p_out[dst_rank] = sock
            return sock

    def _in_sock(self, src_rank: int, deadline: float) -> socket.socket:
        sock = self._p2p_in.get(src_rank)
        if sock is not None:
            return sock
        with self._accept_lock:
            while src_rank not in self._p2p_in:
                try:
                    sock, _ = self._p2p_listener.accept()
                except socket.timeout:
                    self.check_abort()
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"p2p recv from rank {src_rank}: deadline exceeded")
                    continue
                except OSError:
                    self.check_abort()
                    raise
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(self._poll_s)
                peer = _recv_msg(sock, check=self.check_abort, deadline=deadline)
                self._p2p_in[peer] = sock
            return self._p2p_in[src_rank]

    def _tx_array(self, sock, arr: np.ndarray, deadline: float) -> List[_TxJob]:
        """Queue one array (possibly as multiple chunk frames) on the tx
        thread; frames alias `arr`, which must stay unmodified until the
        returned jobs drain."""
        flat = arr.reshape(-1)
        if flat.size == 0:
            return [self._tx.submit(sock, _frame_views(flat, arr.shape, 0),
                                    deadline)]
        jobs = []
        for off, n in _chunks(0, flat.size, self._chunk_elems(arr.itemsize)):
            jobs.append(self._tx.submit(
                sock, _frame_views(flat[off:off + n], arr.shape, off), deadline))
        return jobs

    def _recv_chunk_into(self, sock, dst: np.ndarray, deadline: float) -> int:
        """Receive exactly one array chunk frame straight into `dst`
        (a contiguous 1-D view sized to the schedule's chunk)."""
        length, kind = _read_hdr(sock, self.check_abort, deadline)
        if kind != _K_ARRAY:
            raise RuntimeError("collective protocol error: expected array frame")
        _, _, _, nelems = _read_ameta(sock, self.check_abort, deadline)
        payload = length - _AMETA.size
        if nelems != dst.size or payload != dst.nbytes:
            raise RuntimeError(
                f"collective protocol error: chunk of {nelems} elems /"
                f" {payload} B where {dst.size} elems / {dst.nbytes} B expected")
        _sock_recv_into(sock, memoryview(dst).cast("B"), self.check_abort,
                        deadline)
        counters["deserialize_fast"] += 1
        return payload

    # ---- hub (root-coordinated) plane ------------------------------------

    def _coordinate(self, opcode: str, payload, compute):
        """Root: gather payloads from all ranks, run `compute(payloads)->
        per-rank replies`, scatter. Non-root: send payload, await reply."""
        if self.world_size == 1:
            self.check_abort()
            return compute([payload])[0]
        deadline = self._op_deadline()
        with self._op():
            if self.rank == 0:
                payloads: List = [None] * self.world_size
                payloads[0] = payload
                for r in range(1, self.world_size):
                    op, data = _recv_msg(self._peers[r],
                                         check=self.check_abort,
                                         deadline=deadline)
                    assert op == opcode, f"collective mismatch: {op} vs {opcode}"
                    payloads[r] = data
                replies = compute(payloads)
                for r in range(1, self.world_size):
                    _send_msg(self._peers[r], replies[r],
                              check=self.check_abort, deadline=deadline)
                return replies[0]
            _send_msg(self._root, (opcode, payload),
                      check=self.check_abort, deadline=deadline)
            return _recv_msg(self._root, check=self.check_abort,
                             deadline=deadline)

    def _hub_allreduce(self, array: np.ndarray, op: str) -> np.ndarray:
        def compute(payloads):
            result = reduce_arrays(payloads, op)
            return [result] * self.world_size

        with self._timed("allreduce", "hub"):
            return self._coordinate("allreduce", np.asarray(array), compute)

    def _hub_allgather(self, array: np.ndarray) -> List[np.ndarray]:
        def compute(payloads):
            return [list(payloads)] * self.world_size

        with self._timed("allgather", "hub"):
            return self._coordinate("allgather", np.asarray(array), compute)

    def _hub_reducescatter(self, arrays: Sequence[np.ndarray],
                           op: str) -> np.ndarray:
        def compute(payloads):
            # payloads[r] is a list of world_size shards from rank r.
            return [reduce_arrays([p[r] for p in payloads], op)
                    for r in range(self.world_size)]

        with self._timed("reducescatter", "hub"):
            return self._coordinate("reducescatter",
                                    [np.asarray(a) for a in arrays], compute)

    def _hub_broadcast(self, array, src_rank: int) -> np.ndarray:
        def compute(payloads):
            return [payloads[src_rank]] * self.world_size

        payload = np.asarray(array) if self.rank == src_rank else None
        with self._timed("broadcast", "hub"):
            return self._coordinate("broadcast", payload, compute)

    # ---- ring plane ------------------------------------------------------

    def _ring_allreduce(self, arr: np.ndarray, op: str) -> np.ndarray:
        """Bandwidth-optimal chunked ring allreduce: W-1 reduce-scatter
        steps then W-1 all-gather steps over the neighbor links; each rank
        moves 2*(W-1)/W of the buffer total, in `collective_chunk_bytes`
        chunks that pipeline across hops."""
        w, r = self.world_size, self.rank
        if op not in ("sum", "prod", "min", "max", "mean"):
            raise ValueError(f"unknown reduce op {op!r}")
        if w == 1:
            with self._op():
                self.check_abort()
                return reduce_arrays([arr], op)
        rop = "sum" if op == "mean" else op
        flat = arr.flatten()  # private contiguous working copy
        deadline = self._op_deadline()
        sent = recvd = 0
        t0 = time.perf_counter()
        with self._op():
            try:
                right = self._out_sock((r + 1) % w, deadline)
                left = self._in_sock((r - 1) % w, deadline)
                segs = _segments(flat.size, w)
                ch = self._chunk_elems(flat.itemsize)
                scratch = np.empty(min(ch, max(s for _, s in segs) or 1),
                                   flat.dtype)
                # No per-step barrier: every queued frame aliases a segment
                # that is FINAL at queue time and is never rewritten before
                # causal delivery (a later recv that would overwrite it can
                # only complete after the frame has circled the ring), so
                # all tx jobs drain once at op end and consecutive steps'
                # chunks stream back to back through the socket.
                jobs: List[_TxJob] = []
                # Phase 1: ring reduce-scatter. After step t each rank holds
                # a t+2-rank partial of one more segment; after W-1 steps
                # rank r owns the fully reduced segment (r+1) % W.
                for step in range(w - 1):
                    si = (r - step) % w
                    ri = (r - step - 1) % w
                    jobs += [self._tx.submit(right,
                                             _frame_views(flat[o:o + n]),
                                             deadline)
                             for o, n in _chunks(*segs[si], ch)]
                    for o, n in _chunks(*segs[ri], ch):
                        buf = scratch[:n]
                        recvd += self._recv_chunk_into(left, buf, deadline)
                        _reduce_into(flat[o:o + n], buf, rop)
                # Phase 2: ring all-gather of the reduced segments.
                for step in range(w - 1):
                    si = (r - step + 1) % w
                    ri = (r - step) % w
                    jobs += [self._tx.submit(right,
                                             _frame_views(flat[o:o + n]),
                                             deadline)
                             for o, n in _chunks(*segs[si], ch)]
                    for o, n in _chunks(*segs[ri], ch):
                        recvd += self._recv_chunk_into(left, flat[o:o + n],
                                                       deadline)
                sent += self._drain(jobs, deadline)
            except TimeoutError:
                raise
            except (ConnectionError, OSError) as e:
                self._ring_fail("allreduce", e)
        if op == "mean":
            flat = _mean_div(flat, w)
        self._observe("allreduce", "ring", time.perf_counter() - t0, sent, recvd)
        return flat.reshape(arr.shape)

    def _ring_allgather(self, arr: np.ndarray) -> List[np.ndarray]:
        w, r = self.world_size, self.rank
        if w == 1:
            with self._op():
                self.check_abort()
                return [np.asarray(arr)]
        out: List[Optional[np.ndarray]] = [None] * w
        out[r] = np.ascontiguousarray(arr)
        deadline = self._op_deadline()
        sent = recvd = 0
        t0 = time.perf_counter()
        with self._op():
            try:
                right = self._out_sock((r + 1) % w, deadline)
                left = self._in_sock((r - 1) % w, deadline)
                jobs: List[_TxJob] = []
                for step in range(w - 1):
                    si = (r - step) % w
                    ri = (r - step - 1) % w
                    jobs += self._tx_array(right, out[si], deadline)
                    out[ri] = _recv_msg(left, check=self.check_abort,
                                        deadline=deadline)
                    recvd += out[ri].nbytes
                sent += self._drain(jobs, deadline)
            except TimeoutError:
                raise
            except (ConnectionError, OSError) as e:
                self._ring_fail("allgather", e)
        self._observe("allgather", "ring", time.perf_counter() - t0, sent, recvd)
        return out

    def _ring_reducescatter(self, arrays: Sequence[np.ndarray],
                            op: str) -> np.ndarray:
        w, r = self.world_size, self.rank
        arrays = [np.asarray(a) for a in arrays]
        if len(arrays) != w:
            raise ValueError(f"reducescatter needs {w} shards, got {len(arrays)}")
        if w == 1:
            with self._op():
                self.check_abort()
                return reduce_arrays([arrays[0]], op)
        rop = "sum" if op == "mean" else op
        deadline = self._op_deadline()
        sent = recvd = 0
        t0 = time.perf_counter()
        # Running partial: start with our own contribution to the shard the
        # left neighbor chain will accumulate next.
        acc = arrays[(r - 1) % w].flatten()
        with self._op():
            try:
                right = self._out_sock((r + 1) % w, deadline)
                left = self._in_sock((r - 1) % w, deadline)
                jobs: List[_TxJob] = []
                for step in range(w - 1):
                    jobs += self._tx_array(right, acc, deadline)
                    si = (r - step - 2) % w
                    incoming = _recv_msg(left, check=self.check_abort,
                                         deadline=deadline)
                    recvd += incoming.nbytes
                    local = np.ascontiguousarray(arrays[si]).reshape(-1)
                    _reduce_into(incoming, local, rop)
                    acc = incoming
                sent += self._drain(jobs, deadline)
            except TimeoutError:
                raise
            except (ConnectionError, OSError) as e:
                self._ring_fail("reducescatter", e)
        if op == "mean":
            acc = _mean_div(acc, w)
        self._observe("reducescatter", "ring", time.perf_counter() - t0,
                      sent, recvd)
        return acc.reshape(arrays[r].shape)

    def _ring_broadcast(self, arr, src_rank: int) -> np.ndarray:
        """Pipelined chain broadcast: src streams chunks to its right
        neighbor; every other rank forwards each chunk as it lands, so a
        large tensor occupies all hops simultaneously."""
        w, r = self.world_size, self.rank
        if w == 1:
            with self._op():
                self.check_abort()
                return np.asarray(arr)
        deadline = self._op_deadline()
        sent = recvd = 0
        t0 = time.perf_counter()
        with self._op():
            try:
                if r == src_rank:
                    right = self._out_sock((r + 1) % w, deadline)
                    a = np.ascontiguousarray(np.asarray(arr))
                    sent += self._drain(self._tx_array(right, a, deadline),
                                        deadline)
                    self._observe("broadcast", "ring",
                                  time.perf_counter() - t0, sent, recvd)
                    return a
                left = self._in_sock((r - 1) % w, deadline)
                forward = (r + 1) % w != src_rank
                right = self._out_sock((r + 1) % w, deadline) if forward else None
                jobs: List[_TxJob] = []
                out = flat = None
                got = total = 0
                while out is None or got < total:
                    length, kind = _read_hdr(left, self.check_abort, deadline)
                    if kind != _K_ARRAY:
                        raise RuntimeError(
                            "collective protocol error: expected array frame")
                    dtype, shape, offset, nelems = _read_ameta(
                        left, self.check_abort, deadline)
                    if out is None:
                        out = np.empty(shape, dtype)
                        flat = out.reshape(-1)
                        total = flat.size
                    chunk = flat[offset:offset + nelems]
                    _sock_recv_into(left, memoryview(chunk).cast("B"),
                                    self.check_abort, deadline)
                    counters["deserialize_fast"] += 1
                    recvd += chunk.nbytes
                    got += nelems
                    if forward:
                        jobs.append(self._tx.submit(
                            right, _frame_views(chunk, shape, offset), deadline))
                    if total == 0:
                        break
                sent += self._drain(jobs, deadline)
            except TimeoutError:
                raise
            except (ConnectionError, OSError) as e:
                self._ring_fail("broadcast", e)
        self._observe("broadcast", "ring", time.perf_counter() - t0, sent, recvd)
        return out

    def _alltoall_impl(self, arrays: List[np.ndarray]) -> List[np.ndarray]:
        """Pairwise exchange over the direct p2p links: at offset k every
        rank streams its shard to rank+k while receiving from rank-k —
        sends ride the tx thread, so the exchange is deadlock-free and each
        round keeps both link directions busy."""
        w, r = self.world_size, self.rank
        if len(arrays) != w:
            raise ValueError(f"alltoall needs {w} shards, got {len(arrays)}")
        out: List[Optional[np.ndarray]] = [None] * w
        out[r] = np.asarray(arrays[r])
        if w == 1:
            with self._op():
                self.check_abort()
                return out
        deadline = self._op_deadline()
        sent = recvd = 0
        t0 = time.perf_counter()
        with self._op():
            try:
                jobs: List[_TxJob] = []
                for offset in range(1, w):
                    dst = (r + offset) % w
                    src = (r - offset) % w
                    osock = self._out_sock(dst, deadline)
                    isock = self._in_sock(src, deadline)
                    shard = np.asarray(arrays[dst])
                    if _ring_wire_ok(shard):
                        jobs += self._tx_array(
                            osock, np.ascontiguousarray(shard), deadline)
                    else:
                        jobs.append(self._tx.submit(osock, _ctrl_views(shard),
                                                    deadline))
                    out[src] = _recv_msg(isock, check=self.check_abort,
                                         deadline=deadline)
                    recvd += getattr(out[src], "nbytes", 0)
                sent += self._drain(jobs, deadline)
            except TimeoutError:
                raise
            except (ConnectionError, OSError) as e:
                self._ring_fail("alltoall", e)
        self._observe("alltoall", "ring", time.perf_counter() - t0, sent, recvd)
        return out

    # ---- public collective API -------------------------------------------

    def _ring_enabled(self) -> bool:
        return self._topology == "ring" and self.world_size > 1

    def allreduce_async(self, array, op: str = "sum") -> Work:
        arr, back = _host(array)
        if self._ring_enabled() and _ring_wire_ok(arr):
            return self._submit(lambda: self._ring_allreduce(arr, op), back)
        return self._submit(lambda: self._hub_allreduce(arr, op), back)

    def allgather_async(self, array) -> Work:
        arr, back = _host(array)
        if self._ring_enabled() and _ring_wire_ok(arr):
            return self._submit(lambda: self._ring_allgather(arr), back)
        return self._submit(lambda: self._hub_allgather(arr), back)

    def reducescatter_async(self, arrays, op: str = "sum") -> Work:
        hosted = [_host(a) for a in arrays]
        arrs = [a for a, _ in hosted]
        back = hosted[0][1] if hosted else _same
        if self._ring_enabled() and all(_ring_wire_ok(a) for a in arrs):
            return self._submit(lambda: self._ring_reducescatter(arrs, op),
                                back)
        return self._submit(lambda: self._hub_reducescatter(arrs, op), back)

    def broadcast_async(self, array, src_rank: int = 0) -> Work:
        arr, back = (None, _same) if array is None else _host(array)
        ok = arr is None or _ring_wire_ok(arr)
        if self._ring_enabled() and ok:
            return self._submit(lambda: self._ring_broadcast(arr, src_rank),
                                back)
        return self._submit(lambda: self._hub_broadcast(arr, src_rank), back)

    def allreduce(self, array: np.ndarray, op: str = "sum") -> np.ndarray:
        return self.allreduce_async(array, op).wait()

    def allgather(self, array: np.ndarray) -> List[np.ndarray]:
        return self.allgather_async(array).wait()

    def reducescatter(self, arrays: Sequence[np.ndarray],
                      op: str = "sum") -> np.ndarray:
        return self.reducescatter_async(arrays, op).wait()

    def broadcast(self, array: np.ndarray, src_rank: int = 0) -> np.ndarray:
        return self.broadcast_async(array, src_rank).wait()

    def alltoall(self, arrays) -> List[np.ndarray]:
        hosted = [_host(a) for a in arrays]
        return self._submit(lambda: self._alltoall_impl(
            [a for a, _ in hosted]), hosted[0][1] if hosted else _same).wait()

    def barrier(self) -> None:
        # Rides the op thread so a barrier also fences every previously
        # submitted async op on this rank (FIFO drain), then syncs ranks
        # over the root star links.
        self._submit(lambda: self._coordinate(
            "barrier", None, lambda payloads: [None] * self.world_size)).wait()

    # ---- metrics ---------------------------------------------------------

    def _observe(self, opname: str, algo: str, seconds: float,
                 sent: int, recvd: int) -> None:
        try:
            m = _op_metrics(opname, algo)
            m["ops"].inc()
            m["latency"].observe(seconds)
            if sent:
                m["sent"].inc(sent)
            if recvd:
                m["recv"].inc(recvd)
        except Exception:
            pass  # metrics must never break the data plane

    class _Timed:
        __slots__ = ("comm", "opname", "algo", "t0")

        def __init__(self, comm, opname, algo):
            self.comm, self.opname, self.algo = comm, opname, algo

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                self.comm._observe(self.opname, self.algo,
                                   time.perf_counter() - self.t0, 0, 0)
            return False

    def _timed(self, opname: str, algo: str) -> "_Timed":
        return TCPCommunicator._Timed(self, opname, algo)

    # ---- p2p (direct pairwise connections) -------------------------------

    def send(self, array, dst_rank: int) -> None:
        arr, _ = _host(array)
        deadline = self._op_deadline()
        with self._op():
            sock = self._out_sock(
                dst_rank, min(deadline, time.monotonic() + self._timeout))
            if not _ring_wire_ok(arr):
                _send_msg(sock, arr, check=self.check_abort, deadline=deadline)
                return
            # Inline (not via tx): p2p send is one-directional, so it can't
            # deadlock, and staying off the tx queue keeps user p2p from
            # interleaving with an op-thread collective's frames.
            flat = np.ascontiguousarray(arr).reshape(-1)
            if flat.size == 0:
                for view in _frame_views(flat, arr.shape, 0):
                    _sock_send(sock, view, self.check_abort, deadline)
                return
            for off, n in _chunks(0, flat.size, self._chunk_elems(arr.itemsize)):
                for view in _frame_views(flat[off:off + n], arr.shape, off):
                    _sock_send(sock, view, self.check_abort, deadline)

    def recv(self, shape, dtype, src_rank: int) -> np.ndarray:
        deadline = self._op_deadline()
        with self._op():
            sock = self._in_sock(src_rank, deadline)
            return _recv_msg(sock, check=self.check_abort, deadline=deadline)

    def close(self) -> None:
        # Local-only abort: unblocks any thread of THIS rank still inside a
        # collective, without poisoning peers that are shutting down cleanly.
        self.abort("collective group closed", propagate=False)
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._op_queue is not None:
            self._op_queue.put(None)
        if self._tx is not None:
            self._tx.stop()
        try:
            for sock in list(self._p2p_out.values()) + list(self._p2p_in.values()):
                sock.close()
            self._p2p_listener.close()
            if self.world_size > 1:
                if self.rank == 0:
                    for sock in self._peers:
                        if sock is not None:
                            sock.close()
                    self._listener.close()
                else:
                    self._root.close()
        except Exception:
            pass
        if self._op_thread is not None:
            self._op_thread.join(2.0)
        if self._tx is not None:
            self._tx.join(2.0)


# ---------------------------------------------------------------------------
# Per-(op, algo) metric handles, bound once (tag-key precomputation) so the
# per-op bookkeeping stays off the chunk hot path.
# ---------------------------------------------------------------------------

_METRIC_CACHE: Dict[Tuple[str, str], Dict] = {}
_METRIC_LOCK = threading.Lock()


def _op_metrics(opname: str, algo: str) -> Dict:
    key = (opname, algo)
    handles = _METRIC_CACHE.get(key)
    if handles is None:
        from ray_tpu_torch.runtime import metric_defs as md

        with _METRIC_LOCK:
            handles = _METRIC_CACHE.get(key)
            if handles is None:
                tags = {"op": opname, "algo": algo}
                handles = {
                    "ops": md.COLLECTIVE_OPS.bind(tags),
                    "sent": md.COLLECTIVE_BYTES_SENT.bind(tags),
                    "recv": md.COLLECTIVE_BYTES_RECV.bind(tags),
                    "latency": md.COLLECTIVE_OP_LATENCY.bind(tags),
                }
                _METRIC_CACHE[key] = handles
    return handles
