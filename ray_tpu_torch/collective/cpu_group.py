"""Raw array frames over a TCP socket: the frame layer of the KV stream.

The port's copy of the frame layer in ray_tpu/collective/cpu_group.py
(no collective group, no pickled control frame). A frame is

    [u64 body length][u8 frame kind][body]

and an array travels as kind-1 frames, each a 97-byte `_AMETA` header
(dtype string, rank, 8 dims of the WHOLE array, element offset, element
count) followed by that chunk's raw bytes, sent straight from and
received straight into the array's buffer. The bytes on the wire equal
the JAX package's, so either side may talk to the other.

`counters` is the port's copy of the serialization counters these
functions bump (`fast_ndarray` per array frame sent, `deserialize_fast`
per frame received); `pickle` and `deserialize_pickle` stay 0 here,
which is what a test reads to show that a handoff pickles nothing.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# Wire: [u64 body length][u8 frame kind][body]
_HDR = struct.Struct("<QB")
_K_ARRAY = 1   # body = _AMETA header + raw ndarray chunk bytes

# Array-chunk header: dtype str (NUL-padded), ndim, 8 dims of the FULL
# array this chunk belongs to, element offset of the chunk, chunk elements.
_AMETA = struct.Struct("<16sB8QQQ")
_MAX_DIMS = 8

counters: Dict[str, int] = {
    "pickle": 0, "fast_ndarray": 0, "deserialize_pickle": 0,
    "deserialize_fast": 0}


def _sock_send(sock: socket.socket, view: memoryview,
               check: Optional[Callable] = None,
               deadline: Optional[float] = None) -> None:
    if check is None and deadline is None:
        sock.sendall(view)
        return
    # A partial send to a slow peer is retried each tick, observing the
    # abort check and the deadline like the receive side.
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
                raise
            if check is not None:
                check()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("collective op deadline exceeded")
            continue
        except OSError:
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
    """The wire views of one raw array chunk: [header+meta, payload]. The
    payload view aliases the caller's buffer (no copy). `full_shape` is
    the shape of the array the chunk belongs to (default: the chunk's)."""
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


def _chunks(off: int, size: int, chunk_elems: int):
    end = off + size
    while off < end:
        n = min(chunk_elems, end - off)
        yield off, n
        off += n
