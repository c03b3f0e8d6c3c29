"""Value (de)serialization with zero-copy large buffers.

The port's copy of ray_tpu/core/serialization.py. Where the JAX package
moves a single-device jax array as raw bytes (its `_FAST_DEVICE` path),
the port moves a torch tensor: the bytes with the dtype name (bfloat16
included) and the shape, never through pickle. A CPU tensor's payload
equals a jax array's of the same values byte for byte; a tensor that left
from a CUDA device crosses as `_FAST_CUDA` and comes back on the reader's
current CUDA device. torch is found through `sys.modules`, so serializing
never imports it. The dag channel's CLOSE frame is not ported.

Reference analog: python/ray/_private/serialization.py + the plasma buffer
protocol. We use cloudpickle protocol 5: large contiguous buffers (numpy
arrays, bytes) are extracted out-of-band and laid out after the pickle stream
inside a single store object, so `get` reconstructs arrays as views over
shared memory without copying.

Object payload layout:
    [u32 n_buffers][u64 pickle_len][u64 len × n_buffers]
    [pickle bytes][pad to 8][buf 0][pad to 8][buf 1] ...
"""

from __future__ import annotations

import pickle
import struct
import sys
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle
import numpy as _np

# Buffers >= this go out-of-band (below it, copying beats the bookkeeping).
OUT_OF_BAND_THRESHOLD = 16 * 1024

# Per-process serialization counters. `pickle` counts SLOW-path value
# serializations (a cloudpickle.dumps of the object graph — the thing the
# compiled-graph steady state must never do to an activation); the fast_*
# counters count header-only encodes whose payload bytes move as raw views.
# Tests snapshot these to prove zero host pickling on pipeline hot paths.
counters: Dict[str, int] = {
    "pickle": 0, "fast_ndarray": 0, "fast_bytes": 0, "fast_device": 0,
    "deserialize_pickle": 0, "deserialize_fast": 0,
}


def counter_snapshot() -> Dict[str, int]:
    return dict(counters)


def counter_delta(since: Dict[str, int]) -> Dict[str, int]:
    return {k: counters[k] - since.get(k, 0) for k in counters}


def _align8(n: int) -> int:
    return (n + 7) & ~7


def serialize_with_refs(value: Any) -> Tuple[List, int, List]:
    """serialize() that also reports the ObjectRefs CONTAINED in the pickled
    graph (the owner pins them so a stored object keeps its inner refs alive
    — the nested-ref leg of the borrower protocol, reference_count.h:418)."""
    from ray_tpu_torch.core import object_ref as ref_mod

    ref_mod.start_ref_collection()
    try:
        segments, total = serialize(value)
    finally:
        contained = ref_mod.finish_ref_collection()
    return segments, total, contained


# Fast-path markers: a top-level contiguous ndarray / bytes skips
# cloudpickle entirely (the dominant put() payloads; cloudpickle's
# reducer_override machinery costs ~0.1 ms/MiB-object). The flag rides the
# header's n_buffers field (real buffer counts never approach 2^31).
_FLAG_FAST = 0x8000_0000
_FAST_NDARRAY = 1
_FAST_BYTES = 2
_FAST_DEVICE = 3  # torch.Tensor from the CPU: raw bytes, dtype name, shape
_FAST_CLOSE = 4   # the JAX package's dag.channel CLOSE frame (refused)
_FAST_CUDA = 5    # torch.Tensor from a CUDA device: back on the reader's


def _device_array_view(value: Any):
    """If `value` is a torch tensor we can move as raw bytes, return
    (numpy uint8 host view, dtype name, shape, kind); else None.

    A CPU tensor's bytes are a zero-copy view; a CUDA tensor pays the one
    D2H copy at the transfer seam (`.cpu()` synchronizes with the
    producing stream). Subclasses (nn.Parameter), sparse and quantized
    tensors, and tensors on other devices take the pickle path.
    """
    torch = sys.modules.get("torch")
    tensor_t = getattr(torch, "Tensor", None)
    if tensor_t is None or type(value) is not tensor_t:
        return None
    if value.layout != torch.strided or value.is_quantized:
        return None
    if value.device.type not in ("cpu", "cuda"):
        return None
    kind = _FAST_CUDA if value.device.type == "cuda" else _FAST_DEVICE
    host = value.detach()
    if host.device.type != "cpu":
        host = host.cpu()
    host = host.contiguous().reshape(-1).view(torch.uint8).numpy()
    dtype_name = str(value.dtype).removeprefix("torch.")
    return host, dtype_name, tuple(value.shape), kind


def _try_fast_serialize(value: Any) -> Optional[Tuple[List, int]]:
    import numpy as np

    if isinstance(value, np.ndarray):
        # kind 'M'/'m' (datetime64/timedelta64) rejects memoryview; object
        # dtypes and non-contiguous layouts need pickle: all fall back.
        if (value.dtype.hasobject or value.dtype.kind in "Mm"
                or not value.flags.c_contiguous
                or value.nbytes < OUT_OF_BAND_THRESHOLD):
            return None
        meta = pickle.dumps((_FAST_NDARRAY, value.dtype.str, value.shape),
                            protocol=5)
        try:
            raw = memoryview(value).cast("B")
        except (ValueError, TypeError):
            return None  # exotic dtype: pickle path handles it
        counters["fast_ndarray"] += 1
    elif type(value) is bytes:
        # bytes ONLY: bytearray must round-trip as bytearray (mutable),
        # which the pickle path preserves.
        if len(value) < OUT_OF_BAND_THRESHOLD:
            return None
        meta = pickle.dumps((_FAST_BYTES, None, None), protocol=5)
        raw = memoryview(value)
        counters["fast_bytes"] += 1
    else:
        dev = _device_array_view(value)
        if dev is None:
            return None
        # No size floor: even a scalar loss must never force a pickle of
        # the tensor on the hot path.
        host, dtype_name, shape, kind = dev
        meta = pickle.dumps((kind, dtype_name, shape), protocol=5)
        raw = memoryview(host).cast("B")
        counters["fast_device"] += 1
    header = struct.pack("<IQ", _FLAG_FAST | 1, len(meta)) + struct.pack(
        "<Q", raw.nbytes)
    segments: List = [header, meta]
    offset = len(header) + len(meta)
    pad = _align8(offset) - offset
    if pad:
        segments.append(b"\x00" * pad)
        offset += pad
    segments.append(raw)
    return segments, offset + raw.nbytes


def serialize(value: Any) -> Tuple[List, int]:
    """Serialize `value` to (segments, total_size).

    `segments` is a list of byte-likes whose concatenation is the object
    payload; callers write them into a store buffer (or b"".join them for
    inline transport) without extra copies of the large buffers.
    """
    fast = _try_fast_serialize(value)
    if fast is not None:
        return fast
    buffers: List[pickle.PickleBuffer] = []

    def buffer_callback(buf: pickle.PickleBuffer) -> bool:
        raw = buf.raw()
        if raw.nbytes >= OUT_OF_BAND_THRESHOLD and raw.contiguous:
            buffers.append(buf)
            return False  # out-of-band
        return True  # in-band

    counters["pickle"] += 1
    pickled = cloudpickle.dumps(value, protocol=5, buffer_callback=buffer_callback)
    raw_views = [b.raw() for b in buffers]
    header = struct.pack("<IQ", len(raw_views), len(pickled)) + b"".join(
        struct.pack("<Q", v.nbytes) for v in raw_views)
    segments: List = [header, pickled]
    offset = len(header) + len(pickled)
    for v in raw_views:
        pad = _align8(offset) - offset
        if pad:
            segments.append(b"\x00" * pad)
            offset += pad
        segments.append(v)
        offset += v.nbytes
    return segments, offset


def write_segments(dst: memoryview, segments: List) -> None:
    off = 0
    for seg in segments:
        n = seg.nbytes if isinstance(seg, memoryview) else len(seg)
        dst[off:off + n] = seg
        off += n


def join_segments(segments: List) -> bytes:
    return b"".join(bytes(s) if isinstance(s, memoryview) else s for s in segments)


class PinnedBuffer(_np.ndarray):
    """An ndarray view over a store buffer that pins `pin` (e.g. a
    StoreBuffer read reference) for as long as any derived array is alive.

    Lifetime subtleties this class exists to get right:

    - numpy view/frombuffer chains COLLAPSE their base to the root plain
      ndarray — a subclass instance (and any attribute on it) is dropped
      from the chain, so the pin must NOT live on the subclass object.
    - a consumer that aliases the bytes of a plain ndarray (torch.from_numpy,
      a zero-copy device upload) retains that exact object, not ndarray
      *subclasses*.

    So the pin is anchored with `weakref.finalize` to the inner plain uint8
    array (`.root`): every numpy view built over this buffer keeps `root`
    as its base, and `root` is also what such a consumer retains after
    `np.frombuffer(pinned, ...)`. The store read reference is released only
    when the last derived array is garbage collected —
    eviction can never recycle live bytes. An ndarray subclass (not a
    PEP-688 `__buffer__` class) because buffer-protocol consumers must work
    on every Python we support.
    """

    _pin: Any = None
    root: Any = None

    def __new__(cls, view: memoryview, pin: Any):
        import numpy as np
        import weakref

        root = np.frombuffer(view, dtype=np.uint8)
        if pin is not None:
            # The registry entry holds `pin` until `root` is collected;
            # the callback itself is a no-op — dropping the reference is
            # the release (StoreBuffer.__del__ decrements the store ref).
            weakref.finalize(root, _drop_pin, pin)
        self = root.view(cls)
        self._pin = pin
        self.root = root
        return self


def _drop_pin(pin: Any) -> None:
    """Finalizer target: exists only so weakref.finalize keeps `pin` alive
    exactly as long as the pinned root array."""


def deserialize(payload, pin: Any = None) -> Any:
    """Deserialize a payload (memoryview => out-of-band buffers are views).

    `pin` is attached to every out-of-band buffer: the returned object graph
    keeps it (and thus the underlying store read reference) alive for as long
    as the zero-copy arrays are.
    """
    view = payload if isinstance(payload, memoryview) else memoryview(payload)
    n_buffers, pickle_len = struct.unpack_from("<IQ", view, 0)
    if n_buffers & _FLAG_FAST:
        counters["deserialize_fast"] += 1
        return _fast_deserialize(view, pickle_len, pin)
    counters["deserialize_pickle"] += 1
    lens = struct.unpack_from(f"<{n_buffers}Q", view, 12) if n_buffers else ()
    off = 12 + 8 * n_buffers
    pickled = view[off:off + pickle_len]
    off += pickle_len
    bufs = []
    for ln in lens:
        off = _align8(off)
        chunk = view[off:off + ln]
        bufs.append(PinnedBuffer(chunk, pin) if pin is not None else chunk)
        off += ln
    return pickle.loads(pickled, buffers=bufs)


def _fast_deserialize(view: memoryview, meta_len: int, pin: Any):
    import numpy as np

    (raw_len,) = struct.unpack_from("<Q", view, 12)
    off = 20
    meta = pickle.loads(view[off:off + meta_len])
    off = _align8(off + meta_len)
    chunk = view[off:off + raw_len]
    kind, dtype_str, shape = meta
    if kind == _FAST_BYTES:
        # bytes are immutable python objects: one copy at get (same as the
        # pickled path, which also copies in-band bytes).
        return bytes(chunk)
    if kind in (_FAST_DEVICE, _FAST_CUDA):
        return _device_from_raw(chunk, dtype_str, shape, pin,
                                cuda=kind == _FAST_CUDA)
    if kind == _FAST_CLOSE:
        from ray_tpu_torch.core.exceptions import _unported

        raise _unported("the dag channel's CLOSE frame")
    src = PinnedBuffer(chunk, pin) if pin is not None else chunk
    arr = np.frombuffer(src, dtype=np.dtype(dtype_str)).reshape(shape)
    return arr


def _device_from_raw(chunk: memoryview, dtype_name: str, shape, pin: Any,
                     cuda: bool = False):
    """Rebuild a torch tensor from raw bytes: one synchronous host memcpy
    out of the store view into a private tensor, then (for a tensor that
    left from a CUDA device) the upload to the reader's current CUDA
    device, which raises where the reader has none.

    The copy is deliberate: aliasing the store bytes would tie the store
    slot's lifetime to the tensor's, which the reader controls. No pin
    needs to outlive this call."""
    import numpy as np
    import torch

    host = torch.from_numpy(np.frombuffer(chunk, dtype=np.uint8).copy())
    out = host.view(getattr(torch, dtype_name)).reshape(shape)
    if cuda:
        return out.to(torch.device("cuda", torch.cuda.current_device()))
    return out
