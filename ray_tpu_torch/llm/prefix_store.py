"""KV prefix store, tier 1: the page codec and the host prefix tier.

Port of the first tier of ray_tpu/llm/prefix_store.py. The BlockManager's
prefix cache (llm/engine.py) is a per-engine LRU: when allocation
pressure recycles a parked block, its KV is gone. HostPrefixTier is a
byte-capacity LRU of evicted prefix blocks in host RAM: the block
manager's eviction path hands the victim block here before recycling it,
and admission (`LLMEngine._admit`) promotes matching blocks back into
fresh device pages instead of re-prefilling them. The cluster tier (a
GCS-resident prefix table) needs an actor runtime the port does not have
yet.

The page codec writes the JAX package's wire format byte for byte, so
pages cross between the two packages in either direction:

    [u64 body len][u8 kind=2][JSON meta: kv dtype/shape]
    [u64][u8 kind=1][97B _AMETA][raw k-page bytes]   x ceil(bytes/1MiB)
    [u64][u8 kind=1][97B _AMETA][raw v-page bytes]   x ceil(bytes/1MiB)

Frames are self-delimiting, so N encoded blocks concatenated decode with
`decode_all`. Decoding is whole-or-nothing: a truncated buffer raises
TruncatedSpillError. numpy has no bf16: bf16 pages travel as their uint16
bits with `kv_dtype="bfloat16"` in the JSON frame (what the JAX package
writes for its bf16 arrays), and decode back to uint16 arrays.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.collective.cpu_group import (
    _AMETA, _HDR, _K_ARRAY, _chunks, _frame_views)
from ray_tpu_torch.ops import to_numpy

_K_JSON = 2
_CHUNK_BYTES = 1 << 20

# bf16 bits travel as uint16 payloads under this dtype name.
BF16 = "bfloat16"


class TruncatedSpillError(RuntimeError):
    """A spilled payload buffer ended mid-frame: discard it whole."""


def _host_array(pages) -> Tuple[np.ndarray, Optional[str]]:
    """Pages (numpy, or a tensor) -> (contiguous host array, dtype name
    when it differs from the array's: bf16 tensors become uint16 bits)."""
    if isinstance(pages, torch.Tensor):
        return to_numpy(pages), (BF16 if pages.dtype == torch.bfloat16
                                 else None)
    a = np.ascontiguousarray(pages)
    return a, (BF16 if a.dtype.name == BF16 else None)


# --------------------------------------------------------------- page codec


def encode_pages(meta: dict, k_pages, v_pages,
                 kv_dtype: Optional[str] = None) -> bytes:
    """Serialize (meta, k, v) into one raw-frame buffer (format above).
    kv dtype/shape ride in the JSON frame; array frames carry raw bytes.
    `kv_dtype` names the pages' dtype when the arrays hold another
    type's bits (uint16 arrays of bf16 pages: "bfloat16"); bf16 tensors
    name it themselves."""
    k, k_name = _host_array(k_pages)
    v, _ = _host_array(v_pages)
    meta = dict(meta)
    meta["kv_dtype"] = kv_dtype or k_name or str(k.dtype)
    meta["kv_shape"] = list(k.shape)
    body = json.dumps(meta).encode()
    parts: List[bytes] = [_HDR.pack(len(body), _K_JSON), body]
    for arr in (k, v):
        flat = arr.reshape(-1).view(np.uint8)
        for off, n in _chunks(0, flat.size, _CHUNK_BYTES):
            for view in _frame_views(flat[off:off + n], flat.shape, off):
                parts.append(bytes(view))
    return b"".join(parts)


class _BufReader:
    """Sequential frame reader over a spilled-payload buffer; truncation
    raises instead of blocking."""

    __slots__ = ("view", "pos")

    def __init__(self, buf):
        self.view = memoryview(buf).cast("B")
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= self.view.nbytes

    def _take(self, n: int) -> memoryview:
        if self.pos + n > self.view.nbytes:
            raise TruncatedSpillError(
                f"spill buffer truncated at byte {self.pos} "
                f"(need {n} more of {self.view.nbytes})")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_frame(self) -> Tuple[str, Any]:
        length, kind = _HDR.unpack(self._take(_HDR.size))
        if kind == _K_JSON:
            return "json", json.loads(bytes(self._take(length)).decode())
        if kind != _K_ARRAY:
            raise TruncatedSpillError(
                f"spill protocol error: unknown frame kind {kind}")
        fields = _AMETA.unpack(self._take(_AMETA.size))
        dtype = np.dtype(fields[0].rstrip(b"\x00").decode())
        ndim = fields[1]
        shape = tuple(fields[2:2 + ndim])
        offset, nelems = fields[10], fields[11]
        out = np.empty(shape, dtype)
        flat = out.reshape(-1)
        total, got = flat.size, 0
        while True:
            if nelems:
                chunk = self._take(length - _AMETA.size)
                memoryview(flat[offset:offset + nelems]).cast("B")[:] = chunk
                got += nelems
            if got >= total:
                return "array", flat
            length, kind = _HDR.unpack(self._take(_HDR.size))
            if kind != _K_ARRAY:
                raise TruncatedSpillError(
                    "spill protocol error: truncated array stream")
            fields = _AMETA.unpack(self._take(_AMETA.size))
            offset, nelems = fields[10], fields[11]


def decode_pages(reader) -> Tuple[dict, np.ndarray, np.ndarray]:
    """Decode one (meta, k, v) triple off a _BufReader (or a buffer).
    bf16 pages come back as uint16 arrays of their bits."""
    r = reader if isinstance(reader, _BufReader) else _BufReader(reader)
    kind, meta = r.read_frame()
    if kind != "json":
        raise TruncatedSpillError("spill buffer missing its meta frame")
    kind_k, kflat = r.read_frame()
    kind_v, vflat = r.read_frame()
    if kind_k != "array" or kind_v != "array":
        raise TruncatedSpillError("spill buffer missing a page array")
    name = meta.pop("kv_dtype")
    dtype = np.dtype(np.uint16 if name == BF16 else name)
    shape = tuple(meta.pop("kv_shape"))
    k = kflat.view(dtype).reshape(shape)
    v = vflat.view(dtype).reshape(shape)
    return meta, k, v


def decode_all(buf) -> List[Tuple[dict, np.ndarray, np.ndarray]]:
    """Decode every concatenated (meta, k, v) triple in `buf`.
    Whole-or-nothing: any truncation raises."""
    r = _BufReader(buf)
    out = []
    while not r.eof():
        out.append(decode_pages(r))
    return out


# ------------------------------------------------------------------- tier 1


class HostPrefixTier:
    """Byte-capacity LRU of evicted prefix blocks in host RAM.

    Entries are per block: {digest, tokens (root-anchored, through this
    block), k, v, lora_slot, lora_name, weights_version, nbytes}. Past
    capacity, LRU victims are dropped down to the low watermark (counted
    as demotions: the JAX package hands them to its cluster tier);
    promotion back to the device happens in LLMEngine._admit through
    get()."""

    def __init__(self, capacity_bytes: int, *, low_watermark: float = 0.8):
        self.capacity_bytes = int(capacity_bytes)
        self.low = float(low_watermark)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.spills = 0
        self.demotions = 0
        self._entries: "OrderedDict[bytes, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, digest: bytes, entry: dict) -> None:
        entry = dict(entry)
        entry["digest"] = digest
        nbytes = int(entry["nbytes"])
        if nbytes > self.capacity_bytes:
            return  # one block larger than the whole tier: never fits
        with self._lock:
            old = self._entries.pop(digest, None)
            if old is not None:
                self.bytes -= int(old["nbytes"])
            self._entries[digest] = entry
            self.bytes += nbytes
            self.spills += 1
            if self.bytes > self.capacity_bytes:
                floor = self.low * self.capacity_bytes
                while self._entries and self.bytes > floor:
                    _, victim = self._entries.popitem(last=False)
                    self.bytes -= int(victim["nbytes"])
                    self.demotions += 1

    def get(self, digest: bytes) -> Optional[dict]:
        with self._lock:
            e = self._entries.get(digest)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(digest)
            self.hits += 1
            return e

    def clear(self) -> int:
        """Drop everything (weight hot-swap: spilled KV is stale)."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.bytes = 0
        return n

    def drop(self, pred) -> int:
        """Drop every entry for which pred(entry) holds; returns how many."""
        with self._lock:
            stale = [d for d, e in self._entries.items() if pred(e)]
            for d in stale:
                self.bytes -= int(self._entries.pop(d)["nbytes"])
        return len(stale)

    def hottest(self, limit: int) -> List[dict]:
        """Most-recently-touched entries first (a drain-time push set)."""
        with self._lock:
            return [self._entries[k]
                    for k in list(reversed(self._entries))[:limit]]

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "bytes": self.bytes,
                "hits": self.hits, "misses": self.misses,
                "spills": self.spills, "demotions": self.demotions}
