"""Two-tier KV prefix store: the page codec, the host prefix tier and the
cluster prefix table's client.

Port of ray_tpu/llm/prefix_store.py. The BlockManager's prefix cache
(llm/engine.py) is a per-engine LRU: when allocation pressure recycles a
parked block, its KV is gone, and when the server dies its whole working
set dies with it. Two tiers keep cold prefix pages past both events:

  * Tier 1, HostPrefixTier: a byte-capacity LRU of evicted prefix blocks
    in host RAM. The block manager's eviction path hands the victim block
    here before recycling it, and admission (`LLMEngine._admit`) promotes
    matching blocks back into fresh device pages instead of re-prefilling
    them.

  * Tier 2, ClusterPrefixStore: host-tier victims past its capacity are
    published over the raw-frame RPC wire (runtime/rpc.py call_raw)
    into the GCS-resident prefix table (runtime/gcs/server.py). The pages
    live in the GCS, not in a worker's object store, because a worker's
    objects are reaped when their owner dies, the very event this store
    must survive: any server of the cluster adopts a published prefix.

Cluster entries are keyed by `cluster_chain`, a digest chain under a
FIXED salt seeded with the adapter name, so addresses compare across
processes (the engine's own chain is salted per process). Every entry
carries its whole root-anchored token prefix, and an adopter scatters
pages only after checking those tokens against its own prompt, and the
weights version against its own, so a forged or stale row is never
decoded. The table is keyed by tokens, not by model: the port's
publisher writes its model's fingerprint (`ModelRunner.fingerprint`)
into each row's JSON frame, and an adopter refuses a row of another
model. A row without one (the JAX package's publisher writes none) is
taken on its tokens and weights version alone, as the JAX package takes
every row.

The page codec writes the JAX package's wire format byte for byte, so
pages cross between the two packages in either direction:

    [u64 body len][u8 kind=2][JSON meta: kv dtype/shape]
    [u64][u8 kind=1][97B _AMETA][raw k-page bytes]   x ceil(bytes/1MiB)
    [u64][u8 kind=1][97B _AMETA][raw v-page bytes]   x ceil(bytes/1MiB)

Frames are self-delimiting, so N encoded blocks concatenated (a lookup
reply) decode with `decode_all`. Decoding is whole-or-nothing: a truncated
buffer raises TruncatedSpillError and the adopter takes none of it. numpy
has no bf16: bf16 pages travel as their uint16 bits with
`kv_dtype="bfloat16"` in the JSON frame (what the JAX package writes for
its bf16 arrays), and decode back to uint16 arrays.

Nothing here pickles: the table's traffic is wire.Prefix*Msg headers plus
raw-frame payloads in both directions.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.collective.cpu_group import (
    _AMETA, _HDR, _K_ARRAY, _chunks, _frame_views)
from ray_tpu_torch.ops import to_numpy

logger = logging.getLogger(__name__)

_K_JSON = 2
_CHUNK_BYTES = 1 << 20

# bf16 bits travel as uint16 payloads under this dtype name.
BF16 = "bfloat16"

# Fixed cross-process salt of cluster prefix addresses (the JAX package's:
# the two packages' digests of one prompt are equal). blake2b keys are at
# most 64 bytes.
CLUSTER_PREFIX_SALT = b"ray-tpu/cluster-prefix-store/v1"


def cluster_chain(tokens: Sequence[int], block_size: int,
                  lora_id: str = "") -> List[bytes]:
    """Cluster-comparable digest chain of `tokens`, seeded by the adapter
    name (an adapter changes wk/wv, so its KV differs and its rows are
    keyed apart)."""
    from ray_tpu_torch.llm.engine import prefix_digest_chain

    return prefix_digest_chain(tokens, block_size, salt=CLUSTER_PREFIX_SALT,
                               seed=(lora_id or "").encode())


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
    block), k, v, lora_slot, lora_name, weights_version, nbytes, and
    kv_dtype where the arrays hold another type's bits, and model where
    the engine publishes to a cluster store}. Past capacity, LRU victims
    are demoted through `on_demote` (the engine wires it to
    ClusterPrefixStore.publish) down to the low watermark; without
    `on_demote` they are dropped. Promotion back to the device happens in
    LLMEngine._admit through get()."""

    def __init__(self, capacity_bytes: int, *, low_watermark: float = 0.8,
                 on_demote: Optional[Callable[[dict], None]] = None):
        self.capacity_bytes = int(capacity_bytes)
        self.low = float(low_watermark)
        self.on_demote = on_demote
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.spills = 0
        self.demotions = 0
        self._entries: "OrderedDict[bytes, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: bytes) -> bool:
        """Held? A peek: no hit or miss is counted, the LRU order stays."""
        return digest in self._entries

    def put(self, digest: bytes, entry: dict) -> None:
        entry = dict(entry)
        entry["digest"] = digest
        nbytes = int(entry["nbytes"])
        if nbytes > self.capacity_bytes:
            return  # one block larger than the whole tier: never fits
        demoted: List[dict] = []
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
                    demoted.append(victim)
        _spill_metric("host")
        for victim in demoted:
            if self.on_demote is not None:
                try:
                    self.on_demote(victim)
                except Exception:
                    logger.exception("prefix demotion to the cluster store "
                                     "failed")
        self._gauge()

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
        self._gauge()
        return n

    def drop(self, pred) -> int:
        """Drop every entry for which pred(entry) holds; returns how many."""
        with self._lock:
            stale = [d for d, e in self._entries.items() if pred(e)]
            for d in stale:
                self.bytes -= int(self._entries.pop(d)["nbytes"])
        self._gauge()
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

    def _gauge(self):
        from ray_tpu_torch.runtime import metric_defs

        metric_defs.LLM_PREFIX_STORE_BYTES.set(self.bytes)


def _spill_metric(tier: str) -> None:
    from ray_tpu_torch.runtime import metric_defs

    metric_defs.LLM_PREFIX_SPILLS.inc(tags={"tier": tier})


# ------------------------------------------------------------------- tier 2


class ClusterPrefixStore:
    """Client of the GCS prefix table (gcs/server.py handle_prefix_*).

    All traffic rides `call_raw`: wire.Prefix*Msg headers plus raw-frame
    page payloads, no pickle in either direction. Every method is
    best-effort: no core worker, a refusing GCS or a timeout is a cache
    miss, never an engine error. `transport(method, m, payload) -> (m,
    payload)` replaces the RPC (tests bridge it onto a GcsServer)."""

    def __init__(self, block_size: int, *, replica: str = "",
                 deployment: str = "", timeout_s: float = 5.0,
                 transport: Optional[Callable] = None):
        self.block_size = int(block_size)
        self.replica = replica
        self.deployment = deployment
        self.timeout_s = float(timeout_s)
        self._transport = transport
        self.published = 0
        self.adopted_blocks = 0
        self.stale_rejected = 0
        self.errors = 0

    # -- transport ---------------------------------------------------------

    def _call(self, method: str, m: bytes, payload=b"",
              wait: bool = True) -> Optional[Tuple[bytes, Any]]:
        """One raw-frame RPC to the GCS. wait=False fires and forgets (a
        demotion must never stall the engine's tick on a round trip to the
        head node)."""
        if self._transport is not None:
            return self._transport(method, m, payload)
        from ray_tpu_torch.core import worker as worker_mod

        if not worker_mod.is_initialized():
            return None
        core = worker_mod.global_worker()
        try:
            coro = core.gcs.call_raw(method, m=m, payload=payload,
                                     timeout=self.timeout_s)
            if not wait:
                core.io.spawn(coro)
                return None
            return core.io.run(coro, timeout=self.timeout_s + 2)
        except Exception:
            self.errors += 1
            return None

    def available(self) -> bool:
        if self._transport is not None:
            return True
        from ray_tpu_torch.core import worker as worker_mod

        return worker_mod.is_initialized()

    def _node_id(self) -> bytes:
        from ray_tpu_torch.core import worker as worker_mod

        if not worker_mod.is_initialized():
            return b""
        return bytes(worker_mod.global_worker().node_id or b"")

    # -- operations ----------------------------------------------------------

    def publish(self, entry: dict, *, wait: bool = False) -> bool:
        """Demote one host-tier victim into the cluster table. The payload
        is whole before the RPC leaves, so an upsert lands whole or not at
        all."""
        from ray_tpu_torch.runtime import events, metric_defs, wire
        from ray_tpu_torch.util import tracing

        tokens = list(entry["tokens"])
        lora_id = entry.get("lora_name") or ""
        if not tokens or len(tokens) % self.block_size:
            return False
        digest = cluster_chain(tokens, self.block_size, lora_id)[-1]
        meta = {"model": entry["model"]} if entry.get("model") else {}
        payload = encode_pages(meta, entry["k"], entry["v"],
                               kv_dtype=entry.get("kv_dtype"))
        m = wire.PrefixEntryMsg(
            digest=digest, lora_id=lora_id,
            weights_version=int(entry.get("weights_version", 0)),
            block_size=self.block_size, n_tokens=len(tokens),
            token_ids=[int(t) for t in tokens], nbytes=len(payload),
            owner_replica=self.replica, node_id=self._node_id(),
            deployment=self.deployment).encode()
        t0 = time.time()
        out = self._call("prefix_upsert", m, payload, wait=wait)
        tracing.record_span("llm:prefix_spill", "llm", t0, time.time(),
                            tokens=len(tokens), bytes=len(payload),
                            replica=self.replica)
        self.published += 1
        _spill_metric("store")
        events.emit(events.LLM_PREFIX_SPILLED,
                    f"prefix spilled to cluster store "
                    f"({len(tokens)} tokens, lora={lora_id or 'base'})",
                    source="llm-prefix-store",
                    labels={"replica": self.replica,
                            "deployment": self.deployment,
                            "tokens": str(len(tokens))})
        if not wait:
            return True
        if out is None:
            return False
        return bool(wire.AckMsg.decode(bytes(out[0])).ok)

    def lookup_pages(self, digests: Sequence[bytes], *, lora_id: str = "",
                     weights_version: int = 0,
                     model: str = "") -> List[dict]:
        """Fetch the contiguous run of published blocks from digests[0]
        on. Returns [] on a miss or any failure, else {tokens, k, v,
        lora_id, weights_version} dicts (the caller still checks the
        tokens against its own prompt before scattering). With `model`,
        the run stops at a row another model published (counted as
        stale: its KV is not of this adopter's weights)."""
        from ray_tpu_torch.runtime import events, metric_defs, wire
        from ray_tpu_torch.util import tracing

        if not digests:
            return []
        m = wire.PrefixLookupMsg(
            digests=[bytes(d) for d in digests], lora_id=lora_id or "",
            weights_version=int(weights_version),
            block_size=self.block_size, want_payload=True,
            replica=self.replica).encode()
        t0 = time.time()
        out = self._call("prefix_lookup", m)
        tracing.record_span("llm:prefix_fetch", "llm", t0, time.time(),
                            digests=len(digests), hit=out is not None,
                            bytes=len(out[1]) if out else 0,
                            replica=self.replica)
        if out is None:
            return []
        m_reply, payload = out
        reply = wire.PrefixLookupReplyMsg.decode(bytes(m_reply))
        if not reply.found or not reply.entries:
            return []
        try:
            triples = decode_all(payload)
        except TruncatedSpillError:
            # Whole-or-nothing: a torn reply adopts nothing.
            self.errors += 1
            return []
        if len(triples) != len(reply.entries):
            self.errors += 1
            return []
        results = []
        for ent, (meta, k, v) in zip(reply.entries, triples):
            if (ent.weights_version != int(weights_version)
                    or (model and meta.get("model") not in (None, model))):
                self.stale_rejected += 1
                metric_defs.LLM_PREFIX_STALE_REJECTED.inc()
                break
            results.append({"tokens": list(ent.token_ids), "k": k, "v": v,
                            "lora_id": ent.lora_id,
                            "weights_version": ent.weights_version})
        if results:
            self.adopted_blocks += len(results)
            metric_defs.LLM_PREFIX_ADOPTIONS.inc(len(results),
                                                 tags={"tier": "store"})
            events.emit(events.LLM_PREFIX_ADOPTED,
                        f"adopted {len(results)} spilled prefix "
                        f"block(s) from the cluster store",
                        source="llm-prefix-store",
                        labels={"replica": self.replica,
                                "deployment": self.deployment,
                                "blocks": str(len(results))})
        return results

    def lookup_owner(self, digests: Sequence[bytes], *, lora_id: str = "",
                     weights_version: int = 0) -> Optional[dict]:
        """Metadata-only probe (the router's fallback): does the cluster
        hold this prefix, and which live replica touched it last?"""
        from ray_tpu_torch.runtime import wire

        if not digests:
            return None
        m = wire.PrefixLookupMsg(
            digests=[bytes(d) for d in digests], lora_id=lora_id or "",
            weights_version=int(weights_version),
            block_size=self.block_size, want_payload=False).encode()
        out = self._call("prefix_lookup", m)
        if out is None:
            return None
        reply = wire.PrefixLookupReplyMsg.decode(bytes(out[0]))
        if not reply.found or not reply.entries:
            return None
        ent = reply.entries[-1]
        return {"owner_replica": ent.owner_replica,
                "n_blocks": len(reply.entries), "n_tokens": ent.n_tokens}

    def purge(self, *, owner_replica: str = "", node_id: bytes = b"",
              deployment: str = "", digests: Sequence[bytes] = (),
              below_weights_version: int = 0,
              clear_owner_only: bool = False, wait: bool = False) -> int:
        """Prune the table. `clear_owner_only` blanks live-owner hints (a
        replica's ejection or death: the GCS-homed pages stay adoptable,
        but no router may route to a dead owner); otherwise matching rows
        are dropped (a deleted deployment, stale weights). Returns the
        rows touched, or -1 when fired without waiting."""
        from ray_tpu_torch.runtime import wire

        m = wire.PrefixPurgeMsg(
            owner_replica=owner_replica, node_id=bytes(node_id),
            deployment=deployment, digests=[bytes(d) for d in digests],
            below_weights_version=int(below_weights_version),
            clear_owner_only=bool(clear_owner_only)).encode()
        out = self._call("prefix_purge", m, wait=wait)
        if not wait or out is None:
            return -1
        reply = wire.PrefixPurgeReplyMsg.decode(bytes(out[0]))
        return int(reply.purged + reply.owners_cleared)

    def stats(self) -> Dict[str, int]:
        return {"published": self.published,
                "adopted_blocks": self.adopted_blocks,
                "stale_rejected": self.stale_rejected,
                "errors": self.errors}
