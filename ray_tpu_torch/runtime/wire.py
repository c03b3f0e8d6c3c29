"""Typed wire schema: versioned message structs over the RPC frame.

The port's copy of ray_tpu/runtime/wire.py, whole: every field type and
every message class, so the runtime's typed frames (heartbeats, leases,
task specs and replies, object chunks) and the KV handoff head frame
encode to the JAX package's bytes and decode its bytes.

Reference analog: src/ray/protobuf/ (21 .proto files) — the property that
matters is CROSS-VERSION MESSAGE EVOLUTION: a v(N+1) process can add
fields without breaking v(N) peers, and decoding never depends on both
sides agreeing on the full field set. The pickle wire gave structure no
schema; this module adds protobuf's evolution rules without a compiler:

  * messages declare numbered, typed fields (number = wire identity;
    renames are free, numbers are forever);
  * encoding is field-tagged TLV — unknown field numbers are SKIPPED on
    decode (forward compatibility: old readers tolerate new writers);
  * absent fields decode to their declared defaults (backward
    compatibility: new readers tolerate old writers);
  * nested messages, lists, and string-keyed maps compose; ANY is the
    audited pickle escape hatch for payloads that are genuinely code
    (task args), not schema.

Frame integration: an encoded message travels as one `bytes` value inside
the existing authenticated frame (runtime/rpc.py adds transport auth/MAC;
this layer adds structure). Handlers opt in per message type.

Wire format per field:  [u32 field_no << 3 | wire_type][u32 length][payload]
Message = concatenation of encoded fields, any order.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Dict, List, Optional, Tuple, Type

# wire types (3 bits)
_WT_VARBYTES = 0   # length-delimited scalar payload (int/float/str/bytes/bool)
_WT_MSG = 1        # nested message
_WT_LIST = 2       # repeated inner type
_WT_MAP = 3        # string-keyed map of inner type
_WT_ANY = 4        # pickled (escape hatch)

_TAG = struct.Struct("<I")
_LEN = struct.Struct("<I")


class FieldType:
    """Scalar/composite field type descriptors."""

    def __init__(self, kind: str, inner: Any = None):
        self.kind = kind
        self.inner = inner

    def __repr__(self):
        return f"FieldType({self.kind})"


INT = FieldType("int")
FLOAT = FieldType("float")
BOOL = FieldType("bool")
STR = FieldType("str")
BYTES = FieldType("bytes")
ANY = FieldType("any")


def LIST(inner) -> FieldType:  # noqa: N802 (schema DSL)
    return FieldType("list", inner)


def MAP(inner) -> FieldType:  # noqa: N802
    return FieldType("map", inner)


def MSG(msg_cls) -> FieldType:  # noqa: N802
    return FieldType("msg", msg_cls)


class Field:
    __slots__ = ("number", "type", "default")

    def __init__(self, number: int, ftype: FieldType, default: Any = None):
        if not 1 <= number < (1 << 29):
            raise ValueError(f"field number out of range: {number}")
        self.number = number
        self.type = ftype
        self.default = default


def _default_for(f: Field):
    if f.default is not None:
        return f.default
    return {"int": 0, "float": 0.0, "bool": False, "str": "",
            "bytes": b"", "list": None, "map": None, "msg": None,
            "any": None}[f.type.kind]


def _wire_type(ftype: FieldType) -> int:
    return {"int": _WT_VARBYTES, "float": _WT_VARBYTES,
            "bool": _WT_VARBYTES, "str": _WT_VARBYTES,
            "bytes": _WT_VARBYTES, "msg": _WT_MSG, "list": _WT_LIST,
            "map": _WT_MAP, "any": _WT_ANY}[ftype.kind]


def _payload_encoder(ftype: FieldType):
    """Closure encoding one field's payload — kind dispatch resolved at
    class-definition time, not per call."""
    k = ftype.kind
    if k == "int":
        return struct.Struct("<q").pack
    if k == "float":
        return struct.Struct("<d").pack
    if k == "bool":
        return lambda v: b"\x01" if v else b"\x00"
    if k == "str":
        return str.encode
    if k == "bytes":
        return bytes
    if k == "any":
        return lambda v: pickle.dumps(v, protocol=5)
    if k == "msg":
        return lambda v: v.encode()
    if k == "list":
        inner = _payload_encoder(ftype.inner)

        def enc_list(value):
            parts = []
            for item in value:
                p = inner(item)
                parts.append(_LEN.pack(len(p)))
                parts.append(p)
            return b"".join(parts)

        return enc_list
    if k == "map":
        inner = _payload_encoder(ftype.inner)

        def enc_map(value):
            parts = []
            for key, item in value.items():
                kb = key.encode()
                p = inner(item)
                parts.append(_LEN.pack(len(kb)))
                parts.append(kb)
                parts.append(_LEN.pack(len(p)))
                parts.append(p)
            return b"".join(parts)

        return enc_map
    raise TypeError(f"unknown field kind {k!r}")


def _payload_decoder(ftype: FieldType):
    """Closure decoding one field's payload (see _payload_encoder)."""
    k = ftype.kind
    if k == "int":
        unpack = struct.Struct("<q").unpack
        return lambda p: unpack(p)[0]
    if k == "float":
        unpack = struct.Struct("<d").unpack
        return lambda p: unpack(p)[0]
    if k == "bool":
        return lambda p: bytes(p) != b"\x00"
    if k == "str":
        return lambda p: str(p, "utf-8")
    if k == "bytes":
        return bytes
    if k == "any":
        return pickle.loads
    if k == "msg":
        return ftype.inner.decode
    if k == "list":
        inner = _payload_decoder(ftype.inner)

        def dec_list(payload):
            out = []
            off = 0
            n = len(payload)
            while off < n:
                (ln,) = _LEN.unpack_from(payload, off)
                off += 4
                out.append(inner(payload[off:off + ln]))
                off += ln
            return out

        return dec_list
    if k == "map":
        inner = _payload_decoder(ftype.inner)

        def dec_map(payload):
            out = {}
            off = 0
            n = len(payload)
            while off < n:
                (kl,) = _LEN.unpack_from(payload, off)
                off += 4
                key = str(payload[off:off + kl], "utf-8")
                off += kl
                (vl,) = _LEN.unpack_from(payload, off)
                off += 4
                out[key] = inner(payload[off:off + vl])
                off += vl
            return out

        return dec_map
    raise TypeError(f"unknown field kind {k!r}")


class MessageMeta(type):
    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        fields: Dict[str, Field] = {}
        for base in bases:
            fields.update(getattr(base, "_fields", {}))
        numbers = {f.number for f in fields.values()}
        for key, val in ns.items():
            if isinstance(val, Field):
                if val.number in numbers:
                    raise TypeError(
                        f"{name}.{key}: duplicate field number {val.number}")
                numbers.add(val.number)
                fields[key] = val
        cls._fields = fields
        cls._by_number = {f.number: (n, f) for n, f in fields.items()}
        # Precompiled per-field codecs, resolved ONCE at class definition:
        # string kind-dispatch per field per call costs ~50us per TaskSpec
        # on the actor-call hot path (measured ~20% of call throughput).
        cls._encoders = tuple(
            (n, _TAG.pack((f.number << 3) | _wire_type(f.type)),
             _payload_encoder(f.type))
            for n, f in fields.items())
        cls._decoders = {
            f.number: (n, _wire_type(f.type), _payload_decoder(f.type))
            for n, f in fields.items()}
        cls._scalar_defaults = {
            n: _default_for(f) for n, f in fields.items()
            if f.type.kind not in ("list", "map") or f.default is not None}
        cls._container_defaults = tuple(
            (n, list if f.type.kind == "list" else dict)
            for n, f in fields.items()
            if f.type.kind in ("list", "map") and f.default is None)
        return cls


class Message(metaclass=MessageMeta):
    """Base class: subclass with `Field` class attributes.

    >>> class Heartbeat(Message):
    ...     node_id = Field(1, BYTES)
    ...     available = Field(2, MAP(FLOAT))
    """

    _fields: Dict[str, Field] = {}
    _by_number: Dict[int, Tuple[str, Field]] = {}

    def __init__(self, **kwargs):
        d = self.__dict__
        d.update(self._scalar_defaults)
        for name, factory in self._container_defaults:
            d[name] = factory()  # fresh containers per instance
        for name, value in kwargs.items():
            if name not in self._fields:
                raise TypeError(
                    f"{type(self).__name__} has no field {name!r}")
            d[name] = value

    def __eq__(self, other):
        return (type(self) is type(other)
                and all(getattr(self, n) == getattr(other, n)
                        for n in self._fields))

    def __repr__(self):
        body = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._fields)
        return f"{type(self).__name__}({body})"

    # -- encode ------------------------------------------------------------

    def encode(self) -> bytes:
        out: List[bytes] = []
        d = self.__dict__
        for name, tag, enc in self._encoders:
            value = d[name]
            if value is None:
                continue
            payload = enc(value)
            out.append(tag)
            out.append(_LEN.pack(len(payload)))
            out.append(payload)
        return b"".join(out)

    @classmethod
    def decode(cls, data) -> "Message":
        view = memoryview(data)
        msg = cls()
        d = msg.__dict__
        decoders = cls._decoders
        off = 0
        end = len(view)
        while off < end:
            (tag,) = _TAG.unpack_from(view, off)
            (length,) = _LEN.unpack_from(view, off + 4)
            off += 8
            payload = view[off:off + length]
            off += length
            entry = decoders.get(tag >> 3)
            if entry is None:
                continue  # unknown field from a newer writer: SKIP
            name, wt, dec = entry
            if tag & 7 != wt:
                continue  # wire-type mismatch across versions: default
            try:
                d[name] = dec(payload)
            except Exception:
                # Malformed payload across versions: keep the default
                # rather than failing the whole message.
                continue
        return msg


def _encode_scalar(ftype: FieldType, value) -> bytes:
    k = ftype.kind
    if k == "int":
        return struct.pack("<q", value)
    if k == "float":
        return struct.pack("<d", value)
    if k == "bool":
        return b"\x01" if value else b"\x00"
    if k == "str":
        return value.encode()
    if k == "bytes":
        return bytes(value)
    raise TypeError(f"not a scalar: {k}")


def _decode_scalar(ftype: FieldType, payload: memoryview):
    k = ftype.kind
    if k == "int":
        return struct.unpack("<q", payload)[0]
    if k == "float":
        return struct.unpack("<d", payload)[0]
    if k == "bool":
        return payload != b"\x00" and bytes(payload) != b"\x00"
    if k == "str":
        return str(payload, "utf-8")
    if k == "bytes":
        return bytes(payload)
    raise TypeError(f"not a scalar: {k}")


def _encode_payload(ftype: FieldType, value) -> bytes:
    k = ftype.kind
    if k == "msg":
        return value.encode()
    if k == "list":
        parts = []
        for item in value:
            p = _encode_payload(ftype.inner, item)
            parts.append(_LEN.pack(len(p)))
            parts.append(p)
        return b"".join(parts)
    if k == "map":
        parts = []
        for key, item in value.items():
            kb = key.encode()
            p = _encode_payload(ftype.inner, item)
            parts.append(_LEN.pack(len(kb)))
            parts.append(kb)
            parts.append(_LEN.pack(len(p)))
            parts.append(p)
        return b"".join(parts)
    if k == "any":
        return pickle.dumps(value, protocol=5)
    return _encode_scalar(ftype, value)


def _encode_field(number: int, ftype: FieldType, value) -> bytes:
    payload = _encode_payload(ftype, value)
    return (_TAG.pack((number << 3) | _wire_type(ftype))
            + _LEN.pack(len(payload)) + payload)


def _decode_payload(ftype: FieldType, payload: memoryview):
    k = ftype.kind
    if k == "msg":
        return ftype.inner.decode(payload)
    if k == "list":
        out = []
        off = 0
        while off < len(payload):
            (ln,) = _LEN.unpack_from(payload, off)
            off += 4
            out.append(_decode_payload(ftype.inner, payload[off:off + ln]))
            off += ln
        return out
    if k == "map":
        out = {}
        off = 0
        while off < len(payload):
            (kl,) = _LEN.unpack_from(payload, off)
            off += 4
            key = str(payload[off:off + kl], "utf-8")
            off += kl
            (vl,) = _LEN.unpack_from(payload, off)
            off += 4
            out[key] = _decode_payload(ftype.inner, payload[off:off + vl])
            off += vl
        return out
    if k == "any":
        return pickle.loads(payload)
    return _decode_scalar(ftype, payload)


def _decode_value(ftype: FieldType, wire_type: int, payload: memoryview):
    if wire_type != _wire_type(ftype):
        raise TypeError("wire type mismatch")
    return _decode_payload(ftype, payload)


# --------------------------------------------------------------- schemas
#
# Core control-plane DTOs (the gcs_service.proto / node_manager.proto
# analogs). Field numbers are FOREVER: never reuse a number, only add.

class NodeInfoMsg(Message):
    node_id = Field(1, BYTES)
    host = Field(2, STR)
    port = Field(3, INT)
    resources = Field(4, MAP(FLOAT))
    available = Field(5, MAP(FLOAT))
    labels = Field(6, MAP(STR))
    is_head = Field(7, BOOL)
    alive = Field(8, BOOL, default=True)
    object_store_path = Field(9, STR)
    # Two-phase drain: the node is still alive (leases/objects keep
    # working) but is scheduled for retirement at drain_deadline (unix
    # seconds; 0.0 = not draining). Old peers skip unknown fields.
    draining = Field(10, BOOL)
    drain_deadline = Field(11, FLOAT)


class HeartbeatMsg(Message):
    node_id = Field(1, BYTES)
    available = Field(2, MAP(FLOAT))
    known_version = Field(3, INT, default=-1)
    known_epoch = Field(4, STR)
    backlog = Field(5, ANY)   # per-class demand shapes (advisory)


class ViewDeltaMsg(Message):
    version = Field(1, INT)
    epoch = Field(2, STR)
    full = Field(3, LIST(MSG(NodeInfoMsg)))
    deltas = Field(4, LIST(MSG(NodeInfoMsg)))
    is_full = Field(5, BOOL)


class LeaseRequestMsg(Message):
    resources = Field(1, MAP(FLOAT))
    for_actor = Field(2, BOOL)
    placement_group_id = Field(3, BYTES)
    bundle_index = Field(4, INT, default=-1)
    runtime_env_hash = Field(5, BYTES)
    env_key = Field(6, STR)
    req_id = Field(7, BYTES)
    # Requesting worker's ident (hex): lets the raylet reclaim leases whose
    # holder died while caching them idle (see raylet._reclaim_holder_leases).
    holder = Field(8, STR)


class LeaseReplyMsg(Message):
    """RequestWorkerLeaseReply analog (node_manager.proto): grant, refusal,
    cancellation, or a spillback redirect to another raylet."""

    ok = Field(1, BOOL)
    error = Field(2, STR)
    canceled = Field(3, BOOL)
    spillback_host = Field(4, STR)
    spillback_port = Field(5, INT, default=-1)
    spillback_node = Field(6, BYTES)
    lease_id = Field(7, BYTES)
    worker_id = Field(8, BYTES)
    worker_host = Field(9, STR)
    worker_port = Field(10, INT, default=-1)
    node_id = Field(11, BYTES)
    # Batch extension: which request this reply resolves (echoes the
    # LeaseRequestMsg.req_id), and whether the entry is still queued at
    # the raylet — a pending entry's real resolution arrives later as a
    # `lease_grant` push on the same connection.
    req_id = Field(12, BYTES)
    pending = Field(13, BOOL)

    @classmethod
    def from_reply(cls, reply: dict) -> "LeaseReplyMsg":
        msg = cls(ok=bool(reply.get("ok")),
                  error=str(reply.get("error") or ""),
                  canceled=bool(reply.get("canceled")),
                  pending=bool(reply.get("pending")),
                  req_id=reply.get("req_id") or b"")
        sb = reply.get("spillback")
        if sb:
            msg.spillback_host, msg.spillback_port = str(sb[0]), int(sb[1])
            msg.spillback_node = reply.get("spillback_node") or b""
        if reply.get("ok") and reply.get("lease_id"):
            msg.lease_id = reply["lease_id"]
            msg.worker_id = reply.get("worker_id") or b""
            addr = reply.get("worker_address")
            if addr:
                msg.worker_host, msg.worker_port = str(addr[0]), int(addr[1])
            msg.node_id = reply.get("node_id") or b""
        return msg

    def to_reply(self) -> dict:
        reply: Dict[str, Any] = {"ok": self.ok}
        if self.canceled:
            reply["canceled"] = True
        if self.pending:
            reply["pending"] = True
        if self.req_id:
            reply["req_id"] = self.req_id
        if self.error:
            reply["error"] = self.error
        if self.spillback_port >= 0:
            reply["spillback"] = (self.spillback_host, self.spillback_port)
            if self.spillback_node:
                reply["spillback_node"] = self.spillback_node
        if self.ok and self.lease_id:
            reply["lease_id"] = self.lease_id
            reply["worker_id"] = self.worker_id
            if self.worker_port >= 0:
                reply["worker_address"] = (self.worker_host, self.worker_port)
            reply["node_id"] = self.node_id
        return reply


class TaskSpecMsg(Message):
    """TaskSpec envelope (core_worker.proto:441 PushTaskRequest analog).

    The ENVELOPE — ids, routing, options — is schema; everything that is
    genuinely code/opaque (args, kwarg names, scheduling strategy,
    runtime_env, pinned oids) travels as ONE `payload` ANY field — the
    audited pickle escape hatch, exactly the split the reference draws
    between TaskSpec protos and its pickled function/arg payloads. One
    combined field, not five: each ANY is a separate pickle.dumps, and
    per-call encode cost is the actor-call hot path (a 4->1 pickle
    consolidation measured ~25% higher async actor-call throughput)."""

    task_id = Field(1, BYTES)
    fn_id = Field(2, BYTES)
    name = Field(3, STR)
    # Field 4 is VALUE-versioned (same ANY wire type both versions): a
    # 5-tuple (args, kwarg_names, scheduling_strategy, runtime_env,
    # pinned_oids) from current writers; the bare args LIST from the
    # first-cut schema, whose remaining pieces arrived in the now
    # write-retired fields 5/12/15/16 below. TaskSpec.from_wire
    # disambiguates by shape, so a first-cut writer decodes losslessly.
    payload = Field(4, ANY)
    kwarg_names_v1 = Field(5, ANY)           # decode-only (retired writer)
    num_returns = Field(6, INT, default=1)
    resources = Field(7, MAP(FLOAT))
    max_retries = Field(8, INT, default=3)
    actor_id = Field(9, BYTES)
    method_name = Field(10, STR)
    seq_no = Field(11, INT)
    scheduling_strategy_v1 = Field(12, ANY)  # decode-only (retired writer)
    placement_group_id = Field(13, BYTES)
    placement_group_bundle_index = Field(14, INT, default=-1)
    runtime_env_v1 = Field(15, ANY)          # decode-only (retired writer)
    pinned_oids_v1 = Field(16, LIST(BYTES))  # decode-only (retired writer)
    # Distributed-trace propagation (tracing_helper.py _inject_tracing
    # analog): the caller's trace id + submit-span id travel as typed
    # envelope fields so the executing worker stitches its execute span
    # under the driver's, across processes. Empty = caller not tracing.
    trace_id = Field(17, BYTES)
    parent_span_id = Field(18, BYTES)


class SliceLostMsg(Message):
    """Slice failure-domain event (no reference proto: the reference has no
    slice concept — see ROADMAP "TPU chips/ICI slices"). Published by the
    GCS on the `slice_lost` channel and pushed to sibling raylets when any
    host of a multi-host TPU slice dies: the slice is ONE failure domain,
    so siblings fate-share in the same health tick."""

    slice_name = Field(1, STR)
    nodes = Field(2, LIST(BYTES))      # every node id of the lost slice
    origin_node = Field(3, BYTES)      # the host whose death triggered it
    reason = Field(4, STR)


class TaskReplyMsg(Message):
    """PushTaskReply analog: status + returns; errors are exceptions
    (ANY), return payloads are serialized values (ANY)."""

    status = Field(1, STR)
    returns = Field(2, ANY)
    error = Field(3, ANY)
    node_id = Field(4, BYTES)
    streamed = Field(5, INT, default=-1)

    @classmethod
    def from_reply(cls, reply: dict) -> "TaskReplyMsg":
        msg = cls(status=reply.get("status") or "")
        if "returns" in reply:
            msg.returns = reply["returns"]
        if "error" in reply:
            msg.error = reply["error"]
        if reply.get("node_id"):
            msg.node_id = reply["node_id"]
        if "streamed" in reply:
            msg.streamed = int(reply["streamed"])
        return msg

    def to_reply(self) -> dict:
        reply: Dict[str, Any] = {"status": self.status}
        if self.returns is not None:
            reply["returns"] = self.returns
        if self.error is not None:
            reply["error"] = self.error
        if self.node_id:
            reply["node_id"] = self.node_id
        if self.streamed >= 0:
            reply["streamed"] = self.streamed
        return reply


# ------------------------------------------------- control-plane batching
#
# One framed message per tick/pump instead of N per-item RPCs. These ride
# the same TLV rules as everything above: unknown fields skip, absent
# fields default, numbers are forever.

class LeaseBatchRequestMsg(Message):
    """A pump's worth of lease requests, granted in ONE scheduling pass.

    The raylet enqueues every entry, runs a single `_dispatch_pending()`,
    and replies immediately: entries resolved by that pass (grant, error,
    spillback) come back in `entries`; everything still queued is listed
    in `pending` and resolves later via a `lease_grant` push carrying a
    LeaseReplyMsg with the matching req_id. Waiting for all entries in
    the reply would deadlock — a speculative lease behind a running task
    only grants after that task finishes, which needs the reply."""

    entries = Field(1, LIST(MSG(LeaseRequestMsg)))


class LeaseBatchReplyMsg(Message):
    entries = Field(1, LIST(MSG(LeaseReplyMsg)))  # resolved now (req_id set)
    pending = Field(2, LIST(BYTES))               # req_ids still queued
    error = Field(3, STR)


class TaskEventMsg(Message):
    """One task state transition (gcs.proto TaskEvents analog)."""

    task_id = Field(1, STR)     # hex
    name = Field(2, STR)
    state = Field(3, STR)
    actor_id = Field(4, STR)    # hex, "" = not an actor task
    worker = Field(5, STR)
    time = Field(6, FLOAT)
    error = Field(7, STR)

    @classmethod
    def from_event(cls, ev: dict) -> "TaskEventMsg":
        return cls(task_id=ev.get("task_id") or "",
                   name=ev.get("name") or "",
                   state=ev.get("state") or "",
                   actor_id=ev.get("actor_id") or "",
                   worker=ev.get("worker") or "",
                   time=float(ev.get("time") or 0.0),
                   error=str(ev.get("error") or ""))

    def to_event(self) -> dict:
        return {"task_id": self.task_id, "name": self.name,
                "state": self.state,
                "actor_id": self.actor_id or None,
                "worker": self.worker, "time": self.time,
                "error": self.error or None}


class TaskEventBatchMsg(Message):
    """One flusher tick: every buffered event + the wait-edge snapshot +
    the drop count in a single typed frame (replaces N dict-pickles)."""

    events = Field(1, LIST(MSG(TaskEventMsg)))
    reporter = Field(2, STR)
    node_id = Field(3, BYTES)
    # wait_edges semantics match the pickled handler: has_wait_edges=False
    # means "no update", True with an empty list means "clear".
    has_wait_edges = Field(4, BOOL)
    wait_edges = Field(5, ANY)
    dropped = Field(6, INT)     # events trimmed from the buffer since last tick


class MetricsReportMsg(Message):
    """One metrics flush tick: the node/pid-scoped snapshot as one typed
    frame (same JSON payload the kv_put path shipped, minus the pickle)."""

    node = Field(1, STR)
    pid = Field(2, INT)
    payload = Field(3, BYTES)   # JSON snapshot_all() bytes


# --------------------------------------------------- zero-pickle transfer
#
# Object pull/push headers for the raw-frame RPC fast path: the chunk
# bytes ride OUT-OF-BAND as the frame payload (never pickled, received
# straight off the socket), only this small header is schema-encoded.

class ObjChunkRequestMsg(Message):
    oid = Field(1, BYTES)
    offset = Field(2, INT)
    length = Field(3, INT)


class ObjChunkReplyMsg(Message):
    found = Field(1, BOOL)
    total = Field(2, INT)
    metadata = Field(3, BYTES)
    error = Field(4, STR)


class ObjPutMsg(Message):
    oid = Field(1, BYTES)
    offset = Field(2, INT)
    total = Field(3, INT)
    metadata = Field(4, BYTES)
    seal = Field(5, BOOL)


class AckMsg(Message):
    ok = Field(1, BOOL)
    error = Field(2, STR)
    existed = Field(3, BOOL)


# ------------------------------------------------ cluster prefix store
#
# GCS prefix-table RPCs (llm/prefix_store.py <-> gcs/server.py). Headers
# only — the spilled KV pages ride OUT-OF-BAND as the raw-frame payload,
# exactly like the object pull/push path above. `token_ids` is the full
# root-anchored token prefix the entry covers: adopters verify it
# byte-for-byte against their own prompt before scattering pages (the
# cluster chain uses a FIXED salt so digests compare across processes;
# token verification is what makes a forged digest useless).

class PrefixEntryMsg(Message):
    digest = Field(1, BYTES)           # cluster_chain(token_ids)[-1]
    lora_id = Field(2, STR)            # "" = base model
    weights_version = Field(3, INT)    # adopt only on exact match
    block_size = Field(4, INT)
    n_tokens = Field(5, INT)
    token_ids = Field(6, LIST(INT))
    nbytes = Field(7, INT)             # encoded payload size
    owner_replica = Field(8, STR)      # live-holder hint (router fallback)
    node_id = Field(9, BYTES)          # publisher's node (death pruning)
    deployment = Field(10, STR)


class PrefixLookupMsg(Message):
    # Digest chain from the first block the caller is missing, upward:
    # the GCS answers with the contiguous run it holds from digests[0].
    digests = Field(1, LIST(BYTES))
    lora_id = Field(2, STR)
    weights_version = Field(3, INT)
    block_size = Field(4, INT)
    want_payload = Field(5, BOOL)      # False = owner-hint probe only
    replica = Field(6, STR)            # adopter tag -> new live-owner hint


class PrefixLookupReplyMsg(Message):
    found = Field(1, BOOL)
    entries = Field(2, LIST(MSG(PrefixEntryMsg)))
    error = Field(3, STR)


class PrefixPurgeMsg(Message):
    owner_replica = Field(1, STR)
    node_id = Field(2, BYTES)
    deployment = Field(3, STR)
    digests = Field(4, LIST(BYTES))
    below_weights_version = Field(5, INT)
    # True: blank live-owner hints only (replica eject/death — the pages,
    # homed in the GCS byte plane, stay adoptable). False: drop rows.
    clear_owner_only = Field(6, BOOL)


class PrefixPurgeReplyMsg(Message):
    ok = Field(1, BOOL)
    purged = Field(2, INT)
    owners_cleared = Field(3, INT)


# ------------------------------------------------ LLM KV handoff header
#
# Typed head frame of the disaggregated prefill->decode / live-migration
# KV stream (llm/disagg.py). The portable request state stays JSON bytes
# (it is heterogeneous, small, and already pickle-free); the trace fields
# carry the per-request trace context across the handoff so the decode
# replica's adopt span parent-links to the sender's handoff span — the
# serving-plane analog of TaskSpecMsg fields 17/18.

class KVHandoffMsg(Message):
    state_json = Field(1, BYTES)     # json.dumps(portable request state)
    kv_dtype = Field(2, STR)
    kv_shape = Field(3, LIST(INT))
    migrated = Field(4, BOOL)        # live session migration vs prefill handoff
    trace_id = Field(5, BYTES)       # 16-byte stitched-request trace id
    parent_span_id = Field(6, BYTES)  # sender's handoff span (8 bytes)
