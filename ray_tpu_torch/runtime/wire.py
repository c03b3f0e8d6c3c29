"""Typed wire schema: the tag/length codec and the KV handoff head frame.

The port's copy of ray_tpu/runtime/wire.py, cut down to the field types
`KVHandoffMsg` uses (BYTES, STR, BOOL, and LIST of INT). A message is the
concatenation of its fields, in any order, each

    [u32 field_no << 3 | wire_type][u32 length][payload]

Decoding keeps protobuf's evolution rules, as the JAX decoder does:
unknown field numbers are skipped, a field whose wire type or payload
does not parse keeps its default, and absent fields decode to their
defaults. The bytes equal the JAX package's for the same message.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

# wire types (3 bits); only these two occur in the port's messages.
_WT_VARBYTES = 0   # length-delimited scalar payload (int/str/bytes/bool)
_WT_LIST = 2       # repeated inner type

_TAG = struct.Struct("<I")
_LEN = struct.Struct("<I")


class FieldType:
    """Scalar/list field type descriptors."""

    def __init__(self, kind: str, inner: Any = None):
        self.kind = kind
        self.inner = inner

    def __repr__(self):
        return f"FieldType({self.kind})"


INT = FieldType("int")
BOOL = FieldType("bool")
STR = FieldType("str")
BYTES = FieldType("bytes")


def LIST(inner) -> FieldType:  # noqa: N802 (schema DSL)
    return FieldType("list", inner)


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
    return {"int": 0, "bool": False, "str": "", "bytes": b"",
            "list": None}[f.type.kind]


def _wire_type(ftype: FieldType) -> int:
    return _WT_LIST if ftype.kind == "list" else _WT_VARBYTES


def _payload_encoder(ftype: FieldType):
    """Closure encoding one field's payload (kind resolved once)."""
    k = ftype.kind
    if k == "int":
        return struct.Struct("<q").pack
    if k == "bool":
        return lambda v: b"\x01" if v else b"\x00"
    if k == "str":
        return str.encode
    if k == "bytes":
        return bytes
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
    raise TypeError(f"unknown field kind {k!r}")


def _payload_decoder(ftype: FieldType):
    """Closure decoding one field's payload (see _payload_encoder)."""
    k = ftype.kind
    if k == "int":
        unpack = struct.Struct("<q").unpack
        return lambda p: unpack(p)[0]
    if k == "bool":
        return lambda p: bytes(p) != b"\x00"
    if k == "str":
        return lambda p: str(p, "utf-8")
    if k == "bytes":
        return bytes
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
        cls._encoders = tuple(
            (n, _TAG.pack((f.number << 3) | _wire_type(f.type)),
             _payload_encoder(f.type))
            for n, f in fields.items())
        cls._decoders = {
            f.number: (n, _wire_type(f.type), _payload_decoder(f.type))
            for n, f in fields.items()}
        cls._scalar_defaults = {
            n: _default_for(f) for n, f in fields.items()
            if f.type.kind != "list" or f.default is not None}
        cls._container_defaults = tuple(
            n for n, f in fields.items()
            if f.type.kind == "list" and f.default is None)
        return cls


class Message(metaclass=MessageMeta):
    """Base class: subclass with `Field` class attributes."""

    _fields: Dict[str, Field] = {}

    def __init__(self, **kwargs):
        d = self.__dict__
        d.update(self._scalar_defaults)
        for name in self._container_defaults:
            d[name] = []   # a fresh list per instance
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
                # Malformed payload across versions: keep the default.
                continue
        return msg


# Typed head frame of the disaggregated prefill->decode / live-migration
# KV stream (llm/disagg.py): the portable request state as JSON bytes,
# the pages' dtype and shape, and the request's trace context. Field
# numbers are the JAX package's.

class KVHandoffMsg(Message):
    state_json = Field(1, BYTES)     # json.dumps(portable request state)
    kv_dtype = Field(2, STR)
    kv_shape = Field(3, LIST(INT))
    migrated = Field(4, BOOL)        # live session migration vs prefill handoff
    trace_id = Field(5, BYTES)       # 16-byte stitched-request trace id
    parent_span_id = Field(6, BYTES)  # sender's handoff span (8 bytes)

