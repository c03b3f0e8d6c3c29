"""Binary IDs for tasks/objects/actors/nodes/workers.

Reference analog: src/ray/common/id.h (TaskID/ObjectID/ActorID/NodeID...).
All IDs are fixed-size random byte strings; ObjectIDs for task returns are
derived deterministically from the task id + return index so any process can
compute them.
"""

from __future__ import annotations

import hashlib
import os

ID_SIZE = 20


class BaseID:
    __slots__ = ("_bytes",)
    _prefix = "id"

    def __init__(self, id_bytes: bytes):
        assert len(id_bytes) == ID_SIZE, f"bad id length {len(id_bytes)}"
        self._bytes = bytes(id_bytes)

    @classmethod
    def generate(cls):
        return cls(os.urandom(ID_SIZE))

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other):
        return isinstance(other, BaseID) and other._bytes == self._bytes

    def __hash__(self):
        return hash(self._bytes)

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:12]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    @classmethod
    def for_task_return(cls, task_id: "TaskID", index: int) -> "ObjectID":
        h = hashlib.sha1(task_id.binary() + index.to_bytes(4, "little")).digest()
        return cls(h[:ID_SIZE])


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass
