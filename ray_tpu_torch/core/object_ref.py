"""ObjectRef: a future-like handle to a task result or put object.

Reference analog: python/ray/_raylet.pyx ObjectRef + the distributed
reference counting in src/ray/core_worker/reference_count.h. Each live
ObjectRef pyobject counts toward its process's local reference count for the
underlying object id; when a ref crosses a process boundary (any pickling
path — task args by value, nested containers, actor state), unpickling
registers the receiving process as a BORROWER with the object's owner
(reference_count.h:558-615 borrower protocol). The owner frees the object
everywhere once local refs, borrowers, pins, and containing objects all
drop (delete-on-zero).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

# Thread-local collector: ray_tpu_torch.core.serialization activates this while
# pickling a value so the owner learns which refs the serialized bytes
# CONTAIN (nested-ref pinning: a stored object keeps its inner refs alive).
_collect = threading.local()


def start_ref_collection():
    _collect.refs = []


def finish_ref_collection():
    refs = getattr(_collect, "refs", [])
    _collect.refs = None
    return refs


def _deserialize_ref(object_id: bytes, owner: Optional[bytes],
                     owner_addr: Optional[Tuple[str, int]]) -> "ObjectRef":
    """Unpickling entry point: every ref that arrives from another process
    registers with the local worker (borrow bookkeeping)."""
    ref = ObjectRef(object_id, owner=owner, owner_addr=owner_addr)
    try:
        from ray_tpu_torch.core import worker as worker_mod

        if worker_mod.is_initialized():
            worker_mod.global_worker().register_ref(ref, arrived=True)
    except Exception:
        pass
    return ref


class ObjectRef:
    __slots__ = ("_id", "_owner", "_owner_addr", "_registered", "__weakref__")

    def __init__(self, object_id: bytes, owner: Optional[bytes] = None,
                 owner_addr: Optional[Tuple[str, int]] = None):
        self._id = object_id
        self._owner = owner
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._registered = False

    def binary(self) -> bytes:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    @property
    def owner(self) -> Optional[bytes]:
        return self._owner

    @property
    def owner_addr(self) -> Optional[Tuple[str, int]]:
        return self._owner_addr

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self):
        return hash(self._id)

    def __repr__(self):
        return f"ObjectRef({self._id.hex()[:16]})"

    def __reduce__(self):
        refs = getattr(_collect, "refs", None)
        if refs is not None:
            refs.append(self)
        return (_deserialize_ref, (self._id, self._owner, self._owner_addr))

    def __del__(self):
        if not self._registered:
            return
        try:
            from ray_tpu_torch.core import worker as worker_mod

            w = worker_mod._global_worker
            if w is not None:
                w.ref_dropped(self._id)
        except Exception:
            pass

    # Allow `await ref` inside async actors / drivers.
    def __await__(self):
        from ray_tpu_torch.core.worker import global_worker
        worker = global_worker()

        async def _get():
            import asyncio
            loop = asyncio.get_event_loop()
            return await loop.run_in_executor(None, worker.get_one, self, None)

        return _get().__await__()
