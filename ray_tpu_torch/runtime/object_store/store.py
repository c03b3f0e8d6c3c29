"""Python client for the native shared-memory object store.

Plasma-equivalent client API (reference: src/ray/object_manager/plasma/client.h)
over the serverless C++ store in store.cpp. Every process (driver, workers,
raylet) opens the same shared-memory file; `get` returns zero-copy memoryviews
over the mapping, so numpy host arrays deserialize without copies. The
port's copy of ray_tpu/runtime/object_store/store.py.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
import time
from typing import Optional

from ray_tpu_torch.runtime.object_store.build import ensure_built

ID_SIZE = 20


class StoreFullError(Exception):
    pass


class ObjectNotFoundError(Exception):
    pass


class _Lib:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            so = ensure_built()
            lib = ctypes.CDLL(so)
            lib.store_open.restype = ctypes.c_void_p
            lib.store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int]
            lib.store_close.argtypes = [ctypes.c_void_p]
            lib.store_base.restype = ctypes.c_void_p
            lib.store_base.argtypes = [ctypes.c_void_p]
            for name in ("store_capacity", "store_used", "store_num_objects", "store_seal_count"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_uint64
                fn.argtypes = [ctypes.c_void_p]
            lib.store_create_object.restype = ctypes.c_int
            lib.store_create_object.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
            lib.store_lru_candidates.restype = ctypes.c_uint64
            lib.store_lru_candidates.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            for name in ("store_seal", "store_release", "store_delete", "store_contains",
                         "store_abort"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.store_get.restype = ctypes.c_int
            lib.store_get.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.store_list.restype = ctypes.c_uint64
            lib.store_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.store_event_gen.restype = ctypes.c_uint32
            lib.store_event_gen.argtypes = [ctypes.c_void_p]
            lib.store_wait_event.restype = ctypes.c_int
            lib.store_wait_event.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]
            inst = object.__new__(cls)
            inst.lib = lib
            cls._instance = inst
        return cls._instance


class StoreBuffer:
    """A zero-copy view of a sealed object.

    Holds a read reference in the store for its lifetime: the object cannot be
    evicted while any StoreBuffer on any process is alive.
    """

    __slots__ = ("store", "object_id", "data", "metadata", "_released")

    def __init__(self, store: "ObjectStore", object_id: bytes, data: memoryview, metadata: bytes):
        self.store = store
        self.object_id = object_id
        self.data = data
        self.metadata = metadata
        self._released = False

    def release(self):
        if self._released:
            return
        try:
            self.data.release()
        except BufferError:
            # Exported views (e.g. numpy arrays) are still alive. Keep the
            # store refcount held: dropping it would let eviction reuse the
            # bytes under those views. The ref is retried at GC; if views
            # outlive us we deliberately leak the ref (pin > corruption).
            return
        self._released = True
        self.store._release(self.object_id)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass

    def __len__(self):
        return len(self.data)


class ObjectStore:
    """One per process; maps the node's shared-memory arena."""

    def __init__(self, path: str, capacity: int = 0, create: bool = False,
                 table_size: int = 0):
        self._lib = _Lib().lib
        self.path = path
        self.handle = self._lib.store_open(
            path.encode(), ctypes.c_uint64(capacity), ctypes.c_uint64(table_size),
            1 if create else 0)
        if not self.handle:
            raise RuntimeError(f"failed to open object store at {path} (create={create})")
        # Separate Python-level mapping of the same file for buffer views.
        self._fd = os.open(path, os.O_RDWR)
        size = os.fstat(self._fd).st_size
        self._mm = mmap.mmap(self._fd, size)
        self._view = memoryview(self._mm)
        self._size = size
        self._closed = False
        # Per-create POPULATE_WRITE (see create()): cheap to retry forever
        # on kernels that support it, disabled after the first EINVAL.
        self._populate_ok = True
        # Set by the prefault walk when this process's PTEs cover the
        # whole arena (per-create populate becomes redundant).
        self._warm = False
        self._prefault_started = False
        self._walk_inflight = False
        self._prefault_lock = threading.Lock()
        if create:
            # The creator walks at boot: one process's walk allocates the
            # tmpfs blocks arena-wide, so every other process's faults and
            # per-range populates skip block allocation. Non-creators walk
            # lazily (ensure_prefault) on their first large create —
            # workers that never touch big objects never pay the walk.
            self._start_prefault(create)

    def _start_prefault(self, create: bool):
        """Warm the arena from a background thread (creator at boot;
        other openers lazily via ensure_prefault on first large create).

        Two distinct costs otherwise land on the cold put path (together
        the r3 microbench's 86x put/get asymmetry):
          * page ALLOCATION — tmpfs blocks for the whole file. The
            creator's MADV_POPULATE_WRITE walk (posix_fallocate where
            unsupported) allocates + zeroes them without racing live
            allocator data.
          * per-process PTE population — PTEs are per process, so every
            opener (driver, each worker) takes ~256 minor faults per MiB
            the first time it writes a region (~2 GiB/s copies vs ~9 once
            PTEs are hot, measured on the dev box). The same
            POPULATE_WRITE walk in each opener installs writable PTEs in
            bulk; shmem pages never migrate, so they stay valid for the
            mapping's lifetime. Until the walk finishes, create()
            populates just the range it hands out (_populate_range);
            after it, that becomes a skip.

        RAY_TPU_TORCH_STORE_PREFAULT=0 disables the walk (the per-create
        populate still applies); "full" is accepted as a legacy alias of
        the default.
        """
        self._prefault_started = True
        mode = os.environ.get("RAY_TPU_TORCH_STORE_PREFAULT", "1")
        if mode == "0":
            return

        # The thread gets its OWN dup'd fd: close() recycling the main fd
        # number mid-walk must never let fallocate hit an unrelated file.
        fd = os.dup(self._fd)
        mm, size = self._mm, self._size

        # MADV_POPULATE_WRITE (Linux 5.14+): one syscall allocates tmpfs
        # blocks AND populates writable PTEs — the whole first-touch cost
        # moves off the put path in-kernel.
        MADV_POPULATE_WRITE = self._MADV_POPULATE_WRITE

        def warm():
            walked = True
            madvise_ok = True  # one failure: stop retrying madvise this walk
            # (_warm stays False then, so per-create populate — which has
            # its own errno-specific latch — keeps covering puts)
            try:
                chunk = 128 << 20
                for start in range(0, size, chunk):
                    if self._closed:
                        return
                    end = min(start + chunk, size)
                    if madvise_ok:
                        try:
                            mm.madvise(MADV_POPULATE_WRITE, start,
                                       end - start)
                            continue
                        except (OSError, ValueError):
                            madvise_ok = False
                            walked = False
                    if create:
                        os.posix_fallocate(fd, start, end - start)
                    if mode == "full":
                        # Pre-5.14 fallback: one read per page still
                        # installs (read) PTEs for this process.
                        mm[start:end:4096]
            except (OSError, ValueError, SystemError):
                walked = False  # best-effort (e.g. store closed mid-walk)
            finally:
                if walked and not self._closed:
                    self._warm = True
                self._walk_inflight = False
                try:
                    os.close(fd)
                except OSError:
                    pass

        self._walk_inflight = True
        threading.Thread(target=warm, name="store_prefault",
                         daemon=True).start()

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._view.release()
        except BufferError:
            pass
        try:
            self._mm.close()
        except BufferError:
            pass
        os.close(self._fd)
        self._lib.store_close(self.handle)

    # -- stats -------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._lib.store_capacity(self.handle)

    @property
    def used(self) -> int:
        return self._lib.store_used(self.handle)

    @property
    def num_objects(self) -> int:
        return self._lib.store_num_objects(self.handle)

    # -- object ops --------------------------------------------------------
    def create(self, object_id: bytes, data_size: int, metadata: bytes = b"",
               allow_evict: bool = True) -> memoryview:
        """Allocate an unsealed object; returns writable view of its data area.

        allow_evict=False fails with StoreFullError instead of dropping LRU
        objects, letting the caller spill them to disk first (the
        local_object_manager spill-before-evict path)."""
        assert len(object_id) == ID_SIZE
        off = ctypes.c_uint64()
        rc = self._lib.store_create_object(
            self.handle, object_id, ctypes.c_uint64(data_size),
            ctypes.c_uint64(len(metadata)), ctypes.byref(off),
            ctypes.c_int(1 if allow_evict else 0))
        if rc == -1:
            raise ValueError(f"object {object_id.hex()} already exists")
        if rc == -2:
            raise StoreFullError(
                f"object store full: need {data_size}, capacity {self.capacity}, used {self.used}")
        if rc == -3:
            raise StoreFullError("object table full")
        o = off.value
        self._populate_range(o, data_size + len(metadata))
        if metadata:
            self._view[o + data_size:o + data_size + len(metadata)] = metadata
        return self._view[o:o + data_size]

    # MADV_POPULATE_WRITE (Linux 5.14+). The creator's arena walk
    # (_start_prefault) allocates tmpfs blocks, but PTEs are per PROCESS:
    # every other opener still takes ~256 minor faults per MiB the first
    # time it writes a region, capping a cold 1 MiB put at ~2 GiB/s on the
    # dev box vs ~9 GiB/s once PTEs are hot. One batched populate syscall
    # over exactly the range create() handed out installs writable PTEs
    # ~2.3x faster than faulting them one by one (measured 4.9 GiB/s cold,
    # and it is a no-op walk when the PTEs are already present).
    _MADV_POPULATE_WRITE = 23
    _POPULATE_MIN = 256 << 10  # below this, fault cost < syscall cost

    def _populate_range(self, off: int, length: int) -> None:
        if self._warm or not self._populate_ok or length < self._POPULATE_MIN:
            return
        self.ensure_prefault()
        page = mmap.PAGESIZE
        start = off & ~(page - 1)
        end = min((off + length + page - 1) & ~(page - 1), self._size)
        try:
            self._mm.madvise(self._MADV_POPULATE_WRITE, start, end - start)
        except ValueError:
            self._populate_ok = False
        except OSError as e:
            # Latch off only for "kernel lacks it" errnos; a transient
            # ENOMEM/EINTR must not disable the fast path for the
            # process lifetime (the copy just faults normally this once).
            import errno

            if e.errno in (errno.EINVAL, errno.ENOSYS):
                self._populate_ok = False

    def ensure_prefault(self) -> None:
        """Start this process's background arena walk if it hasn't run yet
        (idempotent). Called automatically on the first large create; until
        the walk finishes, per-range populate keeps each individual put at
        batch-fault speed.

        Deliberate tradeoff: on a host with many big-object writers the
        concurrent walks do compete for CPU (the reason the old design made
        per-process population opt-in), but laziness bounds that to
        processes that actually create >=256 KiB objects, where the walk
        pays for itself within a few dozen puts (~2-4x per cold put)."""
        if self._prefault_started:
            return
        with self._prefault_lock:
            if not self._prefault_started:
                self._start_prefault(False)

    def seal(self, object_id: bytes):
        rc = self._lib.store_seal(self.handle, object_id)
        if rc == -1:
            raise ValueError(f"seal: object {object_id.hex()} not found")
        if rc == -2:
            raise ValueError(
                f"seal: object {object_id.hex()} not in created state (double seal?)")

    def abort(self, object_id: bytes):
        """Abort an in-progress create (frees the unsealed buffer)."""
        self._lib.store_abort(self.handle, object_id)

    def put(self, object_id: bytes, data, metadata: bytes = b"") -> None:
        buf = self.create(object_id, len(data), metadata)
        try:
            buf[:] = data
        except BaseException:
            buf.release()
            self.abort(object_id)
            raise
        buf.release()
        self.seal(object_id)

    def get(self, object_id: bytes, timeout: Optional[float] = 0) -> StoreBuffer:
        """Get a sealed object; blocks up to `timeout` seconds for it to appear.

        Blocking rides the store's seal futex (plasma notification-socket
        analog, reference src/ray/object_manager/plasma/store.h:55): the
        event generation is sampled BEFORE the lookup, so a seal landing
        between lookup and wait wakes us immediately — no spin-poll. The
        wait is capped at 100 ms per lap purely as a liveness backstop."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            gen = self._lib.store_event_gen(self.handle)
            off = ctypes.c_uint64()
            dsz = ctypes.c_uint64()
            msz = ctypes.c_uint64()
            rc = self._lib.store_get(self.handle, object_id, ctypes.byref(off),
                                     ctypes.byref(dsz), ctypes.byref(msz))
            if rc == 0:
                o, d, m = off.value, dsz.value, msz.value
                data = self._view[o:o + d]
                metadata = bytes(self._view[o + d:o + d + m]) if m else b""
                return StoreBuffer(self, object_id, data, metadata)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ObjectNotFoundError(object_id.hex())
                wait_ms = min(int(remaining * 1000) + 1, 100)
            else:
                wait_ms = 100
            self._lib.store_wait_event(self.handle, gen, wait_ms)

    def contains(self, object_id: bytes) -> bool:
        return bool(self._lib.store_contains(self.handle, object_id))

    @property
    def prefaulted(self) -> bool:
        """True once this process's background arena walk has installed
        writable PTEs for the whole mapping (puts run at memcpy speed)."""
        return self._warm

    @property
    def prefault_inflight(self) -> bool:
        """True while a background arena walk is running in this process.
        Distinguishes 'not warm yet, worth waiting' from 'will never be
        warm' (prefault disabled, or kernel without MADV_POPULATE_WRITE)."""
        return self._walk_inflight

    @property
    def event_gen(self) -> int:
        """Store-wide event generation (bumped on seal/delete/abort/evict)."""
        return self._lib.store_event_gen(self.handle)

    def wait_event(self, seen_gen: int, timeout_ms: int) -> bool:
        """Block until the generation moves past `seen_gen` (sampled before
        the caller's state check) or timeout. True if an event arrived."""
        return self._lib.store_wait_event(
            self.handle, ctypes.c_uint32(seen_gen), int(timeout_ms)) == 0

    def delete(self, object_id: bytes) -> bool:
        return self._lib.store_delete(self.handle, object_id) == 0

    def list_objects(self, max_objects: int = 1 << 16) -> list[bytes]:
        buf = ctypes.create_string_buffer(max_objects * ID_SIZE)
        n = self._lib.store_list(self.handle, buf, ctypes.c_uint64(max_objects))
        raw = buf.raw
        return [raw[i * ID_SIZE:(i + 1) * ID_SIZE] for i in range(n)]

    def lru_candidates(self, max_objects: int = 64) -> list[bytes]:
        """Sealed, unreferenced object ids in LRU order: spill candidates."""
        buf = ctypes.create_string_buffer(max_objects * ID_SIZE)
        n = self._lib.store_lru_candidates(
            self.handle, buf, ctypes.c_uint64(max_objects))
        raw = buf.raw
        return [raw[i * ID_SIZE:(i + 1) * ID_SIZE] for i in range(n)]

    def _release(self, object_id: bytes):
        if not self._closed:
            self._lib.store_release(self.handle, object_id)
