"""Spill/restore: move cold objects from the shm store to disk files.

Reference analog: src/ray/raylet/local_object_manager.{h,cc}
(local_object_manager.h:41, min_spilling_size batching) +
python/ray/_private/external_storage.py:72 (filesystem backend,
spill_objects:211); the port's copy of ray_tpu/runtime/object_store/
spill.py, without its metrics. The store spills in-process at the point of
allocation failure instead of via dedicated I/O workers: every worker shares
the node's store and spill directory, so whichever process hits the full
store spills LRU candidates to disk before retrying. File presence is the
spill record (no extra directory service); cross-process races are settled
by atomic rename.

File layout: <session>/spill/<oid.hex>  =  [u64 meta_len][metadata][data]
"""

from __future__ import annotations

import os
import struct
from typing import Optional

from ray_tpu_torch.runtime.object_store.store import (
    ObjectStore,
    StoreFullError,
)

_HDR = struct.Struct("<Q")


class SpillManager:
    """Per-process handle on a node's shared spill directory."""

    def __init__(self, store: ObjectStore, spill_dir: str):
        self.store = store
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)

    # -- spill -------------------------------------------------------------
    def _path(self, oid: bytes) -> str:
        return os.path.join(self.spill_dir, oid.hex())

    def contains(self, oid: bytes) -> bool:
        return os.path.exists(self._path(oid))

    def spilled_bytes(self) -> int:
        """Bytes currently resident in the node's spill directory (shared
        by every process on the node; feeds the per-node spill gauge and
        `node_stats`). Concurrently-deleted files are skipped."""
        total = 0
        try:
            with os.scandir(self.spill_dir) as it:
                for entry in it:
                    try:
                        total += entry.stat().st_size
                    except OSError:
                        pass
        except OSError:
            pass
        return total

    def spill_object(self, oid: bytes) -> bool:
        """Copy one sealed object out to disk, then drop it from the store."""
        try:
            buf = self.store.get(oid, timeout=0)
        except Exception:
            return False
        try:
            path = self._path(oid)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(_HDR.pack(len(buf.metadata)))
                f.write(buf.metadata)
                f.write(buf.data)
            os.replace(tmp, path)
        finally:
            buf.release()
        self.store.delete(oid)
        return True

    def spill_until(self, need_bytes: int, exclude: Optional[set] = None) -> int:
        """Spill LRU candidates until ~need_bytes have been freed (or no
        candidates remain). Returns bytes freed."""
        freed = 0
        exclude = exclude or set()
        while freed < need_bytes:
            progress = False
            for oid in self.store.lru_candidates(max_objects=16):
                if oid in exclude:
                    continue
                try:
                    size = len(self.store.get(oid, timeout=0))
                except Exception:
                    continue
                if self.spill_object(oid):
                    freed += size
                    progress = True
                    if freed >= need_bytes:
                        break
            if not progress:
                break
        return freed

    # -- restore -----------------------------------------------------------
    def read_spilled(self, oid: bytes) -> Optional[tuple]:
        """Read a spilled object's (metadata, data) without restoring it."""
        path = self._path(oid)
        try:
            with open(path, "rb") as f:
                (meta_len,) = _HDR.unpack(f.read(_HDR.size))
                metadata = f.read(meta_len)
                data = f.read()
            return metadata, data
        except FileNotFoundError:
            return None

    def read_chunk(self, oid: bytes, offset: int, length: int
                   ) -> Optional[tuple]:
        """Read (total_data_size, metadata, chunk) from a spill file without
        restoring it — the raylet pull handler's cold path."""
        path = self._path(oid)
        try:
            with open(path, "rb") as f:
                (meta_len,) = _HDR.unpack(f.read(_HDR.size))
                metadata = f.read(meta_len)
                f.seek(0, os.SEEK_END)
                total = f.tell() - _HDR.size - meta_len
                f.seek(_HDR.size + meta_len + offset)
                chunk = f.read(length)
            return total, metadata, chunk
        except FileNotFoundError:
            return None

    def restore(self, oid: bytes) -> bool:
        """Restore a spilled object into the shm store (spilling others to
        make room if needed). Keeps the spill file as a cold copy until the
        object is deleted. Returns False if not spilled here."""
        if self.store.contains(oid):
            return True
        rec = self.read_spilled(oid)
        if rec is None:
            return False
        metadata, data = rec
        try:
            self.create_with_spill(oid, len(data), metadata)[:] = data
            self.store.seal(oid)
        except ValueError:
            # Another process is restoring concurrently: wait for its seal.
            try:
                self.store.get(oid, timeout=10).release()
            except Exception:
                return False
        return True

    def create_with_spill(self, oid: bytes, data_size: int,
                          metadata: bytes = b"") -> memoryview:
        """store.create with spill-before-evict: on a full store, spill LRU
        objects to disk and retry, falling back to evicting restored-cold
        copies (which still live on disk) only as a last resort."""
        try:
            return self.store.create(oid, data_size, metadata,
                                     allow_evict=False)
        except ValueError:
            raise
        except StoreFullError:
            pass
        self.spill_until(data_size + len(metadata) + (1 << 20), exclude={oid})
        # Final attempt may evict: anything spillable has been spilled, so
        # eviction can only drop objects that already have a disk copy.
        return self.store.create(oid, data_size, metadata, allow_evict=True)

    def delete(self, oid: bytes):
        try:
            os.unlink(self._path(oid))
        except FileNotFoundError:
            pass
