"""GCS persistence: the StoreClient seam.

Reference analog: src/ray/gcs/store_client/ — InMemoryStoreClient (default)
and RedisStoreClient (fault-tolerant mode; gcs restarts and reloads its
tables, clients resubscribe — redis_store_client.h). The TPU build's durable
backend is sqlite (WAL mode): one file next to the session, no external
service, safe across GCS process crashes.

Tables are generic (table, key) -> value-bytes maps; the GcsServer decides
what goes in them (kv, nodes, actors, named_actors, jobs, placement_groups).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, Iterable, List, Optional, Tuple


class InMemoryStoreClient:
    """Default: no durability (in_memory_store_client.h analog)."""

    def __init__(self):
        self._tables: Dict[str, Dict[bytes, bytes]] = {}

    def put(self, table: str, key: bytes, value: bytes):
        self._tables.setdefault(table, {})[key] = value

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        return self._tables.get(table, {}).get(key)

    def delete(self, table: str, key: bytes):
        self._tables.get(table, {}).pop(key, None)

    def keys(self, table: str, prefix: bytes = b"") -> List[bytes]:
        return [k for k in self._tables.get(table, {}) if k.startswith(prefix)]

    def load_all(self, table: str) -> Iterable[Tuple[bytes, bytes]]:
        return list(self._tables.get(table, {}).items())

    def close(self):
        pass


class SqliteStoreClient:
    """Durable backend (RedisStoreClient analog). WAL journal so readers
    don't block the single writer; NORMAL sync keeps mutation latency low
    while surviving process crashes (a host power loss may drop the last
    transactions — same durability class as default Redis AOF everysec)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS gcs (tbl TEXT, key BLOB, value BLOB, "
            "PRIMARY KEY (tbl, key))")
        self._conn.commit()

    def put(self, table: str, key: bytes, value: bytes):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO gcs (tbl, key, value) VALUES (?,?,?)",
                (table, key, value))
            self._conn.commit()

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM gcs WHERE tbl=? AND key=?",
                (table, key)).fetchone()
        return row[0] if row else None

    def delete(self, table: str, key: bytes):
        with self._lock:
            self._conn.execute("DELETE FROM gcs WHERE tbl=? AND key=?",
                               (table, key))
            self._conn.commit()

    def keys(self, table: str, prefix: bytes = b"") -> List[bytes]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key FROM gcs WHERE tbl=?", (table,)).fetchall()
        return [r[0] for r in rows if bytes(r[0]).startswith(prefix)]

    def load_all(self, table: str) -> Iterable[Tuple[bytes, bytes]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM gcs WHERE tbl=?", (table,)).fetchall()
        return [(bytes(k), bytes(v)) for k, v in rows]

    def close(self):
        with self._lock:
            self._conn.close()
