"""The GCS's table storage (port of ray_tpu/core/table_store.py's
interface and its in-memory backend). ray_tpu's crash-safe file backend
(``FileTableStore``), which lets a restarted head re-hydrate the KV and
detached actors, is not ported: ``Runtime`` raises for a
``gcs_persist_path``, naming ``core/context.py``'s PERSIST_ITEM."""

from __future__ import annotations

import threading


class TableStore:
    """dict-of-dicts interface: table -> key(str) -> value(bytes)."""

    def put(self, table: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, table: str, key: str) -> bytes | None:
        raise NotImplementedError

    def delete(self, table: str, key: str) -> None:
        raise NotImplementedError

    def all(self, table: str) -> dict[str, bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryTableStore(TableStore):
    """The default: plain dicts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: dict[str, dict[str, bytes]] = {}

    def put(self, table, key, value):
        with self._lock:
            self._tables.setdefault(table, {})[key] = value

    def get(self, table, key):
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table, key):
        with self._lock:
            self._tables.get(table, {}).pop(key, None)

    def all(self, table):
        with self._lock:
            return dict(self._tables.get(table, {}))

