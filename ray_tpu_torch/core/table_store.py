"""The GCS's table storage (port of ray_tpu/core/table_store.py): the
in-memory backend, and ``FileTableStore``, the crash-safe file backend a
restarted head re-hydrates its KV, its job table (``job/`` mirrors every
``JobInfo`` into the ``_jobs`` KV namespace) and its detached actors from.

The file is an append-only JSONL log of ``{"op", "t", "k", "v"}`` records
(``v`` base64), byte for byte ray_tpu's format, so either package replays
a log the other wrote. Every append is flushed and fsync'd before ``put``
returns; a torn final line (a crash mid-append) is truncated on open; the
live state is rewritten as a fresh log through an atomic rename every
``COMPACT_EVERY`` appends; the file is created 0600 (it holds the
cluster's authkeys, ``Runtime._persistent_secret``).
"""

from __future__ import annotations

import base64
import json
import os
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


class FileTableStore(TableStore):
    """Append-only JSONL log with periodic compaction.

    Records: {"op": "put"|"del", "t": table, "k": key, "v": b64} — replayed
    in order at open. Compaction rewrites the live state as a fresh log via
    atomic rename, so a crash at any byte leaves either the old or the new
    complete log. Every append is flushed + fsync'd before put() returns
    (the durability contract head fault tolerance rests on)."""

    COMPACT_EVERY = 2000  # appended records between compactions

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._tables: dict[str, dict[str, bytes]] = {}
        self._appended = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._replay()
        self._f = self._open_append(self.path)

    @staticmethod
    def _open_append(path: str):
        # 0600 from birth: the log holds the cluster's authkeys
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600)
        return os.fdopen(fd, "ab")

    def _replay(self):
        try:
            f = open(self.path, "rb")
        except FileNotFoundError:
            return
        with f:
            data = f.read()
        # a crash mid-append leaves a torn final line: truncate it so the
        # next append starts on a clean record boundary
        if data and not data.endswith(b"\n"):
            cut = data.rfind(b"\n") + 1
            with open(self.path, "r+b") as tf:
                tf.truncate(cut)
            data = data[:cut]
        for line in data.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if rec["op"] == "put":
                    self._tables.setdefault(rec["t"], {})[rec["k"]] = base64.b64decode(rec["v"])
                elif rec["op"] == "del":
                    self._tables.get(rec["t"], {}).pop(rec["k"], None)
            except (ValueError, KeyError):
                # a torn record from a crash mid-append: it was never
                # acknowledged to its caller
                continue

    def _append(self, rec: dict):
        data = (json.dumps(rec, separators=(",", ":")) + "\n").encode()
        self._f.write(data)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._appended += 1
        if self._appended >= self.COMPACT_EVERY:
            self._compact()

    def _compact(self):
        tmp = self.path + ".compact"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            for t, kv in self._tables.items():
                for k, v in kv.items():
                    f.write(
                        (json.dumps({"op": "put", "t": t, "k": k, "v": base64.b64encode(v).decode()}, separators=(",", ":")) + "\n").encode()
                    )
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = self._open_append(self.path)
        self._appended = 0

    def put(self, table, key, value):
        with self._lock:
            self._tables.setdefault(table, {})[key] = value
            self._append({"op": "put", "t": table, "k": key, "v": base64.b64encode(value).decode()})

    def get(self, table, key):
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def delete(self, table, key):
        with self._lock:
            if key in self._tables.get(table, {}):
                self._tables[table].pop(key, None)
                self._append({"op": "del", "t": table, "k": key, "v": ""})

    def all(self, table):
        with self._lock:
            return dict(self._tables.get(table, {}))

    def close(self):
        with self._lock:
            self._f.close()
