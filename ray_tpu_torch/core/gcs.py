"""Control-plane state (port of ray_tpu/core/gcs.py): the namespaced KV
store, the named-actor registry, pubsub, the lifecycle event buffer and
the record of detached actors a restarted head re-creates, over a table
store (``core/table_store.py``: in memory, or the file log of
``gcs_persist_path``)."""

from __future__ import annotations

import fnmatch
import threading
import time
from collections import defaultdict


# namespaces kept in memory only: the workers' metric snapshots, which
# each live worker writes again every second (util/metrics.py)
VOLATILE_NAMESPACES = ("_metrics",)


class KVStore:
    """Namespaced KV, written through to the table store (but
    ``VOLATILE_NAMESPACES``). Keys and values are any picklable objects;
    the table rows are pickled on both sides."""

    def __init__(self, store=None):
        import base64
        import pickle

        from ray_tpu_torch.core.table_store import InMemoryTableStore

        self._lock = threading.Lock()
        self._persist_lock = threading.Lock()  # see put(): ordered log appends
        self._data: dict[str, dict[bytes, bytes]] = defaultdict(dict)
        self._store = store or InMemoryTableStore()
        # re-hydrate from a persistent backend. Keys/values are arbitrary
        # picklable objects (callers pass str, bytes, dicts), so the table
        # rows are pickled on both sides.
        for skey, value in self._store.all("kv").items():
            ns, _, key_b64 = skey.partition("::")
            try:
                self._data[ns][pickle.loads(base64.b64decode(key_b64))] = pickle.loads(value)
            except Exception:
                continue

    @staticmethod
    def _skey(namespace: str, key) -> str:
        import base64
        import pickle

        return f"{namespace}::{base64.b64encode(pickle.dumps(key)).decode()}"

    def put(self, key: bytes, value: bytes, overwrite: bool = True, namespace: str = "default") -> bool:
        import pickle

        # write through outside the KV lock; _persist_lock is taken under
        # it, so the store's order matches memory's
        with self._lock:
            ns = self._data[namespace]
            if not overwrite and key in ns:
                return False
            ns[key] = value
            if namespace in VOLATILE_NAMESPACES:
                return True
            self._persist_lock.acquire()
        try:
            self._store.put("kv", self._skey(namespace, key), pickle.dumps(value))
        except Exception:
            pass  # unpicklable value: kept in memory only
        finally:
            self._persist_lock.release()
        return True

    def get(self, key: bytes, namespace: str = "default") -> bytes | None:
        with self._lock:
            return self._data[namespace].get(key)

    def delete(self, key: bytes, namespace: str = "default") -> bool:
        # put()'s ordering: a racing put's write must not land after the delete
        with self._lock:
            existed = self._data[namespace].pop(key, None) is not None
            if not existed:
                return False
            if namespace in VOLATILE_NAMESPACES:
                return True
            self._persist_lock.acquire()
        try:
            self._store.delete("kv", self._skey(namespace, key))
        finally:
            self._persist_lock.release()
        return True

    def exists(self, key: bytes, namespace: str = "default") -> bool:
        with self._lock:
            return key in self._data[namespace]

    def keys(self, prefix: bytes = b"", namespace: str = "default") -> list[bytes]:
        with self._lock:
            if not prefix:
                return list(self._data[namespace])
            # keys may be str or bytes depending on the caller; only
            # same-typed keys can match a prefix
            return [k for k in self._data[namespace] if isinstance(k, type(prefix)) and k.startswith(prefix)]


class Publisher:
    """In-process pubsub: subscribers' callbacks run on publish."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: dict[str, list] = defaultdict(list)

    def subscribe(self, channel: str, callback) -> callable:
        with self._lock:
            self._subs[channel].append(callback)

        def unsubscribe():
            with self._lock:
                try:
                    self._subs[channel].remove(callback)
                except ValueError:
                    pass

        return unsubscribe

    def publish(self, channel: str, message: dict):
        with self._lock:
            subs = list(self._subs.get(channel, ()))
        for cb in subs:
            try:
                cb(message)
            except Exception:
                pass


class EventBuffer:
    """Bounded buffer of task, actor and node lifecycle events."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: list[dict] = []

    def record(self, kind: str, **fields):
        ev = {"kind": kind, "ts": time.time(), **fields}
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self.capacity:
                del self._events[: self.capacity // 10]

    def query(self, kind: str | None = None, pattern: str | None = None, limit: int = 1000) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if kind:
            evs = [e for e in evs if e["kind"] == kind]
        if pattern:
            evs = [e for e in evs if fnmatch.fnmatch(e.get("name", ""), pattern)]
        return evs[-limit:]


class Gcs:
    def __init__(self, store=None):
        from ray_tpu_torch.core.table_store import InMemoryTableStore

        self.store = store or InMemoryTableStore()
        self.kv = KVStore(self.store)
        self.pubsub = Publisher()
        self.events = EventBuffer()
        self._lock = threading.Lock()
        # named actor registry: (namespace, name) -> ActorID
        self.named_actors: dict[tuple, object] = {}
        self.job_counter = 0

    def register_named_actor(self, name: str, namespace: str, actor_id) -> bool:
        with self._lock:
            key = (namespace, name)
            if key in self.named_actors:
                return False
            self.named_actors[key] = actor_id
            return True

    def lookup_named_actor(self, name: str, namespace: str):
        with self._lock:
            return self.named_actors.get((namespace, name))

    def unregister_named_actor(self, name: str, namespace: str):
        with self._lock:
            self.named_actors.pop((namespace, name), None)

    def list_named_actors(self, namespace: str | None = None) -> list:
        with self._lock:
            return [
                {"name": n, "namespace": ns}
                for (ns, n) in self.named_actors
                if namespace is None or ns == namespace
            ]

    # -- detached actors, recorded for a restarted head --
    def persist_detached_actor(self, actor_id, blob: bytes):
        self.store.put("detached_actors", actor_id.hex(), blob)

    def drop_detached_actor(self, actor_id):
        self.store.delete("detached_actors", actor_id.hex())

    def load_detached_actors(self) -> dict[str, bytes]:
        return self.store.all("detached_actors")
