"""Objects in named POSIX shared memory and the head's store (port of
ray_tpu/core/object_store.py): one segment per object, written with
``os.writev`` straight into the ``shm_open`` fd (no ``SharedMemory``,
no ``resource_tracker``), mapped by any process of this host that holds
its descriptor; and ``ObjectStore``, the head's store of sealed objects
(inline values, segment descriptors and errors) with waiters, pins, LRU
spilling to disk and eviction for lineage to rebuild.

Names are ``rt<tag>_<object id hex>``, ``tag`` the writing process's tag:
a runtime's worker writes under its head's (``<head pid>w``, set by
``set_session_tag``), any other process under ``RT_SHM_NS``, else its
pid. The leading pid is what ``cleanup_orphan_segments`` checks for
liveness, so the segments of a killed process are reclaimed by the next
process that starts a runtime or attaches a plane, and the head-owned
objects a worker wrote (task returns, stream items, sealed direct
results) outlive the worker as long as the head lives. ray_tpu names
every segment of a session after its head's pid (``RT_SESSION_PID``);
the port's workers add ``w`` so that the head's shutdown can sweep
``rt<head pid>w_`` without touching a ray_tpu session's ``rt<pid>_``
segments in the same process.

**The mapping is private and writable.** ray_tpu maps a segment
``PROT_READ`` and decodes numpy arrays with ``writeable=False``. torch has
no read-only tensor: ``torch.frombuffer`` over a read-only mapping only
warns and hands back a tensor whose first in-place op kills the process
with SIGSEGV. The port maps the ``O_RDONLY`` fd ``MAP_PRIVATE`` with
``PROT_READ | PROT_WRITE`` (``mmap.ACCESS_COPY``): the borrow still copies
nothing, a write copies only the page it touches into the writer's own
memory, and the owner's bytes never change.

A descriptor names the shm namespace that holds its bytes (``ns``:
``RT_SHM_NS``, empty for the host's own ``/dev/shm``). A node with a
namespace of its own (``add_node(shm_isolation=True)``, or an agent that
joined from another host) stands for another host: a process reads a
foreign namespace's segment only after ``ensure_local_segment`` pulled
the bytes through the object transfer service (``core/transport.py``)
into a same-id segment of its own namespace (``local_shm_name``), through
the fetch hook its process installed (the head pulls itself; a worker
asks its node's agent).
"""

from __future__ import annotations

import errno
import mmap
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass, field

import _posixshmem

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.serialization import Serialized

SHM_DIR = "/dev/shm"
# the segments this process wrote and has not unlinked: the runtime's
# shutdown unlinks what is left (ray_tpu sweeps its session's name prefix,
# which a ray_tpu session in the same process shares)
_written: set = set()


@dataclass
class ShmDescriptor:
    """Locator of an object in shared memory: the segment's name, the
    header's length and each out-of-band buffer's, and the shm namespace
    that holds the bytes (empty: the host's ``/dev/shm``)."""

    shm_name: str
    header_len: int
    buffer_lens: list[int]
    total_size: int
    ns: str = ""


@dataclass
class StoredObject:
    """An entry of the head's store: inline data, an shm locator, or an
    error to raise at get(). ``contained_refs`` holds live ObjectRefs of
    the objects pickled inside this value, so they live exactly as long
    as the entry. ``spill_path`` set: the segment's bytes were moved to
    disk under memory pressure and come back on the next read."""

    value: Serialized | None = None
    shm: ShmDescriptor | None = None
    error: BaseException | None = None
    sealed_at: float = field(default_factory=time.monotonic)
    contained_refs: list = field(default_factory=list)
    spill_path: str | None = None

    def size(self) -> int:
        if self.shm is not None:
            return self.shm.total_size
        if self.value is not None:
            return self.value.total_size()
        return 0


# a runtime worker's tag: its head's (set_session_tag)
_tag: str | None = None


def set_session_tag(tag: str | None):
    """Name this process's segments under ``tag`` (a runtime's worker:
    its head's ``worker_session_tag()``)."""
    global _tag
    _tag = tag


def worker_session_tag() -> str:
    """The tag of the segments that this head's workers write."""
    return f"{os.getpid()}w"


def _session_tag() -> str:
    """This process's tag in segment names (``set_session_tag``'s, else
    ``RT_SHM_NS``, else the pid)."""
    return _tag or os.environ.get("RT_SHM_NS") or str(os.getpid())


def _namespace() -> str:
    """The shm namespace this process reads and writes ("" = this host's)."""
    return os.environ.get("RT_SHM_NS", "")


# installed by the head and by each worker: pulls a foreign namespace's
# segment into this process's namespace and returns the local name
_fetch_hook = None


def set_fetch_hook(fn):
    global _fetch_hook
    _fetch_hook = fn


def local_shm_name(desc: ShmDescriptor) -> str:
    """The name of this process's copy of a (foreign) descriptor's segment."""
    return f"rt{_session_tag()}_" + desc.shm_name.split("_", 1)[1]


def ensure_local_segment(desc: ShmDescriptor) -> str:
    """The name of a segment this process can map for ``desc``: its own
    when the descriptor lives in this namespace, else a local copy,
    pulled from the owning node when there is none yet."""
    if desc.ns == _namespace():
        return desc.shm_name
    local = local_shm_name(desc)
    if os.path.exists(os.path.join(SHM_DIR, local)):
        return local
    if _fetch_hook is None:
        raise FileNotFoundError(f"object segment {desc.shm_name} lives in foreign shm namespace {desc.ns!r} and "
                                "this process has no transfer fetch hook")
    return _fetch_hook(desc)


def cleanup_orphan_segments():
    """Unlink ``rt<pid>...`` segments whose owning process is dead."""
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return
    for n in names:
        # namespaces: "<pid>" (session), "<pid>n<k>" (isolated node),
        # "<pid>j" (joined agent), "<pid>w" (the workers of head <pid>):
        # the leading pid is the liveness key
        m = re.match(r"^rt(\d+)(?:[njw][0-9a-f]*)?_", n)
        if not m:
            continue
        try:
            os.kill(int(m.group(1)), 0)
        except ProcessLookupError:
            unlink_shm(n)
        except PermissionError:
            pass


def unlink_tagged(tag: str):
    """Unlink every segment named under ``tag``."""
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return
    for n in names:
        if n.startswith(f"rt{tag}_"):
            unlink_shm(n)


def write_to_shm(obj_id: ObjectID, s: Serialized) -> ShmDescriptor:
    """Write a serialized value into a fresh segment named after the
    object; MemoryError when ``/dev/shm`` is full (the partial segment is
    unlinked first)."""
    total = s.total_size()
    # the full 40-hex object id: a truncation could collide across objects
    name = f"rt{_session_tag()}_" + obj_id.hex()
    # write(2) into the tmpfs-backed fd: no fault-in and page zeroing of a
    # fresh mapping before the copy
    flags = os.O_CREAT | os.O_EXCL | os.O_RDWR
    try:
        fd = _posixshmem.shm_open("/" + name, flags, 0o600)
    except FileExistsError:
        # a stale segment under this id: replace it
        unlink_shm(name)
        fd = _posixshmem.shm_open("/" + name, flags, 0o600)
    try:
        views = [memoryview(s.header).cast("B")]
        lens = []
        for b in s.buffers:
            mv = memoryview(b).cast("B")
            lens.append(len(mv))
            views.append(mv)
        while views:
            try:
                written = os.writev(fd, views[:1024])
            except OSError as e:
                unlink_shm(name)
                if e.errno != errno.ENOSPC:
                    raise
                raise MemoryError(f"{SHM_DIR} full writing object {obj_id.hex()[:16]} ({total} bytes)") from e
            while views and written >= len(views[0]):
                written -= len(views[0])
                views.pop(0)
            if views and written:
                views[0] = views[0][written:]
        if total == 0:
            os.ftruncate(fd, 1)
    finally:
        os.close(fd)
    _written.add(name)
    return ShmDescriptor(shm_name=name, header_len=len(s.header), buffer_lens=lens, total_size=total,
                         ns=_namespace())


def _mmap_private(name: str) -> mmap.mmap:
    """Map a segment copy-on-write (MAP_PRIVATE, PROT_READ | PROT_WRITE)
    from an O_RDONLY fd. Exported memoryviews (and tensors built over them)
    keep the mapping alive; it goes with the last of them, and a later
    unlink by the owner leaves it valid (POSIX shm semantics)."""
    fd = _posixshmem.shm_open("/" + name, os.O_RDONLY, 0)
    try:
        size = os.fstat(fd).st_size
        return mmap.mmap(fd, size, access=mmap.ACCESS_COPY)
    finally:
        os.close(fd)


def read_from_shm(desc: ShmDescriptor, zero_copy: bool = False):
    """(Serialized, mapping). With ``zero_copy`` the buffers are writable
    views into the private mapping (no byte copied); otherwise copies
    (``bytearray``) and the mapping is closed (None). A foreign
    namespace's segment is pulled here first (``ensure_local_segment``)."""
    m = _mmap_private(ensure_local_segment(desc))
    view = memoryview(m)
    off = desc.header_len
    header = bytes(view[:off])
    buffers = []
    for n in desc.buffer_lens:
        mv = view[off : off + n]
        if zero_copy:
            buffers.append(mv)
        else:
            buffers.append(bytearray(mv))
            mv.release()
        off += n
    view.release()
    s = Serialized(header=header, buffers=buffers)
    if not zero_copy:
        m.close()
        m = None
    return s, m


def unlink_shm(name: str):
    _written.discard(name)
    try:
        os.unlink(os.path.join(SHM_DIR, name))
    except OSError:
        pass


def _write_segment(name: str, data: bytes):
    fd = _posixshmem.shm_open("/" + name, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        view = memoryview(data)
        while view:
            view = view[os.write(fd, view):]
        if not data:
            os.ftruncate(fd, 1)
    finally:
        os.close(fd)


class ObjectStore:
    """The head's store: sealed entries with waiters, pins, LRU spilling
    and eviction."""

    def __init__(self):
        from ray_tpu_torch._config import get_config

        self._lock = threading.Condition()
        self._objects: dict[ObjectID, StoredObject] = {}
        self._shm_bytes = 0
        self._pinned: dict[ObjectID, int] = {}
        self._evicted: set[ObjectID] = set()
        self.cfg = get_config()
        # called (outside the lock) with the ObjectID on every seal
        self.listeners: list = []
        # installed by the runtime: free a segment of a foreign namespace
        # (the owning node's agent unlinks it)
        self.remote_free = None
        self._spilled_bytes = 0
        self._spill_count = 0
        self._restore_count = 0
        self._spill_dir = None

    def spill_dir(self) -> str:
        if self._spill_dir is None:
            d = self.cfg.object_spill_dir
            if not d:
                from ray_tpu_torch.util.tracing import session_dir

                d = os.path.join(session_dir(), "spill")
            os.makedirs(d, exist_ok=True)
            self._spill_dir = d
        return self._spill_dir

    def _free_shm(self, desc: ShmDescriptor):
        """Unlink a segment where it lives: here for this namespace's, else
        this process's copy and, through the owning node, the original."""
        if desc.ns == _namespace():
            unlink_shm(desc.shm_name)
            return
        unlink_shm(local_shm_name(desc))
        if self.remote_free is not None:
            self.remote_free(desc)

    # -- write path --------------------------------------------------------
    def put_serialized(self, obj_id: ObjectID, s: Serialized, inline_threshold: int | None = None) -> StoredObject:
        thr = self.cfg.max_direct_call_object_size if inline_threshold is None else inline_threshold
        if s.total_size() > thr:
            entry = StoredObject(shm=write_to_shm(obj_id, s), contained_refs=list(s.contained_refs))
        else:
            # detach inline entries from the caller's memory: pickle buffer
            # views alias the original object, which the caller may mutate
            if any(not isinstance(b, bytes) for b in s.buffers):
                s = Serialized(header=s.header, buffers=[bytes(b) for b in s.buffers], contained_refs=s.contained_refs)
            entry = StoredObject(value=s, contained_refs=list(s.contained_refs))
        self.seal(obj_id, entry)
        return entry

    def put_error(self, obj_id: ObjectID, err: BaseException):
        self.seal(obj_id, StoredObject(error=err))

    def seal(self, obj_id: ObjectID, entry: StoredObject):
        with self._lock:
            old = self._objects.get(obj_id)
            if old is not None and old.shm is not None:
                self._drop_bytes(old)
            self._objects[obj_id] = entry
            self._evicted.discard(obj_id)
            if entry.shm is not None:
                self._shm_bytes += entry.shm.total_size
            self._lock.notify_all()
        for listener in self.listeners:
            listener(obj_id)
        self._maybe_evict()

    def _drop_bytes(self, entry: StoredObject):  # holds-lock: _lock
        if entry.spill_path is not None:
            self._drop_spill_file(entry)
        else:
            self._shm_bytes -= entry.shm.total_size
            self._free_shm(entry.shm)

    # -- read path ---------------------------------------------------------
    def contains(self, obj_id: ObjectID) -> bool:
        with self._lock:
            return obj_id in self._objects

    def is_evicted(self, obj_id: ObjectID) -> bool:
        with self._lock:
            return obj_id in self._evicted

    def get_entry(self, obj_id: ObjectID, timeout: float | None = None) -> StoredObject | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while obj_id not in self._objects:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._lock.wait(timeout=remaining if remaining is not None else 1.0)
            entry = self._objects[obj_id]
            entry.sealed_at = time.monotonic()  # LRU touch
            return entry

    def try_get_entry(self, obj_id: ObjectID) -> StoredObject | None:
        with self._lock:
            e = self._objects.get(obj_id)
            if e is not None:
                e.sealed_at = time.monotonic()
            return e

    def wait_ready(self, obj_ids, num_returns: int = 1, timeout: float | None = None):
        """Block until ``num_returns`` of ``obj_ids`` are sealed; returns
        (ready_ids, remaining_ids) in input order."""
        obj_ids = list(obj_ids)
        num_returns = min(num_returns, len(obj_ids))
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                ready = [o for o in obj_ids if o in self._objects]
                if len(ready) >= num_returns:
                    ready = ready[:num_returns]
                    ready_set = set(ready)
                    return ready, [o for o in obj_ids if o not in ready_set]
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return ready, [o for o in obj_ids if o not in ready]
                self._lock.wait(timeout=0.5 if remaining is None else min(remaining, 0.5))

    # -- lifecycle ---------------------------------------------------------
    def pin(self, obj_id: ObjectID):
        with self._lock:
            self._pinned[obj_id] = self._pinned.get(obj_id, 0) + 1

    def unpin(self, obj_id: ObjectID):
        with self._lock:
            n = self._pinned.get(obj_id, 0) - 1
            if n <= 0:
                self._pinned.pop(obj_id, None)
            else:
                self._pinned[obj_id] = n

    def delete(self, obj_id: ObjectID):
        with self._lock:
            entry = self._objects.pop(obj_id, None)
            self._evicted.discard(obj_id)
            if entry is not None and entry.shm is not None:
                self._drop_bytes(entry)

    def mark_lost(self, obj_id: ObjectID):
        """The object's segment vanished: flip it to evicted, so lineage
        reconstruction rebuilds it."""
        with self._lock:
            entry = self._objects.pop(obj_id, None)
            if entry is not None and entry.shm is not None:
                if entry.spill_path is not None:
                    self._drop_spill_file(entry)
                else:
                    self._shm_bytes -= entry.shm.total_size
            self._evicted.add(obj_id)

    def shm_backing_exists(self, entry: StoredObject) -> bool:
        if entry.shm is None:
            return True
        if entry.spill_path is not None:
            return False  # the bytes are on disk: the reader restores first
        if entry.shm.ns != _namespace():
            # another node's segment: a pull finds out (a failed one marks it lost)
            return True
        return os.path.exists(os.path.join(SHM_DIR, entry.shm.shm_name))

    def evict(self, obj_id: ObjectID) -> bool:
        """Drop the object's bytes but remember it existed (lineage can
        rebuild it)."""
        with self._lock:
            if obj_id in self._pinned:
                return False
            entry = self._objects.pop(obj_id, None)
            if entry is None:
                return False
            if entry.shm is not None:
                self._drop_bytes(entry)
            self._evicted.add(obj_id)
            return True

    # -- spilling ----------------------------------------------------------
    def _drop_spill_file(self, entry: StoredObject):
        self._spilled_bytes -= entry.shm.total_size if entry.shm else 0
        try:
            os.unlink(entry.spill_path)
        except OSError:
            pass
        entry.spill_path = None

    def spill(self, obj_id: ObjectID) -> bool:
        """Move a sealed segment's bytes to disk; the entry keeps its
        descriptor and gains ``spill_path``. The copy runs outside the
        lock; the commit re-checks the entry."""
        with self._lock:
            entry = self._objects.get(obj_id)
            if (entry is None or obj_id in self._pinned or entry.shm is None or entry.spill_path is not None
                    or getattr(entry, "_spill_inflight", False)):
                return False
            entry._spill_inflight = True
            src = os.path.join(SHM_DIR, entry.shm.shm_name)
            dst = os.path.join(self.spill_dir(), entry.shm.shm_name)
        ok = True
        try:
            shutil.copyfile(src, dst)
        except OSError:
            try:
                os.unlink(dst)
            except OSError:
                pass
            ok = False  # disk full or the segment raced away: the caller evicts
        with self._lock:
            cur = self._objects.get(obj_id)
            entry._spill_inflight = False
            if cur is not entry or not ok:
                if cur is not entry:  # deleted or replaced mid-copy
                    try:
                        os.unlink(dst)
                    except OSError:
                        pass
                    return True
                return False
            entry.spill_path = dst
            self._shm_bytes -= entry.shm.total_size
            self._spilled_bytes += entry.shm.total_size
            self._spill_count += 1
            unlink_shm(entry.shm.shm_name)
            return True

    def restore(self, obj_id: ObjectID) -> bool:
        """Bring a spilled object's bytes back into its segment (same name,
        so outstanding descriptors map it again), staged under a temporary
        name and renamed into place so no reader maps a partial segment."""
        with self._lock:
            entry = self._objects.get(obj_id)
            if entry is None or entry.shm is None:
                return False
            if entry.spill_path is None:
                # nothing spilled: a spill in flight, or a restore that won
                # the race, brings the bytes back; a vanished segment is lost
                return getattr(entry, "_spill_inflight", False) or os.path.exists(
                    os.path.join(SHM_DIR, entry.shm.shm_name))
            path, desc = entry.spill_path, entry.shm
        tmp_name = f"{desc.shm_name}.r{time.monotonic_ns()}"
        try:
            with open(path, "rb") as f:
                data = f.read()
            _write_segment(tmp_name, data)
        except OSError:
            unlink_shm(tmp_name)
            return False  # the spill file is lost: the caller falls back to lineage
        with self._lock:
            cur = self._objects.get(obj_id)
            if cur is not entry or entry.spill_path is None:
                unlink_shm(tmp_name)  # a concurrent restore or delete won
                return cur is not None
            try:
                os.rename(os.path.join(SHM_DIR, tmp_name), os.path.join(SHM_DIR, desc.shm_name))
            except OSError:
                unlink_shm(tmp_name)
                return False
            self._drop_spill_file(entry)
            self._shm_bytes += desc.total_size
            self._restore_count += 1
            entry.sealed_at = time.monotonic()
        self._maybe_evict()
        return True

    def restore_or_mark_lost(self, obj_id: ObjectID):
        if not self.restore(obj_id):
            self.mark_lost(obj_id)

    def _maybe_evict(self):
        """Past the threshold, in LRU order over sealed unpinned segments:
        spill to disk (the bytes survive), else evict (lineage rebuilds)."""
        cfg = self.cfg
        limit = int(cfg.object_store_memory * cfg.object_store_eviction_threshold)
        with self._lock:
            if self._shm_bytes <= limit:
                return
            # another node's segments hold no bytes of this store: never spilled here
            candidates = sorted((e.sealed_at, oid) for oid, e in self._objects.items()
                                if e.shm is not None and e.spill_path is None and oid not in self._pinned
                                and e.shm.ns == _namespace())
        for _, oid in candidates:
            spilled = False
            if cfg.object_spilling_enabled:
                with self._lock:
                    disk_ok = self._spilled_bytes < cfg.object_spill_max_bytes
                if disk_ok:
                    spilled = self.spill(oid)
            if not spilled:
                self.evict(oid)
            with self._lock:
                if self._shm_bytes <= limit:
                    break

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._objects),
                "shm_bytes": self._shm_bytes,
                "num_evicted": len(self._evicted),
                "num_pinned": len(self._pinned),
                "spilled_bytes": self._spilled_bytes,
                "spill_count": self._spill_count,
                "restore_count": self._restore_count,
            }

    def shutdown(self):
        with self._lock:
            for entry in self._objects.values():
                if entry.spill_path is not None:
                    try:
                        os.unlink(entry.spill_path)
                    except OSError:
                        pass
                elif entry.shm is not None:
                    # a foreign segment goes with its node: only this copy here
                    unlink_shm(entry.shm.shm_name if entry.shm.ns == _namespace() else local_shm_name(entry.shm))
            self._objects.clear()
            self._shm_bytes = 0
            self._spilled_bytes = 0
            self._evicted.clear()
        # the segments this process wrote outside the store (by-value task
        # arguments kept for retries) die with the session
        for n in list(_written):
            unlink_shm(n)
