"""Objects in named POSIX shared memory (port of the segment functions of
ray_tpu/core/object_store.py): one segment per object, written with
``os.writev`` straight into the ``shm_open`` fd (no ``SharedMemory``,
no ``resource_tracker``), mapped by any process of this host that holds
its descriptor.

Names are ``rt<tag>_<object id hex>``, ``tag`` this process's tag
(``RT_SHM_NS``, else the pid): the leading pid is what
``cleanup_orphan_segments`` checks for liveness, so the segments of a
killed owner are reclaimed by the next process that attaches a plane.
ray_tpu names a session's segments after its head's pid
(``RT_SESSION_PID``); the port has no head, so each owner names its own.

**The mapping is private and writable.** ray_tpu maps a segment
``PROT_READ`` and decodes numpy arrays with ``writeable=False``. torch has
no read-only tensor: ``torch.frombuffer`` over a read-only mapping only
warns and hands back a tensor whose first in-place op kills the process
with SIGSEGV. The port maps the ``O_RDONLY`` fd ``MAP_PRIVATE`` with
``PROT_READ | PROT_WRITE`` (``mmap.ACCESS_COPY``): the borrow still copies
nothing, a write copies only the page it touches into the writer's own
memory, and the owner's bytes never change.

A descriptor names the shm namespace that holds its bytes (``ns``:
``RT_SHM_NS``, empty for the host's own ``/dev/shm``). A foreign
namespace needs ray_tpu's object transfer service (``transport.py``,
``ensure_local_segment``), which is not ported: reading one raises
NotImplementedError naming its ROADMAP.md item. ray_tpu's ``ObjectStore``
class, spilling and its fetch hook wait for the runtime.
"""

from __future__ import annotations

import errno
import mmap
import os
import re
from dataclasses import dataclass

import _posixshmem

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.serialization import Serialized

# the ROADMAP.md item that transfers between shm namespaces wait for
TRANSFER_ITEM = "queue 1, multi-device axes"
SHM_DIR = "/dev/shm"


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


def _session_tag() -> str:
    """This process's tag in segment names (``RT_SHM_NS``, else the pid)."""
    return os.environ.get("RT_SHM_NS") or str(os.getpid())


def _namespace() -> str:
    """The shm namespace this process reads and writes ("" = this host's)."""
    return os.environ.get("RT_SHM_NS", "")


def cleanup_orphan_segments():
    """Unlink ``rt<pid>...`` segments whose owning process is dead."""
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return
    for n in names:
        # namespaces: "<pid>" (session), "<pid>n<k>" (isolated node),
        # "<pid>j" (joined agent): the leading pid is the liveness key
        m = re.match(r"^rt(\d+)(?:[nj][0-9a-f]*)?_", n)
        if not m:
            continue
        try:
            os.kill(int(m.group(1)), 0)
        except ProcessLookupError:
            unlink_shm(n)
        except PermissionError:
            pass


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
    (``bytearray``) and the mapping is closed (None)."""
    if desc.ns and desc.ns != _namespace():
        raise NotImplementedError(
            f"object segment {desc.shm_name} lives in shm namespace {desc.ns!r}, not this process's "
            f"({_namespace()!r}); transfers between namespaces are not ported to ray_tpu_torch yet "
            f"(ROADMAP.md, {TRANSFER_ITEM})")
    m = _mmap_private(desc.shm_name)
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
    try:
        os.unlink(os.path.join(SHM_DIR, name))
    except OSError:
        pass
