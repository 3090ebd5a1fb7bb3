"""ObjectRef, a name for an object on the owned-object plane, and the
per-process reference counts behind the borrow protocol (port of
ray_tpu/core/object_ref.py, the owned path).

Each process counts its live refs per object id; a 0 -> 1 transition
queues a register event and a 1 -> 0 transition a release event
(``_rc_events``). A release is only queued by ``ObjectRef.__del__`` (on
a lock-free deque) and applied to the counts under the lock by every
reader: a ``__del__`` can run inside a garbage-collection pass that an
allocation triggers while this very thread holds the non-reentrant count
lock, and ray_tpu's ``_decref``, which takes the lock there, deadlocks
the process (ROADMAP.md queue 3). The plane's housekeeping thread drains them
(``drain_ref_events``) and routes them: to the local owned store when
this process owns the object, else to the owner named by the ref's
hint (``core/direct.py``). A ref pickled out of its owner marks the
entry as serialized out, so the owner waits for the borrower's explicit
release instead of the short grace timer.

``get``/``wait``/``future``/``__await__`` and ``ObjectRefGenerator`` go
through the process's client (``core/context.py``: the head in the
driver, a ``WorkerClient`` in a worker), which tries the owned plane
first. A process with no runtime reads a ref with
``direct.get_owned_view``.
"""

from __future__ import annotations

import threading
from collections import deque

from ray_tpu_torch.core.ids import ObjectID


def _client():
    from ray_tpu_torch.core.context import get_client

    return get_client()

_rc_lock = threading.Lock()
_rc_counts: dict[bytes, int] = {}
_rc_events: list[tuple[bytes, bool]] = []  # (id, True = register / False = release)
_rc_released: deque = deque()  # ids whose ref died, not yet counted down (appended without the lock)
_rc_enabled = True
_ref_sink = threading.local()  # active serialization sinks (serialization.serialize)


def set_ref_counting(enabled: bool):
    global _rc_enabled
    _rc_enabled = enabled


def push_ref_sink(sink: list):
    stack = getattr(_ref_sink, "stack", None)
    if stack is None:
        stack = _ref_sink.stack = []
    stack.append(sink)
    return len(stack) - 1


def pop_ref_sink(token: int):
    stack = getattr(_ref_sink, "stack", None)
    if stack and len(stack) - 1 == token:
        stack.pop()


def _incref(obj_id: ObjectID):
    if not _rc_enabled:
        return
    k = obj_id.binary()
    with _rc_lock:
        c = _rc_counts.get(k, 0)
        _rc_counts[k] = c + 1
        if c == 0:
            _rc_events.append((k, True))


def _decref(obj_id: ObjectID):
    """Queue a release; it never takes the lock (see the module docstring)."""
    if not _rc_enabled:
        return
    try:
        _rc_released.append(obj_id.binary())
    except Exception:  # noqa: BLE001 — interpreter teardown: module globals may be gone
        pass


def _apply_released_locked():  # holds-lock: _rc_lock
    while _rc_released:
        k = _rc_released.popleft()
        c = _rc_counts.get(k)
        if c is None:
            continue
        if c <= 1:
            del _rc_counts[k]
            _rc_events.append((k, False))
        else:
            _rc_counts[k] = c - 1


def drain_ref_events() -> list[tuple[bytes, bool]]:
    with _rc_lock:
        _apply_released_locked()
        ev, _rc_events[:] = list(_rc_events), []
        return ev


def local_ref_count(obj_id: ObjectID) -> int:
    with _rc_lock:
        _apply_released_locked()
        return _rc_counts.get(obj_id.binary(), 0)


_note_hint = None  # direct.note_hint, bound on first use (direct imports this module)
_get_hint = None  # direct.get_hint
_mark_serialized = None  # direct.mark_serialized_out


class ObjectRef:
    __slots__ = ("id", "_owner_hint", "__weakref__")

    def __init__(self, obj_id: ObjectID, owner_hint: str | None = None):
        self.id = obj_id
        self._owner_hint = owner_hint
        if owner_hint is not None:
            # remember who owns this object, so gets, frees and borrow
            # events go straight to the owner
            global _note_hint, _get_hint
            if _note_hint is None:
                from ray_tpu_torch.core.direct import get_hint as _gh
                from ray_tpu_torch.core.direct import note_hint as _nh

                _note_hint, _get_hint = _nh, _gh
            _note_hint(obj_id.binary(), owner_hint)
        _incref(obj_id)

    def __del__(self):
        _decref(self.id)

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def task_id(self):
        return self.id.task_id()

    def get(self, timeout: float | None = None):
        return _client().get_object(self.id, timeout=timeout)

    def wait(self, timeout: float | None = None) -> bool:
        return _client().wait_ready([self.id], num_returns=1, timeout=timeout)[0] != []

    def future(self):
        """A concurrent.futures.Future of this ref's value."""
        import concurrent.futures

        fut = concurrent.futures.Future()

        def _done(value, err):
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(value)

        _client().add_done_callback(self.id, _done)
        return fut

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self.id == other.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:16]})"

    def __reduce__(self):
        # a ref crossing a process boundary is borrowed: the receiving
        # process's __init__ registers its local count, and an active
        # serialization sink records the ref so the carrying value pins it
        stack = getattr(_ref_sink, "stack", None)
        if stack:
            stack[-1].append(self.id)
        global _mark_serialized
        if _mark_serialized is None:
            try:
                from ray_tpu_torch.core.direct import mark_serialized_out as _ms

                _mark_serialized = _ms
            except ImportError:  # partial teardown
                _mark_serialized = lambda _k: True  # noqa: E731
        # if this process owns the object, its store now waits for the
        # borrow-release instead of the short grace timer; if it handed the
        # object to the head, the receiver registers with the head (no hint)
        if not _mark_serialized(self.id.binary()):
            return (ObjectRef, (self.id, None))
        hint = self._owner_hint
        if hint is None and _get_hint is not None:
            # a ref rebuilt without its hint still travels with the owner
            # this process learned for it
            hint = _get_hint(self.id.binary())
        return (ObjectRef, (self.id, hint))


class ObjectRefGenerator:
    """Iterator over the refs a streaming task yields, each produced as the
    task runs (ray_tpu's ObjectRefGenerator)."""

    def __init__(self, generator_id: ObjectID):
        self.generator_id = generator_id
        self._index = 0
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self.next_ref(timeout_s=None)

    def next_ref(self, timeout_s: float | None = None) -> ObjectRef:
        """next() with a bound on the wait for the producer's next item
        (GetTimeoutError on expiry; the stream stays consumable)."""
        if self._done:
            raise StopIteration
        ref = _client().next_generator_item(self.generator_id, self._index, timeout=timeout_s)
        if ref is None:
            self._done = True
            raise StopIteration
        self._index += 1
        return ref if isinstance(ref, ObjectRef) else ObjectRef(ref)

    def __aiter__(self):
        return self

    async def __anext__(self) -> ObjectRef:
        import asyncio

        loop = asyncio.get_running_loop()
        try:
            return await loop.run_in_executor(None, self.__next__)
        except StopIteration:
            raise StopAsyncIteration from None

    def completed(self) -> bool:
        return self._done

    def __reduce__(self):
        return (ObjectRefGenerator, (self.generator_id,))
