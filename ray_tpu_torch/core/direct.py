"""The direct call plane (port of ray_tpu/core/direct.py): values owned
by the process that made them, and calls from a caller straight to the
worker that runs them, with the head out of the hot path.

- **The owner** keeps each value, or the descriptor of its shared-memory
  segment, in its ``OwnedStore``. A large value's bytes never cross the
  socket: the reply carries the descriptor and a borrower on the same host
  maps the segment (``get_owned_view``, zero-copy).
- **Borrowing.** A ref pickled out of its owner carries the owner's
  address (its hint). The receiving process's reference counts register a
  borrow with the owner and release it when its last ref dies; the owner
  frees an entry whose local count and borrows are zero past the grace
  window (or the leak backstop while a serialized-out copy may still be
  about to register).
- **Direct calls.** An actor call goes from the caller to the actor's
  worker over one persistent authenticated connection, once the head has
  answered the endpoint lookup (``try_actor_call``); a stateless task
  streams onto a worker the caller leased from the head
  (``try_task_call``). The caller owns the results: small ones ride the
  reply, large ones the worker seals in the head's store (REDIRECT), and
  the caller keeps the call as lineage. A call lost with its connection
  fails over to the head path (``_failover``) within its retry budget.
- **The head path** stays for everything constrained (placement groups,
  labels, resources beyond one CPU, cards, streaming) and for any
  direct-path failure: ``promote`` hands an owned object to the head
  before a head-path submit, ``wait_mixed`` waits over both kinds of id,
  and an id this plane neither owns nor has a hint for is the head's.
- **Failure.** An owned object dies with its owner: a get whose owner is
  gone raises ObjectLostError. ``free_owned`` frees at once, wherever the
  object lives.

Wire protocol: length-prefixed pickled dicts over TCP, each connection
opened with an HMAC challenge and response on the plane's authkey.

The plane also runs with no runtime (``attach(authkey)``, a process that
only publishes and borrows, as the handoff paths do): the housekeeping
thread then drains this process's reference counts itself, an id freed by
its owner raises ObjectLostError from a bounded list of freed ids, and a
path that needs the head raises RuntimeError saying that this process
has no runtime.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef as _ObjRef
from ray_tpu_torch.core.task_spec import ArgSpec, Payload
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskError,
    WorkerCrashedError,
)

_MAX_FRAME = 256 << 20


def _head(what: str):
    """The process's head client; RuntimeError in a process with no runtime."""
    from ray_tpu_torch.core.context import maybe_client

    client = maybe_client()
    if client is None:
        raise RuntimeError(f"{what} goes through the runtime's head, and this process has none: call "
                           "ray_tpu_torch.init() first")
    return client


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def _send_frame(sock: socket.socket, data: bytes, lock: threading.Lock):
    with lock:
        sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_exact(rf, n: int) -> bytes:
    data = rf.read(n)
    if data is None or len(data) < n:
        raise ConnectionError("direct peer closed")
    return data


def _recv_frame(rf) -> dict:
    (n,) = struct.unpack("<I", _recv_exact(rf, 4))
    if n > _MAX_FRAME:
        raise ConnectionError("oversized direct frame")
    return pickle.loads(_recv_exact(rf, n))


def _dumps(msg: dict) -> bytes:
    return pickle.dumps(msg, protocol=5)


def _auth_server(sock: socket.socket, authkey: bytes):
    import hmac

    lock = threading.Lock()
    challenge = os.urandom(20)
    _send_frame(sock, challenge, lock)
    rf = sock.makefile("rb")
    (n,) = struct.unpack("<I", _recv_exact(rf, 4))
    resp = _recv_exact(rf, n)
    if not hmac.compare_digest(resp, hmac.new(authkey, challenge, "sha256").digest()):
        raise ConnectionError("direct auth failed")
    _send_frame(sock, b"OK", lock)
    return rf


def _auth_client(sock: socket.socket, authkey: bytes):
    import hmac

    lock = threading.Lock()
    rf = sock.makefile("rb")
    (n,) = struct.unpack("<I", _recv_exact(rf, 4))
    challenge = _recv_exact(rf, n)
    _send_frame(sock, hmac.new(authkey, challenge, "sha256").digest(), lock)
    (n,) = struct.unpack("<I", _recv_exact(rf, 4))
    if _recv_exact(rf, n) != b"OK":
        raise ConnectionError("direct auth rejected")
    return rf


# ---------------------------------------------------------------------------
# owned object store (per process)
# ---------------------------------------------------------------------------
PENDING, READY, VALUE, ERROR, REDIRECT = range(5)


class _Entry:
    __slots__ = (
        "state",
        "payload",
        "value",
        "error",
        "event",
        "borrows",
        "zero_since",
        "callbacks",
        "contained",
        "pending_serialized",
    )

    def __init__(self, state: int):
        self.state = state
        self.payload = None
        self.value = None
        self.error = None
        self.event = threading.Event() if state == PENDING else None
        self.borrows = 0
        self.zero_since = None  # monotonic ts when local count hit 0
        self.callbacks = None
        # live ObjectRefs pickled inside this value: the entry pins them
        # while it lives and releases them when it is freed
        self.contained = None
        # serialized-out copies of the ref not yet matched by a registered
        # borrow: while > 0 a borrower may still be about to register, so
        # the owner waits for its registration (then release) and the
        # timer is only the leak backstop. A counter, not a flag: every new
        # serialization re-opens the registration race.
        self.pending_serialized = 0


class OwnedStore:
    """The owner half of the per-owner metadata protocol: values (or their
    shm descriptors) created by this process, served to borrowers, freed on
    last release plus a short grace window (the grace absorbs the in-flight
    register race inherent to async borrow registration).

    Refs known to have been SERIALIZED OUT of this process wait for the
    explicit borrow-release instead; until a borrow registers, the timer is
    only the ``backstop_s`` leak backstop for borrowers that died before
    registering, so a stalled ref pump longer than ``grace_s`` never frees
    a live borrowed ref. Both windows are RT_* flags (``_config.py``:
    owned_object_grace_s / owned_object_leak_backstop_s)."""

    TOMBSTONES = 4096  # freed ids remembered, so a later get names the loss

    def __init__(self, grace_s: float = 1.0, backstop_s: float = 30.0):
        self._lock = threading.Lock()
        self._objects: dict[bytes, _Entry] = {}
        # ids this store freed, newest last (bounded): a get of one raises
        # ObjectLostError
        self._freed: dict[bytes, None] = {}
        self.grace_s = grace_s
        self.backstop_s = max(backstop_s, grace_s)

    def __contains__(self, k: bytes) -> bool:
        with self._lock:
            return k in self._objects

    def owns(self, k: bytes) -> bool:
        """True when this process is the live owner (REDIRECT entries were
        handed to the head: kept only so a second promote is a no-op)."""
        with self._lock:
            e = self._objects.get(k)
            return e is not None and e.state != REDIRECT

    def drop_redirect(self, k: bytes):
        with self._lock:
            e = self._objects.get(k)
            if e is not None and e.state == REDIRECT:
                del self._objects[k]

    def size(self) -> int:
        with self._lock:
            return len(self._objects)

    def was_freed(self, k: bytes) -> bool:
        with self._lock:
            return k in self._freed

    def put_ready(self, k: bytes, payload: Payload, contained=None):
        with self._lock:
            e = self._objects.get(k)
            if e is None:
                e = self._objects[k] = _Entry(READY)
            e.state = READY
            e.payload = payload
            e.contained = contained or None

    def create_pending(self, k: bytes):
        with self._lock:
            if k not in self._objects:
                self._objects[k] = _Entry(PENDING)

    def reset_pending(self, k: bytes):
        """Force an entry back to PENDING (lineage replay of a lost
        result): getters block until the replay completes it again."""
        with self._lock:
            e = _Entry(PENDING)
            old = self._objects.get(k)
            if old is not None:
                e.borrows = old.borrows
                e.pending_serialized = old.pending_serialized
            self._objects[k] = e

    def complete(self, k: bytes, payload: Payload | None = None, value=None, error=None, redirect=False):
        with self._lock:
            e = self._objects.get(k)
            if e is None:
                e = self._objects[k] = _Entry(PENDING)
            if error is not None:
                e.state, e.error = ERROR, error
            elif redirect:
                e.state = REDIRECT
            elif payload is not None:
                e.state, e.payload = READY, payload
                if payload.contained:
                    # pin the objects pickled inside the value while the
                    # entry lives; the ref pump registers the borrows
                    e.contained = [_ObjRef(c) for c in payload.contained]
            else:
                e.state, e.value = VALUE, value
            ev, cbs = e.event, e.callbacks
            e.callbacks = None
        if ev is not None:
            ev.set()
        for cb in cbs or ():
            try:
                cb()
            except Exception:  # noqa: BLE001 — one failing callback must not starve the rest
                pass

    def entry(self, k: bytes) -> _Entry | None:
        with self._lock:
            return self._objects.get(k)

    def wait_entry(self, k: bytes, timeout: float | None) -> _Entry | None:
        """Block until the entry leaves PENDING (or the timeout). None: an
        unknown id (never owned here, or freed already)."""
        with self._lock:
            e = self._objects.get(k)
        if e is None or e.state != PENDING:
            return e
        e.event.wait(timeout=timeout)
        return e  # still PENDING on a timeout: the caller decides

    def add_callback(self, k: bytes, cb) -> bool:
        """Run cb() once the entry completes (immediately if done).
        Returns False for unknown ids."""
        with self._lock:
            e = self._objects.get(k)
            if e is None:
                return False
            if e.state == PENDING:
                if e.callbacks is None:
                    e.callbacks = []
                e.callbacks.append(cb)
                return True
        try:
            cb()
        except Exception:
            pass
        return True

    def is_ready(self, k: bytes) -> bool:
        with self._lock:
            e = self._objects.get(k)
            return e is not None and e.state != PENDING

    # -- borrow protocol (owner side) --
    def mark_serialized(self, k: bytes):
        """The ref just left this process inside a pickle
        (``ObjectRef.__reduce__``): hold the entry for the explicit
        borrow-release; the timer becomes the leak backstop until a borrow
        registers."""
        with self._lock:
            e = self._objects.get(k)
            if e is not None:
                e.pending_serialized += 1

    def on_borrow(self, k: bytes, registered: bool):
        from ray_tpu_torch.core.object_ref import local_ref_count

        with self._lock:
            e = self._objects.get(k)
            if e is None:
                return
            e.borrows += 1 if registered else -1
            if registered and e.pending_serialized > 0:
                e.pending_serialized -= 1
            if e.borrows > 0:
                e.zero_since = None
            elif e.zero_since is None and not registered and local_ref_count(ObjectID(k)) == 0:
                # an explicit release brought borrows back to zero with the
                # local count at zero too: (re)start the grace clock
                e.zero_since = time.monotonic()

    def on_local_zero(self, k: bytes):
        from ray_tpu_torch.core.object_ref import local_ref_count

        with self._lock:
            e = self._objects.get(k)
            if e is not None and local_ref_count(ObjectID(k)) == 0 and e.borrows <= 0:
                e.zero_since = time.monotonic()

    def on_local_reregister(self, k: bytes):
        with self._lock:
            e = self._objects.get(k)
            if e is not None:
                e.zero_since = None

    def free(self, k: bytes):
        self._drop(k)

    def _drop(self, k: bytes):
        from ray_tpu_torch.core.object_store import unlink_shm

        with self._lock:
            e = self._objects.pop(k, None)
            if e is not None:
                self._freed[k] = None
                if len(self._freed) > self.TOMBSTONES:
                    del self._freed[next(iter(self._freed))]
        if e is None:
            return
        if e.payload is not None and e.payload.shm is not None:
            unlink_shm(e.payload.shm.shm_name)
        if e.event is not None and not e.event.is_set():
            e.error = ObjectLostError("object was freed by its owner")
            e.state = ERROR
            e.event.set()
        e.contained = None  # release the contained pins (cascade)

    def gc_pass(self):
        """Free entries whose local count has been zero (and borrow count
        <= 0) for longer than the applicable window: the short grace for
        entries that never left this process (or whose every serialized
        copy registered its borrow, so release is the causal signal), the
        leak backstop while any serialized-out copy's registration may
        still be in flight."""
        from ray_tpu_torch.core.object_ref import local_ref_count

        now = time.monotonic()
        doomed = []
        with self._lock:
            for k, e in self._objects.items():
                window = self.backstop_s if e.pending_serialized > 0 else self.grace_s
                if e.zero_since is not None and now - e.zero_since > window and e.borrows <= 0 and e.state != PENDING:
                    doomed.append(k)
        for k in doomed:
            if local_ref_count(ObjectID(k)) == 0:
                self._drop(k)

    def shutdown(self):
        with self._lock:
            ks = list(self._objects)
        for k in ks:
            self._drop(k)


# ---------------------------------------------------------------------------
# owner hints: obj_id bytes -> "host:port#node_hex" of the owner. Module
# level: filled by ObjectRef materialization in any process, so a borrowed
# ref always knows its owner.
# ---------------------------------------------------------------------------
_hints: dict[bytes, str] = {}
_hints_lock = threading.Lock()


def note_hint(k: bytes, owner: str):
    st = _state
    if st is not None:
        if owner is st.self_owner:
            # our own fresh ref: getters consult the owned store first and
            # __reduce__ carries the instance hint
            return
        if st.owned.owns(k):
            return  # we ARE the owner
    with _hints_lock:
        _hints[k] = owner


def get_hint(k: bytes) -> str | None:
    with _hints_lock:
        return _hints.get(k)


def mark_serialized_out(k: bytes) -> bool:
    """``ObjectRef.__reduce__``'s hook: if this process owns the id, the
    owned store now waits for the borrow-release instead of the grace
    timer (see OwnedStore). A pickle that never leaves the process (a
    deepcopy) costs at most the backstop window before the free, never a
    leak. False when this process handed the object to the head
    (REDIRECT): the ref must then travel without this process's owner
    hint, so that its receiver registers the borrow with the head, the
    object's owner now. (With the hint the receiver's borrow went to this
    process, which has no count to keep for it, and the head freed the
    object while the receiver still held it.)"""
    st = _state
    if st is None:
        return True
    if st.owned.owns(k):
        st.owned.mark_serialized(k)
        return True
    return k not in st.owned  # present but not owned: REDIRECT


def drop_hint(k: bytes):
    with _hints_lock:
        _hints.pop(k, None)


def hint_addr(owner: str) -> tuple[str, int]:
    hp = owner.split("#", 1)[0]
    host, port = hp.rsplit(":", 1)
    return (host, int(port))


def hint_node_hex(owner: str) -> str | None:
    parts = owner.split("#", 1)
    return parts[1] if len(parts) > 1 else None


# ---------------------------------------------------------------------------
# client side: one persistent connection to a peer
# ---------------------------------------------------------------------------
class _CallRec:
    __slots__ = ("kind", "actor_hex", "task_id", "oids", "method", "func_id", "args", "kwargs", "num_returns", "retries_left", "trace", "done_counted", "pins", "raw", "cancelled", "registered")

    def __init__(self, kind, actor_hex, task_id, oids, method, func_id, args, kwargs, num_returns, retries_left, trace, pins=None, raw=None):
        self.done_counted = False
        self.cancelled = False
        # True once the rec is in a PeerConn's _calls: from then on,
        # conn-death failover owns it. False on a ConnectionError means
        # NOBODY will complete the oids unless the submitter fails over.
        self.registered = False
        # live ObjectRefs pinning this call's arguments until completion
        # (the head pins spec args on its path; here the caller does)
        self.pins = pins
        # fast-path args: one pickle blob of (args, kwargs) riding the
        # frame; None when ArgSpec encoding was used
        self.raw = raw
        self.kind = kind  # "actor" | "task"
        self.actor_hex = actor_hex
        self.task_id = task_id
        self.oids = oids
        self.method = method
        self.func_id = func_id
        self.args = args
        self.kwargs = kwargs
        self.num_returns = num_returns
        self.retries_left = retries_left
        self.trace = trace


class PeerConn:
    """Client half of one direct connection: pipelined requests, a reader
    thread completing owned-store entries and blocking slots."""

    def __init__(self, state: "DirectState", addr: tuple[str, int]):
        self.state = state
        self.addr = addr
        self.sock = socket.create_connection(addr, timeout=10.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(None)
        self._rf = _auth_client(self.sock, state.authkey)
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._cid = 0
        self._calls: dict[int, _CallRec] = {}  # in-flight direct calls
        self._slots: dict[int, list] = {}  # cid -> [Event, ok, payload] blocking requests
        self.dead = False
        self.last_used = time.monotonic()
        self._sent_funcs: set[str] = set()
        self.inflight = 0
        self._reader = threading.Thread(target=self._read_loop, daemon=True, name="rt-direct-peer")
        self._reader.start()

    def _next_cid(self) -> int:
        with self._lock:
            self._cid += 1
            return self._cid

    def send(self, msg: dict):
        data = _dumps(msg)
        try:
            _send_frame(self.sock, data, self._wlock)
        except (OSError, ValueError) as e:
            self._on_death()
            raise ConnectionError(f"direct peer send failed: {e}") from None

    def send_call(self, rec: _CallRec, frame: dict, data: bytes | None = None):
        """Register the in-flight call and send its frame. ``data`` is the
        pre-pickled frame (raw fast path; the cid placeholder inside was
        already filled by the caller via reserve_cid)."""
        cid = frame["cid"] if data is not None else self._next_cid()
        if data is None:
            frame["cid"] = cid
        with self._lock:
            if self.dead:
                raise ConnectionError("direct peer is down")
            self._calls[cid] = rec
            rec.registered = True
            self.inflight += 1
        self.last_used = time.monotonic()
        try:
            if data is not None:
                _send_frame(self.sock, data, self._wlock)
            else:
                self.send(frame)
        except (OSError, ValueError) as e:
            self._on_death()
            raise ConnectionError(f"direct peer send failed: {e}") from None

    def reserve_cid(self) -> int:
        return self._next_cid()

    def ensure_func(self, func_id: str, blob):
        if func_id in self._sent_funcs:
            return
        self.send({"op": "reg_func", "func_id": func_id, "blob": blob})
        self._sent_funcs.add(func_id)

    def request(self, op: str, timeout: float | None = None, _fields: dict | None = None, **fields) -> dict:
        """Blocking request/response (GET etc.). ``timeout`` bounds the
        local wait; ``fields`` ride the frame. A frame field whose name
        collides with a parameter here (the server-side "timeout" a
        bounded GET carries) goes through ``_fields`` instead."""
        if _fields:
            fields.update(_fields)
        cid = self._next_cid()
        slot = [threading.Event(), None]
        with self._lock:
            if self.dead:
                raise ConnectionError("direct peer is down")
            self._slots[cid] = slot
        self.last_used = time.monotonic()
        self.send({"op": op, "cid": cid, **fields})
        if not slot[0].wait(timeout=timeout):
            with self._lock:
                self._slots.pop(cid, None)
            raise GetTimeoutError(f"direct {op} to {self.addr} timed out")
        if isinstance(slot[1], ConnectionError):
            raise slot[1]
        return slot[1]

    def request_get(self, k: bytes, timeout: float | None) -> dict:
        """GET an owned object: the owner waits out PENDING entries with
        OUR timeout (None = indefinitely, like a local get)."""
        return self.request(
            "get",
            timeout=None if timeout is None else timeout + 5.0,
            id=k,
            _fields=None if timeout is None else {"timeout": timeout},
        )

    def _read_loop(self):
        try:
            while True:
                msg = _recv_frame(self._rf)
                op = msg.get("op")
                if op == "result":
                    self._on_result(msg)
                elif op == "value":
                    with self._lock:
                        slot = self._slots.pop(msg["cid"], None)
                    if slot is not None:
                        slot[1] = msg
                        slot[0].set()
                # unknown ops ignored (forward compat)
        except (ConnectionError, OSError, EOFError, pickle.UnpicklingError):
            pass  # death observed below: _on_death fails over every in-flight rec
        finally:
            self._on_death()

    def _on_result(self, msg: dict):
        from ray_tpu_torch.core import rpc_chaos

        if not rpc_chaos.apply("direct_result"):
            # chaos: a lost reply is indistinguishable from a dead peer —
            # fail the connection so in-flight calls take the failover path
            self._on_death()
            return
        with self._lock:
            rec = self._calls.pop(msg["cid"], None)
            if rec is not None:
                self.inflight -= 1
        if rec is None:
            return
        self.last_used = time.monotonic()
        owned = self.state.owned
        err = msg.get("error")
        if err is not None:
            for oid in rec.oids:
                owned.complete(oid.binary(), error=err)
        elif "vals" in msg:
            # raw fast path: results came as plain values in the frame
            for oid, v in zip(rec.oids, msg["vals"]):
                owned.complete(oid.binary(), value=v)
        else:
            for (kb, payload, head_owned) in msg["returns"]:
                if head_owned:
                    drop_hint(kb)
                    owned.complete(kb, redirect=True)
                    # the owner (this process) keeps the producing spec:
                    # if the head store loses the bytes, we replay the
                    # call (owner-based lineage; reference:
                    # task_manager.cc lineage reconstruction lives with
                    # the owner, not the GCS)
                    self.state.remember_lineage(kb, rec)
                else:
                    owned.complete(kb, payload=payload)
        self.state.on_call_done(rec)

    def _on_death(self):
        with self._lock:
            if self.dead:
                return
            self.dead = True
            calls, self._calls = self._calls, {}
            slots, self._slots = self._slots, {}
        try:
            self.sock.close()
        except OSError:
            pass
        for slot in slots.values():
            slot[1] = ConnectionError("direct peer died")
            slot[0].set()
        self.state.on_conn_death(self, list(calls.values()))

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------
class DirectServer:
    """Listener serving the direct protocol for this process: owned-object
    GETs, borrow events, frees — and, when an exec handler is installed
    (worker processes), direct CALL execution."""

    def __init__(self, state: "DirectState", host: str = "0.0.0.0", advertise_host: str | None = None):
        self.state = state
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(128)
        adv = advertise_host or os.environ.get("RT_DIRECT_HOST") or "127.0.0.1"
        self.address = (adv, self._sock.getsockname()[1])
        self._stopped = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="rt-direct-srv")
        self._thread = threading.Thread(target=self._accept_loop, daemon=True, name="rt-direct-listen")
        self._thread.start()

    def _accept_loop(self):
        try:
            self._sock.settimeout(0.5)
        except OSError:
            return
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True, name="rt-direct-conn").start()

    def _serve_conn(self, conn: socket.socket):
        try:
            conn.settimeout(30.0)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            rf = _auth_server(conn, self.state.authkey)
            conn.settimeout(None)
        except (ConnectionError, OSError, struct.error):
            conn.close()
            return
        wlock = threading.Lock()

        def reply(msg):
            # dict or pre-pickled bytes (the worker's raw fast path)
            try:
                _send_frame(conn, msg if isinstance(msg, bytes) else _dumps(msg), wlock)
            except (OSError, ValueError):
                pass

        funcs: dict[str, object] = {}
        try:
            while not self._stopped.is_set():
                msg = _recv_frame(rf)
                op = msg.get("op")
                if op == "call":
                    handler = self.state.exec_handler
                    if handler is None:
                        reply({"op": "result", "cid": msg["cid"], "returns": [], "error": TaskError(tb_str="this process does not execute direct calls", task_desc=msg.get("method", ""))})
                    else:
                        handler(msg, reply, funcs)
                elif op == "get":
                    self._pool.submit(self._serve_get, msg, reply)
                elif op == "poll":
                    e = self.state.owned.entry(msg["id"])
                    ready = e is None or e.state != PENDING
                    reply({"op": "value", "cid": msg["cid"], "payload": None, "ready": ready})
                elif op == "ref":
                    self._on_ref_events(msg["events"])
                elif op == "free":
                    for kb in msg["ids"]:
                        self.state.owned.free(kb)
                elif op == "reg_func":
                    funcs[msg["func_id"]] = msg["blob"]
                elif op == "cancel":
                    cd = self.state.cancelled_direct
                    if len(cd) > 1024:
                        cd.clear()  # best-effort cooperative marks, bounded
                    cd.add(msg["task"])
                elif op == "ping":
                    reply({"op": "value", "cid": msg["cid"], "payload": None})
        except (ConnectionError, OSError, EOFError, pickle.UnpicklingError):
            pass  # a vanished client owes us nothing (it fails over)
        finally:
            conn.close()

    def _serve_get(self, msg: dict, reply):
        k = msg["id"]
        e = self.state.owned.entry(k)
        if e is not None and e.state == PENDING:
            # long waits get their own thread so pending GETs can never
            # starve the fixed server pool
            threading.Thread(target=self._serve_get_blocking, args=(msg, reply), daemon=True, name="rt-direct-getwait").start()
            return
        self._serve_get_blocking(msg, reply)

    def _serve_get_blocking(self, msg: dict, reply):
        k = msg["id"]
        timeout = msg.get("timeout")  # None = wait as long as the caller does
        e = self.state.owned.wait_entry(k, timeout)
        if e is None or e.state == REDIRECT:
            reply({"op": "value", "cid": msg["cid"], "payload": None, "not_owned": True})
            return
        if e.state == PENDING:
            reply({"op": "value", "cid": msg["cid"], "payload": None, "error": GetTimeoutError("owner-side wait timed out")})
        elif e.state == ERROR:
            reply({"op": "value", "cid": msg["cid"], "payload": None, "error": e.error})
        elif e.state == VALUE:
            from ray_tpu_torch.core.payloads import encode_value

            reply({"op": "value", "cid": msg["cid"], "payload": encode_value(e.value)})
        else:
            reply({"op": "value", "cid": msg["cid"], "payload": e.payload})

    def _on_ref_events(self, events):
        """Borrow register/release for objects we own. Events of ids
        promoted to the head meanwhile go into this process's head-bound
        ref queue, so the head's holder table stays balanced; with no
        runtime they are dropped (an id freed here has no other home)."""
        owned = self.state.owned
        stale = []
        for kb, reg in events:
            if kb in owned:
                owned.on_borrow(kb, reg)
            else:
                stale.append((kb, reg))
        if stale and self.state.client is not None:
            from ray_tpu_torch.core import object_ref as _oref

            with _oref._rc_lock:
                _oref._rc_events.extend(stale)

    def shutdown(self):
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# actor routes + leases
# ---------------------------------------------------------------------------
class ActorRoute:
    __slots__ = ("addr", "epoch", "max_task_retries", "head_dirty", "inflight_recs", "lock", "drained")

    def __init__(self):
        self.addr = None
        self.epoch = -1
        self.max_task_retries = 0
        self.head_dirty = False  # head-lane submissions since last fence
        self.inflight_recs = 0
        self.lock = threading.Lock()
        self.drained = threading.Event()
        self.drained.set()


class Lease:
    __slots__ = ("wid", "addr", "conn")

    def __init__(self, wid: str, addr, conn: PeerConn):
        self.wid = wid
        self.addr = addr
        self.conn = conn


# ---------------------------------------------------------------------------
# per-process direct state
# ---------------------------------------------------------------------------
class DirectState:
    MAX_CONNS = 256

    def __init__(self, authkey: bytes, node_hex: str = "", client=None, serve: bool = True, exec_handler=None):
        from ray_tpu_torch._config import get_config

        self.client = client
        self.authkey = authkey
        self.node_hex = node_hex
        self.owned = OwnedStore(
            grace_s=get_config().owned_object_grace_s,
            backstop_s=get_config().owned_object_leak_backstop_s,
        )
        self.exec_handler = exec_handler
        self.cancelled_direct: set = set()
        self.server = DirectServer(self) if serve else None
        self.self_owner = (
            f"{self.server.address[0]}:{self.server.address[1]}#{node_hex}" if self.server else None
        )
        self._conns: dict[tuple, PeerConn] = {}
        self._conns_lock = threading.Lock()
        self.routes: dict[str, ActorRoute] = {}
        self._routes_lock = threading.Lock()
        self.leases: list[Lease] = []
        self._leases_lock = threading.Lock()
        self._lease_last_used = 0.0
        self._owner_ref_queues: dict[str, list] = {}  # owner -> pending ref events
        self._orq_lock = threading.Lock()
        # function blobs this client taught (or may teach) leased workers
        self.func_blobs: dict[str, object] = {}
        # owner-side lineage: return-oid -> producing _CallRec for
        # head-sealed (large) direct results; bounded FIFO
        self.lineage: dict[bytes, _CallRec] = {}
        self._lineage_order: list = []
        self._lineage_lock = threading.Lock()
        self._reconstructing: set = set()
        self._reconstruct_cv = threading.Condition(self._lineage_lock)
        self._stopped = False
        self._stop_ev = threading.Event()
        # hot-path cached config values (get_config() per call adds up)
        self.default_max_retries = get_config().default_max_retries
        self.inline_threshold = get_config().max_direct_call_object_size
        self.interval_s = get_config().ref_counting_interval_s
        self._hk = threading.Thread(target=self._housekeeping, daemon=True, name="rt-direct-hk")
        self._hk.start()

    # -- connections --
    def get_conn(self, addr: tuple[str, int]) -> PeerConn:
        addr = tuple(addr)
        with self._conns_lock:
            c = self._conns.get(addr)
            if c is not None and not c.dead:
                return c
        c = PeerConn(self, addr)
        with self._conns_lock:
            old = self._conns.get(addr)
            if old is not None and not old.dead:
                c.close()
                return old
            self._conns[addr] = c
            if len(self._conns) > self.MAX_CONNS:
                idle = sorted(
                    (x for x in self._conns.values() if x.inflight == 0 and x is not c),
                    key=lambda x: x.last_used,
                )
                for x in idle[: len(self._conns) - self.MAX_CONNS]:
                    self._conns.pop(x.addr, None)
                    x.close()
        return c

    def on_conn_death(self, conn: PeerConn, lost_calls: list[_CallRec]):
        with self._conns_lock:
            if self._conns.get(conn.addr) is conn:
                self._conns.pop(conn.addr, None)
        with self._leases_lock:
            self.leases = [l for l in self.leases if l.conn is not conn]
        for rec in lost_calls:
            threading.Thread(target=self._failover, args=(rec,), daemon=True).start()

    def on_call_done(self, rec: _CallRec):
        if rec.kind == "actor" and not rec.done_counted:
            rec.done_counted = True
            route = self.route(rec.actor_hex)
            with route.lock:
                route.inflight_recs -= 1
                if route.inflight_recs <= 0:
                    route.drained.set()

    # -- failover: direct call lost to a dead peer --
    def _failover(self, rec: _CallRec):
        try:
            if rec.cancelled:
                from ray_tpu_torch.exceptions import RayTpuError

                err = RayTpuError(f"task {rec.task_id.hex()[:8]} was cancelled")
                for oid in rec.oids:
                    self.owned.complete(oid.binary(), error=err)
                return
            if self._stopped:
                err = WorkerCrashedError("runtime shut down with direct calls in flight")
                for oid in rec.oids:
                    self.owned.complete(oid.binary(), error=err)
                return
            client = self.client
            if rec.kind == "actor":
                self._failover_actor(client, rec)
            else:
                self._failover_task(client, rec)
        except BaseException as e:  # noqa: BLE001
            for oid in rec.oids:
                self.owned.complete(oid.binary(), error=e if isinstance(e, Exception) else WorkerCrashedError(str(e)))
        finally:
            self.on_call_done(rec)

    @staticmethod
    def _rec_argspecs(rec: _CallRec):
        """ArgSpecs for a head-path resubmit of this rec. Raw fast-path
        recs keep the SUBMISSION-TIME frame pickle; unpickling it
        reproduces the argument snapshot (a caller mutating its objects
        after .remote() must not change what a retry executes)."""
        if rec.raw is None:
            return rec.args, rec.kwargs
        frame = pickle.loads(rec.raw)
        args, kwargs = frame["argv"], frame.get("kwargv") or {}
        from ray_tpu_torch.api import _encode_args

        specs, kw, _pins = _encode_args(args, kwargs)
        return specs, kw

    def _failover_actor(self, client, rec: _CallRec):
        from ray_tpu_torch.core.ids import ActorID

        route = self.route(rec.actor_hex)
        with route.lock:
            route.addr = None  # force endpoint re-resolution
            route.head_dirty = True
        if rec.retries_left <= 0:
            err = ActorDiedError(rec.actor_hex, "actor worker died during a direct call")
            for oid in rec.oids:
                self.owned.complete(oid.binary(), error=err)
            return
        # resubmit through the head (it owns the restart state machine);
        # bridge the head-path results into our owned pending entries
        args, kwargs = self._rec_argspecs(rec)
        ids = client.submit_actor_task(
            actor_id=ActorID.from_hex(rec.actor_hex),
            method_name=rec.method,
            args=args,
            kwargs=kwargs,
            num_returns=rec.num_returns,
            streaming=False,
            options={"_trace_ctx": rec.trace},
        )
        self._bridge(client, ids, rec.oids)

    def _failover_task(self, client, rec: _CallRec):
        if rec.retries_left <= 0:
            err = WorkerCrashedError(f"leased worker died executing {rec.method}")
            for oid in rec.oids:
                self.owned.complete(oid.binary(), error=err)
            return
        args, kwargs = self._rec_argspecs(rec)
        ids = client.submit_task(
            name=rec.method,
            func_id=rec.func_id,
            args=args,
            kwargs=kwargs,
            num_returns=rec.num_returns,
            streaming=False,
            func_blob=self.func_blobs.get(rec.func_id),
            options={"max_retries": rec.retries_left - 1},
        )
        self._bridge(client, ids, rec.oids)

    def _bridge(self, client, head_ids, owned_oids):
        def _pump():
            for hid, oid in zip(head_ids, owned_oids):
                try:
                    v = client.get_object(hid)
                    self.owned.complete(oid.binary(), value=v)
                except BaseException as e:  # noqa: BLE001
                    self.owned.complete(oid.binary(), error=e)

        threading.Thread(target=_pump, daemon=True).start()

    # -- owner-side lineage --
    MAX_LINEAGE = 4096

    def remember_lineage(self, k: bytes, rec: _CallRec):
        with self._lineage_lock:
            if k not in self.lineage:
                self._lineage_order.append(k)
            self.lineage[k] = rec
            while len(self._lineage_order) > self.MAX_LINEAGE:
                old = self._lineage_order.pop(0)
                self.lineage.pop(old, None)

    def forget_lineage(self, k: bytes):
        with self._lineage_lock:
            self.lineage.pop(k, None)

    def reconstruct(self, client, obj_id: ObjectID) -> bool:
        """Replay the direct call that produced a lost head-sealed result.
        Blocks until the replay completes (entries leave PENDING). Returns
        False when this process holds no lineage for the id."""
        k = obj_id.binary()
        with self._lineage_lock:
            rec = self.lineage.get(k)
            if rec is None:
                return False
            tid_b = rec.task_id.binary()
            if tid_b in self._reconstructing:
                # another getter is already replaying this task: wait it out
                while tid_b in self._reconstructing:
                    self._reconstruct_cv.wait(timeout=120.0)
                return True
            self._reconstructing.add(tid_b)
            for oid in rec.oids:
                self.owned.reset_pending(oid.binary())
        try:
            self._replay(client, rec)
            for oid in rec.oids:
                self.owned.wait_entry(oid.binary(), 120.0)
        finally:
            with self._lineage_lock:
                self._reconstructing.discard(tid_b)
                self._reconstruct_cv.notify_all()
        return True

    def _replay(self, client, rec: _CallRec):
        """Resubmit a completed call (head path; bridged into the owned
        entries). The head path re-pins args and re-seals large results."""
        from ray_tpu_torch.core.ids import ActorID

        try:
            args, kwargs = self._rec_argspecs(rec)
            promote_argspecs(client, args, kwargs)
            if rec.kind == "actor":
                ids = client.submit_actor_task(
                    actor_id=ActorID.from_hex(rec.actor_hex),
                    method_name=rec.method,
                    args=args,
                    kwargs=kwargs,
                    num_returns=rec.num_returns,
                    streaming=False,
                    options={},
                )
            else:
                ids = client.submit_task(
                    name=rec.method,
                    func_id=rec.func_id,
                    args=args,
                    kwargs=kwargs,
                    num_returns=rec.num_returns,
                    streaming=False,
                    func_blob=self.func_blobs.get(rec.func_id),
                    options={},
                )
        except BaseException as e:  # noqa: BLE001
            for oid in rec.oids:
                self.owned.complete(oid.binary(), error=e if isinstance(e, Exception) else ObjectLostError(str(e)))
            return
        self._bridge(client, ids, rec.oids)

    # -- actor routing --
    def route(self, actor_hex: str) -> ActorRoute:
        with self._routes_lock:
            r = self.routes.get(actor_hex)
            if r is None:
                r = self.routes[actor_hex] = ActorRoute()
            return r

    # -- ref-event routing (the owner half of the borrow protocol) --
    def route_ref_events(self, events: list[tuple[bytes, bool]]) -> list[tuple[bytes, bool]]:
        """Split this process's local-count transitions: events for objects
        WE own are applied locally; events for remote-owned objects queue
        to their owner; the rest go to the head (returned)."""
        head_events = []
        to_owner: dict[str, list] = {}
        for k, reg in events:
            if self.owned.owns(k):
                if reg:
                    self.owned.on_local_reregister(k)
                else:
                    self.owned.on_local_zero(k)
                continue
            if k in self.owned:  # REDIRECT: head-owned now
                if not reg:
                    from ray_tpu_torch.core.object_ref import local_ref_count

                    if local_ref_count(ObjectID(k)) == 0:
                        self.owned.drop_redirect(k)
                        self.forget_lineage(k)
                head_events.append((k, reg))
                continue
            owner = get_hint(k)
            if owner is not None:
                to_owner.setdefault(owner, []).append((k, reg))
                if not reg:
                    from ray_tpu_torch.core.object_ref import local_ref_count

                    if local_ref_count(ObjectID(k)) == 0:
                        drop_hint(k)
                continue
            head_events.append((k, reg))
        if to_owner:
            with self._orq_lock:
                for owner, evs in to_owner.items():
                    self._owner_ref_queues.setdefault(owner, []).extend(evs)
        return head_events

    def _flush_owner_refs(self):
        with self._orq_lock:
            queues, self._owner_ref_queues = self._owner_ref_queues, {}
        for owner, evs in queues.items():
            try:
                self.get_conn(hint_addr(owner)).send({"op": "ref", "events": evs})
            except (ConnectionError, OSError):
                pass  # the owner is gone: its objects died with it

    # -- leases --
    def acquire_lease(self) -> Lease | None:
        client = self.client
        try:
            info = client.lease_worker()
        except Exception:
            return None
        if not info:
            return None
        try:
            conn = self.get_conn(tuple(info["addr"]))
        except Exception:
            try:
                client.release_lease(info["wid"])
            except Exception:
                pass
            return None
        lease = Lease(info["wid"], tuple(info["addr"]), conn)
        with self._leases_lock:
            self.leases.append(lease)
        return lease

    def pick_lease(self) -> Lease | None:
        self._lease_last_used = time.monotonic()
        with self._leases_lock:
            live = [l for l in self.leases if not l.conn.dead]
            self.leases = live
            if live:
                best = min(live, key=lambda l: l.conn.inflight)
                if best.conn.inflight < 64 or len(live) >= 8:
                    return best
        return self.acquire_lease() or (live[0] if live else None)

    def _release_idle_leases(self):
        now = time.monotonic()
        if now - self._lease_last_used < 2.0:
            return
        with self._leases_lock:
            leases, self.leases = self.leases, []
        for l in leases:
            if l.conn.inflight > 0:
                with self._leases_lock:
                    self.leases.append(l)
                continue
            try:
                self.client.release_lease(l.wid)
            except Exception:
                pass

    # -- housekeeping --
    def _housekeeping(self):
        while not self._stop_ev.wait(0.2 if self.client is not None else self.interval_s):
            try:
                self.pump()
            except Exception:  # noqa: BLE001 — the frees must go on after one bad pass; its traceback is reported
                traceback.print_exc()

    def pump(self):
        """One housekeeping pass: flush the queued borrow events to their
        owners, free what is due, release idle leases. With no runtime
        the pass first drains and routes this process's reference counts
        (a runtime's own loop does that: the head's ref GC loop, a
        worker's ref pump)."""
        if self.client is None:
            from ray_tpu_torch.core.object_ref import drain_ref_events

            self.route_ref_events(drain_ref_events())
        self._flush_owner_refs()
        self.owned.gc_pass()
        if self.client is not None:
            self._release_idle_leases()

    def shutdown(self):
        self._stopped = True
        self._stop_ev.set()
        self._hk.join(timeout=10.0)
        with self._leases_lock:
            leases, self.leases = self.leases, []
        for lease in leases:
            self.client.release_lease(lease.wid)
        if self.client is None:
            self.pump()  # the releases of refs dropped since the last pass reach their owners
        else:
            self._flush_owner_refs()
        if self.server is not None:
            self.server.shutdown()
        with self._conns_lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()
        self.owned.shutdown()
        with _hints_lock:
            _hints.clear()


# ---------------------------------------------------------------------------
# module-level state management
# ---------------------------------------------------------------------------
_state: DirectState | None = None


def state() -> DirectState | None:
    return _state


def attach(authkey: bytes, node_hex: str = "", client=None, serve: bool = True, exec_handler=None) -> DirectState:
    """Install this process's direct plane: the owned store, its server
    (which executes direct calls when ``exec_handler`` is given: a
    worker's) and the housekeeping thread; ``client`` is the runtime's
    client of this process, None for a plane with no runtime. Replaces a
    plane attached before and unlinks the segments of owners that died.
    Raises when the plane cannot start (no authkey, the plane switched off
    by RT_DIRECT_CALLS or RT_OBJECT_REF_COUNTING, the listener failing):
    nothing falls back."""
    global _state
    from ray_tpu_torch._config import get_config
    from ray_tpu_torch.core.object_ref import set_ref_counting
    from ray_tpu_torch.core.object_store import cleanup_orphan_segments

    if not isinstance(authkey, (bytes, bytearray)) or not authkey:
        raise ValueError("attach needs the plane's authkey (non-empty bytes)")
    cfg = get_config()
    if not cfg.direct_calls or not cfg.object_ref_counting:
        # the ownership model rides the borrow protocol: without reference
        # counting there is no owner-side free
        raise RuntimeError("the owned-object plane is switched off (RT_DIRECT_CALLS / RT_OBJECT_REF_COUNTING)")
    detach()
    cleanup_orphan_segments()
    set_ref_counting(True)
    _state = DirectState(bytes(authkey), node_hex=node_hex, client=client, serve=serve, exec_handler=exec_handler)
    return _state


def detach(client=None):
    """Shut the plane down (only when ``client`` is its client, if given):
    every owned object is freed (its segment unlinked), leases go back,
    connections close, the hints are forgotten."""
    global _state
    st = _state
    if st is None or (client is not None and st.client is not client):
        return
    _state = None
    st.shutdown()


# ---------------------------------------------------------------------------
# submit paths (called from api.py; None return = use the head path)
# ---------------------------------------------------------------------------
def raw_eligible(args, kwargs) -> bool:
    """Fast-path eligibility: args ride the call frame as plain values (a
    single pickle for the whole frame — no per-arg Serialized/ArgSpec
    machinery, no separate blob). Top-level ObjectRefs are excluded (they
    need resolve-before-call semantics); nested ObjectRefs are fine —
    __reduce__ reports them to the active sink for pinning and carries
    their owner hints. Cloudpickle-only/oversized values are caught at
    frame-serialize time (the submit falls back to the ArgSpec path)."""
    for a in args:
        if isinstance(a, _ObjRef):
            return False
    if kwargs:
        for v in kwargs.values():
            if isinstance(v, _ObjRef):
                return False
    return True


def _dump_raw_frame(st, frame) -> tuple[bytes, list | None] | None:
    """Serialize a raw-args call frame in ONE pass, collecting nested-ref
    pins via the serialization sink. None = ineligible (unpicklable
    content or too large for inline transport): the ArgSpec path decides.
    The standard library's pickle, host tensors in band (the port sends
    code by reference: ``core/serialization.py``)."""
    from ray_tpu_torch.core import object_ref as _oref
    from ray_tpu_torch.core.serialization import dumps_inband

    sink: list = []
    token = _oref.push_ref_sink(sink)
    try:
        data = dumps_inband(frame)
    except (pickle.PicklingError, TypeError, AttributeError):
        return None  # the ArgSpec path pickles it or reports the error
    finally:
        _oref.pop_ref_sink(token)
    if len(data) > st.inline_threshold + 4096:
        return None
    pins = [_ObjRef(i) for i in sink] if sink else None
    return data, pins


def _direct_ok(options: dict | None) -> bool:
    o = options or {}
    if o.get("num_returns") in ("streaming", "dynamic"):
        return False
    if o.get("num_cpus") not in (None, 1, 1.0):
        return False  # a lease is exactly one CPU
    for k in ("placement_group", "scheduling_strategy", "runtime_env", "label_selector", "_node_id", "resources",
              "num_tpus", "num_gpus", "memory"):
        if o.get(k):
            return False
    return True


def try_actor_call(client, actor_id, method_name: str, arg_specs, kw_specs, options: dict | None, pins=None, raw=None):
    """Direct actor call (pre-encoded ArgSpecs, or a raw pack_raw blob).
    Returns list[ObjectRef] or None (= head path). The caller OWNS the
    returns (inline results live in this process)."""
    st = _state
    if st is None or st.server is None or not _direct_ok(options):
        return None
    from ray_tpu_torch.core import rpc_chaos

    if not rpc_chaos.apply("direct_call"):
        return None  # chaos: degrade to the head path
    actor_hex = actor_id.hex()
    route = st.route(actor_hex)
    with route.lock:
        addr = route.addr
    if addr is None:
        try:
            ep = client.actor_endpoint(actor_hex)
        except Exception:
            return None
        if not ep or not ep.get("addr"):
            return None  # api fallback marks the route head-dirty
        with route.lock:
            route.addr = tuple(ep["addr"])
            route.epoch = ep.get("epoch", 0)
            route.max_task_retries = ep.get("max_task_retries", 0)
            addr = route.addr
    # lane fence: if we sent head-lane calls to this actor since the last
    # direct call, wait for them to finish so per-caller ordering holds
    if route.head_dirty:
        try:
            rids = client.submit_actor_task(actor_id=actor_id, method_name="__ray_ready__", args=[], kwargs={}, num_returns=1, streaming=False, options={})
            client.get_object(rids[0], timeout=60.0)
        except Exception:
            pass  # actor death surfaces on the direct call below
        route.head_dirty = False
    try:
        conn = st.get_conn(addr)
    except Exception:
        with route.lock:
            route.addr = None
        return None
    nr = int((options or {}).get("num_returns", 1) or 1)
    tid = TaskID.from_random()
    oids = [ObjectID.for_task_return(tid, i) for i in range(nr)]
    frame = {
        "op": "call",
        "actor": actor_id.binary(),
        "method": method_name,
        "task": tid.binary(),
        "num_returns": nr,
        "trace": (options or {}).get("_trace_ctx"),
    }
    data = None
    if raw is not None:
        frame["cid"] = conn.reserve_cid()
        frame["argv"], frame["kwargv"] = raw
        packed = _dump_raw_frame(st, frame)
        if packed is None:
            return None  # unpicklable/oversized: ArgSpec path next
        data, pins = packed
        raw = data  # failover resubmits from this snapshot
    else:
        frame["args"] = arg_specs
        frame["kwargs"] = kw_specs
    for oid in oids:
        st.owned.create_pending(oid.binary())
    rec = _CallRec(
        "actor", actor_hex, tid, oids, method_name, None, arg_specs, kw_specs, nr,
        route.max_task_retries, (options or {}).get("_trace_ctx"), pins=pins, raw=raw,
    )
    with route.lock:
        route.inflight_recs += 1
        route.drained.clear()
    try:
        conn.send_call(rec, frame, data)
    except ConnectionError:
        # conn-death failover only covers recs that made it into _calls;
        # a conn that died BEFORE registration would leave the oids
        # PENDING forever (ray.get hangs) — fail over here instead
        if not rec.registered:
            threading.Thread(target=st._failover, args=(rec,), daemon=True).start()
        # else: failover path completes the pending entries
    return _owned_refs(st, oids)


def try_task_call(client, name: str, func_id: str, blob, arg_specs, kw_specs, options: dict | None, pins=None, raw=None):
    """Direct stateless-task submission onto a leased worker (pre-encoded
    ArgSpecs, or a raw pack_raw blob)."""
    st = _state
    if st is None or st.server is None or not _direct_ok(options):
        return None
    o = options or {}
    if o.get("retry_exceptions"):
        return None  # app-level retry policies stay on the head path
    if o.get("max_retries") == 0:
        # non-retriable tasks run head-supervised: the head pins them and
        # the OOM killer's victim policy spares them (a leased worker is
        # always a retriable victim)
        return None
    from ray_tpu_torch.core import rpc_chaos

    if not rpc_chaos.apply("direct_call"):
        return None
    if blob is not None:
        st.func_blobs[func_id] = blob
    elif func_id not in st.func_blobs:
        return None  # no blob available to teach a leased worker
    lease = st.pick_lease()
    if lease is None:
        return None
    nr = int(o.get("num_returns", 1) or 1)
    tid = TaskID.from_random()
    oids = [ObjectID.for_task_return(tid, i) for i in range(nr)]
    frame = {
        "op": "call",
        "actor": None,
        "method": name,
        "func_id": func_id,
        "task": tid.binary(),
        "num_returns": nr,
        "trace": o.get("_trace_ctx"),
    }
    data = None
    if raw is not None:
        frame["cid"] = lease.conn.reserve_cid()
        frame["argv"], frame["kwargv"] = raw
        packed = _dump_raw_frame(st, frame)
        if packed is None:
            return None  # unpicklable/oversized: ArgSpec path next
        data, pins = packed
        raw = data  # failover resubmits from this snapshot
    else:
        frame["args"] = arg_specs
        frame["kwargs"] = kw_specs
    for oid in oids:
        st.owned.create_pending(oid.binary())
    retries = o.get("max_retries")
    if retries is None:
        retries = st.default_max_retries
    rec = _CallRec("task", None, tid, oids, name, func_id, arg_specs, kw_specs, nr, retries, o.get("_trace_ctx"), pins=pins, raw=raw)
    try:
        lease.conn.ensure_func(func_id, st.func_blobs[func_id])
        lease.conn.send_call(rec, frame, data)
    except ConnectionError:
        # ensure_func can raise before the rec is registered (and
        # send_call before registration on an already-dead conn): those
        # recs are invisible to conn-death failover — resubmit here
        if not rec.registered:
            threading.Thread(target=st._failover, args=(rec,), daemon=True).start()
        # else: failover resubmits via the head
    return _owned_refs(st, oids)


def _owned_refs(st: DirectState, oids):
    from ray_tpu_torch.core.object_ref import ObjectRef

    return [ObjectRef(oid, owner_hint=st.self_owner) for oid in oids]


def head_lane_submit(actor_id):
    """Mark an actor's route head-dirty (a head-path call was submitted);
    drain in-flight direct calls first so ordering holds."""
    st = _state
    if st is None:
        return
    route = st.route(actor_id.hex())
    route.head_dirty = True
    route.drained.wait(timeout=60.0)  # best effort: a stuck direct call stalls the actor too


# ---------------------------------------------------------------------------
# owned puts
# ---------------------------------------------------------------------------
def try_put(value):
    """Owner-local put for small values. Returns (ObjectRef, None) or
    (None, Serialized): the Serialized is handed back so the head path
    does not serialize again (its contained owned refs are promoted
    already). A value above the inline threshold is the head's."""
    from ray_tpu_torch.core.payloads import encode_serialized
    from ray_tpu_torch.core.serialization import serialize

    st = _state
    if st is None or st.server is None:
        _head("a put with no owned-object plane")
        return None, serialize(value)
    s = serialize(value)
    if s.total_size() > st.inline_threshold:
        client = _head(f"a head-owned put of {s.total_size()} bytes")
        promote_contained(client, s)
        return None, s
    payload = encode_serialized(s)
    oid = ObjectID.from_put()
    st.owned.put_ready(oid.binary(), payload, contained=list(s.contained_refs))
    return _ObjRef(oid, owner_hint=st.self_owner), None


def put_owned(value) -> _ObjRef:
    """Owner-local put with NO size cap: the large-buffer publish path.

    For transient multi-MB state whose lifetime IS its producer's (a KV
    handoff, a checkpoint, a prefix block): the bytes land in a
    shared-memory segment, the descriptor-bearing payload stays in THIS
    process's OwnedStore, and borrowers on the same host map the segment
    without the bytes ever crossing a socket. Freed on the last
    borrow-release (leak backstop: RT_OWNED_OBJECT_LEAK_BACKSTOP_S for
    borrowers that died before registering). The object dies with its
    owner: callers treat ObjectLostError as "re-produce or fail"."""
    from ray_tpu_torch import chaos
    from ray_tpu_torch.core.payloads import encode_serialized
    from ray_tpu_torch.core.serialization import serialize

    st = _state
    if st is None:
        raise RuntimeError("put_owned needs the direct plane (call ray_tpu_torch.init or ray_tpu_torch.core.direct.attach first)")
    # chaos site: object-plane publish faults (one flag check when unarmed)
    if not chaos.apply("direct.put_owned"):
        raise RuntimeError("chaos: put_owned dropped")
    s = serialize(value)
    payload = encode_serialized(s)
    oid = ObjectID.from_put()
    st.owned.put_ready(oid.binary(), payload, contained=list(s.contained_refs))
    return _ObjRef(oid, owner_hint=st.self_owner)


# ---------------------------------------------------------------------------
# get/wait/free interception
# ---------------------------------------------------------------------------
def maybe_get_owned(obj_id: ObjectID, timeout: float | None = None, zero_copy: bool = False):
    """(handled, value) for owned or remote-owned objects; handled=False
    for an id this plane neither owns nor has a hint for, or one promoted
    to the head: the caller's head path. ``zero_copy`` decodes shm
    payloads as views into a private mapping of the segment (see
    get_owned_view)."""
    st = _state
    k = obj_id.binary()
    if st is not None:
        e = st.owned.entry(k)
        if e is not None:
            if e.state == PENDING:
                e = st.owned.wait_entry(k, timeout)
                if e is None:
                    raise ObjectLostError(f"object {obj_id.hex()[:16]} was freed by its owner")
                if e.state == PENDING:
                    raise GetTimeoutError(f"get() timed out waiting for {obj_id.hex()[:16]}")
            if e.state == ERROR:
                raise e.error
            if e.state == VALUE:
                return True, e.value
            if e.state == READY:
                return True, _decode(e.payload, zero_copy=zero_copy)
            return False, None  # REDIRECT: the head owns it now
        if st.owned.was_freed(k):
            raise ObjectLostError(f"object {obj_id.hex()[:16]} was freed by its owner")
    owner = get_hint(k)
    if owner is not None and st is not None:
        try:
            # the slot's timeout sits above the wire's, so the owner's own
            # timeout reply names the failure
            resp = st.get_conn(hint_addr(owner)).request_get(k, timeout)
        except (ConnectionError, OSError):
            drop_hint(k)
            raise ObjectLostError(f"object {obj_id.hex()[:16]}: owner process at {owner} is gone "
                                  "(owned objects die with their owner)") from None
        if resp.get("not_owned"):
            drop_hint(k)
            if st.client is None:
                # no head to have taken it: its owner freed it
                raise ObjectLostError(f"object {obj_id.hex()[:16]} was freed by its owner at {owner}")
            return False, None  # promoted to the head meanwhile
        if resp.get("error") is not None:
            raise resp["error"]
        return True, _decode(resp["payload"], zero_copy=zero_copy)
    return False, None


def _decode(payload: Payload, zero_copy: bool = False):
    from ray_tpu_torch.core.payloads import decode_payload

    v, _seg = decode_payload(payload, zero_copy=zero_copy)
    if isinstance(v, BaseException):
        raise v
    return v


def get_owned_view(obj_id: ObjectID, timeout: float | None = None):
    """Zero-copy get of an owned or borrowed object: an shm payload
    decodes as views into a private, copy-on-write mapping of the
    segment, so the borrow path never copies the bytes (the reply frame
    carries only the descriptor) and a write into a fetched tensor stays
    in the reader's memory. The mapping outlives a later owner-side unlink
    (POSIX shm semantics), so a view held past the borrow-release stays
    valid.

    The large-buffer read half of ``put_owned``. Raises ObjectLostError
    when the object's owner freed it or is gone, GetTimeoutError on a
    bounded wait; an id this plane neither owns nor has a hint for is the
    head's (a copying get; RuntimeError in a process with no runtime)."""
    from ray_tpu_torch import chaos

    # chaos site: owned-object loss at the borrow-get; a drop IS the loss
    # signal the bounded-retry consumers absorb
    if not chaos.apply("direct.get_owned_view"):
        raise ObjectLostError(f"chaos: owned object {obj_id.hex()[:16]} lost")
    handled, value = maybe_get_owned(obj_id, timeout=timeout, zero_copy=True)
    if handled:
        return value
    client = _head(f"a get of object {obj_id.hex()[:16]}, which this process neither owns nor has an owner hint for,")
    return client.get_object(obj_id, timeout=timeout)


def is_owned_or_hinted(k: bytes) -> bool:
    st = _state
    if st is not None and st.owned.owns(k):
        return True
    return get_hint(k) is not None


def _owned_ready_local(k: bytes) -> bool | None:
    """Readiness from the LOCAL owned table only (dict lookup, no
    network); None = this process can't answer locally (hinted-remote or
    unknown id)."""
    st = _state
    if st is not None:
        e = st.owned.entry(k)
        if e is not None and e.state != REDIRECT:
            return e.state != PENDING
    return None


def owned_ready(k: bytes, poll_timeout: float | None = None) -> bool | None:
    """True/False readiness for an owned/hinted id; None = not ours.
    Remote-owned ids poll the owner (a borrowed ref to an in-flight
    direct result must not report ready early).

    ``poll_timeout`` set means the CALLER is deadline-bounded
    (wait_mixed passes its remaining budget): a poll timeout reports
    not-ready so a small-timeout ray.wait never blocks ~10s on one slow
    owner. Unbounded callers (executor's entry_size probe) keep the
    legacy behavior — a timed-out poll reports ready so the downstream
    get() surfaces the owner's true state instead of stalling forever on
    a blackholed host."""
    st = _state
    local = _owned_ready_local(k)
    if local is not None:
        return local
    owner = get_hint(k)
    if owner is not None:
        if st is None:
            return True
        try:
            resp = st.get_conn(hint_addr(owner)).request(
                "poll", timeout=10.0 if poll_timeout is None else poll_timeout, id=k
            )
            return bool(resp.get("ready", True))
        except GetTimeoutError:
            if poll_timeout is not None:
                return False  # slow owner: not-ready, never block past the deadline
            return True  # unbounded caller: let get() surface the owner state
        except Exception:
            return True  # owner gone: get() surfaces the real error
    return None


def wait_mixed(client, obj_ids, num_returns: int, timeout: float | None, fallback):
    """ray.wait over a mix of owned and head-tracked ids. `fallback` is the
    client's head-path wait_ready."""
    ids = list(obj_ids)
    deadline = None if timeout is None else time.monotonic() + timeout

    def _poll_t() -> float | None:
        # owner polls must respect the caller's remaining budget (a
        # ray.wait(timeout=0.1) blocking 10s per slow owner violates
        # wait semantics); floor keeps a near-expired wait from turning
        # the poll into a busy no-op. An UNBOUNDED wait passes None so
        # owned_ready keeps its legacy ready-on-poll-timeout escape — a
        # blackholed owner must not spin this loop forever, and the
        # follow-up get() surfaces the owner's true state.
        if deadline is None:
            return None
        return max(0.05, min(10.0, deadline - time.monotonic()))

    # classification is local (owned table + hint map, no network): the
    # per-id readiness POLLS belong to the loop below, where they are
    # deadline-bounded — polling here would let a slow owner eat the whole
    # budget before the wait even starts
    split = [is_owned_or_hinted(o.binary() if hasattr(o, "binary") else o) or None for o in ids]
    if all(s is None for s in split):
        return fallback(ids, num_returns, timeout)
    known_ready: set = set()  # readiness is sticky: poll each id once
    delay = 0.002
    while True:
        # ids no owner answers for go to the head's store: those the head
        # tracks, and owned ones whose large result the worker sealed in
        # the head's store while this wait ran (REDIRECT)
        ready, not_ready, head_ids = [], [], []
        for o in ids:
            if o in known_ready:
                ready.append(o)
                continue
            k = o.binary() if hasattr(o, "binary") else o
            # the local owned-table check is a dict lookup and ALWAYS
            # runs — even at timeout=0, ray.wait must see an
            # already-completed local result; only the networked owner
            # poll is gated on remaining budget (one slow owner must not
            # make the round overshoot by a floor-poll per remaining id)
            s = _owned_ready_local(k)
            if s is None:
                if deadline is not None and time.monotonic() >= deadline:
                    head_ids.append(o)  # no owner poll past the deadline; the head's store answers at once
                    continue
                s = owned_ready(k, poll_timeout=_poll_t())
            if s is True:
                known_ready.add(o)
                ready.append(o)
            elif s is False:
                not_ready.append(o)
            else:
                head_ids.append(o)
        head_ready = []
        if head_ids:
            t = 0.05 if deadline is None else max(0.0, min(0.05, deadline - time.monotonic()))
            hr, _ = fallback(head_ids, len(head_ids), t)
            head_ready = hr
        ready.extend(head_ready)
        # preserve input order; cap at num_returns (ray.wait semantics:
        # extra ready refs stay in the not-ready list for the next call)
        want = min(num_returns, len(ids))
        ordered_ready = [o for o in ids if o in ready][:want]
        ordered_not = [o for o in ids if o not in ordered_ready]
        if len(ordered_ready) >= want:
            return ordered_ready, ordered_not
        if deadline is not None and time.monotonic() >= deadline:
            return ordered_ready, ordered_not
        time.sleep(delay)
        delay = min(delay * 1.5, 0.05)  # back off: long waits stop spinning


def free_owned(obj_ids) -> list:
    """Free owned ids locally / at their owner; return the rest for the
    head path."""
    st = _state
    rest = []
    owner_frees: dict[str, list] = {}
    for o in obj_ids:
        k = o.binary() if hasattr(o, "binary") else o
        if st is not None and st.owned.owns(k):
            st.owned.free(k)
            continue
        owner = get_hint(k)
        if owner is not None and st is not None:
            owner_frees.setdefault(owner, []).append(k)
            drop_hint(k)
            continue
        rest.append(o)
    for owner, ks in owner_frees.items():
        try:
            st.get_conn(hint_addr(owner)).send({"op": "free", "ids": ks})
        except Exception:
            pass
    return rest


def add_done_callback_owned(obj_id: ObjectID, cb) -> bool:
    """Wire a done callback for an owned id; returns False if not owned."""
    st = _state
    k = obj_id.binary()
    if st is None:
        return False
    e = st.owned.entry(k)
    if e is None or e.state == REDIRECT:
        if get_hint(k) is not None:
            def _fetch():
                try:
                    handled, v = maybe_get_owned(obj_id)
                    cb(v, None) if handled else cb(None, ObjectLostError("owner lost"))
                except BaseException as err:  # noqa: BLE001
                    cb(None, err)

            threading.Thread(target=_fetch, daemon=True).start()
            return True
        return False

    def _deliver():
        try:
            handled, v = maybe_get_owned(obj_id)
            if handled:
                cb(v, None)
            else:
                try:
                    cb(st.client.get_object(obj_id), None)
                except BaseException as err:  # noqa: BLE001
                    cb(None, err)
        except BaseException as err:  # noqa: BLE001
            cb(None, err)

    if not st.owned.add_callback(k, lambda: threading.Thread(target=_deliver, daemon=True).start()):
        return False
    return True


def owned_location(k: bytes) -> str | None:
    """Node hex for owned/hinted ids (locations API)."""
    st = _state
    if st is not None and st.owned.owns(k):
        return st.node_hex or None
    owner = get_hint(k)
    if owner is not None:
        return hint_node_hex(owner)
    return None


# ---------------------------------------------------------------------------
# promotion: hand an owned object to the head before a head-path submit
# ---------------------------------------------------------------------------
def promote(client, k: bytes) -> bool:
    """Move an owned object into the head store so head-side pinning,
    lineage and locations all see it. Idempotent. ``client`` None: this
    process's runtime (RuntimeError when it has none)."""
    st = _state
    if st is None:
        return False
    if client is None:
        client = _head("promoting an owned object")
    oid = ObjectID(k)
    if st is not None:
        e = st.owned.entry(k)
        if e is not None:
            if e.state == REDIRECT:
                return True
            if e.state == PENDING:
                e = st.owned.wait_entry(k, 120.0)
                if e is None:
                    raise ObjectLostError(f"object {oid.hex()[:16]} was freed by its owner")
            if e.state == ERROR:
                payload = _encode_err(e.error)
            elif e.state == VALUE:
                from ray_tpu_torch.core.payloads import encode_value

                payload = encode_value(e.value, obj_id=oid)
            elif e.state == READY:
                payload = e.payload
            else:
                return False
            _put_payload(client, oid, payload)
            st.owned.complete(k, redirect=True)
            drop_hint(k)
            return True
    owner = get_hint(k)
    if owner is None:
        return False
    try:
        resp = st.get_conn(hint_addr(owner)).request("get", timeout=120.0, id=k)
    except (ConnectionError, OSError):
        drop_hint(k)
        raise ObjectLostError(f"object {oid.hex()[:16]}: owner at {owner} is gone") from None
    if resp.get("not_owned"):
        drop_hint(k)
        return True  # already at the head
    if resp.get("error") is not None:
        payload = _encode_err(resp["error"])
    else:
        payload = resp["payload"]
    _put_payload(client, oid, payload)
    drop_hint(k)
    return True


def _encode_err(err):
    from ray_tpu_torch.core.payloads import encode_value

    return encode_value(err)


def _put_payload(client, oid: ObjectID, payload: Payload):
    if hasattr(client, "put_payload"):
        client.put_payload(oid, payload)
    else:
        client.call("put_object", obj_id=oid, payload=payload)


def promote_argspecs(client, arg_specs, kw_specs):
    """Before a head-path submit: promote every owned ref appearing as a
    top-level arg or contained inside an inline payload."""
    st = _state
    if st is None:
        return
    for a in list(arg_specs or []) + list((kw_specs or {}).values()):
        if a.ref is not None and is_owned_or_hinted(a.ref.binary()):
            promote(client, a.ref.binary())
            a.owner = None  # now head-owned; resolve via the store
        if a.payload is not None:
            for c in a.payload.contained or []:
                if is_owned_or_hinted(c.binary()):
                    promote(client, c.binary())


def promote_contained(client, serialized):
    """Promote owned refs contained in a value headed for the head store."""
    st = _state
    if st is None:
        return
    for r in serialized.contained_refs:
        if is_owned_or_hinted(r.id.binary()):
            promote(client, r.id.binary())


def try_reconstruct(client, obj_id: ObjectID) -> bool:
    """Owner-side lineage replay hook for client get paths: called when
    the head reports a head-sealed direct result lost."""
    st = _state
    if st is None:
        return False
    try:
        return st.reconstruct(client, obj_id)
    except Exception:
        return False


def cancel_owned(client, obj_id: ObjectID, force: bool = False) -> bool:
    """Cancel an in-flight direct call producing obj_id. Cooperative: the
    executing worker checks a cancelled set before starting. force=True
    additionally asks the head to terminate a LEASED worker (the direct
    analogue of cancel_task(force=True)); the conn death then fails the
    call over, where the cancelled mark turns it into a cancel error
    instead of a retry. Returns True when handled; False = not a live
    direct call of ours (caller falls through to the head path)."""
    st = _state
    if st is None:
        return False
    k = obj_id.binary()
    e = st.owned.entry(k)
    if e is None or e.state != PENDING:
        return False
    tid = obj_id.task_id().binary()
    with st._conns_lock:
        conns = list(st._conns.values())
    for c in conns:
        with c._lock:
            recs = list(c._calls.values())
        for rec in recs:
            if rec.task_id.binary() == tid:
                rec.cancelled = True
                try:
                    c.send({"op": "cancel", "task": tid})
                except Exception:
                    pass
                if force and rec.kind == "task":
                    with st._leases_lock:
                        wid = next((l.wid for l in st.leases if l.conn is c), None)
                    if wid is not None:
                        try:
                            client.terminate_leased_worker(wid)
                        except Exception:
                            pass
                return True
    return False
