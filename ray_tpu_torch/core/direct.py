"""The owned-object plane (port of ray_tpu/core/direct.py, its owned
subset): values owned by the process that made them, served to borrowers
in other processes over an authenticated TCP connection, and freed when
the last reference anywhere is gone.

- **The owner** keeps each value, or the descriptor of its shared-memory
  segment, in its ``OwnedStore``. A large value's bytes never cross the
  socket: the reply carries the descriptor and a borrower on the same host
  maps the segment (``get_owned_view``, zero-copy).
- **Borrowing.** A ref pickled out of its owner carries the owner's
  address (its hint). The receiving process's reference counts register a
  borrow with the owner and release it when its last ref dies; the
  housekeeping thread, every ``ref_counting_interval_s``, drains this
  process's count transitions, applies its own objects' locally, sends the
  others' to their owners, and frees owned entries whose local count and
  borrows are zero past the grace window (or the leak backstop while a
  serialized-out copy may still be about to register).
- **Failure.** An owned object dies with its owner: a get whose owner is
  gone raises ObjectLostError. ``free_owned`` frees at once, wherever the
  object lives.

Wire protocol: length-prefixed pickled dicts over TCP, each connection
opened with an HMAC challenge and response on the plane's authkey. The
authkey is explicit (``attach(authkey)``): a process that borrows gets it
from whoever started it.

There is no head in the port. ray_tpu falls through to its head for an
id the plane neither owns nor has a hint for, for an entry promoted to the
head (REDIRECT), for ``promote`` and for ``try_put`` of a large value;
each of those raises NotImplementedError here, naming the runtime's
ROADMAP.md item. Direct calls, leases, actor routes and lineage wait for
the same item; a ``call`` frame is answered with the TaskError ray_tpu
sends from a process that executes no calls.
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

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef as _ObjRef
from ray_tpu_torch.core.task_spec import Payload
from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError, TaskError

_MAX_FRAME = 256 << 20

# the ROADMAP.md item that everything ray_tpu routes through its head waits for
RUNTIME_ITEM = "queue 1, the runtime"


def _needs_runtime(what: str):
    raise NotImplementedError(f"{what} goes through ray_tpu's head, which is not ported to ray_tpu_torch yet "
                              f"(ROADMAP.md, {RUNTIME_ITEM})")


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
        # ObjectLostError, the answer ray_tpu's head gives for a freed
        # owned object
        self._freed: dict[bytes, None] = {}
        self.grace_s = grace_s
        self.backstop_s = max(backstop_s, grace_s)

    def __contains__(self, k: bytes) -> bool:
        with self._lock:
            return k in self._objects

    def owns(self, k: bytes) -> bool:
        """True when this process is the live owner (REDIRECT entries were
        handed to ray_tpu's head)."""
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


def mark_serialized_out(k: bytes):
    """``ObjectRef.__reduce__``'s hook: if this process owns the id, the
    owned store now waits for the borrow-release instead of the grace
    timer (see OwnedStore). A pickle that never leaves the process (a
    deepcopy) costs at most the backstop window before the free, never a
    leak."""
    st = _state
    if st is not None and st.owned.owns(k):
        st.owned.mark_serialized(k)


def drop_hint(k: bytes):
    with _hints_lock:
        _hints.pop(k, None)


def hint_addr(owner: str) -> tuple[str, int]:
    hp = owner.split("#", 1)[0]
    host, port = hp.rsplit(":", 1)
    return (host, int(port))


# ---------------------------------------------------------------------------
# client side: one persistent connection to a peer
# ---------------------------------------------------------------------------
class PeerConn:
    """Client half of one direct connection: pipelined requests and a
    reader thread completing the blocking slots."""

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
        self._slots: dict[int, list] = {}  # cid -> [Event, reply] of a blocking request
        self.dead = False
        self.last_used = time.monotonic()
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

    def request(self, op: str, timeout: float | None = None, _fields: dict | None = None, **fields) -> dict:
        """Blocking request/response. ``timeout`` bounds the local wait;
        ``fields`` ride the frame. A frame field whose name collides with a
        parameter here (the server-side "timeout" a bounded GET carries)
        goes through ``_fields``."""
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
        """GET an owned object: the owner waits out a PENDING entry with
        OUR timeout (None = as long as it takes, like a local get)."""
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
                if msg.get("op") == "value":
                    with self._lock:
                        slot = self._slots.pop(msg["cid"], None)
                    if slot is not None:
                        slot[1] = msg
                        slot[0].set()
                # other ops (ray_tpu's call results) are not sent to this port
        except (ConnectionError, OSError, EOFError, pickle.UnpicklingError):
            pass  # the death is handled below: every waiting slot fails
        finally:
            self._on_death()

    def _on_death(self):
        with self._lock:
            if self.dead:
                return
            self.dead = True
            slots, self._slots = self._slots, {}
        try:
            self.sock.close()
        except OSError:
            pass
        for slot in slots.values():
            slot[1] = ConnectionError("direct peer died")
            slot[0].set()
        self.state.on_conn_death(self)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------
class DirectServer:
    """Listener serving this process's owned objects: GETs, readiness
    polls, borrow events and frees."""

    def __init__(self, state: "DirectState"):
        self.state = state
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(128)
        adv = os.environ.get("RT_DIRECT_HOST") or "127.0.0.1"
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
            try:
                _send_frame(conn, _dumps(msg), wlock)
            except (OSError, ValueError):
                pass  # the client is gone: it owes us nothing

        try:
            while not self._stopped.is_set():
                msg = _recv_frame(rf)
                op = msg.get("op")
                if op == "call":
                    reply({"op": "result", "cid": msg["cid"], "returns": [],
                           "error": TaskError(tb_str="this process does not execute direct calls",
                                              task_desc=msg.get("method", ""))})
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
                elif op == "ping":
                    reply({"op": "value", "cid": msg["cid"], "payload": None})
        except (ConnectionError, OSError, EOFError, pickle.UnpicklingError):
            pass  # a vanished client owes us nothing
        finally:
            conn.close()

    def _serve_get(self, msg: dict, reply):
        k = msg["id"]
        e = self.state.owned.entry(k)
        if e is not None and e.state == PENDING:
            # a long wait gets its own thread, so pending GETs can never
            # starve the fixed server pool
            threading.Thread(target=self._serve_get_blocking, args=(msg, reply), daemon=True,
                             name="rt-direct-getwait").start()
            return
        self._serve_get_blocking(msg, reply)

    def _serve_get_blocking(self, msg: dict, reply):
        k = msg["id"]
        e = self.state.owned.wait_entry(k, msg.get("timeout"))  # None: as long as the caller waits
        if e is None or e.state == REDIRECT:
            reply({"op": "value", "cid": msg["cid"], "payload": None, "not_owned": True})
        elif e.state == PENDING:
            reply({"op": "value", "cid": msg["cid"], "payload": None,
                   "error": GetTimeoutError("owner-side wait timed out")})
        elif e.state == ERROR:
            reply({"op": "value", "cid": msg["cid"], "payload": None, "error": e.error})
        elif e.state == VALUE:
            from ray_tpu_torch.core.payloads import encode_value

            reply({"op": "value", "cid": msg["cid"], "payload": encode_value(e.value)})
        else:
            reply({"op": "value", "cid": msg["cid"], "payload": e.payload})

    def _on_ref_events(self, events):
        """Borrow register/release for objects we own. Events for ids this
        process no longer owns (freed meanwhile) are dropped: ray_tpu
        forwards them to its head's holder table, which the port lacks."""
        owned = self.state.owned
        for kb, reg in events:
            if kb in owned:
                owned.on_borrow(kb, reg)

    def shutdown(self):
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# per-process direct state
# ---------------------------------------------------------------------------
class DirectState:
    MAX_CONNS = 256

    def __init__(self, authkey: bytes, node_hex: str = ""):
        from ray_tpu_torch._config import get_config

        cfg = get_config()
        self.authkey = authkey
        self.node_hex = node_hex
        self.owned = OwnedStore(grace_s=cfg.owned_object_grace_s, backstop_s=cfg.owned_object_leak_backstop_s)
        self.server = DirectServer(self)
        self.self_owner = f"{self.server.address[0]}:{self.server.address[1]}#{node_hex}"
        self._conns: dict[tuple, PeerConn] = {}
        self._conns_lock = threading.Lock()
        self._owner_ref_queues: dict[str, list] = {}  # owner -> pending ref events
        self._orq_lock = threading.Lock()
        self._stopped = threading.Event()
        self.interval_s = cfg.ref_counting_interval_s
        self.inline_threshold = cfg.max_direct_call_object_size
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
                idle = sorted((x for x in self._conns.values() if x is not c), key=lambda x: x.last_used)
                for x in idle[: len(self._conns) - self.MAX_CONNS]:
                    self._conns.pop(x.addr, None)
                    x.close()
        return c

    def on_conn_death(self, conn: PeerConn):
        with self._conns_lock:
            if self._conns.get(conn.addr) is conn:
                self._conns.pop(conn.addr, None)

    # -- ref-event routing (the owner half of the borrow protocol) --
    def route_ref_events(self, events: list[tuple[bytes, bool]]) -> list[tuple[bytes, bool]]:
        """Split this process's local-count transitions: events of objects
        WE own apply locally; events of remote-owned objects queue to their
        owner. Returns the rest (ray_tpu's head-tracked ids: none of the
        port's)."""
        from ray_tpu_torch.core.object_ref import local_ref_count

        rest = []
        to_owner: dict[str, list] = {}
        for k, reg in events:
            if self.owned.owns(k):
                if reg:
                    self.owned.on_local_reregister(k)
                else:
                    self.owned.on_local_zero(k)
                continue
            owner = get_hint(k)
            if owner is not None:
                to_owner.setdefault(owner, []).append((k, reg))
                if not reg and local_ref_count(ObjectID(k)) == 0:
                    drop_hint(k)
                continue
            rest.append((k, reg))
        if to_owner:
            with self._orq_lock:
                for owner, evs in to_owner.items():
                    self._owner_ref_queues.setdefault(owner, []).extend(evs)
        return rest

    def _flush_owner_refs(self):
        with self._orq_lock:
            queues, self._owner_ref_queues = self._owner_ref_queues, {}
        for owner, evs in queues.items():
            try:
                self.get_conn(hint_addr(owner)).send({"op": "ref", "events": evs})
            except (ConnectionError, OSError):
                pass  # the owner is gone: its objects died with it

    # -- housekeeping: ray_tpu's driver ref-drain loop and its direct
    # housekeeping, one thread --
    def _housekeeping(self):
        while not self._stopped.wait(self.interval_s):
            try:
                self.pump()
            except Exception:  # noqa: BLE001 — the frees must go on after one bad pass; its traceback is reported
                traceback.print_exc()

    def pump(self):
        """One housekeeping pass: route the drained ref events, flush them
        to their owners, free what is due."""
        from ray_tpu_torch.core.object_ref import drain_ref_events

        self.route_ref_events(drain_ref_events())
        self._flush_owner_refs()
        self.owned.gc_pass()

    def shutdown(self):
        self._stopped.set()
        self._hk.join(timeout=10.0)
        self.pump()  # the releases of refs dropped since the last pass reach their owners
        self.server.shutdown()
        with self._conns_lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()
        self.owned.shutdown()
        with _hints_lock:
            _hints.clear()


# ---------------------------------------------------------------------------
# module-level state
# ---------------------------------------------------------------------------
_state: DirectState | None = None


def state() -> DirectState | None:
    return _state


def attach(authkey: bytes, node_hex: str = "") -> DirectState:
    """Install this process's owned-object plane: the owned store, its
    server and the housekeeping thread. Replaces a plane attached before.
    Unlinks the segments of owners that died first. Raises when the plane
    cannot start (no authkey, the plane switched off by RT_DIRECT_CALLS or
    RT_OBJECT_REF_COUNTING, the listener failing): nothing falls back."""
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
    _state = DirectState(bytes(authkey), node_hex=node_hex)
    return _state


def detach():
    """Shut the plane down: every owned object is freed (its segment
    unlinked), connections close, the hints are forgotten."""
    global _state
    st, _state = _state, None
    if st is not None:
        st.shutdown()


# ---------------------------------------------------------------------------
# owned puts
# ---------------------------------------------------------------------------
def try_put(value):
    """Owner-local put of a small value: (ObjectRef, None). ray_tpu keeps
    anything above the inline threshold head-owned; that path raises here
    (use ``put_owned`` for large values)."""
    from ray_tpu_torch.core.payloads import encode_serialized
    from ray_tpu_torch.core.serialization import serialize

    st = _state
    if st is None:
        _needs_runtime("a put without an attached owned-object plane")
    s = serialize(value)
    if s.total_size() > st.inline_threshold:
        _needs_runtime(f"a head-owned put of {s.total_size()} bytes")
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
        raise RuntimeError("put_owned needs the direct plane (call ray_tpu_torch.core.direct.attach first)")
    # chaos site: object-plane publish faults (one flag check when unarmed)
    if not chaos.apply("direct.put_owned"):
        raise RuntimeError("chaos: put_owned dropped")
    s = serialize(value)
    payload = encode_serialized(s)
    oid = ObjectID.from_put()
    st.owned.put_ready(oid.binary(), payload, contained=list(s.contained_refs))
    return _ObjRef(oid, owner_hint=st.self_owner)


# ---------------------------------------------------------------------------
# get / readiness / free
# ---------------------------------------------------------------------------
def maybe_get_owned(obj_id: ObjectID, timeout: float | None = None, zero_copy: bool = False):
    """(handled, value) for owned or remote-owned objects; handled=False
    for an id this plane neither owns nor has a hint for (ray_tpu's head
    path). ``zero_copy`` decodes shm payloads as views into a private
    mapping of the segment (see get_owned_view)."""
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
            return False, None  # REDIRECT: ray_tpu's head owns it
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
            # freed by its owner: an owned object is never re-homed in the port
            drop_hint(k)
            raise ObjectLostError(f"object {obj_id.hex()[:16]} was freed by its owner at {owner}")
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
    bounded wait, and NotImplementedError for an id this plane neither
    owns nor has a hint for (ray_tpu's head path)."""
    from ray_tpu_torch import chaos

    # chaos site: owned-object loss at the borrow-get; a drop IS the loss
    # signal the bounded-retry consumers absorb
    if not chaos.apply("direct.get_owned_view"):
        raise ObjectLostError(f"chaos: owned object {obj_id.hex()[:16]} lost")
    handled, value = maybe_get_owned(obj_id, timeout=timeout, zero_copy=True)
    if not handled:
        _needs_runtime(f"a get of object {obj_id.hex()[:16]}, which this process neither owns nor has an owner "
                       "hint for,")
    return value


def _owned_ready_local(k: bytes) -> bool | None:
    """Readiness from the LOCAL owned table only; None = this process
    cannot answer locally (a hinted-remote or unknown id)."""
    st = _state
    if st is not None:
        e = st.owned.entry(k)
        if e is not None and e.state != REDIRECT:
            return e.state != PENDING
    return None


def owned_ready(k: bytes, poll_timeout: float | None = None) -> bool | None:
    """True/False readiness for an owned or hinted id; None = not ours.
    A remote-owned id polls its owner. ``poll_timeout`` set means the
    caller is deadline-bounded: a poll timeout reports not-ready. An
    unbounded caller gets ready on a poll timeout or a dead owner, so its
    get() surfaces the owner's true state instead of stalling."""
    st = _state
    local = _owned_ready_local(k)
    if local is not None:
        return local
    owner = get_hint(k)
    if owner is None:
        return None
    if st is None:
        return True
    try:
        resp = st.get_conn(hint_addr(owner)).request("poll", timeout=10.0 if poll_timeout is None else poll_timeout,
                                                     id=k)
        return bool(resp.get("ready", True))
    except GetTimeoutError:
        return poll_timeout is None  # a slow owner: not ready for a bounded caller
    except (ConnectionError, OSError):
        return True  # the owner is gone: get() surfaces the real error


def free_owned(obj_ids) -> list:
    """Free owned ids locally and remote-owned ones at their owner; returns
    the ids this plane neither owns nor has a hint for (in ray_tpu, the
    head's; freed already or never on the plane here)."""
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
        except (ConnectionError, OSError):
            pass  # the owner is gone: its objects died with it
    return rest


def promote(k: bytes) -> bool:
    """ray_tpu moves an owned object into its head's store here."""
    _needs_runtime("promoting an owned object")
