"""Cross-language drivers and workers (port of ray_tpu/core/xlang.py).

The head serves one language-neutral TCP endpoint. Its frames need only
sockets and HMAC-SHA256 on the client's side, so the repository's
``cpp/ray_tpu_client.hpp`` and ``cpp/ray_tpu_worker.hpp`` drive this head
unchanged. The wire format is ray_tpu's, byte for byte:

    request  frame: [op u8][body]
    response frame: [status u8][body]     status 0 = ok, 1 = error (utf-8)

    PUT  (0x01) body = raw bytes             -> ok body = object id (20 B)
    GET  (0x02) body = [id 20 B][timeout f64] -> ok body = value bytes
    CALL (0x03) body = [u16 name_len][name][payload]
                                             -> ok body = object id (20 B)
    REG_WORKER (0x04) body = [u16 port][u16 name_len][name]

Frames are little-endian u32 length-prefixed and capped at 1 GiB, after
the transfer service's challenge and response (``core/transport.py``).
PUT stores the raw bytes as a bytes object. CALL runs a function exported
on the head (``export("name")``) as a cluster task with the payload as
its one argument. GET returns bytes raw, a str as utf-8 and anything else
as compact JSON, so structured results cross without pickle.

**Code by reference.** ``export`` takes a module-level function, as every
entry point of the port does, and raises TypeError at once for a lambda
or a closure. The proxies of C++ functions and actors (``cpp_function``,
``cpp_actor``) are module-level here; ray_tpu defines them as closures.

**Pins.** A CALL's result and a PUT's object are held by the server for
the remote driver (at least the newest 4096 of them), since no Python
reference would keep them alive until the client's GET.

    info = xlang.serve()           # {host, port, authkey}: hand to the client
    xlang.export("generate")(generate)
"""

from __future__ import annotations

import json
import socket
import struct
import threading

from ray_tpu_torch.api import remote
from ray_tpu_torch.core.transport import _auth_client, _auth_server, _send_frame

OP_PUT = 0x01
OP_GET = 0x02
OP_CALL = 0x03
OP_REG_WORKER = 0x04  # a non-Python worker announces its own listener

# ops served BY a registered xlang worker (cpp/ray_tpu_worker.hpp)
OP_EXEC_FN = 0x10
OP_NEW_ACTOR = 0x11
OP_CALL_METHOD = 0x12
OP_DEL_ACTOR = 0x13

MAX_FRAME = 1 << 30  # xlang payloads are data, not control messages
PINNED = 4096  # results and puts held for remote drivers: at least the newest PINNED


def _recv_frame(sock: socket.socket) -> bytearray:
    """One length-prefixed frame of at most MAX_FRAME bytes, received into
    one buffer (a 64 MiB PUT arrives without a copy per chunk)."""
    head = _recv_into(sock, 4)
    (n,) = struct.unpack("<I", head)
    if n > MAX_FRAME:
        raise ConnectionError("oversized xlang frame")
    return _recv_into(sock, n)


def _recv_into(sock: socket.socket, n: int) -> bytearray:
    # acknowledge at once: a client that writes a frame's length and body
    # in two sends (cpp/ray_tpu_client.hpp) holds the body under Nagle
    # until the length's ACK, which a delayed ACK holds for ~40 ms
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_QUICKACK, 1)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("xlang peer closed")
        got += r
    return buf


def _to_wire_bytes(value) -> bytes:
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes(value)
    if isinstance(value, str):
        return value.encode()
    return json.dumps(value, separators=(",", ":")).encode()


class XLangServer:
    """The head's endpoint for cross-language drivers and workers."""

    def __init__(self, runtime, host: str = "0.0.0.0", port: int = 0, authkey: bytes | None = None):
        import secrets

        self.rt = runtime
        self.authkey = authkey or secrets.token_bytes(16)
        self._fns: dict[str, object] = {}  # name -> RemoteFunction
        # registered non-Python workers: name -> (host, port)
        self.workers: dict[str, tuple] = {}
        self._pinned: list = []
        self._pin_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True, name="rt-xlang")
        self._thread.start()

    def register(self, name: str, fn):
        """Expose ``fn(payload: bytes)`` to cross-language CALLs. ``fn`` is
        a module-level function (or its ``remote`` wrapper): TypeError now
        for a lambda or a closure, not at the first CALL."""
        from ray_tpu_torch.core.serialization import code_ref

        rf = fn if hasattr(fn, "remote") else remote(fn)
        code_ref(rf._rt_target)
        self._fns[name] = rf

    def _pin(self, ref):
        with self._pin_lock:
            self._pinned.append(ref)
            if len(self._pinned) > 2 * PINNED:
                del self._pinned[:PINNED]

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True, name="rt-xlang-conn").start()

    def _serve_conn(self, conn: socket.socket):
        try:
            conn.settimeout(30.0)
            _auth_server(conn, self.authkey)
            conn.settimeout(None)  # keep-alive: many requests per connection
            while True:
                try:
                    req = _recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                _send_frame(conn, self._handle(conn, req[0], memoryview(req)[1:]))
        except (ConnectionError, OSError):
            pass  # the client went away or failed the challenge
        finally:
            conn.close()

    def _handle(self, conn: socket.socket, op: int, body: memoryview) -> bytes:
        from ray_tpu_torch.core.ids import ObjectID

        try:
            if op == OP_PUT:
                ref = self.rt.put_object(bytes(body))
                self._pin(ref)
                return bytes([0]) + ref.id.binary()
            if op == OP_GET:
                oid = ObjectID(bytes(body[:20]))
                (timeout,) = struct.unpack("<d", body[20:28])
                value = self.rt.get_object(oid, timeout=timeout if timeout > 0 else None)
                return bytes([0]) + _to_wire_bytes(value)
            if op == OP_REG_WORKER:
                # a C++ (or other-language) worker announces the listener it
                # serves executions on; the proxies resolve it by name
                (wport, name_len) = struct.unpack("<HH", body[:4])
                wname = bytes(body[4 : 4 + name_len]).decode()
                peer_host = conn.getpeername()[0]
                if peer_host.startswith("127.") or peer_host == "::1":
                    # dialed over loopback: it runs on this host; record the
                    # cluster-routable address for proxies on other nodes
                    srv = getattr(self.rt, "_transfer_server", None)
                    if srv is not None and srv.address[0] not in ("0.0.0.0", ""):
                        peer_host = srv.address[0]
                self.workers[wname] = (peer_host, wport)
                return bytes([0])
            if op == OP_CALL:
                (name_len,) = struct.unpack("<H", body[:2])
                name = bytes(body[2 : 2 + name_len]).decode()
                rf = self._fns.get(name)
                if rf is None:
                    raise KeyError(f"no exported function {name!r} (xlang.export it on the head)")
                ref = rf.remote(bytes(body[2 + name_len :]))
                self._pin(ref)
                return bytes([0]) + ref.id.binary()
            raise ValueError(f"unknown xlang op {op:#x}")
        except Exception as e:  # noqa: BLE001 — the error travels to the client as its status 1 frame
            return bytes([1]) + f"{type(e).__name__}: {e}".encode()

    def shutdown(self):
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._pin_lock:
            self._pinned.clear()


# ---------------------------------------------------------------- public API
_server: XLangServer | None = None


def serve(port: int = 0, host: str = "0.0.0.0") -> dict:
    """Start (or return) the head's cross-language endpoint. Returns
    {host, port, authkey}: hand these to the C++ or other-language client."""
    global _server
    from ray_tpu_torch.core import context

    if _server is None:
        _server = XLangServer(context.get_client(), host=host, port=port)
    return {"host": "127.0.0.1" if host == "0.0.0.0" else host, "port": _server.port, "authkey": _server.authkey.hex()}


def export(name: str):
    """Decorator: expose a module-level function to cross-language CALLs
    by name."""

    def deco(fn):
        if _server is None:
            raise RuntimeError("call xlang.serve() before exporting functions")
        _server.register(name, fn)
        return fn

    return deco


def shutdown():
    global _server
    if _server is not None:
        _server.shutdown()
        _server = None


# ---------------------------------------------------------------------------
# Python proxies for functions and actors DEFINED in a registered xlang
# worker (cpp/ray_tpu_worker.hpp): called from the cluster as tasks and
# actors, with results through the object plane
# ---------------------------------------------------------------------------
def _worker_endpoint(worker_name: str, timeout: float = 30.0) -> tuple:
    import time

    if _server is None:
        raise RuntimeError("call xlang.serve() first")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ep = _server.workers.get(worker_name)
        if ep is not None:
            return ep
        time.sleep(0.05)
    raise KeyError(f"no xlang worker named {worker_name!r} registered")


def _dial_worker(host: str, port: int, authkey_hex: str) -> socket.socket:
    sock = socket.create_connection((host, port), timeout=30.0)
    sock.settimeout(120.0)
    _auth_client(sock, bytes.fromhex(authkey_hex))
    return sock


def _worker_roundtrip(sock: socket.socket, req: bytes) -> bytes:
    _send_frame(sock, req)
    resp = _recv_frame(sock)
    if not resp or resp[0] != 0:
        raise RuntimeError(f"xlang worker error: {bytes(resp[1:]).decode(errors='replace')}")
    return bytes(resp[1:])


@remote
def _cpp_call(host: str, port: int, key: str, fn: str, payload: bytes) -> bytes:
    """A C++ function's execution, as a cluster task: dial the worker's
    listener, send EXEC_FN, return its bytes."""
    sock = _dial_worker(host, port, key)
    try:
        return _worker_roundtrip(sock, bytes([OP_EXEC_FN]) + struct.pack("<H", len(fn)) + fn.encode() + bytes(payload))
    finally:
        sock.close()


class _CppFunction:
    """``.remote(payload)`` of a C++ function: a ``_cpp_call`` task."""

    def __init__(self, host: str, port: int, key: str, fn_name: str):
        self._args = (host, port, key, fn_name)

    def remote(self, payload: bytes = b""):
        return _cpp_call.remote(*self._args, payload)


@remote
class _CppActorProxy:
    """A C++ actor instance behind one persistent connection, so one
    caller's method calls keep the connection's FIFO order."""

    def __init__(self, host: str, port: int, key: str, cls: str, payload: bytes):
        self._sock = _dial_worker(host, port, key)
        body = _worker_roundtrip(self._sock, bytes([OP_NEW_ACTOR]) + struct.pack("<H", len(cls)) + cls.encode()
                                 + bytes(payload))
        (self._iid,) = struct.unpack("<Q", body[:8])

    def call(self, method: str, payload: bytes = b"") -> bytes:
        req = (bytes([OP_CALL_METHOD]) + struct.pack("<Q", self._iid) + struct.pack("<H", len(method))
               + method.encode() + bytes(payload))
        return _worker_roundtrip(self._sock, req)


def cpp_function(worker_name: str, fn_name: str) -> _CppFunction:
    """A ``.remote()``-able proxy for a function DEFINED in a registered C++
    worker. It executes in the C++ process; the call runs as a cluster
    task, so the result is an ordinary owned object."""
    host, port = _worker_endpoint(worker_name)
    return _CppFunction(host, port, _server.authkey.hex(), fn_name)


def cpp_actor(worker_name: str, class_name: str, ctor_payload: bytes = b""):
    """Instantiate an actor CLASS defined in a registered C++ worker and
    return the handle of its proxy actor:
    ``h = cpp_actor("w", "Counter"); h.call.remote("add", b"2")``."""
    host, port = _worker_endpoint(worker_name)
    return _CppActorProxy.remote(host, port, _server.authkey.hex(), class_name, ctor_payload)
