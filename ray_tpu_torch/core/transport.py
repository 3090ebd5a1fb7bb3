"""Objects between nodes (port of ray_tpu/core/transport.py): pulls of
shared-memory segments over TCP.

Every node with a shm namespace of its own (an agent's node; the head for
the host's namespace) runs an ``ObjectTransferServer`` that serves byte
ranges of the segments in its namespace. A process that needs a foreign
segment pulls it (``pull_segment``) into a same-id segment of its own
namespace, a local cache: one round trip streams up to 16 MiB and
announces the size, larger segments come in four ranged streams in
parallel over pooled, authenticated (HMAC challenge) connections, and the
socket's bytes go to the file through ``os.splice`` (``_recv_to_file``).
The head is the directory: it maps a namespace to the address of the
node that serves it. Host tensors cross here; a tensor on the card never
does.
"""

from __future__ import annotations

import os
import select
import socket
import struct
import threading
import time

_STATS_LOCK = threading.Lock()
STATS = {"pulls": 0, "pull_bytes": 0, "serves": 0, "serve_bytes": 0, "pull_errors": 0, "pull_retries": 0}


def _bump(key: str, n: int = 1):
    with _STATS_LOCK:
        STATS[key] += n


def reset_stats():
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = 0


# ---------------------------------------------------------------------------
# wire protocol: length-prefixed frames over a raw TCP socket.
#   client -> server:  HMAC-free hello: 16-byte authkey digest handshake via
#                      challenge/response (same scheme as multiprocessing's
#                      connection auth, reimplemented minimally), then one
#                      request frame: b"PULL" + u32 name_len + name bytes.
#   server -> client:  u64 total_size (or 0xFFFF..FF on error + error frame),
#                      then raw chunks until total_size bytes are sent.
# ---------------------------------------------------------------------------
_ERR = 0xFFFFFFFFFFFFFFFF


def _send_frame(sock: socket.socket, data: bytes):
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("transfer peer closed")
        buf.extend(part)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    if n > 1 << 20:
        raise ConnectionError("oversized transfer frame")
    return _recv_exact(sock, n)


def _auth_server(sock: socket.socket, authkey: bytes):
    import hmac

    challenge = os.urandom(20)
    _send_frame(sock, challenge)
    resp = _recv_frame(sock)
    if not hmac.compare_digest(resp, hmac.new(authkey, challenge, "sha256").digest()):
        raise ConnectionError("transfer auth failed")
    _send_frame(sock, b"OK")


def _auth_client(sock: socket.socket, authkey: bytes):
    import hmac

    challenge = _recv_frame(sock)
    _send_frame(sock, hmac.new(authkey, challenge, "sha256").digest())
    if _recv_frame(sock) != b"OK":
        raise ConnectionError("transfer auth rejected")


class ObjectTransferServer:
    """Serves chunked reads of /dev/shm segments in this process's namespace
    (``allowed_prefixes``: the segment-name prefixes it may serve).

    ``advertise_host`` is the address peers dial — it must be routable FROM
    other nodes, so a cross-host agent advertises the interface it reaches
    the head on, not the bind wildcard."""

    def __init__(self, authkey: bytes, host: str = "0.0.0.0", advertise_host: str = "127.0.0.1", chunk_bytes: int = 4 << 20, allowed_prefixes: tuple | None = None):
        self.authkey = authkey
        self.chunk_bytes = chunk_bytes
        # only serve THIS node's namespaces: an authenticated peer must not
        # be able to read /dev/shm segments of other sessions/clusters on
        # the same host (default: the process's own session tag)
        if allowed_prefixes is None:
            from ray_tpu_torch.core.object_store import _session_tag

            allowed_prefixes = (f"rt{_session_tag()}_",)
        self.allowed_prefixes = tuple(allowed_prefixes)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        self.address = (advertise_host, self._sock.getsockname()[1])
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True, name="rt-transfer-srv")
        self._thread.start()

    def _accept_loop(self):
        # timeout-polling accept: close() from another thread does NOT
        # reliably wake a blocked accept() on Linux, which leaked this
        # thread on every runtime shutdown
        try:
            self._sock.settimeout(0.5)
        except OSError:
            return  # raced an immediate shutdown(): socket already closed
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,), daemon=True).start()

    def _serve_one(self, conn: socket.socket):
        """Serve PULL requests on one authenticated connection until the
        peer closes it (persistent connections: the pull-side pool reuses
        sockets across pulls). Ops:
          b"PULL" + name                      -> whole segment
          b"PULLR" + u64 off + u64 len + name -> byte range (parallel pulls)
        """
        try:
            conn.settimeout(30.0)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8 << 20)
            except OSError:
                pass
            _auth_server(conn, self.authkey)
            while True:
                conn.settimeout(300.0)  # idle pooled conns park here
                try:
                    req = _recv_frame(conn)
                except ConnectionError:
                    return  # peer closed / retired the pooled socket
                conn.settimeout(30.0)
                head_want = None
                stat_only = False
                if req.startswith(b"PULLR"):
                    off, length = struct.unpack("<QQ", req[5:21])
                    name = req[21:].decode()
                elif req.startswith(b"PULLH"):
                    # head pull: announce the TOTAL size, then stream at
                    # most `want` bytes — small segments finish in ONE
                    # round trip, large ones learn the size for ranged
                    # sibling pulls without a wasted full-stream push
                    (head_want,) = struct.unpack("<Q", req[5:13])
                    name = req[13:].decode()
                    off, length = 0, None
                elif req.startswith(b"PULL"):
                    off, length = 0, None
                    name = req[4:].decode()
                elif req.startswith(b"STAT"):
                    name = req[4:].decode()
                    off, length, stat_only = 0, 0, True
                else:
                    raise ConnectionError(f"bad transfer op {req[:8]!r}")
                if "/" in name or not name.startswith(self.allowed_prefixes):
                    raise ConnectionError("illegal segment name")
                path = "/dev/shm/" + name
                if stat_only:
                    try:
                        conn.sendall(struct.pack("<Q", os.path.getsize(path)))
                    except OSError:
                        conn.sendall(struct.pack("<Q", _ERR))
                        _send_frame(conn, b"not found")
                    continue
                try:
                    f = open(path, "rb")
                except OSError:
                    conn.sendall(struct.pack("<Q", _ERR))
                    _send_frame(conn, b"not found")
                    continue
                with f:
                    from ray_tpu_torch.core import rpc_chaos

                    size = os.fstat(f.fileno()).st_size
                    if head_want is not None:
                        send_size = min(head_want, size)
                        conn.sendall(struct.pack("<QQ", size, send_size))
                    elif length is None:
                        send_size = max(0, size - off)
                        conn.sendall(struct.pack("<Q", send_size))
                    else:
                        send_size = max(0, min(length, size - off))
                        conn.sendall(struct.pack("<Q", send_size))
                    f.seek(off)
                    sent = 0
                    use_sendfile = True
                    while sent < send_size:
                        if not rpc_chaos.apply("transfer_chunk"):
                            raise ConnectionError("chaos: transfer aborted mid-stream")
                        want = min(self.chunk_bytes, send_size - sent)
                        if use_sendfile:
                            # kernel path: page cache -> socket with the
                            # GIL released. socket.sendfile (not raw
                            # os.sendfile) handles the timeout socket's
                            # EAGAIN internally by waiting for
                            # writability instead of failing the window.
                            try:
                                m = conn.sendfile(f, offset=off + sent, count=want)
                                if m == 0:
                                    break
                                sent += m
                                continue
                            except OSError:
                                use_sendfile = False
                                # sendfile(offset=...) never moved f's
                                # position; resume the read fallback at
                                # the bytes actually sent
                                f.seek(off + sent)
                        chunk = f.read(want)
                        if not chunk:
                            break
                        conn.sendall(chunk)
                        sent += len(chunk)
                _bump("serves")
                _bump("serve_bytes", sent)
        except Exception:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def shutdown(self):
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# client side: a pool of authenticated TCP_NODELAY connections per peer and
# ranged parallel pulls (a fresh connection and auth per segment, and small
# frames under Nagle's delayed ACK, cost a round trip each)
# ---------------------------------------------------------------------------
_PARALLEL_THRESHOLD = 16 << 20  # range-split pulls above this size
_PARALLEL_STREAMS = 4
_POOL_MAX_PER_ADDR = 6
_pool_lock = threading.Lock()
_conn_pool: dict[tuple, list] = {}  # addr -> [socket, ...]
# admission control: global cap on concurrent pull streams so a burst of
# large pulls cannot swamp the NIC/loopback (pull_manager admission)
_admission = threading.BoundedSemaphore(8)


def _pool_get(addr, authkey: bytes, timeout: float) -> socket.socket:
    addr = tuple(addr)
    with _pool_lock:
        conns = _conn_pool.get(addr)
        while conns:
            sock = conns.pop()
            return sock
    sock = socket.create_connection(addr, timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    except OSError:
        pass
    sock.settimeout(timeout)
    _auth_client(sock, authkey)
    return sock


def _pool_put(addr, sock: socket.socket):
    addr = tuple(addr)
    with _pool_lock:
        conns = _conn_pool.setdefault(addr, [])
        if len(conns) < _POOL_MAX_PER_ADDR:
            conns.append(sock)
            return
    try:
        sock.close()
    except OSError:
        pass


def _drop_pool():
    with _pool_lock:
        pools = list(_conn_pool.values())
        _conn_pool.clear()
    for conns in pools:
        for s in conns:
            try:
                s.close()
            except OSError:
                pass


def pull_segment(addr, authkey: bytes, src_name: str, dst_name: str, timeout: float = 60.0, retries: int = 2) -> int:
    """Pull segment ``src_name`` from the transfer server at ``addr`` and
    install it atomically as /dev/shm/``dst_name``. Returns byte count.

    Transient transport failures (reset, truncation, timeout) RETRY with
    backoff before surfacing: a network blip on a large expensive block
    must not force a full lineage recompute. Only an authoritative
    peer-side not-found — or exhausted retries — raises FileNotFoundError
    (which callers treat as object-lost -> reconstruction)."""
    if os.path.exists("/dev/shm/" + dst_name):
        return os.path.getsize("/dev/shm/" + dst_name)
    last: Exception | None = None
    for attempt in range(retries + 1):
        try:
            return _pull_once(addr, authkey, src_name, dst_name, timeout)
        except FileNotFoundError:
            raise  # peer says gone: retrying cannot help
        except (ConnectionError, socket.timeout, OSError) as e:
            _bump("pull_errors")
            _drop_addr(addr)  # siblings of a broken conn are suspect too
            last = e
            if attempt < retries:
                _bump("pull_retries")
                time.sleep(0.1 * (attempt + 1))
    raise FileNotFoundError(
        f"pull of {src_name} from {addr} failed after {retries + 1} attempts: {last}"
    ) from None


def _recv_to_file(sock: socket.socket, fd: int, file_off: int, length: int) -> int:
    """Stream exactly ``length`` socket bytes into ``fd`` at ``file_off``.
    Kernel path (socket -> pipe -> file via splice: zero userspace copies,
    GIL released per ~1MB window) with a recv_into/pwrite fallback."""
    got = 0
    if hasattr(os, "splice"):
        pr = pw = -1
        consumed_any = False  # bytes left the SOCKET (possibly into the pipe)
        try:
            pr, pw = os.pipe()
            try:
                import fcntl

                fcntl.fcntl(pw, 1031, 1 << 20)  # F_SETPIPE_SZ
            except OSError:
                pass
            while got < length:
                try:
                    n = os.splice(sock.fileno(), pw, min(1 << 20, length - got))
                except BlockingIOError:
                    # the Python-level socket timeout puts the fd in
                    # non-blocking mode, so a momentarily-empty receive
                    # buffer surfaces as EAGAIN — routine mid-stream on
                    # real networks, NOT a transport failure. The stream
                    # offset is well-defined here (nothing left the
                    # socket): wait for readability and resume. poll(),
                    # not select(): a busy head can sit above FD_SETSIZE
                    # and select() would raise ValueError there.
                    waiter = select.poll()
                    waiter.register(sock, select.POLLIN)
                    t = sock.gettimeout()
                    if not waiter.poll(None if t is None else max(0, int(t * 1000))):
                        raise socket.timeout(
                            "splice read stalled past the socket timeout"
                        ) from None
                    continue
                except OSError:
                    if consumed_any:
                        raise ConnectionError("splice transfer failed mid-stream") from None
                    break  # first socket splice unsupported: clean fallback
                if n == 0:
                    raise ConnectionError("transfer truncated")
                consumed_any = True
                moved = 0
                while moved < n:
                    # any failure past this point strands bytes in the
                    # pipe — the stream offset is unknowable, so the pull
                    # (and its pooled socket) must fail, never fall back
                    try:
                        moved += os.splice(pr, fd, n - moved, offset_dst=file_off + got + moved)
                    except OSError:
                        raise ConnectionError("splice pipe drain failed mid-stream") from None
                got += n
            else:
                return got
        finally:
            for p in (pr, pw):
                if p >= 0:
                    try:
                        os.close(p)
                    except OSError:
                        pass
    buf = bytearray(min(max(length - got, 1), 4 << 20))
    mv = memoryview(buf)
    while got < length:
        n = sock.recv_into(mv[: min(len(mv), length - got)])
        if not n:
            raise ConnectionError("transfer truncated")
        os.pwrite(fd, mv[:n], file_off + got)
        got += n
    return got


def _drop_addr(addr):
    """Discard pooled sockets to a peer after a transport error: siblings
    of a broken connection are usually broken too (server restart)."""
    with _pool_lock:
        conns = _conn_pool.pop(tuple(addr), [])
    for s in conns:
        try:
            s.close()
        except OSError:
            pass


def _pull_once(addr, authkey: bytes, src_name: str, dst_name: str, timeout: float) -> int:
    tmp = f"/dev/shm/{dst_name}.t{os.getpid()}.{threading.get_ident()}"
    sock = _pool_get(addr, authkey, timeout)
    pooled = False
    try:
        sock.settimeout(timeout)
        # ONE round trip: PULLH streams up to the parallel threshold and
        # announces the total, so small segments finish immediately and
        # large ones learn the size for ranged sibling pulls with no
        # wasted full-stream push
        _send_frame(sock, b"PULLH" + struct.pack("<Q", _PARALLEL_THRESHOLD) + src_name.encode())
        (total,) = struct.unpack("<Q", _recv_exact(sock, 8))
        if total == _ERR:
            err = _recv_frame(sock)
            _bump("pull_errors")
            _pool_put(addr, sock)
            pooled = True
            raise FileNotFoundError(f"remote segment {src_name}: {err.decode()}")
        (sending,) = struct.unpack("<Q", _recv_exact(sock, 8))
        with _admission:
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT, 0o600)
            try:
                os.ftruncate(fd, total)
                got = _recv_to_file(sock, fd, 0, sending)
            finally:
                os.close(fd)
        _pool_put(addr, sock)
        pooled = True
        if total > sending:
            got += _pull_parallel(addr, authkey, src_name, tmp, sending, total, timeout)
        os.rename(tmp, "/dev/shm/" + dst_name)
        _bump("pulls")
        _bump("pull_bytes", got)
        return got
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if not pooled:
            try:
                sock.close()
            except OSError:
                pass


def _pull_parallel(addr, authkey: bytes, src_name: str, tmp: str, start: int, size: int, timeout: float) -> int:
    """Pull [start, size) of a segment as parallel ranged streams over
    pooled connections (under the admission cap). The file already holds [0, start)."""
    nstreams = _PARALLEL_STREAMS
    todo = size - start
    part = (todo + nstreams - 1) // nstreams
    ranges = [
        (start + i * part, min(part, todo - i * part)) for i in range(nstreams) if i * part < todo
    ]
    fd = os.open(tmp, os.O_WRONLY)
    errors: list = []
    try:
        def fetch_range(off, length, sock=None):
            own = sock is None
            with _admission:
                try:
                    if own:
                        sock = _pool_get(addr, authkey, timeout)
                        _send_frame(sock, b"PULLR" + struct.pack("<QQ", off, length) + src_name.encode())
                        (announced,) = struct.unpack("<Q", _recv_exact(sock, 8))
                        if announced == _ERR:
                            _recv_frame(sock)
                            raise FileNotFoundError(f"remote segment {src_name} vanished mid-pull")
                        if announced != length:
                            raise ConnectionError("range size mismatch")
                    _recv_to_file(sock, fd, off, length)
                    if own:
                        _pool_put(addr, sock)
                        sock = None
                finally:
                    if own and sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass

        threads = []
        try:
            for off, length in ranges[1:]:
                t = threading.Thread(target=lambda o=off, l=length: _capture(errors, fetch_range, o, l), daemon=True)
                t.start()
                threads.append(t)
            fetch_range(ranges[0][0], ranges[0][1])
        finally:
            # join BEFORE the fd closes below: a failed range must not
            # leave siblings writing into a recycled fd number. The join
            # is transitively bounded: every sibling socket op carries
            # the pull timeout, so an unbounded join here cannot outlive
            # the siblings' own deadlines.
            for t in threads:
                t.join()
    finally:
        os.close(fd)
    if errors:
        raise errors[0]
    return todo  # bytes THIS call transferred (the caller holds [0, start))


def _capture(errors: list, fn, *a):
    try:
        fn(*a)
    except BaseException as e:  # noqa: BLE001
        errors.append(e)
