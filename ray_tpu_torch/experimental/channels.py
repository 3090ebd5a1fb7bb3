"""Persistent SPSC shared-memory channels for compiled DAG execution
(port of ray_tpu/experimental/channels.py).

One channel = one producer process -> one consumer process:

  * a named POSIX shm segment holding ``nslots`` fixed-size slots,
    created once at compile time and reused for every message;
  * one abstract-namespace unix stream socket (Linux: no filesystem
    litter, gone with the processes) carrying 1-byte doorbells
    producer->consumer ("a slot is ready") and 1-byte credits
    consumer->producer ("a slot was drained"). Socket EOF doubles as
    failure detection: a peer's death ends a wait on it.

The sockets are non-blocking: a wait is one ``poll`` and one ``recv``,
with no change of the socket's mode (no ``fcntl`` per message).

**A reader spins only where spinning pays.** Waking a sleeping process
costs a hop most of its time on a virtual machine whose idle cores halt
(on the H100's host: 60-137 µs a hop asleep, 37-72 µs polling the socket
for up to 1 ms); on a machine whose cores are shared with other guests,
polling made every hop several times slower (the spinners take the time
the working process needs). So each reader measures: it waits
``_PROBE`` messages asleep, then ``_PROBE`` polling its socket without
sleeping (for at most ``SPIN_MAX_S`` a message), keeps polling for the
next ``_KEEP`` messages only if the polled waits were clearly shorter
(their median under ``_SPIN_GAIN`` of the sleeping ones': a median, so
one stall in a probe decides nothing), and measures again. A polled wait
past ``_SPIN_ABORT`` times the sleeping median ends the probe at once:
where spinners starve the producers, each polled message costs
milliseconds. An idle pipeline's waits are
the producer's and do not shorten, so its readers sleep.
``reader_modes()`` lists this process's readers and how each waits.

Backpressure is credit-based: the writer starts with ``nslots`` credits
and waits in ``send`` while the ring is full.

**Every wait has a bound.** Accept, connect, recv and the credit wait
each take a timeout and end in a ``ChannelError``
(``ChannelTimeoutError`` for a timed-out wait, which is also a
``TimeoutError`` and leaves the channel consistent; ``ChannelClosedError``
for a peer's death or a local close). A wait with no timeout polls in
slices of ``_POLL_S`` and ends when the endpoint is closed from another
thread, so no thread is left blocked on a socket nobody will write.

Values are pickled with the port's serialization (``core/serialization``:
stdlib pickle protocol 5, host tensors as dtype, shape and bytes), in
band, into the slot; a value larger than the slot raises
``ChannelFullError`` naming the knob to raise. A tensor on the card
raises TypeError: a channel carries host bytes, so move it with
``.cpu()`` or pass a ``DeviceRef`` (``device_put_object``) instead. (ray_tpu's
channel pickles a jax array through the host; ROADMAP.md, Differences
kept on purpose.)

Ring names follow the port's segment namespace: ``rt<head pid>w_ch...``
(``ring_name``), the tag of what a runtime's workers write, so the
head's ``shutdown()`` unlinks a ring whose reader died before it could,
and the next ``init()`` unlinks those of a dead head.
"""

from __future__ import annotations

import errno
import io
import os
import pickle
import select
import socket
import struct
import threading
import time
import weakref

import torch

from ray_tpu_torch.core import serialization as _ser

_HDR = struct.Struct("<Q")  # payload length per slot
SPIN_MAX_S = 1e-3  # the longest a reader polls its socket without sleeping, a message
_PROBE, _KEEP = 8, 512  # messages a reader measures each way, then keeps the faster way for
_SPIN_GAIN = 0.8  # polling is kept when its median wait is under this share of the sleeping one
_SPIN_ABORT = 4.0  # a polled wait past this many sleeping medians ends the probe: keep sleeping
_POLL_S = 0.5  # the slice of an unbounded wait (closing ends it within one)
_READERS: "weakref.WeakSet" = weakref.WeakSet()  # this process's live readers (reader_modes)
SETUP_TIMEOUT_S = 60.0  # accept and connect


class ChannelError(RuntimeError):
    pass


class ChannelClosedError(ChannelError):
    """Peer went away (process death or teardown)."""


class ChannelFullError(ChannelError):
    """Value exceeds slot capacity."""


class ChannelTimeoutError(ChannelError, TimeoutError):
    """A bounded wait ran out; nothing was consumed, so a retry is safe."""


class _Stop:
    """Poison sentinel: tears the pipeline down edge by edge."""

    def __repr__(self):
        return "<channel STOP>"


STOP = _Stop()

_NOTIFY = b"n"
_CREDIT = b"c"


class _ChannelPickler(_ser._Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise TypeError(
                f"a tensor on {obj.device} cannot travel through a channel, which carries host bytes: move it "
                "to the host with .cpu(), or register it with device_put_object and send its DeviceRef")
        return super().reducer_override(obj)


def dumps(value) -> bytes:
    """One in-band pickle of ``value`` (host tensors as dtype, shape and
    bytes); TypeError for a tensor on the card."""
    if type(value) in _ser._FAST_TYPES:
        return pickle.dumps(value, protocol=5)
    out = io.BytesIO()
    _ChannelPickler(out, protocol=5).dump(value)
    return out.getvalue()


def ring_name(dag_id: str, n: int) -> str:
    """The shm name of a compiled DAG's ``n``-th channel, under the tag
    of this runtime's workers (``rt<head pid>w_``) in the head and in
    its workers alike."""
    from ray_tpu_torch.core import object_store

    tag = object_store._tag or object_store.worker_session_tag()
    return f"rt{tag}_ch{dag_id}_{n}"


def _sock_addr(name: str) -> str:
    return "\0rtch-" + name  # Linux abstract namespace


def create_ring(name: str, nslots: int, slot_size: int) -> None:
    """Create (or replace) the backing shm ring. Called by the writer."""
    import _posixshmem

    fd = _posixshmem.shm_open("/" + name, os.O_CREAT | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, nslots * slot_size)
    finally:
        os.close(fd)


def _map_ring(name: str, writable: bool):
    import mmap

    import _posixshmem

    fd = _posixshmem.shm_open("/" + name, os.O_RDWR if writable else os.O_RDONLY, 0)
    try:
        size = os.fstat(fd).st_size
        prot = mmap.PROT_READ | (mmap.PROT_WRITE if writable else 0)
        return mmap.mmap(fd, size, prot=prot)
    finally:
        os.close(fd)


def unlink_ring(name: str) -> None:
    try:
        os.unlink("/dev/shm/" + name)
    except OSError:
        pass


class _Endpoint:
    """Socket plumbing shared by both ends of a channel."""

    def __init__(self, name: str, nslots: int, slot_size: int):
        self.name = name
        self.nslots = nslots
        self.slot_size = slot_size
        self.sock: socket.socket | None = None
        self._srv: socket.socket | None = None
        self._closed = False
        self._map = None
        self._view = None
        self._poller = None

    def _attach(self, sock: socket.socket):
        sock.setblocking(False)
        self._poller = select.poll()
        self._poller.register(sock, select.POLLIN)
        self.sock = sock

    # -- connection establishment -------------------------------------
    # Bind/accept are SPLIT: every reader in a plan binds its listener
    # before any writer dials, and accepts only after all the plan's
    # writers have connected. connect(2) completes against the listen
    # backlog without an accept, so cyclic actor reuse (a -> b -> a)
    # cannot deadlock two setups against each other.
    def _bind_listen(self):
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(_sock_addr(self.name))
        except OSError as e:
            srv.close()
            if e.errno != errno.EADDRINUSE:
                raise ChannelError(f"channel {self.name}: bind failed: {e}") from None
            # abstract sockets die with their process: an address in use
            # means a live listener of the same name
            raise ChannelError(f"channel {self.name} already has a listener") from None
        srv.listen(1)
        self._srv = srv

    def _accept(self, timeout: float):
        srv = self._srv
        self._srv = None
        srv.settimeout(timeout)
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            raise ChannelTimeoutError(f"channel {self.name}: no writer connected within {timeout} s") from None
        except OSError as e:
            raise ChannelClosedError(f"channel {self.name}: accept failed: {e}") from None
        finally:
            srv.close()
        self._attach(conn)

    def _connect(self, timeout: float):
        deadline = time.monotonic() + timeout
        while True:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.connect(_sock_addr(self.name))
                self._attach(s)
                return
            except OSError:
                s.close()
                if time.monotonic() >= deadline:
                    raise ChannelTimeoutError(f"channel {self.name}: no listener within {timeout} s") from None
                time.sleep(0.005)

    def _recv_bytes(self, n: int, timeout: float | None, spin_s: float = 0.0) -> int:
        """Up to ``n`` control bytes the peer has sent (at least one),
        waiting at most ``timeout`` (``None``: while the peer lives and
        this end is open, in slices of ``_POLL_S``); for the first
        ``spin_s`` of it polling without sleeping."""
        deadline = None if timeout is None else time.monotonic() + timeout
        spin_end = time.perf_counter() + spin_s
        while True:
            sock = self.sock
            if sock is None or self._closed:
                raise ChannelClosedError(f"channel {self.name}: closed")
            if time.perf_counter() < spin_end:
                if not self._poller.poll(0):
                    continue
            else:
                wait = _POLL_S if deadline is None else min(_POLL_S, deadline - time.monotonic())
                if wait <= 0:
                    # nothing was consumed: the channel stays consistent
                    raise ChannelTimeoutError(f"channel {self.name}: recv timed out")
                if not self._poller.poll(wait * 1e3):
                    continue
            try:
                b = sock.recv(n)
            except BlockingIOError:
                continue
            except OSError as e:
                raise ChannelClosedError(f"channel {self.name}: {e}") from None
            if not b:
                raise ChannelClosedError(f"channel {self.name}: peer closed")
            return len(b)

    def _send_byte(self, b: bytes):
        sock = self.sock
        if sock is None:
            raise ChannelClosedError(f"channel {self.name}: closed")
        try:
            if sock.send(b) == 1:
                return
        except BlockingIOError:
            pass
        except OSError as e:
            raise ChannelClosedError(f"channel {self.name}: {e}") from None
        # a full socket buffer: only a peer that reads no control byte
        # fills it; wait for room, bounded
        out = select.poll()
        out.register(sock, select.POLLOUT)
        if not out.poll(SETUP_TIMEOUT_S * 1e3):
            raise ChannelTimeoutError(f"channel {self.name}: send timed out")
        try:
            sock.send(b)
        except OSError as e:
            raise ChannelClosedError(f"channel {self.name}: {e}") from None

    def close(self):
        self._closed = True
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
            self._srv = None
        sock, self.sock = self.sock, None
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)  # wakes a recv blocked on it
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self._view is not None:
            self._view.release()
            self._view = None
        if self._map is not None:
            self._map.close()
            self._map = None


class ChannelWriter(_Endpoint):
    """Producer end: creates the ring and dials the reader's listener."""

    def __init__(self, name: str, nslots: int = 8, slot_size: int = 256 << 10, *, create: bool = True,
                 connect_timeout: float = SETUP_TIMEOUT_S):
        super().__init__(name, nslots, slot_size)
        if create:
            create_ring(name, nslots, slot_size)
        self._map = _map_ring(name, writable=True)
        self._view = memoryview(self._map)
        self._seq = 0
        self._credits = nslots
        self._lock = threading.Lock()  # send() is not re-entrant; guard misuse
        try:
            self._connect(connect_timeout)
        except ChannelError:
            self.close()
            raise

    def send(self, value, timeout: float | None = None) -> None:
        self.send_bytes(dumps(value), timeout)

    def send_bytes(self, payload: bytes, timeout: float | None = None) -> None:
        """Send a pre-pickled payload (lets a caller validate a whole row
        of sends before committing any). Waits at most ``timeout`` for a
        credit."""
        if len(payload) > self.slot_size - _HDR.size:
            raise ChannelFullError(
                f"channel message of {len(payload)} bytes exceeds slot size "
                f"{self.slot_size}; raise experimental_compile(buffer_size_bytes=...)"
            )
        with self._lock:
            if self._credits == 0:
                self._credits += self._recv_bytes(self.nslots, timeout)  # credits
            view = self._view
            if view is None:
                raise ChannelClosedError(f"channel {self.name}: closed")
            off = (self._seq % self.nslots) * self.slot_size
            view[off : off + _HDR.size] = _HDR.pack(len(payload))
            view[off + _HDR.size : off + _HDR.size + len(payload)] = payload
            self._seq += 1
            self._credits -= 1
            self._send_byte(_NOTIFY)


class ChannelReader(_Endpoint):
    """Consumer end: binds the socket and waits for the writer. With
    ``eager=False`` only the listener is bound; call ``finish()`` after
    the plan's writers have dialed (two-phase setup). Unlinks the ring
    when closed."""

    def __init__(self, name: str, nslots: int = 8, slot_size: int = 256 << 10, *,
                 connect_timeout: float = SETUP_TIMEOUT_S, eager: bool = True):
        super().__init__(name, nslots, slot_size)
        self._seq = 0
        self._spin = False  # poll the socket without sleeping (chosen by measuring: _account)
        self._phase, self._left, self._probe = 0, _PROBE, ([], [])
        _READERS.add(self)
        self._bind_listen()
        if eager:
            self.finish(connect_timeout)

    def finish(self, timeout: float = SETUP_TIMEOUT_S):
        self._accept(timeout)
        self._map = _map_ring(self.name, writable=False)
        self._view = memoryview(self._map)

    def recv(self, timeout: float | None = None):
        """The next value; waits at most ``timeout`` for its doorbell."""
        t0 = time.perf_counter()
        self._recv_bytes(1, timeout, SPIN_MAX_S if self._spin else 0.0)
        self._account(time.perf_counter() - t0)
        view = self._view
        if view is None:
            raise ChannelClosedError(f"channel {self.name}: closed")
        off = (self._seq % self.nslots) * self.slot_size
        (n,) = _HDR.unpack_from(view, off)
        value = pickle.loads(view[off + _HDR.size : off + _HDR.size + n])
        self._seq += 1
        self._send_byte(_CREDIT)
        return value

    def _account(self, wait: float):
        """One message's wait: _PROBE asleep, then _PROBE polling, then
        _KEEP the faster way (module docstring)."""
        if self._phase < 2:
            self._probe[self._phase].append(wait)
        self._left -= 1
        asleep = sorted(self._probe[0])[len(self._probe[0]) // 2] if self._phase == 1 else 0.0
        if self._phase == 1 and wait > _SPIN_ABORT * asleep:
            self._phase, self._left, self._spin = 2, _KEEP, False
        elif self._left:
            return
        elif self._phase == 0:
            self._phase, self._spin, self._left = 1, True, _PROBE
        elif self._phase == 1:
            polled = sorted(self._probe[1])[len(self._probe[1]) // 2]
            self._phase, self._left, self._spin = 2, _KEEP, polled < _SPIN_GAIN * asleep
        else:
            self._phase, self._spin, self._left, self._probe = 0, False, _PROBE, ([], [])

    def close(self):
        super().close()
        unlink_ring(self.name)


def reader_modes() -> list:
    """This process's live readers: name, how each waits now ("poll" or
    "block"), its measuring phase (0/1: probing asleep/polling, 2: keeping),
    and messages received."""
    return [dict(name=r.name, mode="poll" if r._spin else "block", phase=r._phase, received=r._seq)
            for r in list(_READERS)]


class _WrappedError:
    """Carries an upstream exception through the pipeline to the driver."""

    def __init__(self, exc: BaseException, where: str):
        self.exc = exc
        self.where = where


class ChannelLoopRunner:
    """The execution loop a compiled DAG starts in each participating
    actor's worker (the builtin ``__rt_chan_setup__``). Runs on a thread
    of its own so the actor's task queue stays live for teardown calls.

    ``plan`` (one per actor, produced at compile):
        nslots/slot_size: ring geometry
        steps: topo-ordered list of
            {method, in: [channel names], out: [channel names],
             arg_template: [('edge', i) | ('const', value) ...]}
    In-edges are read in template order; every out-edge gets the result.
    STOP or an upstream _WrappedError short-circuits the method call and
    propagates downstream, so teardown and failures drain the whole
    pipeline without the control plane.
    """

    def __init__(self, actor_instance, plan: dict):
        self.instance = actor_instance
        self.plan = plan
        self.readers: dict[str, ChannelReader] = {}
        self.writers: dict[str, ChannelWriter] = {}
        self.local: dict[str, list] = {}
        self.thread: threading.Thread | None = None
        self.error: BaseException | None = None

    def setup(self):
        nslots = self.plan["nslots"]
        slot = self.plan["slot_size"]
        # self-edges (a step feeding a later step on the SAME actor) stay
        # in-process: steps run in order on one thread, so the value is
        # queued locally; a socket to ourselves would deadlock setup
        in_names = {n for s in self.plan["steps"] for n in s["in"]}
        out_names = {n for s in self.plan["steps"] for n in s["out"]}
        self.local = {n: [] for n in in_names & out_names}
        try:
            # bind every listener, dial every writer, then accept: immune
            # to cyclic actor reuse
            for step in self.plan["steps"]:
                for name in step["in"]:
                    if name not in self.readers and name not in self.local:
                        self.readers[name] = ChannelReader(name, nslots, slot, eager=False)
            for step in self.plan["steps"]:
                for name in step["out"]:
                    if name not in self.writers and name not in self.local:
                        self.writers[name] = ChannelWriter(name, nslots, slot)
            for r in self.readers.values():
                r.finish()
        except BaseException:
            self._close_all()
            raise
        self.thread = threading.Thread(target=self._loop, name="rt-chan-loop", daemon=True)
        self.thread.start()

    def _loop(self):
        try:
            while not self._run_iteration():
                pass
        except ChannelClosedError as e:
            # a peer died mid-pipeline: poison what we can downstream
            self.error = e
            self._propagate_all(_WrappedError(e, where="channel"))
        except BaseException as e:  # noqa: BLE001 - recorded; the endpoints close below
            self.error = e
        finally:
            self._close_all()

    def _recv_edge(self, name):
        if name in self.local:
            return self.local[name].pop(0)
        return self.readers[name].recv()

    def _send_edge(self, name, value):
        if name in self.local:
            self.local[name].append(value)
            return
        try:
            payload = dumps(value)
        except Exception as e:  # noqa: BLE001 - an unsendable result (a card tensor): the driver sees why
            payload = dumps(_WrappedError(TypeError(str(e)), where=name))
        self.writers[name].send_bytes(payload)

    def _run_iteration(self) -> bool:
        saw_stop = False
        for step in self.plan["steps"]:
            ins = [self._recv_edge(n) for n in step["in"]]
            poison = next((v for v in ins if isinstance(v, (_Stop, _WrappedError))), None)
            if poison is not None:
                for n in step["out"]:
                    self._send_edge(n, STOP if isinstance(poison, _Stop) else poison)
                if isinstance(poison, _Stop):
                    saw_stop = True
                continue
            args = [ins[t[1]] if t[0] == "edge" else t[1] for t in step["arg_template"]]
            try:
                result = getattr(self.instance, step["method"])(*args)
            except Exception as e:  # noqa: BLE001 - an application error travels to the driver
                result = _WrappedError(e, where=step["method"])
            for n in step["out"]:
                self._send_edge(n, result)
        return saw_stop

    def _propagate_all(self, value):
        for w in self.writers.values():
            try:
                w.send(value, timeout=1.0)
            except ChannelError:
                pass

    def _close_all(self):
        for w in self.writers.values():
            w.close()
        for r in self.readers.values():
            r.close()

    def teardown(self, timeout: float = 10.0):
        """Force-stop: close the endpoints; the loop thread ends at its
        next channel operation (within ``_POLL_S``)."""
        self._close_all()
        if self.thread is not None:
            self.thread.join(timeout=timeout)
