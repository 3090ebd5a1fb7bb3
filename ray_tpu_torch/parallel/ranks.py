"""Rank processes: how a tensor-parallel engine runs over a mesh.

ray_tpu is single-controller: one process drives every device of its
mesh, and ``shard_map`` bodies call ``lax.psum``. PyTorch's idiom is one
process per rank over a ``torch.distributed`` process group, and the
port takes it. An object of rank 0 (the engine, in the caller's
process) starts the other ranks as fresh interpreters
(``python -m ray_tpu_torch.parallel.ranks``: a CUDA context cannot be
forked), each of which builds its twin from a factory named by
reference (module, name) and then runs, in order, every operation rank 0
sends it: ``Ranks.send`` (no reply; the operations that hold a
collective run in lockstep with rank 0's own) or ``Ranks.call`` (each
rank's result back). An operation that raises in a rank sends its
traceback, and the rank exits; rank 0's next ``send`` or ``call``
raises it. A rank exits when rank 0 closes it (``Ranks.close``: at the
engine's ``shutdown``, its collection, or interpreter exit) or when its
control socket reaches EOF, which is when rank 0's process dies.

The group (``RankGroup``) is each object's own: a ``TCPStore`` on
127.0.0.1 that rank 0 opens on a free port, and a process group made
from it directly, never the process-global default group, so a
tensor-parallel engine and a trainer's ``init_process_group`` live in one
process. ``nccl`` when every rank has its own card, ``gloo`` otherwise
(``group_backend``; ``train/backend.py`` follows the same rule): NCCL
refuses two ranks on one card, so one H100 serving tp=2 runs gloo on
CUDA tensors. gloo takes CUDA tensors for every op the group runs
(all-reduce, all-gather, all-to-all and broadcast, in f32, bf16 and
int8; ``chip_smoke.py`` phase 4n on the H100 with torch 2.11) and moves
them through host memory itself: that is the transport, not a fallback,
and the arithmetic around it stays on the card. gloo's sockets are on
the loopback device (a lookup of the host's name may wait on a resolver
no one answers). Every op of the group has the group's timeout
(``DEFAULT_TIMEOUT_S``), so a dead rank raises instead of hanging.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import Connection

import torch

from ray_tpu_torch.collective.ici import WireCounter

DEFAULT_TIMEOUT_S = 60.0
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def group_backend(devices) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index or 0 for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


class RankGroup:
    """One object's process group, in one rank: ``all_reduce`` (in place),
    ``all_gather`` and ``all_to_all`` over tensors on ``device``, each op's
    wire bytes counted in ``wire`` (``collective/ici.py``'s factors) and
    its host seconds in ``op_s`` (op -> seconds from the call to the end
    of its wait), and ``broadcast`` (uncounted: it moves weights at
    start-up, not a step's sums)."""

    def __init__(self, store, rank: int, size: int, device, backend: str):
        import torch.distributed as dist

        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        if backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            torch.cuda.set_device(self.device)
            self.pg = dist.ProcessGroupNCCL(store, self.rank, self.size, opts)
        else:
            # over the loopback device: resolving the host's name may wait on a resolver no one answers
            opts = dist.ProcessGroupGloo._Options()
            opts._timeout = timeout
            opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
            self.pg = dist.ProcessGroupGloo(store, self.rank, self.size, opts)
        self.wire = WireCounter(self.size)
        self.op_s: dict = {}  # op -> host seconds spent in it, wait included

    def _wait(self, op: str, t0: float, work) -> None:
        work.wait(datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        self.op_s[op] = self.op_s.get(op, 0.0) + time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, written into ``x`` (contiguous), returned."""
        t0 = time.perf_counter()
        self.wire.add("psum", x)
        self._wait("all_reduce", t0, self.pg.allreduce([x]))
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``[size, *x.shape]``."""
        t0 = time.perf_counter()
        self.wire.add("all_gather", x)
        x = x.contiguous()
        out = torch.empty((self.size, *x.shape), dtype=x.dtype, device=x.device)
        self._wait("all_gather", t0, self.pg.allgather([list(out.unbind(0))], [x]))
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` into every rank's ``x`` (contiguous), in place."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        opts = dist.BroadcastOptions()
        opts.rootRank = int(src)
        self._wait("broadcast", t0, self.pg.broadcast([x], opts))
        return x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [size, ...]: block j goes to rank j; the result's block j
        came from rank j."""
        t0 = time.perf_counter()
        self.wire.add("all_to_all", x)
        x = x.contiguous()
        out = torch.empty_like(x)
        self._wait("all_to_all", t0, self.pg.alltoall_base(out, x, [], []))
        return out

    def close(self) -> None:
        pg, self.pg = self.pg, None
        if pg is not None and hasattr(pg, "shutdown"):
            try:
                pg.shutdown()
            except RuntimeError:  # already torn down by a failed peer
                pass


# ------------------------------------------------------------------- wire
def _send(conn: Connection, obj) -> None:
    """Plain pickle (tensors by value): no shared-memory handles that
    would tie a message to the sender's lifetime."""
    conn.send_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _recv(conn: Connection):
    return pickle.loads(conn.recv_bytes())


class RankError(RuntimeError):
    """An operation failed in another rank (its traceback in the message)."""


class Ranks:
    """Rank 0's handle on ranks 1..n-1 of one object: starts them, opens
    the store and rank 0's own ``group`` (``self.group``), sends them
    operations and closes them. ``factory`` is ``(module, name)`` of a
    function ``f(group, conn, *args, **kwargs)`` that builds a rank's twin
    (it may read further messages from ``conn`` and join collectives, e.g.
    to take its weights from rank 0: ``send_all``)."""

    def __init__(self, devices, factory: tuple, args=(), kwargs=None):
        import torch.distributed as dist

        devices = [torch.device(d) for d in devices]
        self.size = len(devices)
        self.backend = group_backend(devices)
        self._lock = threading.Lock()
        self._closed = False
        self.procs: list = []
        self.conns: list = []
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        self._store = dist.TCPStore("127.0.0.1", 0, self.size, True, timeout=timeout, wait_for_workers=False)
        port = self._store.port
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
        try:
            for r in range(1, self.size):
                parent_sock, child_sock = socket.socketpair()
                proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.parallel.ranks", str(child_sock.fileno())],
                    pass_fds=(child_sock.fileno(),), env=env, stdin=subprocess.DEVNULL)
                child_sock.close()
                conn = Connection(parent_sock.detach())
                self.procs.append(proc)
                self.conns.append(conn)
                _send(conn, {"rank": r, "size": self.size, "port": port, "device": str(devices[r]),
                             "backend": self.backend, "factory": factory,
                             "args": args, "kwargs": kwargs or {}, "threads": torch.get_num_threads()})
            self.group = RankGroup(self._store, 0, self.size, devices[0], self.backend)
        except BaseException as e:
            states = [p.poll() for p in self.procs]
            self.close()
            if isinstance(e, Exception):
                raise RankError(f"rank 0's group did not form ({type(e).__name__}: {e}); the other ranks' exit "
                                f"codes (None: running) {states}") from e
            raise
        # each rank's start-up, (stage, seconds since its spec arrived), from wait_ready
        self.start_stages: list = []

    @property
    def pids(self) -> list:
        return [p.pid for p in self.procs]

    def send_all(self, msg) -> None:
        """One message to every other rank's ``conn`` (a factory reading it)."""
        for conn in self.conns:
            _send(conn, msg)

    def wait_ready(self) -> None:
        """Block until every rank built its twin (raises its traceback);
        ``start_stages`` then holds each rank's start-up stages."""
        self.start_stages = [self._expect(r, conn) for r, conn in enumerate(self.conns, start=1)]

    def _expect(self, r: int, conn: Connection):
        deadline = DEFAULT_TIMEOUT_S * 10  # a rank's build may draw a large tree
        if not conn.poll(deadline):
            raise RankError(f"rank {r} did not answer within {deadline:.0f} s")
        try:
            kind, val = _recv(conn)
        except (EOFError, OSError):
            try:
                code = self.procs[r - 1].wait(timeout=5)
            except subprocess.TimeoutExpired:
                code = None
            raise RankError(f"rank {r} exited (code {code})") from None
        if kind == "err":
            raise RankError(f"rank {r} failed:\n{val}")
        return val

    def check(self) -> None:
        """Raise a rank's pending failure, if one has been reported."""
        for r, conn in enumerate(self.conns, start=1):
            if conn.poll(0):
                self._expect(r, conn)
            elif self.procs[r - 1].poll() is not None:
                raise RankError(f"rank {r} exited (code {self.procs[r - 1].poll()})")

    def failed(self, exc: BaseException, within: float = 2.0) -> None:
        """After rank 0's side of an operation raised ``exc``: raise a
        RankError naming a rank that failed or exited meanwhile (waiting up
        to ``within`` for its exit), from ``exc``; return if none did."""
        end = time.perf_counter() + within
        while True:
            try:
                self.check()
            except RankError as e:
                raise e from exc
            if time.perf_counter() >= end:
                return
            time.sleep(0.05)

    def send(self, op: str, *args) -> None:
        """Run ``op(*args)`` on every other rank, in order, no reply."""
        with self._lock:
            self.check()
            for conn in self.conns:
                _send(conn, (op, args, False))

    def call(self, op: str, *args) -> list:
        """``op(*args)``'s result from each of ranks 1..n-1."""
        with self._lock:
            self.check()
            for conn in self.conns:
                _send(conn, (op, args, True))
            return [self._expect(r, conn) for r, conn in enumerate(self.conns, start=1)]

    def close(self) -> None:
        """Stop the ranks (each finishes its current op first) and drop the
        group; idempotent."""
        if self._closed:
            return
        self._closed = True
        for conn in self.conns:
            try:
                _send(conn, (None, (), False))
            except OSError:
                pass
        for proc in self.procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for conn in self.conns:
            conn.close()
        group = getattr(self, "group", None)
        if group is not None:
            group.close()
        self._store = None


def close_ranks(ranks: "Ranks") -> None:
    """A finalizer's target: close without referencing the owner."""
    ranks.close()


def _rank_main(fd: int) -> int:
    conn = Connection(fd)
    spec = _recv(conn)
    import torch.distributed as dist

    t0 = time.perf_counter()
    stages = []

    def stage(name):
        stages.append((name, round(time.perf_counter() - t0, 3)))

    torch.set_num_threads(int(spec["threads"]))
    try:
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        store = dist.TCPStore("127.0.0.1", spec["port"], spec["size"], False, timeout=timeout)
        stage("store")
        device = torch.device(spec["device"])
        if spec["backend"] == "nccl":
            torch.cuda.set_device(device)
        group = RankGroup(store, spec["rank"], spec["size"], device, spec["backend"])
        stage("group")
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.cuda.synchronize(device)
            stage("device")
        mod, name = spec["factory"]
        obj = getattr(importlib.import_module(mod), name)(group, conn, *spec["args"], **spec["kwargs"])
        stage("built")
        _send(conn, ("ok", stages))
    except BaseException:
        _send(conn, ("err", f"{traceback.format_exc()}start-up stages so far: {stages}"))
        return 1
    while True:
        try:
            op, args, reply = _recv(conn)
        except (EOFError, OSError):
            return 0  # rank 0's process is gone
        if op is None:
            group.close()
            return 0
        try:
            out = getattr(obj, op)(*args)
            if reply:
                _send(conn, ("ok", out))
        except BaseException:
            _send(conn, ("err", traceback.format_exc()))
            return 1


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1])))
