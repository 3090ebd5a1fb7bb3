"""The node manager (port of ray_tpu/core/node.py, the local node): one
node's resources, its placement-group bundles, its card pool and its
pool of worker processes.

**Workers come from a server of their own.** ray_tpu forks workers from
multiprocessing's global forkserver, preloaded with its worker module. A
port worker forked from that server would hold jax and ray_tpu in
``sys.modules`` whenever both packages run in one process (the parity
tests do). So the port starts its own zygote: a multiprocessing
``ForkServer`` instance, not the global one, exec'd fresh, that imports
``ray_tpu_torch.core.worker_main`` (and with it ``torch``) once, never
touches CUDA, and forks a worker per request (``worker_start_method =
"forkserver"``, the default). Each worker takes the driver's ``sys.path``
and working directory from multiprocessing's preparation data, and its
process handle, pipe and sentinel are multiprocessing's own.

**The card.** A worker bound to cards is forked with
``CUDA_VISIBLE_DEVICES`` in the environment it sets first, before it
imports the driver's ``__main__`` or runs anything that could touch
CUDA, and it serves that one task or actor only (``fresh`` and
``env_binding``, as ray_tpu's chip-bound workers). The zygote has no CUDA
context to pass on, and neither may a driver that forks workers itself
(``worker_start_method = "fork"`` is refused once it has one).

**The driver's __main__** is imported in each worker as ``__mp_main__``
from its file (or by module name for ``python -m``), after the
environment is set, so a function or class the driver defined at the
top level of its script resolves by reference (``core/serialization.py``).
multiprocessing's own import of it at the child's start is left out for
that reason.

**A node run by an agent.** ``AgentBackedNode`` is a node whose worker
pool lives in a separate agent process (``core/node_agent.py``) that
dials the head's ``AgentListener`` over authenticated TCP: ``RemoteNode``
when the head started the agent (``add_node(remote=True)``, ray_tpu's
default), ``JoinedNode`` when an ``rt agent`` joined by itself (another
host). The head reaches such a node's workers through proxies
(``_RemoteWorkerProc``, ``_RemoteWorkerConn``) whose frames ride the
agent's socket as pickled bytes the agent relays without reading. The
head starts an agent as a fresh interpreter (``python -m
ray_tpu_torch.core.node_agent``), never a fork of the driver: the agent
imports neither the driver's script nor jax nor ray_tpu, and never
initialises CUDA; it forks its workers from a zygote of its own, each
card-bound one with ``CUDA_VISIBLE_DEVICES`` set before it starts, and
a worker's death reaches the head only once its process has exited (a
card's memory is free by then).
"""

from __future__ import annotations

import contextlib
import io
import multiprocessing as mp
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from multiprocessing import forkserver, popen_forkserver, process, reduction, spawn, util

from ray_tpu_torch._config import get_config
from ray_tpu_torch.core.ids import NodeID, WorkerID

_zygote = None
_zygote_lock = threading.Lock()
# held while a "spawn" or "fork" worker starts: the driver's __main__ is
# hidden from multiprocessing meanwhile (_suppress_child_main_import)
_start_lock = threading.Lock()


class NodeShutDown(RuntimeError):
    """The node shut down before or while a worker was started for it."""


def _zygote_server() -> forkserver.ForkServer:
    global _zygote
    with _zygote_lock:
        if _zygote is None:
            z = forkserver.ForkServer()
            z.set_forkserver_preload(["ray_tpu_torch.core.worker_main"])
            _zygote = z
        return _zygote


def zygote_pid() -> int | None:
    """The zygote's pid while it runs (None before the first worker)."""
    z = _zygote
    return None if z is None else z._forkserver_pid


class _ZygotePopen(popen_forkserver.Popen):
    """multiprocessing's forkserver Popen, against the port's own server."""

    def _launch(self, process_obj):
        prep_data = spawn.get_preparation_data(process_obj._name)
        # the worker imports the driver's __main__ itself, after setting its
        # environment (worker_main.worker_entry)
        prep_data.pop("init_main_from_name", None)
        prep_data.pop("init_main_from_path", None)
        buf = io.BytesIO()
        mp.context.set_spawning_popen(self)
        try:
            reduction.dump(prep_data, buf)
            reduction.dump(process_obj, buf)
        finally:
            mp.context.set_spawning_popen(None)
        self.sentinel, w = _zygote_server().connect_to_new_process(self._fds)
        # a duplicate of the data pipe's write end is the child's sentinel of this process
        _parent_w = os.dup(w)
        self.finalizer = util.Finalize(self, util.close_fds, (_parent_w, self.sentinel))
        with open(w, "wb", closefd=True) as f:
            f.write(buf.getbuffer())
        self.pid = forkserver.read_signed(self.sentinel)


class _ZygoteProcess(process.BaseProcess):
    _start_method = "forkserver"

    @staticmethod
    def _Popen(process_obj):  # noqa: N802 — multiprocessing's hook name
        return _ZygotePopen(process_obj)


class _ZygoteContext:
    Process = _ZygoteProcess

    @staticmethod
    def Pipe(duplex=True):  # noqa: N802 — multiprocessing's name
        return mp.Pipe(duplex)


def _watchdog_stop(stop_fn, pid, name):
    t = threading.Thread(target=stop_fn, daemon=True, name=f"rt-{name}-stop")
    t.start()
    t.join(3.0)
    if t.is_alive() and pid:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass  # it exited meanwhile
        t.join(2.0)


def stop_zygote():
    """Stop the zygote and multiprocessing's resource tracker, each under a
    SIGKILL watchdog: both hold pipes that straggling workers keep open,
    and their finalizers would block the interpreter's exit in waitpid.
    Both start again on demand. The runtime registers this at exit once."""
    global _zygote
    from multiprocessing import resource_tracker

    with _zygote_lock:
        z, _zygote = _zygote, None
    if z is not None and z._forkserver_pid is not None:
        _watchdog_stop(z._stop, z._forkserver_pid, "zygote")
    rt = resource_tracker._resource_tracker
    if getattr(rt, "_pid", None) is not None:
        _watchdog_stop(rt._stop, rt._pid, "tracker")
        # a watchdog kill leaves _pid set: clear it so the module
        # finalizer's second _stop cannot wait on it again
        rt._pid = None
        rt._fd = None


def _ctx():
    method = get_config().worker_start_method
    if method == "forkserver":
        return _ZygoteContext
    if method == "fork":
        import torch

        if torch.cuda.is_initialized():
            raise RuntimeError("worker_start_method='fork': this process holds a CUDA context, which a forked worker "
                               "cannot use; use 'forkserver' (the default) or 'spawn'")
    return mp.get_context(method)


def _driver_main():
    """How a worker imports the driver's __main__: ("name", module) for
    ``python -m``, ("path", file) for a script, None when it has neither."""
    main = sys.modules.get("__main__")
    if main is None:
        return None
    name = getattr(getattr(main, "__spec__", None), "name", None)
    if name:
        return None if name == "__main__" or name.endswith(".__main__") else ("name", name)
    path = getattr(main, "__file__", None)
    if path and os.path.isfile(path):
        return ("path", os.path.abspath(path))
    return None


@contextlib.contextmanager
def _suppress_child_main_import():
    """Keep multiprocessing from importing the driver's __main__ at the
    child's start: the worker imports it itself, after its environment
    is set (``worker_main.worker_entry``)."""
    main = sys.modules.get("__main__")
    if main is None:
        yield
        return
    saved = {}
    for attr in ("__spec__", "__file__"):
        if hasattr(main, attr):
            saved[attr] = getattr(main, attr)
            setattr(main, attr, None)
    try:
        yield
    finally:
        for attr, val in saved.items():
            setattr(main, attr, val)


def gpu_binding(gpus: list[int] | None) -> dict:
    """The environment that binds a worker to ``gpus`` (empty for none)."""
    if not gpus:
        return {}
    from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

    return GPUAcceleratorManager.worker_env_for_chips(gpus)


def fork_worker(wid_hex: str, node_id_hex: str, env: dict, main, session_tag: str | None):
    """Start one worker process (the zygote's fork, or the configured
    start method's); returns (process, the parent's end of its pipe).
    ``main``: how it imports the driver's __main__ (``_driver_main``);
    ``session_tag``: the tag of its segments (None: its namespace's)."""
    from ray_tpu_torch.core.worker_main import worker_entry

    ctx = _ctx()
    parent_conn, child_conn = ctx.Pipe(duplex=True)
    with _start_lock:
        proc = ctx.Process(
            target=worker_entry,
            args=(child_conn, wid_hex, node_id_hex, env, main, session_tag),
            daemon=True,
            name=f"rt-worker-{wid_hex[:8]}",
        )
        if ctx is _ZygoteContext:
            proc.start()  # _ZygotePopen leaves the driver's __main__ out
        else:
            with _suppress_child_main_import():
                proc.start()
    child_conn.close()
    return proc, parent_conn


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    proc: object
    conn: object  # the head's end of the duplex pipe
    node_id: NodeID
    state: str = "starting"  # starting | idle | busy | actor | leased | retiring | dead
    actor_id: object = None
    # the direct call plane: this worker's own listener (host, port), from its ready message
    direct_addr: object = None
    # never executed user code; card-bound work and actors take fresh workers only
    fresh: bool = True
    retired_gpus: object = None
    running_tasks: dict = field(default_factory=dict)  # task_id -> (spec, allocation)
    env_binding: dict = field(default_factory=dict)  # sticky env: CUDA_VISIBLE_DEVICES
    gpus: list = field(default_factory=list)  # the cards this worker was forked for
    last_idle: float = field(default_factory=time.monotonic)
    started_at: float = field(default_factory=time.monotonic)
    ready_s: float | None = None  # seconds from the fork request to its ready message
    send_lock: threading.Lock = field(default_factory=threading.Lock)

    def send(self, msg: dict):
        from ray_tpu_torch.core import rpc_chaos

        if not rpc_chaos.apply("to_worker"):
            return  # chaos: the message is lost on the way
        with self.send_lock:
            self.conn.send(msg)

    def alive(self) -> bool:
        return self.state != "dead" and self.proc.is_alive()


class Node:
    """One node: resources, labels, bundles, cards, worker pool."""

    def __init__(self, node_id: NodeID | None, resources: dict, labels: dict | None = None, env: dict | None = None):
        self.node_id = node_id or NodeID.from_random()
        self.total_resources = dict(resources)
        self.available = dict(resources)
        self.labels = dict(labels or {})
        self.env = dict(env or {})
        self.workers: dict[WorkerID, WorkerHandle] = {}
        self.dispatch_queue: list = []  # (spec, allocation, gpus): resources reserved, waiting for a worker
        self.alive = True
        from ray_tpu_torch.core.lock_sanitizer import make_lock

        self._lock = make_lock("node")  # one lockdep class for all nodes
        # placement-group bundle accounting: pg_id -> {bundle_idx: {res: avail}}
        self.pg_bundles: dict = {}
        self.pg_bundle_totals: dict = {}
        # the card indices handed out as CUDA_VISIBLE_DEVICES
        self._gpus_free = list(range(int(resources.get("GPU", 0))))
        self.worker_pids: list[int] = []  # every worker this node started

    # ---- resources ----
    def feasible(self, resources: dict) -> bool:
        return all(self.total_resources.get(k, 0) >= v for k, v in resources.items() if v > 0)

    def can_allocate(self, resources: dict) -> bool:
        return all(self.available.get(k, 0) >= v - 1e-9 for k, v in resources.items() if v > 0)

    def allocate(self, resources: dict) -> bool:
        with self._lock:
            if not self.can_allocate(resources):
                return False
            for k, v in resources.items():
                if v > 0:
                    self.available[k] = self.available.get(k, 0) - v
            return True

    def release(self, resources: dict):
        with self._lock:
            for k, v in resources.items():
                if v > 0:
                    self.available[k] = min(self.available.get(k, 0) + v, self.total_resources.get(k, 0))

    def utilization(self) -> float:
        """The largest used fraction over the resource dimensions."""
        u = 0.0
        for k, tot in self.total_resources.items():
            if tot > 0:
                u = max(u, 1.0 - self.available.get(k, 0) / tot)
        return u

    # ---- placement-group bundles ----
    def reserve_bundle(self, pg_id, bundle_idx: int, resources: dict) -> bool:
        with self._lock:
            if not self.allocate(resources):
                return False
            self.pg_bundles.setdefault(pg_id, {})[bundle_idx] = dict(resources)
            self.pg_bundle_totals.setdefault(pg_id, {})[bundle_idx] = dict(resources)
            return True

    def return_bundle(self, pg_id, bundle_idx: int):
        with self._lock:
            total = self.pg_bundle_totals.get(pg_id, {}).pop(bundle_idx, None)
            self.pg_bundles.get(pg_id, {}).pop(bundle_idx, None)
            # drop emptied groups: an empty {pg_id: {}} would still read as reserved
            if not self.pg_bundles.get(pg_id):
                self.pg_bundles.pop(pg_id, None)
            if not self.pg_bundle_totals.get(pg_id):
                self.pg_bundle_totals.pop(pg_id, None)
            if total:
                self.release(total)

    def allocate_from_bundle(self, pg_id, bundle_idx: int, resources: dict) -> bool:
        with self._lock:
            avail = self.pg_bundles.get(pg_id, {}).get(bundle_idx)
            if avail is None:
                return False
            if not all(avail.get(k, 0) >= v - 1e-9 for k, v in resources.items() if v > 0):
                return False
            for k, v in resources.items():
                if v > 0:
                    avail[k] = avail.get(k, 0) - v
            return True

    def release_to_bundle(self, pg_id, bundle_idx: int, resources: dict):
        with self._lock:
            avail = self.pg_bundles.get(pg_id, {}).get(bundle_idx)
            total = self.pg_bundle_totals.get(pg_id, {}).get(bundle_idx)
            if avail is None or total is None:
                return
            for k, v in resources.items():
                if v > 0:
                    avail[k] = min(avail.get(k, 0) + v, total.get(k, 0))

    # ---- cards ----
    def take_gpus(self, n: int) -> list[int]:
        with self._lock:
            gpus, self._gpus_free = self._gpus_free[:n], self._gpus_free[n:]
            return gpus

    def return_gpus(self, gpus: list[int]):
        with self._lock:
            self._gpus_free.extend(gpus)

    # ---- workers ----
    def start_worker(self, gpus: list[int] | None = None) -> WorkerHandle:
        """Fork a worker; with ``gpus`` it sees only those cards."""
        from ray_tpu_torch.core.object_store import worker_session_tag

        if not self.alive:
            raise NodeShutDown("node is shut down")
        binding = gpu_binding(gpus)
        wid = WorkerID.from_random()
        t0 = time.monotonic()
        proc, parent_conn = fork_worker(wid.hex(), self.node_id.hex(), {**self.env, **binding}, _driver_main(),
                                        worker_session_tag())
        handle = WorkerHandle(worker_id=wid, proc=proc, conn=parent_conn, node_id=self.node_id,
                              env_binding=binding, gpus=list(gpus or []), started_at=t0)
        with self._lock:
            if not self.alive:
                # the spawn raced shutdown: reap it now
                proc.terminate()
                parent_conn.close()
                raise NodeShutDown("node shut down during worker spawn")
            self.workers[wid] = handle
            self.worker_pids.append(proc.pid)
        return handle

    def idle_workers(self) -> list[WorkerHandle]:
        with self._lock:
            return [w for w in self.workers.values() if w.state == "idle"]

    def remove_worker(self, wid: WorkerID):
        with self._lock:
            self.workers.pop(wid, None)

    def shutdown(self):
        """Stop every worker and wait until its process is gone (a card's
        memory returns only when its process exits)."""
        self.alive = False
        with self._lock:
            workers = list(self.workers.values())
            self.workers.clear()
        for w in workers:
            try:
                w.send({"type": "shutdown"})
            except (OSError, ValueError):
                pass  # its pipe is already closed: it is exiting
        deadline = time.monotonic() + 2.0
        for w in workers:
            w.proc.join(timeout=max(0.0, deadline - time.monotonic()))
            if w.proc.is_alive():
                w.proc.terminate()
        for w in workers:
            w.proc.join(timeout=5.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=5.0)
            w.conn.close()


# ----------------------------------------------------------------------
# a node run by an agent process
# ----------------------------------------------------------------------
# seconds a started agent has to dial back (a fresh interpreter importing torch)
_AGENT_CONNECT_S = 60.0

class AgentListener:
    """The head's TCP rendezvous, gated by an authkey (multiprocessing's
    challenge): agents the head started are matched to their waiting
    ``RemoteNode`` by node id; an agent_ready hello with an unknown node id
    goes to ``on_join`` (an ``rt agent`` from another host), a
    driver_ready hello to ``on_driver`` (``init(address=...)``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, authkey: bytes | None = None, on_join=None,
                 on_driver=None):
        from multiprocessing import connection as mp_connection

        self.authkey = authkey or os.urandom(16)
        self._listener = mp_connection.Listener((host, port), "AF_INET", authkey=self.authkey)
        self.address = self._listener.address  # (host, port)
        self.on_join = on_join
        self.on_driver = on_driver
        self._pending: dict[str, list] = {}  # node id hex -> [Event, conn, hello]
        self._lock = threading.Lock()
        self._stopped = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True, name="rt-agent-listener")
        self._thread.start()

    def expect(self, node_id_hex: str) -> list:
        slot = [threading.Event(), None, None]
        with self._lock:
            self._pending[node_id_hex] = slot
        return slot

    def abandon(self, node_id_hex: str):
        with self._lock:
            self._pending.pop(node_id_hex, None)

    def _accept_loop(self):
        while not self._stopped:
            try:
                conn = self._listener.accept()
            except Exception:  # noqa: BLE001 — a failed handshake (a wrong authkey) ends that dial only
                if self._stopped:
                    return
                continue
            threading.Thread(target=self._handshake, args=(conn,), daemon=True, name="rt-agent-hello").start()

    def _handshake(self, conn):
        try:
            hello = conn.recv()
        except (EOFError, OSError):
            conn.close()
            return
        kind = hello.get("type") if isinstance(hello, dict) else None
        if kind == "driver_ready" and self.on_driver is not None:
            self._hand_over(self.on_driver, conn, hello)
            return
        if kind != "agent_ready":
            conn.close()
            return
        with self._lock:
            slot = self._pending.pop(hello.get("node_id"), None)
        if slot is not None:
            slot[1], slot[2] = conn, hello
            slot[0].set()
        elif self.on_join is not None:
            self._hand_over(self.on_join, conn, hello)
        else:
            conn.close()

    @staticmethod
    def _hand_over(fn, conn, hello):
        try:
            fn(conn, hello)
        except Exception:  # noqa: BLE001 — a refused join closes its connection; the listener goes on
            import logging

            logging.getLogger(__name__).exception("refused a %s", hello.get("type"))
            conn.close()

    def shutdown(self):
        self._stopped = True
        # close() does not wake a blocked accept() on Linux: a throwaway dial
        # does (its failed handshake makes accept raise, and the loop exits)
        import socket

        try:
            with socket.create_connection(self.address, timeout=1.0):
                pass
        except OSError:
            pass
        self._listener.close()
        self._thread.join(timeout=2.0)


class _RemoteWorkerProc:
    """The head's handle of a worker that an agent owns. ``is_alive`` holds
    until the agent reports the process gone (it reports a death only
    after the process exited) or the node dies; ``terminate`` asks the
    agent to kill it."""

    def __init__(self, node: "AgentBackedNode", wid_hex: str):
        self._node = node
        self._wid_hex = wid_hex
        self.pid = None
        self._exited = threading.Event()

    @property
    def dead(self) -> bool:
        return self._exited.is_set()

    def mark_exited(self):
        self._exited.set()

    def is_alive(self) -> bool:
        return not self._exited.is_set() and self._node.alive

    def terminate(self):
        # report=True: the agent's worker_death drives _on_worker_death, as
        # a local worker's pipe EOF does
        self._node.agent_send({"type": "kill_worker", "wid": self._wid_hex, "report": True})

    def join(self, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.is_alive():
            wait = 0.2 if deadline is None else min(0.2, deadline - time.monotonic())
            if wait <= 0:
                return
            self._exited.wait(wait)


class _RemoteWorkerConn:
    """The head's end of a remote worker's pipe: a frame is pickled here
    and rides the agent's socket as bytes the agent relays unread."""

    def __init__(self, node: "AgentBackedNode", wid_hex: str):
        self._node = node
        self._wid_hex = wid_hex

    def send(self, msg):
        from multiprocessing.reduction import ForkingPickler

        self._node.agent_send({"type": "to_worker", "wid": self._wid_hex, "data": bytes(ForkingPickler.dumps(msg))})

    def close(self):
        pass


class AgentBackedNode(Node):
    """A node whose worker pool runs in an agent process, reached over the
    agent's authenticated TCP socket and health-checked by the head's
    ping loop."""

    remote = True
    agent_proc = None

    def _attach(self, conn, hello: dict):
        self.agent_conn = conn
        self.agent_pid = hello["pid"]
        self.transfer_addr = tuple(hello["transfer_addr"]) if hello.get("transfer_addr") else None
        self.shm_ns = hello.get("ns", "")
        self._agent_send_lock = threading.Lock()
        self.last_pong = time.monotonic()
        self.ping_seq = 0

    def agent_send(self, msg):
        with self._agent_send_lock:
            try:
                self.agent_conn.send(msg)
            except (OSError, EOFError, ValueError):
                pass  # the agent is gone: the IO loop's end of file or the health loop removes the node

    def start_worker(self, gpus: list[int] | None = None) -> WorkerHandle:
        if not self.alive:
            raise NodeShutDown("node is shut down")
        wid = WorkerID.from_random()
        binding = gpu_binding(gpus)
        handle = WorkerHandle(worker_id=wid, proc=_RemoteWorkerProc(self, wid.hex()),
                              conn=_RemoteWorkerConn(self, wid.hex()), node_id=self.node_id, env_binding=binding,
                              gpus=list(gpus or []))
        with self._lock:
            self.workers[wid] = handle
        self.agent_send({"type": "start_worker", "wid": wid.hex(), "env": binding})
        return handle

    def on_worker_started(self, wid: WorkerID, pid: int):
        w = self.workers.get(wid)
        if w is not None:
            w.proc.pid = pid
            self.worker_pids.append(pid)

    def shutdown(self):
        """Stop the agent; a head-started agent is waited for, so its
        workers (and their cards' memory) are gone when this returns."""
        self.alive = False
        with self._lock:
            workers = list(self.workers.values())
            self.workers.clear()
        for w in workers:
            w.proc.mark_exited()
        self.agent_send({"type": "shutdown"})
        if self.agent_proc is not None:
            try:
                self.agent_proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                self.agent_proc.kill()
                self.agent_proc.wait(timeout=5.0)
        self.agent_conn.close()


class RemoteNode(AgentBackedNode):
    """A node whose agent the head started on this host; the agent dials
    back into the head's listener, the path an agent of another host
    takes too."""

    def __init__(self, node_id, resources: dict, labels: dict | None = None, env: dict | None = None,
                 listener: AgentListener | None = None, transfer_authkey: bytes = b"", worker_tag: str | None = None,
                 reconnect_s: float = 0.0):
        super().__init__(node_id, resources, labels=labels, env=env)
        slot = listener.expect(self.node_id.hex())
        args = dict(address=listener.address, authkey=listener.authkey, node_id_hex=self.node_id.hex(),
                    env=self.env, transfer_authkey=transfer_authkey, resources=dict(self.total_resources),
                    reconnect_s=reconnect_s, main=_driver_main(), worker_tag=worker_tag,
                    sys_path=[p for p in sys.path if p])
        proc_env = {**os.environ, **{k: str(v) for k, v in self.env.items()}}
        proc_env["PYTHONPATH"] = os.pathsep.join(args["sys_path"])
        # the agent must not take the head's session as its own shm namespace
        # unless its node shares it (RT_SHM_NS comes with shm_isolation)
        if "RT_SHM_NS" not in self.env:
            proc_env.pop("RT_SHM_NS", None)
        self.agent_proc = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch.core.node_agent"],
                                           stdin=subprocess.PIPE, env=proc_env, cwd=os.getcwd())
        self.agent_proc.stdin.write(pickle.dumps(args))
        self.agent_proc.stdin.close()
        # a bounded wait: an agent that dies before it connects (an import
        # failure, an OOM kill) makes add_node raise, not hang
        deadline = time.monotonic() + _AGENT_CONNECT_S
        while not slot[0].wait(timeout=0.2):
            if self.agent_proc.poll() is not None:
                listener.abandon(self.node_id.hex())
                raise RuntimeError(f"the node agent for {self.node_id.hex()[:8]} exited before it connected "
                                   f"(code {self.agent_proc.returncode})")
            if time.monotonic() > deadline:
                listener.abandon(self.node_id.hex())
                self.agent_proc.kill()
                self.agent_proc.wait(timeout=5.0)
                raise RuntimeError(f"the node agent never connected within {_AGENT_CONNECT_S:.0f} s")
        self._attach(slot[1], slot[2])


class JoinedNode(AgentBackedNode):
    """A node whose agent started by itself (``rt agent --address
    head:port``, another host's) and joined through the listener: the
    head holds only its socket."""

    def __init__(self, node_id, conn, hello: dict):
        resources = dict(hello.get("resources") or {"CPU": 1.0})
        labels = dict(hello.get("labels") or {})
        labels.setdefault("ray_tpu.io/node-type", "joined")
        super().__init__(node_id, resources, labels=labels, env=dict(hello.get("env") or {}))
        self._attach(conn, hello)
