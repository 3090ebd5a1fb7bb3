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

Multi-host nodes (``AgentListener``, ``AgentBackedNode``, ``RemoteNode``,
``JoinedNode``, ``node_agent.py``) are not ported: ``Runtime.add_node``
with ``remote=True`` raises naming their ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
import io
import multiprocessing as mp
import os
import signal
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
        self._lock = threading.RLock()
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
        from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
        from ray_tpu_torch.core.object_store import worker_session_tag
        from ray_tpu_torch.core.worker_main import worker_entry

        if not self.alive:
            raise NodeShutDown("node is shut down")
        ctx = _ctx()
        env = dict(self.env)
        binding = {}
        if gpus:
            binding = GPUAcceleratorManager.worker_env_for_chips(gpus)
            env.update(binding)
        parent_conn, child_conn = ctx.Pipe(duplex=True)
        wid = WorkerID.from_random()
        t0 = time.monotonic()
        with _start_lock:
            proc = ctx.Process(
                target=worker_entry,
                args=(child_conn, wid.hex(), self.node_id.hex(), env, _driver_main(), worker_session_tag()),
                daemon=True,
                name=f"rt-worker-{wid.hex()[:8]}",
            )
            if ctx is _ZygoteContext:
                proc.start()  # _ZygotePopen leaves the driver's __main__ out
            else:
                with _suppress_child_main_import():
                    proc.start()
        child_conn.close()
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
