"""The head runtime on one host (port of ray_tpu/core/runtime.py): the
driver's client and the cluster's control plane in one process.

It owns the head's objects (``ObjectStore``), runs the scheduler over the
nodes, keeps the actor table with its restart state machine and the
placement groups, serves the workers' client RPCs over their pipes, and
answers the direct plane's endpoint lookups and worker leases
(``core/direct.py``). Threads: the IO loop over the worker pipes and the
agents' sockets, the scheduler loop, the ref GC loop (this process's
reference counts), the health loop and the state dump. A local worker's
death is its pipe's end of file; the health loop pings node agents only.

**Across processes.** ``add_node()`` (``remote=True``, ray_tpu's default)
starts a node agent (``core/node_agent.py``) that dials the head's
``AgentListener``; ``shm_isolation`` gives the node a shared-memory
namespace of its own, so every object that crosses to or from it moves
through the transfer servers (``core/transport.py``) as it would between
hosts, with the head as the directory from namespace to server. ``rt
agent`` joins a node from another host the same way. An attached driver
(``init(address=...)``, ``core/driver_client.py``) dials the same
listener and speaks a worker's client protocol. ``gcs_persist_path``
keeps the GCS's tables in an fsync'd log (``FileTableStore``): the KV
(with the job table), the cluster's authkeys and the detached actors,
which the next head on that log re-creates under their ids and names.

**The card is a resource.** ``init`` counts the cards
(``accelerators/gpu.py``) into ``"GPU"``; ``num_gpus`` and ``num_tpus``
both fold into it (``_sched_options``). A task or actor that holds cards
gets a worker forked for exactly them (``CUDA_VISIBLE_DEVICES``) that runs
nothing else; when it is done, or dies, its cards go back to the pool
only after its process has exited, so the card's memory is free before
the next holder is placed. A request no node can hold is infeasible and
stays queued; it never runs on the CPU.

**runtime_env.** ``working_dir`` and ``py_modules`` are packed once per
content (``runtime_env/packaging.py``) into the head's store, pinned and
held; a worker that applied an env serves only tasks of the same env
(``env_binding["runtime_env"]``), a plain task never lands on it, and a
card-bound worker keeps both bindings. ``env_vars`` are applied in the
worker.

**Monitors.** Each worker writes its stdout and stderr to its own file
under ``<session>/logs``; the log monitor streams them to the driver
(``core/log_monitor.py``, ``log_to_driver``). The memory monitor kills
the largest retriable worker under memory pressure
(``core/memory_monitor.py``). ``dump_worker_stacks`` asks every worker
for its threads' stacks on its receive loop.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import connection as mp_connection

from ray_tpu_torch._config import get_config, reset_config
from ray_tpu_torch.core import context
from ray_tpu_torch.core.gcs import Gcs
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID
from ray_tpu_torch.core.node import Node, NodeShutDown, WorkerHandle
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import ObjectStore, StoredObject, read_from_shm
from ray_tpu_torch.core.payloads import decode_payload, encode_value
from ray_tpu_torch.core.scheduler import Scheduler
from ray_tpu_torch.core.serialization import Serialized, deserialize_s
from ray_tpu_torch.core.task_manager import TaskManager
from ray_tpu_torch.core.task_spec import ActorInfo, ArgSpec, Payload, SchedulingOptions, TaskSpec
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    PlacementGroupUnschedulableError,
    TaskError,
)

logger = logging.getLogger(__name__)

_exit_hook_registered = False


#: placeholder for a stream index whose item has not arrived (out-of-order
#: replay gap). Distinct from None, which means end-of-stream to consumers.
_STREAM_HOLE = object()


class GenState:
    """A streaming task's items, as they arrive."""

    __slots__ = ("items", "finished", "error", "error_ref_made", "total_items")

    def __init__(self):
        self.items: list[ObjectID] = []
        self.finished = False
        self.error: BaseException | None = None
        self.error_ref_made = False
        self.total_items = -1  # set when the items list is cleared on exhaustion


class ActorState:
    def __init__(self, info: ActorInfo):
        self.info = info
        self.lock = threading.RLock()
        self.seq = 0
        self.pending: list[tuple] = []  # (spec, msg) queued while not ALIVE
        self.allocation = None  # (node, resources, gpus)
        self.expected_exit = False
        self.waiters = threading.Condition(self.lock)


class PlacementGroupState:
    def __init__(self, pg_id: PlacementGroupID, bundles: list[dict], strategy: str, name: str = ""):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = "PENDING"  # PENDING | CREATED | REMOVED
        self.placements: list = []  # bundle_idx -> NodeID
        self.cond = threading.Condition()


class Runtime:
    """Driver-side CoreClient + cluster control plane."""

    def __init__(
        self,
        resources: dict | None = None,
        num_nodes: int = 1,
        local_mode: bool = False,
        namespace: str = "default",
        system_config: dict | None = None,
        labels: dict | None = None,
    ):
        reset_config()
        self.cfg = get_config()
        self.cfg.update(system_config)
        os.environ["RT_SESSION_PID"] = str(os.getpid())
        # one exit hook stops the zygote before interpreter teardown (a
        # live zygote is reused by the next init() and saves its boot)
        global _exit_hook_registered
        if not _exit_hook_registered:
            import atexit

            from ray_tpu_torch.core.node import stop_zygote

            atexit.register(stop_zygote)
            _exit_hook_registered = True
        from ray_tpu_torch.core.object_store import cleanup_orphan_segments

        cleanup_orphan_segments()
        self.local_mode = local_mode
        self.namespace = namespace
        self.job_id = JobID.from_random()
        self.node_id = None
        self.worker_id = None
        self.current_task_id = None
        self.current_actor_id = None
        self.assigned_resources = {}

        self.store = ObjectStore()
        # the GCS's tables: an fsync'd log when configured, so the KV, the
        # jobs and the detached actors survive a kill -9 of the head
        if self.cfg.gcs_persist_path and not local_mode:
            from ray_tpu_torch.core.table_store import FileTableStore

            self.gcs = Gcs(FileTableStore(self.cfg.gcs_persist_path))
        else:
            self.gcs = Gcs()
        self.task_manager = TaskManager(self)
        self.scheduler = Scheduler(self)
        # the cluster's keys, the same across heads on one persistent GCS:
        # agents that redial a restarted head still hold them
        self._transfer_authkey = self._persistent_secret("transfer_authkey")
        self._listener_authkey = self._persistent_secret("listener_authkey")
        self._direct_authkey = self._persistent_secret("direct_authkey")
        # worker leases of the direct plane: wid -> (node, resources, owner_hex)
        self._leases: dict = {}
        self._leases_lock = threading.Lock()
        from ray_tpu_torch.core.lock_sanitizer import make_lock

        self._nodes_lock = make_lock("runtime.nodes")
        self._drivers: dict = {}  # attached drivers: worker id hex -> _DriverHandle
        self._drivers_lock = threading.Lock()
        # the object directory across shm namespaces: namespace -> the
        # transfer server that serves it, and the node that holds it
        from ray_tpu_torch.core import object_store as _os_mod

        self._head_ns = _os_mod._namespace()
        self._ns_addrs: dict[str, tuple] = {}
        self._ns_nodes: dict[str, NodeID] = {}
        self._shm_ns_counter = 0
        self._transfer_server = None
        self._agent_listener = None
        if not local_mode:
            from ray_tpu_torch.core import transport

            self._transfer_server = transport.ObjectTransferServer(
                self._transfer_authkey, advertise_host=self.cfg.node_manager_host,
                allowed_prefixes=(f"rt{_os_mod._session_tag()}_", f"rt{_os_mod.worker_session_tag()}_"))
            self._ns_addrs[self._head_ns] = self._transfer_server.address
            _os_mod.set_fetch_hook(self._fetch_foreign_segment)
            self.store.remote_free = self._free_foreign_segment
        # dead-worker pipes waiting for the IO loop to close them (_retire_conn)
        self._conn_graveyard: list = []
        self._conn_graveyard_lock = threading.Lock()
        # dump_worker_stacks' open requests: req_id -> (event, results)
        self._stack_pending: dict[str, tuple] = {}
        # runtime_env archives: (path, fingerprint) pairs -> the packed env,
        # and the archives' refs, held for the session
        self._renv_cache: dict = {}
        self._renv_pins: list = []
        self._renv_lock = threading.Lock()
        self._log_monitor = None
        self._memory_monitor = None
        self.nodes: dict[NodeID, Node] = {}
        self.actors: dict[ActorID, ActorState] = {}
        self.placement_groups: dict[PlacementGroupID, PlacementGroupState] = {}
        self._pending_pgs: set = set()  # PENDING pg ids (re-place kicks scan only these)
        self.generators: dict[ObjectID, GenState] = {}
        self._gen_tombstones: collections.deque[ObjectID] = collections.deque()
        self._gen_cond = threading.Condition()
        self._functions: dict[str, Serialized] = {}
        self._local_fn_cache: dict[str, object] = {}
        self._done_callbacks: dict[ObjectID, list] = {}
        self._dc_lock = threading.Lock()
        # reference counting: remote holders per object and pins from live
        # task specs' args; this process's own refs are object_ref's counts
        self._ref_holders: dict[bytes, set[str]] = {}
        self._arg_pins: dict[bytes, int] = {}
        self._freed_ids: collections.deque = collections.deque(maxlen=65536)
        self._freed_set: set = set()
        self._rc_head_lock = threading.Lock()
        from ray_tpu_torch.core import object_ref as _oref_mod

        _oref_mod.set_ref_counting(self.cfg.object_ref_counting)
        self._stopped = False
        # workers a node may start beyond its CPU count before it retires an idle one
        self._worker_count_limit_extra = 4
        # seconds from each worker's fork request to its ready message, in order
        self.worker_ready_s: list[float] = []
        # a large pool: client RPCs like get_object block until the object
        # is produced, so it must exceed the blocked workers at worst
        self._req_pool = ThreadPoolExecutor(max_workers=256, thread_name_prefix="rt-req")

        from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

        base_res = dict(resources or {})
        base_res.setdefault("CPU", float(os.cpu_count() or 4))
        base_res.setdefault("memory", float(2**33))
        base_res.setdefault("GPU", float(GPUAcceleratorManager.get_current_node_num_accelerators()))
        if base_res.get("GPU", 0) <= 0:
            base_res.pop("GPU", None)
        node_labels = {"ray_tpu.io/node-type": "head", **(labels or {})}
        head = Node(None, base_res, labels=node_labels, env=self._base_worker_env())
        self.head_node = head
        self.node_id = head.node_id
        self.nodes[head.node_id] = head
        self.gcs.events.record("node_added", node_id=head.node_id.hex(), resources=base_res)
        if not local_mode:
            from ray_tpu_torch.core.node import AgentListener

            # the rendezvous of node agents (started here, or joined by `rt
            # agent` from another host) and of attached drivers; up once the
            # node table is, since an agent redialing a fixed port joins at once
            self._agent_listener = AgentListener(host=self.cfg.node_manager_host, port=self.cfg.node_manager_port,
                                                 authkey=self._listener_authkey, on_join=self._on_agent_join,
                                                 on_driver=self._on_driver_join)
        for _ in range(max(0, num_nodes - 1)):
            self.add_node(dict(base_res))

        self.store.listeners.append(self._on_sealed)
        # the driver's direct plane: it owns small objects and serves them
        # to workers, and submits direct calls
        self._direct = None
        if self.cfg.direct_calls and self.cfg.object_ref_counting and not local_mode:
            from ray_tpu_torch.core import direct as _direct_mod

            self._direct = _direct_mod.attach(self._direct_authkey, node_hex=self.node_id.hex(), client=self)
        if not local_mode:
            self._io_thread = threading.Thread(target=self._io_loop, daemon=True, name="rt-io")
            self._io_thread.start()
            self._sched_thread = threading.Thread(target=self.scheduler.run_loop, daemon=True, name="rt-sched")
            self._sched_thread.start()
            if self.cfg.object_ref_counting:
                threading.Thread(target=self._ref_gc_loop, daemon=True, name="rt-ref-gc").start()
            self._health_thread = threading.Thread(target=self._health_loop, daemon=True, name="rt-health")
            self._health_thread.start()
            from ray_tpu_torch.util import state as _state

            _state.dump_cluster_info(self)
            if self.cfg.state_dump_interval_s > 0:
                threading.Thread(target=self._state_dump_loop, daemon=True, name="rt-state-dump").start()
            if self.cfg.log_to_driver:
                from ray_tpu_torch.core.log_monitor import LogMonitor

                self._log_monitor = LogMonitor(self._logs_dir()).start()
            from ray_tpu_torch.core.memory_monitor import MemoryMonitor

            self._memory_monitor = MemoryMonitor(self).start()
            if self.cfg.prestart_workers:
                # warm the pool in the background: overlaps the zygote's
                # one-time boot with the caller's own setup
                n = min(int(head.total_resources.get("CPU", 1)), 4)

                def _prestart():
                    for _ in range(n):
                        if self._stopped:  # shutdown can race the warmup
                            return
                        try:
                            head.start_worker()
                        except NodeShutDown:
                            return

                self._prestart_thread = threading.Thread(target=_prestart, daemon=True)
                self._prestart_thread.start()
        if self.cfg.gcs_persist_path and not local_mode:
            self._rehydrate_detached_actors()

    # ------------------------------------------------------------------
    # cluster membership
    # ------------------------------------------------------------------
    def add_node(
        self,
        resources: dict,
        labels: dict | None = None,
        env: dict | None = None,
        remote: bool = True,
        shm_isolation: bool | None = None,
    ) -> Node:
        """Add a node. ``remote=True`` (the default) runs the node's worker
        pool in an agent process of its own, over the agent's socket and
        health-checked; ``remote=False`` adds an in-process node whose
        workers this process forks. ``shm_isolation=True`` (an agent's node)
        gives the node its own shm namespace: every object that crosses
        the node's boundary moves through the transfer servers, as between
        hosts. A node counts cards only as ``resources`` says ("GPU")."""
        if shm_isolation is None:
            shm_isolation = self.cfg.shm_isolation
        env = {**self._base_worker_env(), **(env or {})}
        if remote and not self.local_mode:
            from ray_tpu_torch.core.node import RemoteNode
            from ray_tpu_torch.core.object_store import worker_session_tag

            if shm_isolation:
                self._shm_ns_counter += 1
                env["RT_SHM_NS"] = f"{os.getpid()}n{self._shm_ns_counter}"
            node = RemoteNode(None, resources, labels=labels, env=env, listener=self._agent_listener,
                              transfer_authkey=self._transfer_authkey,
                              worker_tag=None if shm_isolation else worker_session_tag(),
                              reconnect_s=self.cfg.agent_reconnect_s)
            self._register_node_transfer(node)
        elif shm_isolation:
            raise ValueError("shm_isolation needs a node run by an agent (remote=True): an in-process node's "
                             "workers share this process's namespace")
        else:
            node = Node(None, resources, labels=labels, env=env)
        with self._nodes_lock:
            self.nodes[node.node_id] = node
        self.gcs.events.record("node_added", node_id=node.node_id.hex(), resources=resources)
        self.gcs.pubsub.publish("node", {"event": "added", "node_id": node.node_id.hex()})
        self.scheduler.bump_capacity()
        return node

    def _persistent_secret(self, name: str) -> bytes:
        key = self.gcs.store.get("cluster_secrets", name)
        if key is None:
            key = os.urandom(16)
            self.gcs.store.put("cluster_secrets", name, key)
        return key

    def _base_worker_env(self) -> dict:
        """The env every worker must see explicitly: the zygote froze
        os.environ at its boot, so driver-side settings made later (e.g.
        tracing) reach workers only through the per-worker env."""
        env = {}
        from ray_tpu_torch.util import tracing

        if tracing.enabled():
            env["RT_TRACING"] = "1"
        if self.cfg.direct_calls and self.cfg.object_ref_counting and not self.local_mode:
            env["RT_DIRECT_AUTHKEY"] = self._direct_authkey.hex()
        env["RT_LOG_DIR"] = self._logs_dir()
        return env

    @staticmethod
    def _logs_dir() -> str:
        """The workers' log files: ``<session>/logs``."""
        from ray_tpu_torch.util.tracing import session_dir

        return os.path.join(session_dir(), "logs")

    def _register_node_transfer(self, node):
        ns = getattr(node, "shm_ns", "")
        if ns and getattr(node, "transfer_addr", None):
            self._ns_addrs.setdefault(ns, node.transfer_addr)
            self._ns_nodes[ns] = node.node_id

    def _state_dump_loop(self):
        """The session's state.json for the CLI, every ``state_dump_interval_s``."""
        from ray_tpu_torch.util import state as _state

        while not self._stopped:
            time.sleep(self.cfg.state_dump_interval_s)
            if self._stopped:
                return
            try:
                _state.dump_state(self)
            except Exception:  # noqa: BLE001 — a snapshot that fails is skipped; the next one is tried
                logger.debug("state dump failed", exc_info=True)

    # ---- attached drivers ----
    def _on_driver_join(self, conn, hello: dict):
        """A driver process attached through the listener
        (``init(address=...)``): it speaks a worker's client protocol over
        its socket, with a pump thread of its own; its references and
        leases are dropped when it goes, as a dead worker's."""
        import socket

        wid = WorkerID.from_random()
        handle = _DriverHandle(conn, wid)
        handle.send({
            "type": "driver_welcome",
            "worker_id": wid.hex(),
            "node_id": self.node_id.hex(),
            "session_pid": os.getpid(),
            "namespace": self.namespace,
            "hostname": socket.gethostname(),
            "direct_authkey": self._direct_authkey.hex() if self._direct is not None else None,
        })
        # registered only after the welcome went through: a dialer that died
        # mid-handshake leaves nothing behind
        with self._drivers_lock:
            self._drivers[wid.hex()] = handle
        threading.Thread(target=self._driver_pump, args=(handle,), daemon=True,
                         name=f"rt-driver-{wid.hex()[:8]}").start()
        self.gcs.events.record("driver_attached", worker_id=wid.hex(), pid=hello.get("pid"))

    def _driver_pump(self, handle: "_DriverHandle"):
        wid_hex = handle.worker_id.hex()
        try:
            while not self._stopped:
                try:
                    msg = handle.conn.recv()
                except (EOFError, OSError):
                    break
                if msg.get("type") == "driver_bye":
                    break
                self._dispatch_client_msg(handle, msg)
        finally:
            with self._drivers_lock:
                self._drivers.pop(wid_hex, None)
            self._drop_holder(wid_hex)
            self._release_leases_of_owner(wid_hex)
            handle.conn.close()
            self.gcs.events.record("driver_detached", worker_id=wid_hex)

    # ---- node agents ----
    def _on_agent_join(self, conn, hello: dict):
        """An agent that started by itself (``rt agent``, another host's)
        joined through the listener: adopt it as a node."""
        from ray_tpu_torch.core.node import JoinedNode

        node_id = NodeID.from_hex(hello["node_id"])
        with self._nodes_lock:
            stale = self.nodes.get(node_id)
        if stale is not None:
            # a re-join after a dropped connection: the old record's socket is dead
            self.remove_node(node_id, graceful=False)
        node = JoinedNode(node_id, conn, hello)
        self._register_node_transfer(node)
        with self._nodes_lock:
            self.nodes[node.node_id] = node
        self.gcs.events.record("node_added", node_id=node.node_id.hex(), resources=node.total_resources, joined=True)
        self.gcs.pubsub.publish("node", {"event": "added", "node_id": node.node_id.hex()})
        logger.info("node %s joined through the agent listener (ns %r)", node.node_id.hex()[:8], node.shm_ns)
        self.scheduler.bump_capacity()

    def _on_agent_death(self, node: Node):
        """A node agent is gone: its whole node is dead."""
        if not node.alive:
            return
        logger.warning("node agent %s died; removing its node", node.node_id.hex()[:8])
        self.remove_node(node.node_id, graceful=False)

    def _health_loop(self):
        """Ping the node agents every ``health_check_period_s``; a node whose
        agent answered none for ``health_check_failure_threshold`` periods
        is dead."""
        from ray_tpu_torch.core import rpc_chaos

        period = self.cfg.health_check_period_s
        threshold = self.cfg.health_check_failure_threshold
        while not self._stopped:
            time.sleep(period)
            for node in self.node_list():
                if not getattr(node, "remote", False) or not node.alive:
                    continue
                if time.monotonic() - node.last_pong > period * threshold:
                    logger.warning("node %s missed %d health checks; declaring it dead", node.node_id.hex()[:8],
                                   threshold)
                    # off the loop: the removal waits for a hung agent (up to
                    # 15 s) while the other nodes' pings must go on
                    threading.Thread(target=self._on_agent_death, args=(node,), daemon=True,
                                     name="rt-node-death").start()
                    continue
                node.ping_seq += 1
                if rpc_chaos.apply("ping"):
                    node.agent_send({"type": "ping", "seq": node.ping_seq})

    def _handle_agent_msg(self, node: Node, msg: dict):
        """One message from a node agent's socket."""
        from multiprocessing.reduction import ForkingPickler

        from ray_tpu_torch.core import rpc_chaos

        t = msg.get("type")
        if not rpc_chaos.apply(t):
            return  # chaos: the message is lost
        if t == "from_worker":
            w = node.workers.get(WorkerID.from_hex(msg["wid"]))
            if w is not None and w.state != "dead":
                self._handle_worker_msg(node, w, ForkingPickler.loads(msg["data"]))
        elif t == "worker_death":
            w = node.workers.get(WorkerID.from_hex(msg["wid"]))
            if w is not None:
                w.proc.mark_exited()
                self._on_worker_death(node, w, msg.get("reason", "worker died"))
        elif t == "worker_started":
            node.on_worker_started(WorkerID.from_hex(msg["wid"]), msg.get("pid"))
        elif t == "pong":
            node.last_pong = time.monotonic()
        elif t == "resolve_ns":
            ns = msg.get("ns", "")
            node.agent_send({"type": "ns_addr", "ns": ns, "addr": self._ns_addrs.get(ns)})

    # ---- segments of other namespaces (the head's side) ----
    def _fetch_foreign_segment(self, desc) -> str:
        """The object store's fetch hook: pull a foreign namespace's segment
        into the head's; returns the local name."""
        from ray_tpu_torch.core import object_store as _os_mod
        from ray_tpu_torch.core import transport

        addr = self._ns_addrs.get(desc.ns)
        if addr is None:
            raise FileNotFoundError(f"no transfer address for shm namespace {desc.ns!r} (its node is gone)")
        local = _os_mod.local_shm_name(desc)
        transport.pull_segment(addr, self._transfer_authkey, desc.shm_name, local)
        _os_mod._written.add(local)  # the session's shutdown unlinks this copy
        return local

    def _free_foreign_segment(self, desc):
        """The object store's remote free: the agent of the namespace's node
        unlinks the segment."""
        node_id = self._ns_nodes.get(desc.ns)
        if node_id is None:
            return
        with self._nodes_lock:
            node = self.nodes.get(node_id)
        if node is not None and getattr(node, "remote", False) and node.alive:
            node.agent_send({"type": "free_shm", "name": desc.shm_name})

    # ---- detached actors across heads (a persistent GCS) ----
    def _persist_detached_actor(self, info: ActorInfo, func_blob):
        """Record what a restarted head needs to re-create the actor: its
        creation spec and its class's code reference (a class of the
        driver's script names the script). Only inline constructor
        arguments: one in the object plane would dangle after a restart."""
        import pickle

        spec = info.creation_spec
        kwargs = getattr(spec, "_kwargs", {}) or {}
        if any(a.ref is not None or (a.payload is not None and a.payload.shm is not None)
               for a in [*spec.args, *kwargs.values()]):
            logger.warning("detached actor %s is not persisted: its constructor arguments live in the object "
                           "plane", info.name or info.actor_id.hex()[:8])
            return
        blob = pickle.dumps({
            "spec": spec,
            "kwargs": kwargs,
            "func_blob": func_blob if func_blob is not None else self._functions.get(spec.func_id),
            "name": info.name,
            "namespace": info.namespace,
            "detached": True,
        })
        self.gcs.persist_detached_actor(info.actor_id, blob)

    def _rehydrate_detached_actors(self):
        """At the start of a head on a persistent GCS: re-create the detached
        actors the earlier head recorded, under their actor ids and names.
        An actor whose record or class does not resolve here is marked dead
        with that error (``ray_tpu_torch.get_actor`` of its name fails with
        it); it is never skipped silently."""
        import pickle

        for actor_hex, blob in self.gcs.load_detached_actors().items():
            try:
                rec = pickle.loads(blob)
                spec = rec["spec"]
                if spec.actor_id in self.actors:
                    continue
                self.register_function(spec.func_id, rec.get("func_blob"))
                self.get_function(spec.func_id)  # its class must resolve in this head's processes
            except Exception as e:  # noqa: BLE001 — the failure is the actor's: recorded as its death below
                self._rehydration_failed(actor_hex, blob, e)
                continue
            spec._kwargs = rec.get("kwargs", {})
            spec.attempt = 0
            info = ActorInfo(
                actor_id=spec.actor_id,
                name=rec.get("name"),
                namespace=rec.get("namespace", "default"),
                class_id=spec.func_id,
                state="PENDING",
                max_restarts=spec.max_restarts,
                max_task_retries=spec.max_task_retries,
                max_concurrency=spec.max_concurrency,
                creation_spec=spec,
                resources=dict(spec.scheduling.resources),
                placement_group=None,
                bundle_index=-1,
                detached=True,
            )
            if info.name:
                self.gcs.register_named_actor(info.name, info.namespace, spec.actor_id)
            self.actors[spec.actor_id] = ActorState(info)
            self.task_manager.register(spec)
            self.gcs.events.record("actor_rehydrated", actor_id=actor_hex, name=info.name or "")
            self.scheduler.submit(spec)

    def _rehydration_failed(self, actor_hex: str, blob: bytes, err: BaseException):
        """A recorded detached actor this head cannot re-create: it is dead
        with the error (its ready reference raises it), and it says so."""
        import pickle

        name, namespace = None, "default"
        try:
            rec = pickle.loads(blob)
            name, namespace = rec.get("name"), rec.get("namespace", "default")
        except Exception:  # noqa: BLE001 — an unreadable record still fails loudly, by its id
            pass
        actor_id = ActorID.from_hex(actor_hex)
        cause = f"re-creating detached actor {name or actor_hex[:8]} after a head restart failed: {err!r}"
        logger.error(cause)
        info = ActorInfo(actor_id=actor_id, name=name, namespace=namespace, class_id="", state="DEAD",
                         detached=True, death_cause=cause)
        self.actors[actor_id] = ActorState(info)
        self.store.put_error(_actor_ready_oid(actor_id), ActorDiedError(actor_id, cause))
        self.gcs.events.record("actor_dead", actor_id=actor_hex, cause=cause)

    def remove_node(self, node_id: NodeID, graceful: bool = False):
        """A node's death: its workers die (their tasks retry, their actors
        restart elsewhere) and its queued tasks go back to the scheduler."""
        with self._nodes_lock:
            node = self.nodes.get(node_id)
        if node is None:
            return
        # tasks with resources reserved but no worker yet go back to the
        # scheduler; alive flips and the queue drains under the node's lock
        # so _dispatch_node cannot pop a spec this drain also resubmits
        with node._lock:
            node.alive = False
            queued = list(node.dispatch_queue)
            node.dispatch_queue.clear()
        workers = list(node.workers.values())
        for w in workers:
            self._on_worker_death(node, w, "node removed")
            w.proc.terminate()
        for spec, _alloc, _gpus in queued:
            if spec.is_actor_creation or spec.actor_id is None:
                self.scheduler.submit(spec)
        node.shutdown()
        with self._nodes_lock:
            self.nodes.pop(node_id, None)
        ns = getattr(node, "shm_ns", "")
        if ns and ns != self._head_ns:
            # the node's namespace dies with it: lookups fail fast, and its
            # objects fall back to lineage reconstruction
            self._ns_addrs.pop(ns, None)
            self._ns_nodes.pop(ns, None)
            # an agent killed before its own cleanup leaves them on this host
            from ray_tpu_torch.core.object_store import unlink_tagged

            unlink_tagged(ns)
        self.gcs.events.record("node_removed", node_id=node_id.hex())
        self.gcs.pubsub.publish("node", {"event": "removed", "node_id": node_id.hex()})
        # membership changed: parked shapes re-evaluate
        self.scheduler.bump_capacity()

    def node_list(self) -> list[Node]:
        with self._nodes_lock:
            return [n for n in self.nodes.values() if n.alive]

    # ------------------------------------------------------------------
    # object plane (CoreClient impl)
    # ------------------------------------------------------------------
    def put_object(self, value) -> ObjectRef:
        from ray_tpu_torch.core import direct as _direct

        ref, s = _direct.try_put(value)
        if ref is not None:
            return ref
        obj_id = ObjectID.from_put()
        self.store.put_serialized(obj_id, s if s is not None else _to_serialized(value))
        return ObjectRef(obj_id)

    def put_payload(self, obj_id: ObjectID, payload: Payload):
        # wrap contained ids as live refs on the entry: the head's local
        # ref count then pins inner objects while the container lives
        contained = [ObjectRef(c) for c in (payload.contained or [])]
        if payload.shm is not None:
            self.store.seal(obj_id, StoredObject(shm=payload.shm, contained_refs=contained))
        else:
            self.store.seal(obj_id, StoredObject(value=payload.inline, contained_refs=contained))

    def get_object(self, obj_id: ObjectID, timeout: float | None = None, _depth: int = 0):
        from ray_tpu_torch.core import direct as _direct
        from ray_tpu_torch.exceptions import ObjectLostError

        for _attempt in range(3):
            handled, v = _direct.maybe_get_owned(obj_id, timeout)
            if handled:
                return v
            try:
                return self._get_object_store(obj_id, timeout)
            except ObjectLostError:
                # owner-side lineage: a head-sealed direct result can be
                # replayed by its owner (this process) even though the
                # head never saw the producing task
                if not _direct.try_reconstruct(self, obj_id):
                    raise
        raise ObjectLostError(f"object {obj_id.hex()[:16]} lost repeatedly despite lineage replay")

    def _get_object_store(self, obj_id: ObjectID, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            entry = self._get_entry_reconstructing(obj_id, deadline)
            if entry is None:
                raise GetTimeoutError(f"get() timed out waiting for {obj_id.hex()[:16]}")
            if entry.error is not None:
                raise entry.error
            if entry.shm is not None:
                try:
                    # zero-copy: tensors are views of a private mapping of
                    # the segment (core/object_store.py)
                    s, _ = read_from_shm(entry.shm, zero_copy=True)
                except FileNotFoundError:
                    # raced an eviction or the bytes were spilled to disk
                    self.store.restore_or_mark_lost(obj_id)
                    continue
                return deserialize_s(s)
            return deserialize_s(entry.value)

    def _get_entry_reconstructing(self, obj_id, deadline):
        while True:
            if obj_id in self._freed_set:
                from ray_tpu_torch.exceptions import ObjectLostError

                raise ObjectLostError(
                    f"object {obj_id.hex()[:16]} was freed: every reference "
                    "went out of scope (reference counting)"
                )
            timeout = None if deadline is None else max(0.0, deadline - time.monotonic())
            if self.store.is_evicted(obj_id):
                self.task_manager.reconstruct(obj_id)
            entry = self.store.get_entry(obj_id, timeout=0.2 if timeout is None else min(timeout, 0.2))
            if entry is not None:
                if not self.store.shm_backing_exists(entry):
                    self.store.restore_or_mark_lost(obj_id)
                    continue
                return entry
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def entry_to_payload(self, entry: StoredObject) -> Payload:
        if entry.error is not None:
            return encode_value(entry.error)
        if entry.shm is not None:
            return Payload(shm=entry.shm)
        s = entry.value
        return Payload(inline=Serialized(header=s.header, buffers=[bytes(b) for b in s.buffers]))

    def wait_ready(self, obj_ids, num_returns=1, timeout=None, fetch_local=True):
        from ray_tpu_torch.core import direct as _direct

        return _direct.wait_mixed(
            self, list(obj_ids), num_returns, timeout,
            lambda ids, nr, t: self.store.wait_ready(ids, nr, t),
        )

    def add_done_callback(self, obj_id: ObjectID, cb):
        from ray_tpu_torch.core import direct as _direct

        if _direct.add_done_callback_owned(obj_id, cb):
            return
        with self._dc_lock:
            if not self.store.contains(obj_id):
                self._done_callbacks.setdefault(obj_id, []).append(cb)
                return
        self._req_pool.submit(self._fire_callback, obj_id, cb)

    def _fire_callback(self, obj_id, cb):
        try:
            v = self.get_object(obj_id)
            cb(v, None)
        except BaseException as e:  # noqa: BLE001
            cb(None, e)

    def free_objects(self, obj_ids):
        from ray_tpu_torch.core import direct as _direct

        for oid in _direct.free_owned(list(obj_ids)):
            self.store.delete(oid)

    def dump_worker_stacks(self, worker_prefix: str = "", timeout: float = 10.0) -> dict:
        """The live Python stacks of every worker (whose id starts with
        ``worker_prefix``): each answers on its receive loop, which stays
        free while its exec threads run user code. {worker id hex: {pid,
        current_task, stacks: {thread: stack}}}; a worker that does not
        answer within ``timeout`` is reported ``unresponsive``, never
        waited for longer."""
        import uuid

        req_id = uuid.uuid4().hex[:12]
        ev = threading.Event()
        results: dict = {}
        targets = [(w, w.worker_id.hex()) for node in self.node_list() for w in list(node.workers.values())
                   if w.worker_id.hex().startswith(worker_prefix) and w.state not in ("starting", "dead", "retiring")]
        if not targets:
            return {}
        with self._dc_lock:
            self._stack_pending[req_id] = (ev, results)
        try:
            for w, _ in targets:
                try:
                    w.send({"type": "stack_dump", "req_id": req_id})
                except (OSError, ValueError):
                    pass  # its pipe closed: it is reported unresponsive
            deadline = time.monotonic() + timeout
            while len(results) < len(targets) and time.monotonic() < deadline:
                ev.wait(timeout=0.2)
                ev.clear()
        finally:
            with self._dc_lock:
                self._stack_pending.pop(req_id, None)
        for _, whex in targets:
            if whex not in results:
                results[whex] = {"unresponsive": True, "stacks": {}}
        return results

    def object_locations(self, obj_ids) -> dict:
        """The node holding each object's primary copy: for the head store's
        entries the node of the segment's namespace (the head's for inline
        values), the owner's for owned ones, None when unknown."""
        from ray_tpu_torch.core import direct as _direct

        out = {}
        head_hex = self.node_id.hex()
        for oid in obj_ids:
            entry = self.store.try_get_entry(oid)
            if entry is None:
                out[oid.hex()] = _direct.owned_location(oid.binary())
            elif entry.shm is None or entry.shm.ns == self._head_ns:
                out[oid.hex()] = head_hex
            else:
                # a segment's namespace is its location: the node that holds it
                nid = self._ns_nodes.get(entry.shm.ns)
                out[oid.hex()] = nid.hex() if nid is not None else None
        return out

    def _on_sealed(self, obj_id: ObjectID):
        self.scheduler.on_object_sealed(obj_id)
        with self._dc_lock:
            cbs = self._done_callbacks.pop(obj_id, None)
        if cbs:
            for cb in cbs:
                self._req_pool.submit(self._fire_callback, obj_id, cb)

    # ------------------------------------------------------------------
    # function registry
    # ------------------------------------------------------------------
    def register_function(self, func_id: str, blob: Serialized | None):
        if blob is not None and func_id not in self._functions:
            self._functions[func_id] = Serialized(header=blob.header, buffers=[bytes(b) for b in blob.buffers])

    def has_function(self, func_id: str) -> bool:
        return func_id in self._functions

    def get_function_blob(self, func_id: str) -> Serialized:
        return self._functions[func_id]

    def get_function(self, func_id: str):
        if func_id not in self._local_fn_cache:
            from ray_tpu_torch.core.serialization import resolve_code

            self._local_fn_cache[func_id] = resolve_code(*deserialize_s(self._functions[func_id]))
        return self._local_fn_cache[func_id]

    # ------------------------------------------------------------------
    # task submission (CoreClient impl)
    # ------------------------------------------------------------------
    def submit_task(
        self,
        name: str,
        func_id: str,
        args: list[ArgSpec],
        kwargs: dict[str, ArgSpec] | None = None,
        num_returns: int = 1,
        streaming: bool = False,
        func_blob: Serialized | None = None,
        options: dict | None = None,
    ):
        self.register_function(func_id, func_blob)
        opts = options or {}
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            name=name,
            func_id=func_id,
            args=args,
            num_returns=num_returns,
            streaming=streaming,
            scheduling=_sched_options(opts),
            max_retries=opts.get("max_retries", self.cfg.default_max_retries),
            retry_exceptions=opts.get("retry_exceptions", False),
            runtime_env=self._prepare_runtime_env(opts.get("runtime_env")),
            trace_ctx=opts.get("_trace_ctx"),
        )
        spec._kwargs = kwargs or {}
        self.task_manager.register(spec)
        if self.local_mode:
            self._local_execute(spec)
        elif not self._fast_submit(spec):
            self.scheduler.submit(spec)
        if streaming:
            return [spec.generator_id()]
        return spec.return_ids()

    def _fast_submit(self, spec: TaskSpec) -> bool:
        """Submit-side fast path: an unconstrained task whose dependencies
        are all local is reserved and dispatched on the calling thread,
        without the scheduler thread's hop. Constrained placement or tight
        capacity goes through the policy queue."""
        s = spec.scheduling
        if (
            s.placement_group is not None
            or s.node_id is not None
            or s.soft_node_id is not None
            or s.label_selector
            or s.scheduling_strategy != "DEFAULT"
        ):
            return False
        if self.scheduler.has_pending():
            return False  # don't jump ahead of queued work
        for a in spec.args:
            if a.ref is not None and not self.store.contains(a.ref):
                return False
        for node in self.node_list():
            if node.alive and self.reserve_and_queue(node, spec):
                self._dispatch_node(node)
                return True
        return False

    def _prepare_runtime_env(self, renv: dict | None) -> dict | None:
        """Pack ``working_dir`` and ``py_modules`` into the head's store,
        once per content (cached by each path's fingerprint, so an edit
        packs again); ``pip``, ``conda``, ``uv`` and ``container`` raise
        ValueError on every submit (``runtime_env/packaging.py``)."""
        if not renv:
            return renv
        from ray_tpu_torch.runtime_env.packaging import (GATED, dir_fingerprint, prepare_runtime_env,
                                                         validate_runtime_env)

        if not any(k in renv for k in ("working_dir", "py_modules", *GATED)):
            return renv
        validate_runtime_env(renv)
        key = tuple((p, dir_fingerprint(p)) for p in [renv.get("working_dir"), *(renv.get("py_modules") or ())] if p)
        with self._renv_lock:
            cached = self._renv_cache.get(key)
            if cached is None:
                prepared = prepare_runtime_env({k: v for k, v in renv.items() if k != "env_vars"},
                                               self._put_head_object)
                for packed in [prepared.get("_packed_working_dir"), *(prepared.get("_packed_py_modules") or [])]:
                    if packed:
                        # the id travels as a hex string inside the env, which
                        # the reference counter cannot see: the archive is
                        # pinned against eviction and its ref held for the session
                        ref = packed.pop("_ref")
                        self.store.pin(ref.id)
                        self._renv_pins.append(ref)
                cached = self._renv_cache[key] = prepared
        out = dict(cached)
        if renv.get("env_vars"):
            out["env_vars"] = renv["env_vars"]
        return out

    def _put_head_object(self, value) -> ObjectRef:
        """Store ``value`` in the head's store (not as an object this
        process owns on the direct plane): any worker fetches it by id."""
        obj_id = ObjectID.from_put()
        self.store.put_serialized(obj_id, _to_serialized(value))
        return ObjectRef(obj_id)

    def resubmit(self, spec: TaskSpec):
        """Re-run a task (retry or lineage reconstruction)."""
        spec.attempt += 1
        if spec.actor_id is not None and not spec.is_actor_creation:
            self._submit_actor_spec(spec)
        elif self.local_mode:
            self._local_execute(spec)
        else:
            self.scheduler.submit(spec)

    # ------------------------------------------------------------------
    # actors (CoreClient impl)
    # ------------------------------------------------------------------
    def create_actor(
        self,
        name_desc: str,
        func_id: str,
        args: list[ArgSpec],
        kwargs: dict | None = None,
        func_blob: Serialized | None = None,
        options: dict | None = None,
    ) -> dict:
        self.register_function(func_id, func_blob)
        opts = options or {}
        actor_id = ActorID.from_random()
        actor_name = opts.get("name")
        namespace = opts.get("namespace", self.namespace)
        if actor_name:
            if not self.gcs.register_named_actor(actor_name, namespace, actor_id):
                raise ValueError(f"actor name {actor_name!r} already taken in namespace {namespace!r}")
        spec = TaskSpec(
            task_id=TaskID.from_random(),
            name=f"{name_desc}.__init__",
            func_id=func_id,
            args=args,
            num_returns=0,
            scheduling=_sched_options(opts, is_actor=True),
            actor_id=actor_id,
            is_actor_creation=True,
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            runtime_env=self._prepare_runtime_env(opts.get("runtime_env")),
        )
        spec._kwargs = kwargs or {}
        info = ActorInfo(
            actor_id=actor_id,
            name=actor_name,
            namespace=namespace,
            class_id=func_id,
            state="PENDING",
            max_restarts=spec.max_restarts,
            max_task_retries=spec.max_task_retries,
            max_concurrency=spec.max_concurrency,
            creation_spec=spec,
            resources=dict(spec.scheduling.resources),
            placement_group=spec.scheduling.placement_group,
            bundle_index=spec.scheduling.bundle_index,
            detached=opts.get("lifetime") == "detached",
        )
        self.actors[actor_id] = ActorState(info)
        self.task_manager.register(spec)
        self.gcs.events.record("actor_created", actor_id=actor_id.hex(), name=name_desc)
        if info.detached and self.cfg.gcs_persist_path and not self.local_mode:
            self._persist_detached_actor(info, func_blob)
        if self.local_mode:
            self._local_create_actor(spec)
        else:
            self.scheduler.submit(spec)
        return {"actor_id": actor_id, "method_meta": {}}

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: list[ArgSpec],
        kwargs: dict | None = None,
        num_returns: int = 1,
        streaming: bool = False,
        options: dict | None = None,
    ):
        astate = self.actors.get(actor_id)
        if astate is None:
            raise ActorDiedError(actor_id, "unknown actor")
        with astate.lock:
            if astate.info.state == "DEAD":
                err_ids = self._make_actor_error_returns(actor_id, method_name, num_returns, streaming, astate.info.death_cause)
                return err_ids
            astate.seq += 1
            spec = TaskSpec(
                task_id=TaskID.for_actor(actor_id, astate.seq),
                name=f"{method_name}",
                func_id="",
                args=args,
                num_returns=num_returns,
                streaming=streaming,
                actor_id=actor_id,
                method_name=method_name,
                seq_no=astate.seq,
                max_retries=astate.info.max_task_retries,
                trace_ctx=(options or {}).get("_trace_ctx"),
            )
            spec._kwargs = kwargs or {}
            self.task_manager.register(spec)
            if self.local_mode:
                self._local_actor_call(spec)
            else:
                self._submit_actor_spec(spec)
        if streaming:
            return [spec.generator_id()]
        return spec.return_ids()

    def _make_actor_error_returns(self, actor_id, method_name, num_returns, streaming, cause):
        tid = TaskID.from_random()
        err = ActorDiedError(actor_id, cause or "actor is dead")
        ids = []
        if streaming:
            ids = [ObjectID.for_task_return(tid, 0)]
        else:
            ids = [ObjectID.for_task_return(tid, i) for i in range(num_returns)]
        for oid in ids:
            self.store.put_error(oid, err)
        return ids

    def _submit_actor_spec(self, spec: TaskSpec):
        astate = self.actors[spec.actor_id]
        with astate.lock:
            if astate.info.state == "ALIVE":
                self._dispatch_actor_task(astate, spec)
            elif astate.info.state in ("PENDING", "RESTARTING"):
                astate.pending.append(spec)
            else:
                err = ActorDiedError(spec.actor_id, astate.info.death_cause)
                for oid in self._spec_return_ids(spec):
                    self.store.put_error(oid, err)

    def _dispatch_actor_task(self, astate: ActorState, spec: TaskSpec):
        node = self.nodes.get(astate.info.node_id)
        worker = node.workers.get(astate.info.worker_id) if node else None
        if worker is None or not worker.alive():
            astate.pending.append(spec)
            return
        msg = self._build_exec_msg(spec, node, resources=astate.info.resources, env=None)
        if msg is None:
            return  # dependency error already sealed
        worker.running_tasks[spec.task_id] = (spec, None)
        self.task_manager.mark_running(spec.task_id, node.node_id, worker.worker_id)
        try:
            worker.send(msg)
        except (OSError, ValueError):
            # pipe closed between alive() check and send: route through the
            # normal worker-death path (restart machinery + retry policy)
            # instead of raising to the submit_actor_task caller
            self._on_worker_death(node, worker, "send failed")

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        astate = self.actors.get(actor_id)
        if astate is None:
            return
        with astate.lock:
            astate.expected_exit = no_restart
            if no_restart:
                astate.info.max_restarts = 0
            node = self.nodes.get(astate.info.node_id)
            worker = node.workers.get(astate.info.worker_id) if node else None
            if worker is None and astate.info.creation_spec is not None:
                # still PENDING: pull the creation task out of the scheduler
                # so the actor can't resurrect after the kill
                self.scheduler.remove_task(astate.info.creation_spec.task_id)
        if worker is not None:
            worker.proc.terminate()  # its pipe's EOF drives the death path
        else:
            self._finalize_actor_death(astate, "killed via ray_tpu_torch.kill")

    def get_actor_handle_info(self, name: str, namespace: str = "default") -> dict | None:
        actor_id = self.gcs.lookup_named_actor(name, namespace)
        if actor_id is None:
            return None
        astate = self.actors.get(actor_id)
        if astate is None or astate.info.state == "DEAD":
            return None
        return {"actor_id": actor_id, "class_id": astate.info.class_id}

    # ------------------------------------------------------------------
    # placement groups
    # ------------------------------------------------------------------
    def create_placement_group(self, bundles: list[dict], strategy: str = "PACK", name: str = "") -> PlacementGroupID:
        """All-or-nothing bundle reservation (one process plans and commits
        every bundle under the nodes' lock)."""
        pg_id = PlacementGroupID.from_random()
        pgs = PlacementGroupState(pg_id, bundles, strategy, name)
        self.placement_groups[pg_id] = pgs
        self._pending_pgs.add(pg_id)
        self._try_place_pg(pgs)
        return pg_id

    def _try_place_pg(self, pgs: PlacementGroupState) -> bool:
        with self._nodes_lock:
            with pgs.cond:
                if pgs.state != "PENDING":
                    return pgs.state == "CREATED"
            nodes = self.node_list()
            plan = _plan_pg(pgs.bundles, pgs.strategy, nodes)
            if plan is None:
                return False
            reserved = []
            ok = True
            for idx, node in enumerate(plan):
                if node.reserve_bundle(pgs.pg_id, idx, pgs.bundles[idx]):
                    reserved.append((node, idx))
                else:
                    ok = False
                    break
            if not ok:
                for node, idx in reserved:
                    node.return_bundle(pgs.pg_id, idx)
                return False
            with pgs.cond:
                if pgs.state != "PENDING":
                    # removed while we were reserving: roll back, don't
                    # let a dead group consume capacity
                    for node, idx in reserved:
                        node.return_bundle(pgs.pg_id, idx)
                    return False
                pgs.placements = [n.node_id for n in plan]
                pgs.state = "CREATED"
                pgs.cond.notify_all()
        self._pending_pgs.discard(pgs.pg_id)
        from ray_tpu_torch.util.placement_group import _pg_ready_oid

        self.store.put_serialized(_pg_ready_oid(pgs.pg_id), _to_serialized(True))
        self.gcs.events.record("pg_created", pg_id=pgs.pg_id.hex(), strategy=pgs.strategy)
        self.scheduler.bump_capacity()
        return True

    def pending_pg_demand(self) -> list[dict]:
        """The resource requests of PENDING placement groups, for the
        autoscaler (ray_tpu's ``pending_pg_demand``): a STRICT_PACK group's
        bundles merge into one request, since the whole group must fit one
        node; PACK and SPREAD bundles are requests of their own."""
        out = []
        for pg_id in list(self._pending_pgs):
            pgs = self.placement_groups.get(pg_id)
            if pgs is None:
                continue
            with pgs.cond:
                if pgs.state != "PENDING":
                    continue
                bundles = [dict(b) for b in pgs.bundles]
                strategy = pgs.strategy
            if strategy == "STRICT_PACK" and len(bundles) > 1:
                merged: dict = {}
                for b in bundles:
                    for k, v in b.items():
                        merged[k] = merged.get(k, 0.0) + v
                out.append(merged)
            else:
                out.extend(bundles)
        return out

    def wait_placement_group(self, pg_id: PlacementGroupID, timeout: float | None = None) -> bool:
        pgs = self.placement_groups.get(pg_id)
        if pgs is None:
            raise PlacementGroupUnschedulableError(f"unknown placement group {pg_id}")
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with pgs.cond:
                if pgs.state == "CREATED":
                    return True
                if pgs.state == "REMOVED":
                    raise PlacementGroupUnschedulableError("placement group removed")
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                pgs.cond.wait(timeout=0.1 if remaining is None else min(0.1, remaining))
            if pgs.state == "PENDING":
                self._try_place_pg(pgs)

    def remove_placement_group(self, pg_id: PlacementGroupID):
        pgs = self.placement_groups.get(pg_id)
        if pgs is None:
            return
        # flip REMOVED first (under the cond): a concurrent _try_place_pg
        # commit sees it and rolls its reservation back
        with pgs.cond:
            pgs.state = "REMOVED"
            pgs.cond.notify_all()
        self._pending_pgs.discard(pg_id)
        # actors scheduled into the group die with it (their bundles are
        # about to be reclaimed)
        for astate in list(self.actors.values()):
            if astate.info.placement_group == pg_id and astate.info.state != "DEAD":
                self.kill_actor(astate.info.actor_id, no_restart=True)
        with self._nodes_lock:
            for node in self.node_list():
                for idx in list(node.pg_bundles.get(pg_id, {})):
                    node.return_bundle(pg_id, idx)
        self.gcs.events.record("pg_removed", pg_id=pg_id.hex())
        self.scheduler.bump_capacity()
        # the freed capacity may place pending groups
        for other_id in list(self._pending_pgs):
            other = self.placement_groups.get(other_id)
            if other is not None:
                self._try_place_pg(other)

    def placement_group_table(self) -> list[dict]:
        return [
            {
                "pg_id": p.pg_id.hex(),
                "name": p.name,
                "state": p.state,
                "strategy": p.strategy,
                "bundles": p.bundles,
                "nodes": [n.hex() for n in p.placements],
            }
            for p in self.placement_groups.values()
        ]

    # ------------------------------------------------------------------
    # generators
    # ------------------------------------------------------------------
    def next_generator_item(self, gen_id: ObjectID, index: int, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._gen_cond:
            while True:
                gen = self.generators.get(gen_id)
                # error sealed directly on the generator id (worker crash,
                # actor death, dependency failure) terminates the stream
                entry = self.store.try_get_entry(gen_id)
                if entry is not None and entry.error is not None:
                    if gen is None:
                        gen = self.generators.setdefault(gen_id, GenState())
                    gen.finished = True
                    gen.error = entry.error
                if gen is not None:
                    if index < len(gen.items) and gen.items[index] is not _STREAM_HOLE:
                        return gen.items[index]
                    if gen.finished and (index >= len(gen.items) or gen.total_items >= 0):
                        if gen.error is not None and not gen.error_ref_made:
                            gen.error_ref_made = True
                            err_id = ObjectID.for_task_return(gen_id.task_id(), len(gen.items) + 1)
                            self.store.put_error(err_id, gen.error)
                            gen.items.append(err_id)
                            return err_id
                        # exhausted: drop the item list (the obj ids live in the
                        # store; consumers past this point only need StopIteration)
                        # but keep the GenState as a bounded tombstone so a late
                        # or repeat consumer terminates instead of blocking forever
                        if gen.total_items < 0:
                            gen.total_items = len(gen.items)
                            gen.items = []
                            self._gen_tombstones.append(gen_id)
                            while len(self._gen_tombstones) > 4096:
                                old = self._gen_tombstones.popleft()
                                self.generators.pop(old, None)
                        return None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError("generator next timed out")
                self._gen_cond.wait(timeout=0.2 if remaining is None else min(remaining, 0.2))

    # ------------------------------------------------------------------
    # scheduling integration
    # ------------------------------------------------------------------
    def reserve_and_queue(self, node: Node, spec: TaskSpec) -> bool:
        sched = spec.scheduling
        res = dict(sched.resources)
        if sched.placement_group is not None:
            idx = sched.bundle_index
            if idx < 0:
                bundles = node.pg_bundles.get(sched.placement_group, {})
                idx = next(
                    (
                        i
                        for i, avail in bundles.items()
                        if all(avail.get(k, 0) >= v - 1e-9 for k, v in res.items() if v > 0)
                    ),
                    -1,
                )
                if idx < 0:
                    return False
            if not node.allocate_from_bundle(sched.placement_group, idx, res):
                return False
            alloc = ("pg", sched.placement_group, idx, res)
        else:
            if not node.allocate(res):
                return False
            alloc = ("node", None, -1, res)
        gpus = []
        n_gpu = int(res.get("GPU", 0))
        if n_gpu > 0:
            gpus = node.take_gpus(n_gpu)
            if len(gpus) < n_gpu:  # a bundle's count outlived its cards' holder
                node.return_gpus(gpus)
                self._release_alloc(node, alloc, [])
                return False
        with node._lock:
            if not node.alive:
                # raced the node's removal: do not strand the spec on a dead queue
                self._release_alloc(node, alloc, gpus)
                return False
            node.dispatch_queue.append((spec, alloc, gpus))
        return True

    def dispatch_all(self):
        for node in self.node_list():
            self._dispatch_node(node)

    @staticmethod
    def _renv_key(spec: TaskSpec) -> str | None:
        """The packed runtime_env a spec's worker must have applied (None: none)."""
        renv = spec.runtime_env or {}
        wd = renv.get("_packed_working_dir")
        mods = renv.get("_packed_py_modules") or []
        if not wd and not mods:
            return None
        return (wd or {}).get("hash", "") + ":" + ",".join(m["hash"] for m in mods)

    def _dispatch_node(self, node: Node):
        while True:
            with node._lock:
                if not node.alive or not node.dispatch_queue:
                    return
                spec, alloc, gpus = node.dispatch_queue[0]
            # card-bound work takes a never-used worker forked for exactly
            # its cards; an actor takes a never-used worker; a plain task any
            # idle worker bound to no card and no runtime_env; a task with a
            # runtime_env an idle worker bound to the same env or to none
            needs_fresh = bool(gpus) or spec.is_actor_creation
            renv_key = self._renv_key(spec)

            def fits(w):
                if gpus:
                    return w.fresh and w.gpus == gpus
                if w.gpus or not (w.fresh or not needs_fresh):
                    return False
                return w.env_binding.get("runtime_env") == renv_key or not w.env_binding

            # a worker already bound to this env first: it has it unpacked
            idle = sorted((w for w in node.idle_workers() if fits(w)),
                          key=lambda w: w.env_binding.get("runtime_env") != renv_key)
            if not idle:
                starting = [w for w in node.workers.values() if w.state == "starting"]
                if gpus:
                    if not any(w.gpus == gpus for w in starting):
                        try:
                            node.start_worker(gpus=gpus)
                        except NodeShutDown:
                            pass  # its queue drains via remove_node
                        except Exception as e:  # noqa: BLE001
                            self._fail_worker_start(node, spec, alloc, gpus, e)
                            continue
                    return
                starting_plain = sum(1 for w in starting if not w.gpus)
                nonactor = sum(1 for w in node.workers.values() if w.state in ("starting", "idle", "busy")
                               and not w.gpus)
                limit = int(node.total_resources.get("CPU", 1)) + self._worker_count_limit_extra
                # actor creations need a fresh worker and may find the pool
                # full of used idle ones: they may spawn past the soft limit
                if (nonactor < limit or spec.is_actor_creation) and starting_plain < len(node.dispatch_queue):
                    try:
                        node.start_worker()
                    except NodeShutDown:
                        pass  # its queue drains via remove_node
                    except Exception as e:  # noqa: BLE001
                        self._fail_worker_start(node, spec, alloc, gpus, e)
                        continue
                elif nonactor >= limit and starting_plain == 0:
                    # the pool is full of idle workers this spec cannot take
                    # (used ones, for an actor; ones bound to another
                    # runtime_env): retire one so a fitting worker can start
                    stale = [w for w in node.idle_workers() if not w.gpus and not fits(w)
                             and (spec.is_actor_creation or w.env_binding)]
                    if stale:
                        victim = min(stale, key=lambda w: w.last_idle)
                        victim.state = "retiring"
                        victim.proc.terminate()
                return
            with node._lock:
                if not node.alive or not node.dispatch_queue or node.dispatch_queue[0][0] is not spec:
                    continue  # raced remove_node's drain
                # _dispatch_node runs on the scheduler thread, the IO
                # thread's completion fast path and _fast_submit: the worker
                # is claimed under the node's lock
                w = next((x for x in idle if x.state == "idle" and fits(x)), None)
                if w is None:
                    continue  # the idle snapshot went stale; rescan
                node.dispatch_queue.pop(0)
                w.state = "busy"
            self._dispatch_to_worker(node, w, spec, alloc, gpus)

    def _fail_worker_start(self, node: Node, spec: TaskSpec, alloc, gpus, exc: BaseException):
        """No worker can start for the spec at the head of ``node``'s queue
        (the node itself is up): the spec fails with the start's error, as
        a task's or an actor's creation error, instead of waiting for a
        worker that never comes."""
        with node._lock:
            if not node.dispatch_queue or node.dispatch_queue[0][0] is not spec:
                return  # another thread dispatched or drained it
            node.dispatch_queue.pop(0)
        self._release_alloc(node, alloc, gpus)
        err = TaskError.from_exception(exc, spec.desc())
        if spec.is_actor_creation:
            self._on_actor_creation_done(spec, err, None)
            return
        if not self.task_manager.handle_app_error(spec.task_id, err):
            for oid in self._spec_return_ids(spec):
                self.store.put_error(oid, err)

    def _dispatch_to_worker(self, node: Node, worker: WorkerHandle, spec: TaskSpec, alloc, gpus):
        env = {}
        if spec.runtime_env and spec.runtime_env.get("env_vars"):
            env.update(spec.runtime_env["env_vars"])
        renv_key = self._renv_key(spec)
        if renv_key is not None:
            # beside a card's binding: the worker serves only this env from now on
            worker.env_binding["runtime_env"] = renv_key
        resources = dict(alloc[3])
        if gpus:
            resources["_gpu_ids"] = gpus
        msg = self._build_exec_msg(spec, node, resources=resources, env=env)
        if msg is None:
            self._release_alloc(node, alloc, gpus)
            # un-claim: the worker was marked busy under the node's lock
            if worker.state == "busy":
                worker.state = "idle"
                worker.last_idle = time.monotonic()
            return
        if spec.is_actor_creation:
            worker.state = "actor"
            worker.actor_id = spec.actor_id
            astate = self.actors[spec.actor_id]
            with astate.lock:
                astate.info.node_id = node.node_id
                astate.info.worker_id = worker.worker_id
                astate.allocation = (node, alloc, gpus)
        else:
            worker.state = "busy"
        worker.fresh = False
        worker.running_tasks[spec.task_id] = (spec, (node, alloc, gpus))
        self.task_manager.mark_running(spec.task_id, node.node_id, worker.worker_id)
        try:
            worker.send(msg)
        except (OSError, ValueError):
            self._on_worker_death(node, worker, "send failed")

    def _build_exec_msg(self, spec: TaskSpec, node: Node, resources: dict, env: dict | None):
        """Resolve ref args into payloads; returns None if a dependency
        failed (the dependency's error is propagated to the task returns)."""
        args, err = self._resolve_args(spec.args)
        if err is None:
            kw, err = self._resolve_kwargs(getattr(spec, "_kwargs", {}))
        if err is not None:
            retried = self.task_manager.handle_app_error(spec.task_id, err if isinstance(err, TaskError) else TaskError.from_exception(err, spec.desc()))
            if not retried:
                for oid in self._spec_return_ids(spec):
                    self.store.put_error(oid, err)
            return None
        import dataclasses

        wire_spec = dataclasses.replace(spec, args=[])  # args travel separately, resolved
        return {
            "type": "exec",
            "spec": wire_spec,
            "args": args,
            "kwargs": kw,
            "resources": resources,
            "env": env,
        }

    def _resolve_args(self, args: list[ArgSpec]):
        out = []
        for a in args:
            if a.ref is None:
                out.append(a)
                continue
            entry = self.store.try_get_entry(a.ref)
            if entry is None:
                # evicted or not yet local: let the worker fetch via RPC
                out.append(a)
                continue
            if entry.error is not None:
                return None, entry.error
            out.append(ArgSpec(payload=self.entry_to_payload(entry)))
        return out, None

    def _resolve_kwargs(self, kwargs: dict[str, ArgSpec]):
        out = {}
        for k, a in (kwargs or {}).items():
            lst, err = self._resolve_args([a])
            if err is not None:
                return None, err
            out[k] = lst[0]
        return out, None

    def _spec_return_ids(self, spec: TaskSpec):
        if spec.streaming:
            with self._gen_cond:
                self.generators.setdefault(spec.generator_id(), GenState())
            return [spec.generator_id()]
        return spec.return_ids()

    def _release_alloc(self, node: Node, alloc, gpus, proc=None):
        """Give an allocation back. The cards of a worker whose process
        still runs, and their "GPU" count, go back only once it has exited
        (its CUDA context holds the card's memory until then): the count
        and the card indices never part, so a reservation of the count
        always finds its cards."""
        kind, pg_id, idx, res = alloc
        rest = {k: v for k, v in res.items() if k != "GPU"}
        cards = {k: v for k, v in res.items() if k == "GPU"}

        def _give(part):
            if kind == "pg":
                node.release_to_bundle(pg_id, idx, part)
            else:
                node.release(part)

        _give(rest)
        if gpus and proc is not None and proc.is_alive():
            def _after_exit():
                proc.join()
                node.return_gpus(gpus)
                _give(cards)
                self.scheduler.bump_capacity()

            threading.Thread(target=_after_exit, daemon=True, name="rt-gpu-release").start()
        else:
            if gpus:
                node.return_gpus(gpus)
            _give(cards)
        # parked (infeasible or busy) shapes become placeable again
        self.scheduler.bump_capacity()

    # ------------------------------------------------------------------
    # worker IO loop
    # ------------------------------------------------------------------
    def _retire_conn(self, conn):
        """Queue a dead worker's pipe for closing ON the io-loop thread.

        Closing it here (possibly from a kill/submit-failure thread) frees
        the fd while the io loop's current mp_connection.wait() may still
        list this Connection; a NEW worker's pipe can then be allocated
        the SAME fd number, and the stale Connection object steals the new
        worker's bytes — the head misreads the framing and declares a
        perfectly healthy worker dead (observed as a second Trainer.fit
        dying with 'worker process exited' while the process lived on).
        Only the io loop closes pipes it waits on."""
        with self._conn_graveyard_lock:
            self._conn_graveyard.append(conn)

    def _drain_conn_graveyard(self):
        with self._conn_graveyard_lock:
            conns, self._conn_graveyard = self._conn_graveyard, []
        for c in conns:
            try:
                c.close()
            except Exception:
                pass

    def _io_loop(self):
        while not self._stopped:
            # the previous wait() has returned, so no listed fd is still
            # polled: dead pipes can close without their fd numbers being
            # reused under the poll
            self._drain_conn_graveyard()
            conn_map = {}
            for node in self.node_list():
                if getattr(node, "remote", False):
                    conn_map[node.agent_conn] = (node, None)
                    continue
                for w in list(node.workers.values()):
                    if w.state != "dead":
                        conn_map[w.conn] = (node, w)
            if not conn_map:
                time.sleep(0.02)
                continue
            try:
                ready = mp_connection.wait(list(conn_map), timeout=0.05)
            except OSError:
                continue
            for c in ready:
                node, w = conn_map[c]
                if w is None:  # a node agent's socket
                    try:
                        msg = c.recv()
                    except (EOFError, OSError):
                        self._on_agent_death(node)
                        continue
                    try:
                        self._handle_agent_msg(node, msg)
                    except Exception:  # noqa: BLE001 — one bad message must not stop the IO loop; it is logged
                        logger.exception("error handling agent message %s", msg.get("type"))
                    continue
                if w.state == "dead":
                    # died on another thread after this wait() started:
                    # buffered messages must not be applied for a holder
                    # whose state was already dropped
                    continue
                try:
                    msg = c.recv()
                except (EOFError, OSError):
                    # a broken channel from a still-live process must not
                    # leave a zombie holding an actor: kill it
                    if w.proc.is_alive():
                        w.proc.terminate()
                        reason = "worker channel broke (process terminated)"
                    else:
                        reason = "worker process exited"
                    self._on_worker_death(node, w, reason)
                    continue
                try:
                    self._handle_worker_msg(node, w, msg)
                except Exception:  # noqa: BLE001 — one bad message must not stop the IO loop; it is logged
                    logger.exception("error handling worker message %s", msg.get("type"))

    # ------------------------------------------------------------------
    # reference-counted object GC
    # ------------------------------------------------------------------
    def _ref_gc_loop(self):
        """Drain the head process's own 1->0 transitions and re-check any
        object whose last known holder vanished."""
        from ray_tpu_torch.core.object_ref import drain_ref_events

        from ray_tpu_torch.core import direct as _direct

        while not self._stopped:
            time.sleep(self.cfg.ref_counting_interval_s)
            if self._stopped:
                return
            try:
                events = drain_ref_events()
                st = _direct.state()
                if st is not None and st.client is self:
                    # owned-object events apply owner-locally; remote-owned
                    # events flow to their owners (core/direct.py)
                    events = st.route_ref_events(events)
                for k, registered in events:
                    if not registered:
                        self._maybe_free_object(k)
            except Exception:
                logger.exception("ref gc loop error")

    def on_ref_events(self, holder: str, events: list):
        """A worker's batched 0->1 / 1->0 local-count transitions."""
        to_check = []
        with self._rc_head_lock:
            for k, registered in events:
                if registered:
                    self._ref_holders.setdefault(k, set()).add(holder)
                else:
                    s = self._ref_holders.get(k)
                    if s is not None:
                        s.discard(holder)
                        if not s:
                            del self._ref_holders[k]
                            to_check.append(k)
        for k in to_check:
            self._maybe_free_object(k)

    def _drop_holder(self, holder: str):
        """A worker process died: everything it held is released."""
        to_check = []
        with self._rc_head_lock:
            for k, s in list(self._ref_holders.items()):
                s.discard(holder)
                if not s:
                    del self._ref_holders[k]
                    to_check.append(k)
        for k in to_check:
            self._maybe_free_object(k)

    def pin_spec_args(self, spec: TaskSpec):
        """Pin every object a live spec's args reference (top-level refs +
        refs pickled inside payloads) — retries/lineage re-resolve them."""
        if not self.cfg.object_ref_counting:
            return
        if getattr(spec, "_pinned_arg_ids", None) is not None:
            return  # already pinned (actor restarts re-register the spec)
        ids = set()
        for a in list(spec.args) + list(getattr(spec, "_kwargs", {}).values()):
            if a.ref is not None:
                ids.add(a.ref.binary())
            if a.payload is not None:
                for c in a.payload.contained or []:
                    ids.add(c.binary())
        spec._pinned_arg_ids = ids
        with self._rc_head_lock:
            for k in ids:
                self._arg_pins[k] = self._arg_pins.get(k, 0) + 1

    def unpin_spec_args(self, spec: TaskSpec):
        ids = getattr(spec, "_pinned_arg_ids", None)
        if not ids:
            return
        spec._pinned_arg_ids = None
        with self._rc_head_lock:
            for k in ids:
                n = self._arg_pins.get(k, 0) - 1
                if n <= 0:
                    self._arg_pins.pop(k, None)
                else:
                    self._arg_pins[k] = n
        for k in ids:
            self._maybe_free_object(k)

    def _maybe_free_object(self, k: bytes):
        """Free the store entry once NOTHING can reach it: no ref in any
        process (head local count included — store containers hold live
        refs there), no live spec pinning it as an argument."""
        if self._stopped or not self.cfg.object_ref_counting:
            return
        if k.endswith(b"\xfe\xfe\xfe\xfe"):
            return  # actor-ready sentinels are runtime-managed
        from ray_tpu_torch.core.object_ref import local_ref_count

        oid = ObjectID(k)
        if oid in self.generators:
            return  # streaming generator state (incl. tombstones) manages these
        with self._rc_head_lock:
            # holder registrations serialize on this lock, and the local
            # count is re-checked immediately before the delete — the
            # remaining head-local incref window is the unavoidable
            # distributed-GC race, shrunk to the delete call itself
            if self._ref_holders.get(k) or self._arg_pins.get(k, 0) > 0:
                return
            if local_ref_count(oid) > 0:
                return
            entry = self.store.try_get_entry(oid)
            if entry is not None:
                self.store.delete(oid)
                # a late get() of a freed id must error, not block forever
                if len(self._freed_ids) == self._freed_ids.maxlen:
                    self._freed_set.discard(self._freed_ids[0])
                self._freed_ids.append(oid)
                self._freed_set.add(oid)
                # the entry's contained_refs die with it -> cascading
                # releases surface on the next gc tick
        # transitive lineage release: once ALL of a terminal task's outputs
        # are unreachable, reconstruction can never run again, so the
        # spec's argument pins release too
        self._maybe_release_lineage(oid)

    def _maybe_release_lineage(self, oid: ObjectID):
        try:
            tid = oid.task_id()
        except Exception:
            return
        st = self.task_manager.get(tid)
        if st is None or getattr(st.spec, "_pinned_arg_ids", None) is None:
            return
        from ray_tpu_torch.core.task_manager import TERMINAL

        if st.status not in TERMINAL:
            return
        from ray_tpu_torch.core.object_ref import local_ref_count

        for out_id in self._spec_return_ids(st.spec):
            if self.store.contains(out_id) or local_ref_count(out_id) > 0:
                return
            with self._rc_head_lock:
                if self._ref_holders.get(out_id.binary()):
                    return
        self.unpin_spec_args(st.spec)

    def _handle_worker_msg(self, node: Node, w: WorkerHandle, msg: dict):
        from ray_tpu_torch.core import rpc_chaos

        t = msg["type"]
        if not rpc_chaos.apply(t):
            return  # chaos: per-message-type fault injection (done, stream_item, ...)
        if t == "ready":
            if msg.get("direct_addr"):
                w.direct_addr = tuple(msg["direct_addr"])
            if w.ready_s is None:
                w.ready_s = time.monotonic() - w.started_at
                self.worker_ready_s.append(w.ready_s)
            if w.state == "starting":
                w.state = "idle"
                w.last_idle = time.monotonic()
            self.scheduler.wake()
        elif t == "done":
            self._on_task_done(node, w, msg)
        elif t == "seal":
            # a worker completed a direct call with large results: they
            # live in shm under head ownership (core/direct.py)
            for oid, payload in msg["items"]:
                self.put_payload(oid, payload)
        elif t == "task_events":
            # batched spans of direct-plane executions (observability)
            self.task_manager.record_external(msg["events"], node_id=node.node_id, worker_id=w.worker_id)
        elif t == "stream_item":
            self._on_stream_item(msg)
        elif t == "metrics":
            # a worker's registry snapshot (util/metrics.py's flusher)
            self.gcs.kv.put(msg["key"], msg["value"], namespace="_metrics")
        elif t == "stack_dump_result":
            with self._dc_lock:
                slot = self._stack_pending.get(msg.get("req_id"))
            if slot is not None:
                slot[1][w.worker_id.hex()] = {"pid": msg.get("pid"), "current_task": msg.get("current_task"),
                                              "stacks": msg.get("stacks", {})}
                slot[0].set()
        else:
            self._dispatch_client_msg(w, msg)  # the client-protocol subset (req, ref_events)

    def _dispatch_client_msg(self, handle, msg: dict) -> bool:
        """The client protocol of a worker's pipe and an attached driver's
        socket: req (a control-plane RPC), agent_req (the head answering as
        its own node's agent) and ref_events (borrow-protocol flushes,
        ordered with the sender's other messages on one channel). True
        when handled."""
        t = msg.get("type")
        if t == "req":
            self._req_pool.submit(self._handle_client_req, handle, msg)
        elif t == "agent_req":
            self._req_pool.submit(self._handle_agent_req_local, handle, msg)
        elif t == "ref_events":
            self.on_ref_events(handle.worker_id.hex(), [(bytes.fromhex(h), reg) for h, reg in msg["events"]])
        else:
            return False
        return True

    def _handle_agent_req_local(self, w, msg: dict):
        """An agent RPC from one of the head's own processes: pull a foreign
        segment into the head's namespace (``fetch_object``)."""
        from ray_tpu_torch.core.object_store import ensure_local_segment

        resp = {"type": "resp", "req_id": msg["req_id"], "ok": True, "payload": None, "error": None}
        try:
            if msg.get("method") != "fetch_object":
                raise ValueError(f"unknown agent method {msg.get('method')!r}")
            resp["payload"] = ensure_local_segment(msg["params"]["desc"])
        except Exception as e:  # noqa: BLE001 — the error goes back to the asking process
            resp["ok"], resp["error"] = False, _picklable_error(e)
        try:
            w.send(resp)
        except (OSError, ValueError):
            pass  # the asker is gone

    def _on_task_done(self, node: Node, w: WorkerHandle, msg: dict):
        if msg.get("ref_events"):
            # borrows registered BEFORE any pin release below
            self.on_ref_events(
                w.worker_id.hex(), [(bytes.fromhex(h), reg) for h, reg in msg["ref_events"]]
            )
        task_id = msg["task_id"]
        entry = w.running_tasks.pop(task_id, None)
        if entry is None:
            return
        spec, allocation = entry
        if allocation is not None and not spec.is_actor_creation:
            anode, alloc, gpus = allocation
            if w.state == "busy" and w.gpus:
                # card-bound workers are single-use: the card is bound into
                # the process (its CUDA context). Release the CPU side now,
                # hold the cards until the process has exited, so a fresh
                # worker never shares a card with a dying context.
                w.retired_gpus = (anode, alloc, gpus)
                w.state = "retiring"
                try:
                    w.send({"type": "shutdown"})
                except (OSError, ValueError):
                    self._finish_retirement(node, w)
            else:
                self._release_alloc(anode, alloc, gpus)
                if w.state == "busy":
                    w.state = "idle"
                    w.last_idle = time.monotonic()
                    # completion fast path: the next ready task for this
                    # node, dispatched here on the IO thread
                    self.scheduler.take_ready_for(node, self.reserve_and_queue)
                    self._dispatch_node(node)
        err = msg.get("error")
        if spec.is_actor_creation:
            self._on_actor_creation_done(spec, err, w)
            self.scheduler.wake()
            return
        if err is not None:
            retried = self.task_manager.handle_app_error(task_id, err)
            if not retried:
                if spec.streaming:
                    with self._gen_cond:
                        gen = self.generators.setdefault(spec.generator_id(), GenState())
                        gen.finished = True
                        gen.error = err
                        self._gen_cond.notify_all()
                else:
                    for oid in spec.return_ids():
                        self.store.put_error(oid, err)
        else:
            for oid, payload in msg["returns"]:
                self.put_payload(oid, payload)
            if spec.streaming:
                with self._gen_cond:
                    gen = self.generators.setdefault(spec.generator_id(), GenState())
                    gen.finished = True
                    self._gen_cond.notify_all()
            self.task_manager.complete(task_id)
        self.gcs.events.record("task_finished", task_id=task_id.hex(), name=spec.name, ok=err is None)
        self.scheduler.wake()

    def _on_actor_creation_done(self, spec: TaskSpec, err, w: WorkerHandle):
        astate = self.actors.get(spec.actor_id)
        if astate is None:
            return
        with astate.lock:
            if astate.info.state == "DEAD":
                # killed while the creation was in flight: tear down the
                # worker that just constructed it
                if w is not None:
                    w.proc.terminate()
                return
            if err is not None:
                astate.info.state = "DEAD"
                astate.info.death_cause = f"creation failed: {err}"
                self.store.put_error(_actor_ready_oid(spec.actor_id), err)
                pending, astate.pending = astate.pending, []
                for p in pending:
                    for oid in self._spec_return_ids(p):
                        self.store.put_error(oid, ActorDiedError(spec.actor_id, astate.info.death_cause))
                self._release_actor_resources(astate)
                return
            astate.info.state = "ALIVE"
            self.store.put_serialized(_actor_ready_oid(spec.actor_id), _to_serialized(True))
            pending, astate.pending = astate.pending, []
            for p in pending:
                self._dispatch_actor_task(astate, p)
        self.gcs.events.record("actor_alive", actor_id=spec.actor_id.hex())

    def _on_stream_item(self, msg: dict):
        task_id = msg["task_id"]
        obj_id = msg["obj_id"]
        index = msg.get("index", None)
        self.put_payload(obj_id, msg["payload"])
        gen_id = ObjectID.for_task_return(task_id, 0)
        with self._gen_cond:
            gen = self.generators.setdefault(gen_id, GenState())
            # Place idempotently by the worker-assigned index so a retried
            # attempt replaying its prefix never duplicates items consumers
            # already saw.
            if index is None:
                gen.items.append(obj_id)
            elif index < len(gen.items):
                gen.items[index] = obj_id
            else:
                if index > len(gen.items):
                    # protocol violation over in-order pipes; holes make the
                    # reader wait (not truncate) until the item is replayed
                    logger.error("stream gap for %s: got index %d at length %d", gen_id, index, len(gen.items))
                    gen.items.extend([_STREAM_HOLE] * (index - len(gen.items)))
                gen.items.append(obj_id)
            self._gen_cond.notify_all()

    def _finish_retirement(self, node: Node, w: WorkerHandle):
        """A retired card-bound worker's process is gone: its allocation,
        cards included, is free."""
        retired = w.retired_gpus
        if retired is not None:
            anode, alloc, gpus = retired
            w.retired_gpus = None
            w.proc.join(timeout=30.0)  # reaped: its CUDA context has released the card
            self._release_alloc(anode, alloc, gpus)
        w.state = "dead"
        node.remove_worker(w.worker_id)
        self._retire_conn(w.conn)
        self.scheduler.bump_capacity()

    # ---- worker death / actor restart ----
    def _on_worker_death(self, node: Node, w: WorkerHandle, reason: str):
        if w.state == "dead" or self._stopped:
            return
        self._drop_holder(w.worker_id.hex())
        # direct plane: reclaim the lease ON this worker and any leases it
        # held as a client
        with self._leases_lock:
            lease = self._leases.pop(w.worker_id, None)
        if lease is not None:
            lnode, res, _owner = lease
            lnode.release(res)
        self._release_leases_of_owner(w.worker_id.hex())
        if w.state == "retiring":
            self._finish_retirement(node, w)
            return
        was_actor = w.state == "actor"
        w.state = "dead"
        node.remove_worker(w.worker_id)
        self._retire_conn(w.conn)
        running = dict(w.running_tasks)
        w.running_tasks.clear()
        for task_id, (spec, allocation) in running.items():
            if allocation is not None and not spec.is_actor_creation:
                anode, alloc, gpus = allocation
                self._release_alloc(anode, alloc, gpus, proc=w.proc)
            if spec.is_actor_creation or spec.actor_id is not None:
                continue  # handled by actor death path
            self.task_manager.handle_worker_crash(task_id, reason)
        if was_actor and w.actor_id is not None:
            self._on_actor_worker_death(w.actor_id, running, reason, proc=w.proc)
        self.scheduler.wake()

    def _on_actor_worker_death(self, actor_id: ActorID, running: dict, reason: str, proc=None):
        astate = self.actors.get(actor_id)
        if astate is None:
            return
        with astate.lock:
            info = astate.info
            inflight = [spec for _, (spec, _) in running.items() if not spec.is_actor_creation]
            if astate.expected_exit or info.num_restarts >= info.max_restarts:
                cause = "expected exit" if astate.expected_exit else f"{reason}; max_restarts exhausted"
                self._finalize_actor_death(astate, cause, inflight, proc=proc)
                return
            # restart
            info.num_restarts += 1
            info.state = "RESTARTING"
            logger.info("restarting actor %s (%d/%d): %s", actor_id.hex()[:8], info.num_restarts, info.max_restarts, reason)
            for spec in inflight:
                if info.max_task_retries != 0:
                    astate.pending.append(spec)
                else:
                    for oid in self._spec_return_ids(spec):
                        self.store.put_error(oid, ActorDiedError(actor_id, f"actor died while task inflight: {reason}"))
            self.store.delete(_actor_ready_oid(actor_id))
            if astate.allocation is not None:
                anode, alloc, gpus = astate.allocation
                self._release_alloc(anode, alloc, gpus, proc=proc)
                astate.allocation = None
            creation = info.creation_spec
        self.task_manager.register(creation)
        self.scheduler.submit(creation)

    def _finalize_actor_death(self, astate: ActorState, cause: str, inflight: list | None = None, proc=None):
        info = astate.info
        info.state = "DEAD"
        info.death_cause = cause
        if info.creation_spec is not None:
            self.unpin_spec_args(info.creation_spec)  # no more restarts
        # ready-ref waiters must observe the death (even if creation never ran)
        self.store.put_error(_actor_ready_oid(info.actor_id), ActorDiedError(info.actor_id, cause))
        for spec in inflight or []:
            for oid in self._spec_return_ids(spec):
                self.store.put_error(oid, ActorDiedError(info.actor_id, cause))
        pending, astate.pending = astate.pending, []
        for spec in pending:
            for oid in self._spec_return_ids(spec):
                self.store.put_error(oid, ActorDiedError(info.actor_id, cause))
        self._release_actor_resources(astate, proc=proc)
        if info.name:
            self.gcs.unregister_named_actor(info.name, info.namespace)
        if info.detached:
            self.gcs.drop_detached_actor(info.actor_id)  # dead for good
        self.gcs.events.record("actor_dead", actor_id=info.actor_id.hex(), cause=cause)

    def _release_actor_resources(self, astate: ActorState, proc=None):
        if astate.allocation is not None:
            node, alloc, gpus = astate.allocation
            self._release_alloc(node, alloc, gpus, proc=proc)
            astate.allocation = None

    # ------------------------------------------------------------------
    # client RPC handling (requests from worker processes)
    # ------------------------------------------------------------------
    def _handle_client_req(self, w: WorkerHandle, msg: dict):
        method = msg["method"]
        params = msg["params"]
        if method == "lease_worker":
            # lease ownership rides the requesting channel's identity so a
            # dead client's leases can be reclaimed
            params = {**params, "_owner": w.worker_id.hex()}
        try:
            handler = getattr(self, f"_rpc_{method}", None)
            if handler is None:
                raise AttributeError(f"unknown client RPC {method}")
            payload = handler(**params)
            w.send({"type": "resp", "req_id": msg["req_id"], "ok": True, "payload": payload})
        except BaseException as e:  # noqa: BLE001
            try:
                w.send({"type": "resp", "req_id": msg["req_id"], "ok": False, "error": _picklable_error(e)})
            except Exception:
                logger.exception("failed to send error response")

    def _rpc_object_locations(self, obj_ids):
        return self.object_locations(obj_ids)

    def _rpc_get_object(self, obj_id, timeout_s=None):
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        entry = self._get_entry_reconstructing(obj_id, deadline)
        if entry is None:
            raise GetTimeoutError(f"get() timed out waiting for {obj_id.hex()[:16]}")
        return self.entry_to_payload(entry)

    def _rpc_put_object(self, obj_id, payload):
        self.put_payload(obj_id, payload)
        return True

    def _rpc_mark_object_lost(self, obj_id):
        # a worker failed to attach the segment: restore from spill when
        # the bytes are on disk, otherwise mark lost for reconstruction
        self.store.restore_or_mark_lost(obj_id)
        return True

    def _rpc_wait_ready(self, obj_ids, num_returns, timeout_s=None):
        return self.store.wait_ready(obj_ids, num_returns, timeout_s)

    def _rpc_submit_task(self, **kw):
        return self.submit_task(**kw)

    def _rpc_create_actor(self, **kw):
        return self.create_actor(**kw)

    def _rpc_submit_actor_task(self, **kw):
        return self.submit_actor_task(**kw)

    def _rpc_kill_actor(self, actor_id, no_restart=True):
        self.kill_actor(actor_id, no_restart)
        return True

    def _rpc_cancel_task(self, obj_id, force=False):
        return self.cancel_task(obj_id, force)

    def _rpc_get_actor_handle_info(self, name, namespace="default"):
        return self.get_actor_handle_info(name, namespace)

    def _rpc_next_generator_item(self, gen_id, index, timeout_s=None):
        return self.next_generator_item(gen_id, index, timeout=timeout_s)

    def _rpc_free_objects(self, obj_ids):
        self.free_objects(obj_ids)
        return True

    def _rpc_get_function(self, func_id):
        return self.get_function_blob(func_id)

    def _rpc_actor_endpoint(self, actor_id):
        return self.actor_endpoint(actor_id)

    def _rpc_lease_worker(self, _owner=""):
        return self.lease_worker(owner=_owner)

    def _rpc_release_lease(self, wid):
        return self.release_lease(wid)

    def _rpc_cluster_info(self, kind):
        return self.cluster_info(kind)

    def _rpc_kv(self, op, **kw):
        return getattr(self.gcs.kv, op)(**kw)

    def _rpc_pg(self, op, **kw):
        if op == "create":
            return self.create_placement_group(**kw)
        if op == "wait":
            return self.wait_placement_group(**kw)
        if op == "remove":
            return self.remove_placement_group(**kw)
        if op == "table":
            return self.placement_group_table()
        raise ValueError(op)

    def pg(self, op, **kw):
        return self._rpc_pg(op, **kw)

    def kv(self, op, **kw):
        return getattr(self.gcs.kv, op)(**kw)

    # ------------------------------------------------------------------
    # misc API
    # ------------------------------------------------------------------
    def cancel_task(self, obj_id: ObjectID, force: bool = False) -> bool:
        from ray_tpu_torch.exceptions import RayTpuError

        task_id = obj_id.task_id()
        if self.scheduler.remove_task(task_id):
            self.task_manager.mark_cancelled(task_id)
            st = self.task_manager.get(task_id)
            if st:
                for oid in self._spec_return_ids(st.spec):
                    self.store.put_error(oid, RayTpuError(f"task {task_id.hex()[:8]} was cancelled"))
            return True
        # a running streaming task: cooperative cancel, the worker's
        # generator loop stops between items and ends the stream cleanly
        for node in self.node_list():
            for w in list(node.workers.values()):
                entry = w.running_tasks.get(task_id)
                if entry is not None and entry[0].streaming:
                    try:
                        w.send({"type": "cancel_stream", "task_id": task_id})
                    except (OSError, ValueError):
                        pass  # its pipe closed: the stream ends with the worker
                    return True
        if force:
            for node in self.node_list():
                for w in list(node.workers.values()):
                    if task_id in w.running_tasks and w.state == "busy":
                        self.task_manager.mark_cancelled(task_id)
                        w.proc.terminate()
                        return True
        return False

    # ------------------------------------------------------------------
    # direct call plane: endpoints + worker leases (core/direct.py;
    # lease-based scheduling)
    # ------------------------------------------------------------------
    def actor_endpoint(self, actor_id) -> dict | None:
        """Direct address of an ALIVE actor's worker, or None (caller then
        stays on the head path, which owns PENDING/RESTARTING queueing)."""
        if isinstance(actor_id, str):
            actor_id = ActorID.from_hex(actor_id)
        astate = self.actors.get(actor_id)
        if astate is None:
            return None
        info = astate.info
        if info.state != "ALIVE":
            return None
        node = self.nodes.get(info.node_id)
        w = node.workers.get(info.worker_id) if node else None
        if w is None or not w.alive() or w.direct_addr is None:
            return None
        return {
            "addr": w.direct_addr,
            "epoch": info.num_restarts,
            "max_task_retries": info.max_task_retries,
        }

    def lease_worker(self, owner: str = "") -> dict | None:
        """Reserve one CPU and a worker for direct task submission. The
        worker leaves the dispatch pool until the lease is released."""
        res = {"CPU": 1.0}
        for node in self.node_list():
            if getattr(node, "remote", False) and not node.workers:
                continue  # an agent's first worker boots its zygote: the caller takes the head path instead
            if not node.allocate(res):
                continue
            try:
                w = self._claim_lease_worker(node)
            except BaseException:
                node.release(res)  # no worker could start: the caller takes the head path
                raise
            if w is None:
                node.release(res)
                continue
            with self._leases_lock:
                self._leases[w.worker_id] = (node, res, owner)
            return {"wid": w.worker_id.hex(), "addr": w.direct_addr}
        return None

    def _claim_lease_worker(self, node: Node, timeout: float = 15.0):
        """An idle unbound worker with a direct address; spawns one if the
        pool is empty (a bounded wait for its ready handshake)."""
        deadline = time.monotonic() + timeout
        spawned = False
        while time.monotonic() < deadline and not self._stopped:
            with node._lock:
                for w in node.workers.values():
                    if w.state == "idle" and not w.env_binding and w.direct_addr is not None:
                        w.state = "leased"
                        return w
                starting = any(w.state == "starting" for w in node.workers.values())
            if not starting and not spawned:
                try:
                    node.start_worker()
                    spawned = True
                except NodeShutDown:
                    return None
            time.sleep(0.005)
        return None

    def release_lease(self, wid_hex: str) -> bool:
        wid = WorkerID.from_hex(wid_hex) if isinstance(wid_hex, str) else wid_hex
        with self._leases_lock:
            lease = self._leases.pop(wid, None)
        if lease is None:
            return False
        node, res, _owner = lease
        node.release(res)
        w = node.workers.get(wid)
        if w is not None and w.state == "leased":
            w.state = "idle"
            w.last_idle = time.monotonic()
        self.scheduler.bump_capacity()
        return True

    def terminate_leased_worker(self, wid_hex: str) -> bool:
        """Force-cancel of a direct-plane task: kill a leased worker (only;
        never an actor's or a busy one) so the caller's connection death
        completes the cancelled call."""
        wid = WorkerID.from_hex(wid_hex) if isinstance(wid_hex, str) else wid_hex
        for node in self.node_list():
            w = node.workers.get(wid)
            if w is not None and w.state == "leased":
                w.proc.terminate()
                return True
        return False

    def _rpc_terminate_leased_worker(self, wid):
        return self.terminate_leased_worker(wid)

    def _release_leases_of_owner(self, owner_hex: str):
        with self._leases_lock:
            doomed = [wid for wid, (_, _, o) in self._leases.items() if o == owner_hex]
        for wid in doomed:
            self.release_lease(wid)

    def cluster_info(self, kind: str):
        if kind == "nodes":
            return [
                {
                    "node_id": n.node_id.hex(),
                    "alive": n.alive,
                    "resources": dict(n.total_resources),
                    "available": dict(n.available),
                    "labels": dict(n.labels),
                    "num_workers": len(n.workers),
                }
                for n in self.node_list()
            ]
        if kind == "cluster_resources":
            out = {}
            for n in self.node_list():
                for k, v in n.total_resources.items():
                    out[k] = out.get(k, 0) + v
            return out
        if kind == "available_resources":
            out = {}
            for n in self.node_list():
                for k, v in n.available.items():
                    out[k] = out.get(k, 0) + v
            return out
        if kind == "actors":
            return [
                {
                    "actor_id": a.info.actor_id.hex(),
                    "name": a.info.name,
                    "state": a.info.state,
                    "class": a.info.class_id[:16],
                    "num_restarts": a.info.num_restarts,
                    "node_id": a.info.node_id.hex() if a.info.node_id else None,
                }
                for a in self.actors.values()
            ]
        if kind == "tasks":
            return self.task_manager.states()
        if kind == "objects":
            return self.store.stats()
        if kind == "placement_groups":
            return self.placement_group_table()
        raise ValueError(kind)

    def actor_ready_ref(self, actor_id: ActorID) -> ObjectRef:
        return ObjectRef(_actor_ready_oid(actor_id))

    # ------------------------------------------------------------------
    # local mode execution
    # ------------------------------------------------------------------
    def _local_decode_args(self, spec):
        args = []
        for a in spec.args:
            if a.ref is not None:
                args.append(self.get_object(a.ref))
            else:
                v, _ = decode_payload(a.payload, zero_copy=False)
                args.append(v)
        kwargs = {}
        for k, a in getattr(spec, "_kwargs", {}).items():
            if a.ref is not None:
                kwargs[k] = self.get_object(a.ref)
            else:
                v, _ = decode_payload(a.payload, zero_copy=False)
                kwargs[k] = v
        return args, kwargs

    def _local_execute(self, spec: TaskSpec):
        import inspect as _inspect

        fn = self.get_function(spec.func_id)
        try:
            args, kwargs = self._local_decode_args(spec)
            result = fn(*args, **kwargs)
            if spec.streaming:
                with self._gen_cond:
                    gen = self.generators.setdefault(spec.generator_id(), GenState())
                for i, item in enumerate(result):
                    oid = ObjectID.for_task_return(spec.task_id, i + 1)
                    self.store.put_serialized(oid, _to_serialized(item))
                    with self._gen_cond:
                        gen.items.append(oid)
                        self._gen_cond.notify_all()
                with self._gen_cond:
                    gen.finished = True
                    self._gen_cond.notify_all()
                return
            if _inspect.isgenerator(result):
                result = list(result)
            values = [result] if spec.num_returns == 1 else list(result)
            for oid, v in zip(spec.return_ids(), values):
                self.store.put_serialized(oid, _to_serialized(v))
            self.task_manager.complete(spec.task_id)
        except BaseException as e:  # noqa: BLE001
            err = TaskError.from_exception(e, spec.desc())
            if not self.task_manager.handle_app_error(spec.task_id, err):
                for oid in self._spec_return_ids(spec):
                    self.store.put_error(oid, err)

    def _local_create_actor(self, spec: TaskSpec):
        cls = self.get_function(spec.func_id)
        astate = self.actors[spec.actor_id]
        try:
            args, kwargs = self._local_decode_args(spec)
            astate.local_instance = cls(*args, **kwargs)
            astate.info.state = "ALIVE"
            self.store.put_serialized(_actor_ready_oid(spec.actor_id), _to_serialized(True))
        except BaseException as e:  # noqa: BLE001
            astate.info.state = "DEAD"
            astate.info.death_cause = str(e)
            self.store.put_error(_actor_ready_oid(spec.actor_id), TaskError.from_exception(e, spec.desc()))

    def _local_actor_call(self, spec: TaskSpec):
        astate = self.actors[spec.actor_id]
        inst = getattr(astate, "local_instance", None)
        try:
            args, kwargs = self._local_decode_args(spec)
            if spec.method_name == "__ray_ready__":
                result = True
            elif spec.method_name == "__ray_terminate__":
                result = True
            else:
                result = getattr(inst, spec.method_name)(*args, **kwargs)
            import inspect as _inspect

            if _inspect.iscoroutine(result):
                import asyncio

                result = asyncio.get_event_loop().run_until_complete(result)
            values = [result] if spec.num_returns == 1 else list(result)
            for oid, v in zip(spec.return_ids(), values):
                self.store.put_serialized(oid, _to_serialized(v))
        except BaseException as e:  # noqa: BLE001
            err = TaskError.from_exception(e, spec.desc())
            for oid in spec.return_ids():
                self.store.put_error(oid, err)

    # ------------------------------------------------------------------
    def shutdown(self):
        """Stop the runtime: every worker process exits (and is reaped),
        the head's objects and this session's segments are unlinked."""
        if self._stopped:
            return
        self._stopped = True
        from ray_tpu_torch.core import direct as _direct_mod
        from ray_tpu_torch.core.object_store import cleanup_orphan_segments, unlink_tagged, worker_session_tag

        _direct_mod.detach(self)
        self.scheduler.stop()
        # a prestart spawn mid-boot must finish (and be reaped by the alive
        # check in start_worker) before teardown
        t = getattr(self, "_prestart_thread", None)
        if t is not None and t.is_alive():
            t.join(timeout=60.0)
        with self._drivers_lock:
            drivers = list(self._drivers.values())
        for d in drivers:
            try:
                d.send({"type": "head_shutdown"})
            except (OSError, ValueError):
                pass  # it detached meanwhile
            d.conn.close()
        if self._memory_monitor is not None:
            self._memory_monitor.stop()
        for node in list(self.nodes.values()):
            node.shutdown()
        if self._log_monitor is not None:
            self._log_monitor.stop()  # joins its thread
            self._log_monitor.poll_once()  # the workers are gone: their last lines
        self.store.shutdown()
        if self._agent_listener is not None:
            self._agent_listener.shutdown()
        if self._transfer_server is not None:
            self._transfer_server.shutdown()
            from ray_tpu_torch.core import object_store as _os_mod

            _os_mod.set_fetch_hook(None)
        self.gcs.store.close()
        t_io = getattr(self, "_io_thread", None)
        if t_io is not None and t_io.is_alive():
            # the loop exits within ~70 ms of _stopped; closing graveyarded
            # conns while its current wait() lists them would bring back the
            # fd-reuse hazard _retire_conn prevents
            t_io.join(timeout=2.0)
        self._drain_conn_graveyard()
        unlink_tagged(worker_session_tag())  # what the workers wrote: their processes are gone
        cleanup_orphan_segments()
        self._req_pool.shutdown(wait=False, cancel_futures=True)
        context.set_client(None)


def _actor_ready_oid(actor_id: ActorID) -> ObjectID:
    return ObjectID(actor_id.binary() + b"\xfe\xfe\xfe\xfe")


def _to_serialized(value) -> Serialized:
    from ray_tpu_torch.core.serialization import serialize

    # contained_refs MUST survive: the store entry holding them is what
    # keeps objects pickled inside this value alive (borrow protocol).
    # Buffers stay as pickle5 views: put_serialized copies them exactly
    # once — into shm for large values, into bytes for inline entries.
    return serialize(value)


def _sched_options(opts: dict, is_actor: bool = False) -> SchedulingOptions:
    resources = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    if num_cpus is None:
        num_cpus = 0 if is_actor else 1
    if num_cpus:
        resources["CPU"] = float(num_cpus)
    # num_gpus and num_tpus both fold into the card resource, as ray_tpu
    # folds both into "TPU"
    num_gpus = opts.get("num_gpus") or opts.get("num_tpus")
    if num_gpus:
        from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

        ok, msg = GPUAcceleratorManager.validate_resource_request_quantity(num_gpus)
        if not ok:
            raise ValueError(msg)
        resources["GPU"] = float(num_gpus)
    if opts.get("memory"):
        resources["memory"] = float(opts["memory"])
    pg = opts.get("placement_group")
    pg_id = None
    bundle_index = -1
    if pg is not None:
        pg_id = pg.id if hasattr(pg, "id") else pg
        bundle_index = opts.get("placement_group_bundle_index", -1)
    strategy = opts.get("scheduling_strategy", "DEFAULT")
    node_id = None
    soft_node_id = None
    if hasattr(strategy, "node_id"):  # NodeAffinitySchedulingStrategy
        if strategy.soft:
            soft_node_id = strategy.node_id
        else:
            node_id = strategy.node_id
        strategy = "DEFAULT"
    elif hasattr(strategy, "placement_group"):  # PlacementGroupSchedulingStrategy
        pg_obj = strategy.placement_group
        pg_id = pg_obj.id if hasattr(pg_obj, "id") else pg_obj
        bundle_index = getattr(strategy, "placement_group_bundle_index", -1)
        strategy = "DEFAULT"
    return SchedulingOptions(
        resources=resources,
        node_id=node_id,
        soft_node_id=soft_node_id,
        placement_group=pg_id,
        bundle_index=bundle_index if bundle_index is not None else -1,
        scheduling_strategy=strategy if isinstance(strategy, str) else "DEFAULT",
        label_selector=opts.get("label_selector") or {},
    )


def _plan_pg(bundles: list[dict], strategy: str, nodes: list[Node]):
    """Choose a node per bundle; None if infeasible. All-or-nothing commit
    happens in the caller under the cluster lock."""
    if not nodes:
        return None
    plan = []
    # track would-be availability to keep the plan feasible
    avail = {n.node_id: dict(n.available) for n in nodes}

    def fits(node, res):
        a = avail[node.node_id]
        return all(a.get(k, 0) >= v - 1e-9 for k, v in res.items() if v > 0)

    def take(node, res):
        a = avail[node.node_id]
        for k, v in res.items():
            if v > 0:
                a[k] = a.get(k, 0) - v

    order = list(nodes)
    for i, b in enumerate(bundles):
        cands = [n for n in order if fits(n, b)]
        if strategy in ("STRICT_SPREAD",):
            cands = [n for n in cands if n not in plan]
        if not cands:
            return None
        if strategy in ("PACK", "STRICT_PACK"):
            # prefer the node already used by previous bundles
            used = [n for n in plan if n in cands]
            node = used[0] if used else cands[0]
            if strategy == "STRICT_PACK" and plan and node is not plan[0]:
                if plan[0] in cands:
                    node = plan[0]
                else:
                    return None
        elif strategy in ("SPREAD", "STRICT_SPREAD"):
            unused = [n for n in cands if n not in plan]
            node = (unused or cands)[0]
        else:
            node = cands[0]
        plan.append(node)
        take(node, b)
    return plan


def _picklable_error(e: BaseException) -> BaseException:
    import pickle

    try:
        pickle.dumps(e)
        return e
    except Exception:
        return TaskError(cause=None, tb_str=str(e), task_desc="rpc")


class _DriverHandle:
    """The head's record of an attached driver: the part of a
    ``WorkerHandle`` its client requests and reference events use (a
    driver runs no tasks)."""

    __slots__ = ("conn", "worker_id", "_send_lock")

    def __init__(self, conn, worker_id):
        self.conn = conn
        self.worker_id = worker_id
        self._send_lock = threading.Lock()

    def send(self, msg: dict):
        with self._send_lock:
            self.conn.send(msg)
