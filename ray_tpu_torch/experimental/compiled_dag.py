"""Channel-compiled DAG execution: the head leaves the steady-state loop
(port of ray_tpu/experimental/compiled_dag.py).

After ``compile_channel_dag``:

    driver --chan--> actor A --chan--> actor B --chan--> driver

every ``execute`` writes the input into a pinned ring and every hop is a
shm write and a doorbell: no task submission, no scheduler, no head.

Topology rules (same host):
  * every compute node is a method bound on an EXISTING actor handle
    (ActorMethodNode) or on a ClassNode-created actor;
  * every node consumes at least one InputNode or upstream node (the
    channel clock: a node with no in-edge would free-run);
  * all actors live on this host (abstract unix sockets and shm).

Compile is two-phase per actor (``ChannelLoopRunner.setup``: bind every
listener, dial every writer, accept), so cyclic actor reuse cannot
deadlock. At most ``nslots`` executions are in flight. An application
error travels down the pipeline and is raised by that execution's
``get()``; a dead stage breaks the DAG (``ChannelClosedError``).
``teardown()`` drains a STOP through every stage, force-stops what did
not drain, unlinks every ring of the graph and, with
``kill_actors=True``, kills its actors.
"""

from __future__ import annotations

import threading
import uuid
from collections import deque

from ray_tpu_torch.dag import ActorMethodNode, ClassMethodNode, ClassNode, DAGNode, InputNode, topo_order
from ray_tpu_torch.experimental.channels import (
    _HDR,
    STOP,
    ChannelClosedError,
    ChannelError,
    ChannelFullError,
    ChannelReader,
    ChannelWriter,
    _Stop,
    _WrappedError,
    dumps,
    ring_name,
    unlink_ring,
)

SETUP_TIMEOUT_S = 120.0  # every actor's endpoints up
TEARDOWN_CALL_S = 10.0  # each actor's force-stop call


class CompiledDagRef:
    """Future for one execute(); results are delivered in submission
    order (the rings are FIFO), so get() drains up to this ref's seq.
    The outcome is cached on the ref: repeated get() returns (or
    re-raises) the same result; only a timeout leaves it pending."""

    def __init__(self, dag: "ChannelCompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._state = "pending"
        self._value = None
        self._exc: BaseException | None = None

    def get(self, timeout: float | None = None):
        if self._state == "pending":
            try:
                self._value = self._dag._read_result(self._seq, timeout)
            except TimeoutError:
                raise  # row not consumed; retry is safe
            except BaseException as e:  # noqa: BLE001 - cached on the ref, re-raised
                self._state = "err"
                self._exc = e
                raise
            self._state = "ok"
        if self._state == "err":
            raise self._exc
        return self._value


class ChannelCompiledDAG:
    def __init__(self, leaves, nslots: int = 8, buffer_size_bytes: int = 256 << 10):
        self._leaves = leaves if isinstance(leaves, list) else [leaves]
        self.nslots = nslots
        self.slot_size = buffer_size_bytes
        self._dag_id = uuid.uuid4().hex[:8]
        self._broken: BaseException | None = None
        self._torn_down = False
        self._send_seq = 0
        self._read_seq = 0
        self._done: dict[int, list] = {}
        self._pending: dict = {}  # channel name -> deque of undelivered values
        self._lock = threading.Lock()  # counters + _done; NEVER held across recv
        self._drain_lock = threading.Lock()  # serializes reader draining
        self._ring_names: list[str] = []
        self._handles: list = []
        self._writers: dict[str, ChannelWriter] = {}
        self._readers: dict[str, ChannelReader] = {}
        self._plan_and_connect(topo_order(self._leaves))

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    @staticmethod
    def _node_handle(node, boot_memo):
        if isinstance(node, ActorMethodNode):
            return node._handle
        if isinstance(node, ClassMethodNode):
            return node._class_node._execute_memo(boot_memo)
        raise ValueError(
            f"channel-compiled DAGs support actor-method nodes only, got {type(node).__name__} "
            "(plain @remote functions have no persistent process to pin a channel to)"
        )

    def _plan_and_connect(self, schedule):
        boot_memo: dict = {"__inputs__": ()}
        compute = []
        for node in schedule:
            if isinstance(node, InputNode):
                continue
            if isinstance(node, ClassNode):
                node._execute_memo(boot_memo)  # create compile-time actors
                continue
            compute.append(node)
        if not compute:
            raise ValueError("empty DAG")
        for lf in self._leaves:
            if isinstance(lf, InputNode):
                raise ValueError("an InputNode cannot be a DAG output")

        # (producer key, consumer id) -> channel name; producer key is
        # id(node) or ('input', index). A node feeding the driver through
        # several leaf positions shares ONE channel; the driver fans the
        # single delivered value out to every position.
        chans: dict[tuple, str] = {}

        def chan_for(producer_key, consumer_id) -> str:
            key = (producer_key, consumer_id)
            if key not in chans:
                chans[key] = ring_name(self._dag_id, len(chans))
            return chans[key]

        node_in: dict[int, list[str]] = {}
        node_tmpl: dict[int, list] = {}
        node_out: dict[int, list[str]] = {id(n): [] for n in compute}
        compute_ids = set(node_out)
        self._input_chans: dict[str, int] = {}  # name -> input index
        for node in compute:
            ins: list[str] = []
            tmpl: list = []
            if node._bound_kwargs:
                raise ValueError("channel-compiled DAGs do not support kwargs binds")
            for a in node._bound_args:
                if isinstance(a, InputNode):
                    name = chan_for(("input", a.index), id(node))
                    self._input_chans.setdefault(name, a.index)
                elif isinstance(a, DAGNode):
                    if id(a) not in compute_ids:
                        raise ValueError(f"unsupported upstream node {type(a).__name__}")
                    name = chan_for(id(a), id(node))
                    node_out[id(a)].append(name)
                else:
                    tmpl.append(("const", a))
                    continue
                if name not in ins:
                    ins.append(name)
                tmpl.append(("edge", ins.index(name)))
            if not ins:
                raise ValueError(
                    f"node {node._method!r} consumes no InputNode/upstream output; "
                    "a channel-compiled node needs an in-edge to clock it"
                )
            node_in[id(node)] = ins
            node_tmpl[id(node)] = tmpl

        # leaf output channels -> driver
        self._output_names: list[str] = []
        for lf in self._leaves:
            name = chan_for(id(lf), "driver")
            node_out[id(lf)].append(name)
            self._output_names.append(name)
        for nid, outs in node_out.items():
            node_out[nid] = list(dict.fromkeys(outs))
        self._ring_names = list(chans.values())

        # group steps per actor (topo order kept within each plan)
        by_actor: dict = {}
        for node in compute:
            h = self._node_handle(node, boot_memo)
            if h._actor_id not in by_actor:
                by_actor[h._actor_id] = (h, [])
                self._handles.append(h)
            by_actor[h._actor_id][1].append(
                {"method": node._method, "in": node_in[id(node)], "out": node_out[id(node)],
                 "arg_template": node_tmpl[id(node)]})

        # every actor brings its endpoints up at once (each call returns
        # when its channels connect); then the driver's ends: writers dial
        # the root actors' listeners, readers accept the leaves' writers
        import ray_tpu_torch

        setup_refs = [h.__rt_chan_setup__.remote({"nslots": self.nslots, "slot_size": self.slot_size, "steps": steps})
                      for h, steps in by_actor.values()]
        try:
            for name in self._input_chans:
                self._writers[name] = ChannelWriter(name, self.nslots, self.slot_size)
            for name in dict.fromkeys(self._output_names):
                self._readers[name] = ChannelReader(name, self.nslots, self.slot_size)
            ray_tpu_torch.get(setup_refs, timeout=SETUP_TIMEOUT_S)
        except BaseException:
            self._teardown_endpoints()
            raise

    # ------------------------------------------------------------------
    # execute
    # ------------------------------------------------------------------
    def execute(self, *input_args) -> CompiledDagRef:
        if self._torn_down:
            raise ChannelError("compiled DAG was torn down")
        if self._broken is not None:
            raise ChannelError(f"compiled DAG is broken: {self._broken!r}")
        with self._lock:
            # in-flight cap = output ring capacity: past it the leaves'
            # writers would stall the whole pipeline
            if self._send_seq - self._read_seq >= self.nslots:
                raise ChannelError(
                    f"{self.nslots} executions already in flight; get() results "
                    "first (or compile with a larger nslots)"
                )
            # validate EVERYTHING before any send (arity, picklability,
            # slot fit): a partial row in the input rings would desync
            # every later execution
            needed = max(self._input_chans.values(), default=-1) + 1
            if len(input_args) < needed:
                raise ValueError(f"compiled DAG takes {needed} inputs, got {len(input_args)}")
            payloads = {}
            for name, idx in self._input_chans.items():
                data = dumps(input_args[idx])
                if len(data) > self.slot_size - _HDR.size:
                    raise ChannelFullError(
                        f"input {idx} is {len(data)} bytes, exceeds slot size {self.slot_size}; "
                        "raise experimental_compile(buffer_size_bytes=...)"
                    )
                payloads[name] = data
            try:
                for name, data in payloads.items():
                    self._writers[name].send_bytes(data)
            except ChannelError as e:  # a mid-row failure poisons the rings
                self._broken = e
                raise
            seq = self._send_seq
            self._send_seq += 1
        return CompiledDagRef(self, seq)

    def _read_result(self, seq: int, timeout: float | None):
        with self._drain_lock:
            with self._lock:
                if seq in self._done:
                    return self._unwrap(self._done.pop(seq))
                if self._broken is not None:
                    raise ChannelError(f"compiled DAG is broken: {self._broken!r}")
                if not self._pending:
                    self._pending = {n: deque() for n in self._readers}
            while True:
                with self._lock:
                    if self._read_seq > seq:
                        return self._unwrap(self._done.pop(seq))
                    row_seq = self._read_seq
                # fill each channel's buffer for this row BEFORE popping
                # any: a timeout mid-row leaves buffered values buffered,
                # so a retried get() resumes without desyncing the rings
                for name, r in self._readers.items():
                    if not self._pending[name]:
                        try:
                            self._pending[name].append(r.recv(timeout))
                        except ChannelClosedError as e:
                            with self._lock:
                                self._broken = e
                            raise
                vals = {name: self._pending[name].popleft() for name in self._readers}
                with self._lock:
                    self._done[row_seq] = [vals[n] for n in self._output_names]
                    self._read_seq += 1

    @staticmethod
    def _unwrap(vals: list):
        for v in vals:
            if isinstance(v, _WrappedError):
                raise v.exc
            if isinstance(v, _Stop):
                raise ChannelError("pipeline was stopped")
        return vals if len(vals) > 1 else vals[0]

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------
    def teardown(self, *, kill_actors: bool = False, timeout: float = 30.0):
        """Drain gracefully: STOP flows through every stage in order, the
        actor loops end, endpoints close, every ring of the graph is
        unlinked. Safe after failures too."""
        if self._torn_down:
            return
        self._torn_down = True
        # graceful drain only if no get() is wedged in a recv: otherwise
        # straight to the force path, whose close ends the stuck reader
        drained = self._drain_lock.acquire(timeout=5.0)
        try:
            if drained and self._broken is None:
                try:
                    for name in self._input_chans:
                        self._writers[name].send(STOP, timeout=timeout)
                    for r in self._readers.values():
                        while not isinstance(r.recv(timeout), _Stop):
                            pass
                except ChannelError:
                    pass  # a dead or wedged stage: the force path below
        finally:
            if drained:
                self._drain_lock.release()
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import RayTpuError

        # force-stop any loop that did not drain (dead peers)
        refs = [h.__rt_chan_teardown__.remote() for h in self._handles]
        for ref in refs:
            try:
                ray_tpu_torch.get(ref, timeout=TEARDOWN_CALL_S)
            except (RayTpuError, TimeoutError):
                pass  # a dead actor has no loop left to stop
        self._teardown_endpoints()
        if kill_actors:
            for h in self._handles:
                ray_tpu_torch.kill(h)

    def _teardown_endpoints(self):
        for ep in (*self._writers.values(), *self._readers.values()):
            ep.close()
        for name in self._ring_names:  # a dead reader's rings too
            unlink_ring(name)


def compile_channel_dag(leaf_or_leaves, *, nslots: int = 8, buffer_size_bytes: int = 256 << 10) -> ChannelCompiledDAG:
    return ChannelCompiledDAG(leaf_or_leaves, nslots=nslots, buffer_size_bytes=buffer_size_bytes)
