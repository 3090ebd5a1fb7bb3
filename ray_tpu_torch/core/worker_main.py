"""The worker process (port of ray_tpu/core/worker_main.py): its
execution loop and its client of the head.

One duplex pipe connects the worker to the head. Inbound messages are
task executions, responses to this worker's own client calls (get, put,
submit, ...), stream cancels and shutdown. Execution runs on a
thread pool sized by the actor's ``max_concurrency`` (1 by default:
strictly ordered); an async actor's coroutines run on one event-loop
thread (``_complete_async``); a streaming method or task sends each item
as it is yielded. The worker also serves the direct plane on its own
socket (``core/direct.py``): owned objects, and calls straight from a
caller.

``worker_entry`` sets the worker's environment first (a card-bound
worker's ``CUDA_VISIBLE_DEVICES`` among it), points its stdout and stderr
at its log file (``<session>/logs/worker-<id>.log``, which the head's log
monitor streams to the driver), then imports the driver's ``__main__``
(``core/node.py``), then connects. ray_tpu's jax platform lines there
have no counterpart; a worker imports no jax.

A task's packed runtime_env (``runtime_env/packaging.py``) is applied
before its function or actor class resolves, so code that lives only in
its ``py_modules`` resolves by reference; a setup error fails the task.
The receive loop answers ``stack_dump`` with every thread's stack, also
while the exec threads run user code. The metrics registry is flushed
once more as the worker exits (``util/metrics.py``).
"""

from __future__ import annotations

import asyncio
import inspect
import os
import pickle
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

from ray_tpu_torch.core import context
from ray_tpu_torch.core import direct as _direct
from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.node_agent import AGENT_ENV, AGENT_FRAME
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import set_fetch_hook, set_session_tag
from ray_tpu_torch.core.payloads import decode_payload, encode_value
from ray_tpu_torch.core.serialization import deserialize_s
from ray_tpu_torch.exceptions import ActorDiedError, TaskError


class WorkerClient:
    """CoreClient implementation for worker processes: every control-plane
    operation is an RPC over the pipe to the node manager."""

    # the prefix of a request to this node's agent (``call_agent``): set in
    # an agent's workers, empty where the head answers them
    agent_frame = b""

    def __init__(self, conn, worker_id: str, node_id: str):
        from ray_tpu_torch.core.ids import NodeID, WorkerID

        self.conn = conn
        self.worker_id = WorkerID.from_hex(worker_id)
        self.node_id = NodeID.from_hex(node_id)
        self.job_id = None
        self._send_lock = threading.Lock()
        self._req_lock = threading.Lock()
        self._req_seq = 0
        self._pending: dict[int, list] = {}  # req_id -> [event, ok, payload]
        self.current_task_id = None
        self.current_actor_id = None
        self.assigned_resources = {}
        self._shutdown = False
        # execution machinery (created lazily / per actor)
        self._exec_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rt-exec")
        self._actor_instance = None
        self._actor_loop = None  # asyncio loop thread for async actors
        self._actor_loop_lock = threading.Lock()
        self._func_cache: dict[str, object] = {}
        self._sent_funcs: set[str] = set()
        # shm mappings whose close was deferred because user code still
        # holds zero-copy views into them
        self._deferred_segs: list = []
        # streaming tasks asked to stop early (cooperative cancel: the
        # generator loop checks between items)
        self._cancelled_streams: set = set()

    # ---------------- transport ----------------
    def _send_done(self, msg: dict):
        """Task-completion send: piggybacks this process's pending ref-count
        transitions so the head registers borrows (refs deserialized during
        the task) BEFORE it releases any argument pins — closing the race
        between the async ref pump and pin release."""
        from ray_tpu_torch.core.object_ref import drain_ref_events

        events = drain_ref_events()
        st = _direct.state()
        if st is not None:
            events = st.route_ref_events(events)  # owned events go to owners
        if events:
            msg["ref_events"] = [(k.hex(), reg) for k, reg in events]
        self._send(msg)

    def _send(self, msg: dict):
        with self._send_lock:
            self.conn.send(msg)

    def _check_alive_locked(self):
        """Raise when no reply can come (an attached driver's lost head);
        called under the request lock before a call registers."""

    def call(self, method: str, timeout: float | None = None, _kind: str = "req", _frame: bytes = b"", **params):
        """A request answered on this process's pipe; ``_frame``: a prefix
        that makes the frame its agent's (``call_agent``)."""
        with self._req_lock:
            self._check_alive_locked()
            self._req_seq += 1
            req_id = self._req_seq
            slot = [threading.Event(), False, None]
            self._pending[req_id] = slot
        try:
            msg = {"type": _kind, "req_id": req_id, "method": method, "params": params}
            if _frame:
                with self._send_lock:
                    self.conn.send_bytes(_frame + pickle.dumps(msg))
            else:
                self._send(msg)
        except Exception:
            with self._req_lock:
                self._pending.pop(req_id, None)
            raise
        if not slot[0].wait(timeout=timeout):
            with self._req_lock:
                self._pending.pop(req_id, None)
            raise TimeoutError(f"worker RPC {method} timed out")
        if not slot[1]:
            raise slot[2]
        return slot[2]

    def call_agent(self, method: str, timeout: float | None = None, **params):
        """An RPC that this node's agent answers: an agent's worker marks
        the frame with ``AGENT_FRAME``, so the agent reads it and relays
        every other frame unread; the head's own workers and attached
        drivers send a head RPC of kind ``agent_req``."""
        return self.call(method, timeout=timeout, _kind="agent_req", _frame=self.agent_frame, **params)

    def _fetch_remote_segment(self, desc) -> str:
        """The object store's fetch hook: the node's agent pulls a foreign
        namespace's segment into this node's namespace."""
        return self.call_agent("fetch_object", desc=desc, timeout=120.0)

    def _handle_resp(self, msg):
        with self._req_lock:
            slot = self._pending.pop(msg["req_id"], None)
        if slot is None:
            return
        slot[1] = msg["ok"]
        slot[2] = msg["payload"] if msg["ok"] else msg["error"]
        slot[0].set()

    # ---------------- CoreClient API ----------------
    def get_object(self, obj_id: ObjectID, timeout: float | None = None):
        from ray_tpu_torch.exceptions import ObjectLostError

        handled, v = _direct.maybe_get_owned(obj_id, timeout)
        if handled:
            return v
        for attempt in range(3):
            try:
                payload = self.call("get_object", obj_id=obj_id, timeout_s=timeout, timeout=None)
            except ObjectLostError:
                # owner-side lineage replay for head-sealed direct results
                if _direct.try_reconstruct(self, obj_id):
                    handled, v = _direct.maybe_get_owned(obj_id, timeout)
                    if handled:
                        return v
                    continue
                raise
            try:
                value, seg = decode_payload(payload, zero_copy=True)
            except FileNotFoundError:
                # the segment raced an eviction: tell the head and retry
                # (lineage rebuilds it)
                self.call("mark_object_lost", obj_id=obj_id)
                continue
            if isinstance(value, BaseException):
                raise value
            return value
        raise FileNotFoundError(f"object {obj_id.hex()[:16]} backing store repeatedly lost")

    def put_object(self, value) -> ObjectRef:
        ref, s = _direct.try_put(value)
        if ref is not None:
            return ref
        from ray_tpu_torch.core.payloads import encode_serialized

        obj_id = ObjectID.from_put()
        payload = encode_serialized(s, obj_id=obj_id)
        self.call("put_object", obj_id=obj_id, payload=payload)
        return ObjectRef(obj_id)

    def put_payload(self, obj_id: ObjectID, payload):
        self.call("put_object", obj_id=obj_id, payload=payload)

    def wait_ready(self, obj_ids, num_returns=1, timeout=None, fetch_local=True):
        return _direct.wait_mixed(
            self, list(obj_ids), num_returns, timeout,
            lambda ids, nr, t: self.call("wait_ready", obj_ids=list(ids), num_returns=nr, timeout_s=t, timeout=None),
        )

    def add_done_callback(self, obj_id, cb):
        if _direct.add_done_callback_owned(obj_id, cb):
            return

        # Poll-free callback support for workers: run a waiter thread.
        def _wait():
            try:
                v = self.get_object(obj_id)
                cb(v, None)
            except BaseException as e:  # noqa: BLE001
                cb(None, e)

        threading.Thread(target=_wait, daemon=True).start()

    def submit_task(self, **payload):
        return self.call("submit_task", **payload)

    def create_actor(self, **payload):
        return self.call("create_actor", **payload)

    def submit_actor_task(self, **payload):
        return self.call("submit_actor_task", **payload)

    def kill_actor(self, actor_id, no_restart=True):
        return self.call("kill_actor", actor_id=actor_id, no_restart=no_restart)

    def cancel_task(self, obj_id, force=False):
        return self.call("cancel_task", obj_id=obj_id, force=force)

    def get_actor_handle_info(self, name, namespace="default"):
        return self.call("get_actor_handle_info", name=name, namespace=namespace)

    def next_generator_item(self, gen_id, index, timeout=None):
        oid = self.call("next_generator_item", gen_id=gen_id, index=index, timeout_s=timeout, timeout=None)
        return ObjectRef(oid) if oid is not None else None

    def free_objects(self, obj_ids):
        rest = _direct.free_owned(list(obj_ids))
        if rest:
            self.call("free_objects", obj_ids=rest)

    # ---------------- direct-plane head RPCs ----------------
    def actor_endpoint(self, actor_hex: str):
        return self.call("actor_endpoint", actor_id=actor_hex)

    def lease_worker(self):
        return self.call("lease_worker")

    def release_lease(self, wid: str):
        return self.call("release_lease", wid=wid)

    def terminate_leased_worker(self, wid: str):
        return self.call("terminate_leased_worker", wid=wid)

    def object_locations(self, obj_ids) -> dict:
        ids = list(obj_ids)
        out = {}
        rest = []
        for o in ids:
            loc = _direct.owned_location(o.binary())
            if loc is not None or _direct.is_owned_or_hinted(o.binary()):
                out[o.hex()] = loc
            else:
                rest.append(o)
        if rest:
            out.update(self.call("object_locations", obj_ids=rest))
        return out

    def cluster_info(self, kind: str):
        return self.call("cluster_info", kind=kind)

    def kv(self, op: str, **kw):
        return self.call("kv", op=op, **kw)

    def pg(self, op: str, **kw):
        return self.call("pg", op=op, **kw)

    def push_metrics(self, key: str, value: dict):
        """One-way: this process's metrics snapshot into the head's GCS KV
        (``util/metrics.py``); never waits, so an exiting worker's last
        flush cannot hang on a head that stopped reading."""
        self._send({"type": "metrics", "key": key, "value": value})

    def has_function(self, func_id: str) -> bool:
        return func_id in self._sent_funcs

    def mark_function_sent(self, func_id: str):
        self._sent_funcs.add(func_id)

    def get_function(self, func_id: str):
        if func_id not in self._func_cache:
            blob = self.call("get_function", func_id=func_id)
            self._func_cache[func_id] = _resolve(deserialize_s(blob))
        return self._func_cache[func_id]

    # ---------------- execution ----------------
    def _apply_env(self, env: dict | None):
        if env:
            os.environ.update({k: str(v) for k, v in env.items()})

    def _decode_args(self, arg_specs, kwarg_specs):
        args, kwargs, segs = [], {}, []

        def one(a):
            if a.ref is not None:
                if getattr(a, "owner", None):
                    # direct-plane owned argument: fetch from its owner
                    _direct.note_hint(a.ref.binary(), a.owner)
                return self.get_object(a.ref)
            try:
                v, seg = decode_payload(a.payload, zero_copy=True)
            except FileNotFoundError:
                shm = getattr(a.payload, "shm", None)
                if shm is None:
                    raise
                # the head resolved a ref into this descriptor but its
                # segment raced an eviction: the object id is in the
                # segment's name, and the head's get path rebuilds it
                return self.get_object(ObjectID.from_hex(shm.shm_name.rsplit("_", 1)[-1]))
            if seg is not None:
                segs.append(seg)
            return v

        for a in arg_specs:
            args.append(one(a))
        for k, a in (kwarg_specs or {}).items():
            kwargs[k] = one(a)
        return args, kwargs, segs

    def _encode_returns(self, spec, value):
        """Return list of (obj_id, payload)."""
        out = []
        ids = spec_return_ids(spec)
        if spec.num_returns == 1:
            values = [value]
        else:
            values = list(value)
            if len(values) != spec.num_returns:
                raise ValueError(f"task {spec.name} returned {len(values)} values, expected {spec.num_returns}")
        for oid, v in zip(ids, values):
            out.append((oid, encode_value(v, obj_id=oid)))
        return out

    def _execute(self, msg):
        spec = msg["spec"]
        if getattr(spec, "trace_ctx", None) is not None:
            from ray_tpu_torch.util import tracing

            # server span under the caller's submit span; nested .remote
            # calls inside the task inherit this context (one trace id
            # stitches the whole cross-process call tree)
            with tracing.span(
                f"task::{spec.name}", kind="server", parent_ctx=tuple(spec.trace_ctx),
                task_id=spec.task_id.hex(), actor=spec.actor_id.hex() if spec.actor_id else None,
            ):
                return self._execute_inner(msg)
        return self._execute_inner(msg)

    def _execute_inner(self, msg):
        spec = msg["spec"]
        self.current_task_id = spec.task_id
        self.assigned_resources = msg.get("resources", {})
        self._apply_env(msg.get("env"))
        try:
            renv = spec.runtime_env
            if renv and ("_packed_working_dir" in renv or "_packed_py_modules" in renv):
                # inside the try: a bad archive, a failed fetch or a chdir
                # error fails the task instead of hanging its caller
                from ray_tpu_torch.runtime_env import apply_runtime_env_in_worker

                apply_runtime_env_in_worker(renv, lambda h: self.get_object(ObjectID.from_hex(h)))
            if spec.is_actor_creation:
                self._create_actor_instance(spec, msg)
                self._send_done({"type": "done", "task_id": spec.task_id, "returns": [], "error": None})
                return
            if spec.actor_id is not None:
                fn = self._actor_method(spec.method_name)
            else:
                fn = self.get_function(spec.func_id)
            args, kwargs, segs = self._decode_args(msg["args"], msg.get("kwargs"))
            try:
                result = fn(*args, **kwargs)
                if inspect.iscoroutine(result):
                    if spec.streaming:
                        result = self._run_on_actor_loop(result)
                    else:
                        # async actor: complete without blocking the exec slot
                        self._complete_async(spec, result)
                        return
                if spec.streaming:
                    self._stream_generator(spec, result)
                    return
                if inspect.isgenerator(result):
                    result = list(result)
                returns = self._encode_returns(spec, result)
            finally:
                self._release_segments(segs)
                del args, kwargs
            self._send_done({"type": "done", "task_id": spec.task_id, "returns": returns, "error": None})
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, TaskError) else TaskError.from_exception(e, task_desc=spec.desc())
            try:
                self._send_done({"type": "done", "task_id": spec.task_id, "returns": [], "error": err})
            except Exception:
                traceback.print_exc()
                try:
                    fallback = TaskError(cause=None, tb_str=err.tb_str, task_desc=spec.desc())
                    self._send_done({"type": "done", "task_id": spec.task_id, "returns": [], "error": fallback})
                except Exception:
                    pass
        finally:
            self.current_task_id = None

    def _release_segments(self, segs):
        """Close shm mappings; views still referenced by user code defer the
        close (retried after later tasks)."""
        pending = self._deferred_segs + list(segs or [])
        self._deferred_segs = []
        import gc

        for seg in pending:
            try:
                seg.close()
            except BufferError:
                self._deferred_segs.append(seg)
        if len(self._deferred_segs) > 64:
            gc.collect()
            still = []
            for seg in self._deferred_segs:
                try:
                    seg.close()
                except BufferError:
                    still.append(seg)
            self._deferred_segs = still

    def _complete_async(self, spec, coro):
        """Run an async actor method on the actor's event loop; the loop's
        completion callback sends the done message. The caller's trace
        context rides into the coroutine."""
        if getattr(spec, "trace_ctx", None) is not None:
            from ray_tpu_torch.util import tracing

            ctx = tracing._ctx()
            if ctx is not None:
                async def _with_ctx(c=coro, ctx=ctx):
                    tracing.set_context(ctx)
                    return await c

                coro = _with_ctx()
        fut = asyncio.run_coroutine_threadsafe(coro, self._get_actor_loop())

        def _cb(f):
            try:
                returns = self._encode_returns(spec, f.result())
                self._send_done({"type": "done", "task_id": spec.task_id, "returns": returns, "error": None})
            except BaseException as e:  # noqa: BLE001
                err = TaskError.from_exception(e, task_desc=spec.desc())
                try:
                    self._send_done({"type": "done", "task_id": spec.task_id, "returns": [], "error": err})
                except Exception:
                    pass

        fut.add_done_callback(_cb)

    def _stream_generator(self, spec, gen):
        index = 0
        try:
            if inspect.isasyncgen(gen):
                gen = _drain_async_gen(self._get_actor_loop(), gen)
            for item in gen:
                if spec.task_id in self._cancelled_streams:
                    # cooperative cancel: stop producing, close the
                    # generator so its finally blocks run, end the stream
                    try:
                        gen.close()
                    except Exception:
                        pass
                    break
                oid = ObjectID.for_task_return(spec.task_id, index + 1)
                payload = encode_value(item, obj_id=oid)
                self._send({"type": "stream_item", "task_id": spec.task_id, "index": index, "obj_id": oid, "payload": payload})
                index += 1
            self._send_done({"type": "done", "task_id": spec.task_id, "returns": [], "error": None, "stream_count": index})
        except BaseException as e:  # noqa: BLE001
            err = TaskError.from_exception(e, task_desc=spec.desc())
            self._send_done({"type": "done", "task_id": spec.task_id, "returns": [], "error": err, "stream_count": index})
        finally:
            self._cancelled_streams.discard(spec.task_id)

    # ---------------- direct-plane execution ----------------
    def _direct_exec_handler(self, msg, reply, conn_funcs):
        """Server hook (core/direct.py): a peer submitted a call straight
        to this worker. Runs on the same exec lane as head-dispatched work
        so per-actor ordering and max_concurrency hold."""
        self._exec_pool.submit(self._execute_direct, msg, reply, conn_funcs)

    def _reply_direct_raw(self, msg, values, reply):
        """Fast-path reply: plain values ride the result frame as one
        pickle. False for unpicklable or store-sized results (the caller
        encodes them as payloads)."""
        import pickle

        from ray_tpu_torch._config import get_config
        from ray_tpu_torch.core import object_ref as _oref
        from ray_tpu_torch.core.serialization import dumps_inband

        sink: list = []
        token = _oref.push_ref_sink(sink)
        try:
            data = dumps_inband({"op": "result", "cid": msg["cid"], "vals": values, "error": None})
        except (pickle.PicklingError, TypeError, AttributeError):
            return False  # the payload path pickles it or reports the error
        finally:
            _oref.pop_ref_sink(token)
        if len(data) > get_config().max_direct_call_object_size:
            return False
        if sink:
            self._keepalive_refs(sink)
        reply(data)
        return True

    def _buffer_task_event(self, msg, started: float, ok: bool):
        """Buffer one direct-execution span; the ref pump flushes batches
        to the head (observability parity: task_event_buffer.h)."""
        buf = getattr(self, "_task_event_buf", None)
        if buf is None:
            buf = self._task_event_buf = []
        actor = msg.get("actor")
        buf.append({
            "task": msg["task"],
            "name": msg["method"],
            "actor": actor.hex() if actor else None,
            "start": started,
            "end": time.time(),
            "ok": ok,
        })

    def _flush_task_events(self):
        buf = getattr(self, "_task_event_buf", None)
        if buf:
            events, self._task_event_buf = buf, []
            self._send({"type": "task_events", "events": events})

    def _keepalive_refs(self, contained_ids, hold_s: float = 3.0):
        import collections

        ka = getattr(self, "_direct_keepalive", None)
        if ka is None:
            ka = self._direct_keepalive = collections.deque()
        now = time.monotonic()
        ka.append((now + hold_s, [ObjectRef(c) for c in contained_ids]))
        while ka and ka[0][0] < now:
            ka.popleft()

    def _prune_keepalive(self):
        """Timer-driven keepalive expiry (the append-time prune alone
        would hold the LAST call's pins for the worker's lifetime)."""
        ka = getattr(self, "_direct_keepalive", None)
        if ka:
            now = time.monotonic()
            while ka and ka[0][0] < now:
                ka.popleft()

    def _direct_fn(self, func_id: str, conn_funcs: dict):
        fn = self._func_cache.get(func_id)
        if fn is None:
            blob = conn_funcs.get(func_id)
            if blob is None:
                raise RuntimeError(f"direct call for unregistered function {func_id[:12]}")
            fn = _resolve(deserialize_s(blob))
            self._func_cache[func_id] = fn
        return fn

    def _execute_direct(self, msg, reply, conn_funcs):
        trace = msg.get("trace")
        if trace is not None:
            from ray_tpu_torch.util import tracing

            with tracing.span(
                f"task::{msg['method']}", kind="server", parent_ctx=tuple(trace),
                task_id=msg["task"].hex(),
            ):
                return self._execute_direct_inner(msg, reply, conn_funcs)
        return self._execute_direct_inner(msg, reply, conn_funcs)

    def _execute_direct_inner(self, msg, reply, conn_funcs):
        tid = TaskID(msg["task"])
        st = _direct.state()
        if st is not None and msg["task"] in st.cancelled_direct:
            st.cancelled_direct.discard(msg["task"])
            from ray_tpu_torch.exceptions import RayTpuError

            reply({"op": "result", "cid": msg["cid"], "returns": [],
                   "error": RayTpuError(f"task {tid.hex()[:8]} was cancelled")})
            return
        self.current_task_id = tid
        started = time.time()
        ok = True
        segs = []
        try:
            if msg.get("actor") is not None:
                fn = self._actor_method(msg["method"])
            else:
                fn = self._direct_fn(msg["func_id"], conn_funcs)
            if "argv" in msg:
                # fast path: args arrived as plain values with the frame.
                # POP them out of msg: the server conn loop keeps msg
                # alive until the NEXT frame arrives, and a materialized
                # ObjectRef arg retained there would hold its borrow open
                # indefinitely on an idle connection — the owner could
                # never free (the handoff-block leak the disagg tests
                # guard against)
                args = msg.pop("argv")
                kwargs = msg.pop("kwargv", None) or {}
            else:
                args, kwargs, segs = self._decode_args(msg["args"], msg.get("kwargs"))
            try:
                result = fn(*args, **kwargs)
            finally:
                del args, kwargs
            if inspect.iscoroutine(result):
                self._complete_async_direct(msg, result, reply)
                return  # the loop callback buffers the span
            if inspect.isgenerator(result):
                result = list(result)
            self._reply_direct(msg, result, reply)
            self._buffer_task_event(msg, started, True)
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, TaskError) else TaskError.from_exception(
                e, task_desc=f"{msg['method']}[{tid.hex()[:8]}]"
            )
            reply({"op": "result", "cid": msg["cid"], "returns": [], "error": err})
            self._buffer_task_event(msg, started, False)
        finally:
            self._release_segments(segs)
            self.current_task_id = None

    def _reply_direct(self, msg, result, reply):
        tid = TaskID(msg["task"])
        nr = msg.get("num_returns", 1)
        values = [result] if nr == 1 else list(result)
        if len(values) != nr:
            raise ValueError(f"direct call {msg['method']} returned {len(values)} values, expected {nr}")
        if self._reply_direct_raw(msg, values, reply):
            return
        returns, seals = [], []
        for i, v in enumerate(values):
            oid = ObjectID.for_task_return(tid, i)
            payload = encode_value(v, obj_id=oid)
            head_owned = payload.shm is not None
            if head_owned:
                seals.append((oid, payload))
            if payload.contained:
                # refs pickled inside the result: hold them past the reply
                # so the caller's borrow registration beats our release
                # (the direct-plane analogue of the done-piggyback ordering)
                self._keepalive_refs(payload.contained)
            returns.append((oid.binary(), payload, head_owned))
        if seals:
            # large results go to the shared store under head ownership;
            # the seal must reach the head BEFORE the caller can act on
            # the reply (pipe FIFO gives that ordering on this side; the
            # head blocks unknown-id gets until the seal arrives)
            self._send_done({"type": "seal", "items": seals})
        reply({"op": "result", "cid": msg["cid"], "returns": returns, "error": None})

    def _complete_async_direct(self, msg, coro, reply):
        started = time.time()
        fut = asyncio.run_coroutine_threadsafe(coro, self._get_actor_loop())

        def _cb(f):
            ok = True
            try:
                self._reply_direct(msg, f.result(), reply)
            except BaseException as e:  # noqa: BLE001
                ok = False
                err = e if isinstance(e, TaskError) else TaskError.from_exception(e, task_desc=msg["method"])
                reply({"op": "result", "cid": msg["cid"], "returns": [], "error": err})
            self._buffer_task_event(msg, started, ok)

        fut.add_done_callback(_cb)

    # -- actors --
    def _create_actor_instance(self, spec, msg):
        cls = self.get_function(spec.func_id)
        args, kwargs, _ = self._decode_args(msg["args"], msg.get("kwargs"))
        self.current_actor_id = spec.actor_id
        if spec.max_concurrency > 1:
            self._exec_pool = ThreadPoolExecutor(max_workers=spec.max_concurrency, thread_name_prefix="rt-actor")
        self._actor_instance = cls(*args, **kwargs)

    def _actor_method(self, name):
        if self._actor_instance is None:
            raise ActorDiedError(reason="actor instance not created")
        if name == "__ray_terminate__":
            return self._terminate_actor
        if name == "__ray_ready__":
            return lambda: True
        if name == "__rt_device_get__":
            # device objects: any actor serves its own registered tensors
            # to a consumer in another process (experimental/device_objects.py)
            from ray_tpu_torch.experimental.device_objects import export_for_transfer

            return export_for_transfer
        if name == "__rt_chan_setup__":
            return self._chan_setup
        if name == "__rt_chan_teardown__":
            return self._chan_teardown
        fn = getattr(self._actor_instance, name, None)
        if fn is None:
            raise AttributeError(f"actor has no method {name!r}")
        return fn

    def _terminate_actor(self):
        self._shutdown = True
        return True

    def _chan_setup(self, plan):
        """A channel-compiled DAG's builtin: bring up this actor's ring
        endpoints and start its execution loop (experimental/channels.py)."""
        from ray_tpu_torch.experimental.channels import ChannelLoopRunner

        self._chan_teardown()
        runner = ChannelLoopRunner(self._actor_instance, plan)
        runner.setup()
        self._chan_runner = runner
        return True

    def _chan_teardown(self):
        runner, self._chan_runner = getattr(self, "_chan_runner", None), None
        if runner is not None:
            runner.teardown()
        return True

    def _get_actor_loop(self):
        # exec-pool threads (max_concurrency of them) race here; one loop only
        with self._actor_loop_lock:
            if self._actor_loop is None:
                loop = asyncio.new_event_loop()
                t = threading.Thread(target=loop.run_forever, daemon=True, name="rt-actor-loop")
                t.start()
                self._actor_loop = loop
            return self._actor_loop

    def _run_on_actor_loop(self, coro):
        fut = asyncio.run_coroutine_threadsafe(coro, self._get_actor_loop())
        return fut.result()

    # ---------------- main loop ----------------
    def _ref_pump_loop(self):
        """Flush this process's ref-count transitions to the head (the
        borrow protocol's worker half). Events of direct-plane owned
        objects go to their owners instead."""
        from ray_tpu_torch._config import get_config
        from ray_tpu_torch.core.object_ref import drain_ref_events

        interval = max(0.05, get_config().ref_counting_interval_s)
        while not self._shutdown:
            time.sleep(interval)
            self._prune_keepalive()
            try:
                self._flush_task_events()
                events = drain_ref_events()
                st = _direct.state()
                if st is not None:
                    events = st.route_ref_events(events)
                if events:
                    # one-way on the worker pipe: FIFO with done messages,
                    # so batches never overtake done-piggybacked borrows
                    self._send({"type": "ref_events", "events": [(k.hex(), reg) for k, reg in events]})
            except (OSError, ValueError):
                return  # the pipe is gone: the head drops this worker's holdings

    def run(self):
        from ray_tpu_torch._config import get_config
        from ray_tpu_torch.core.object_ref import set_ref_counting

        if get_config().object_ref_counting:
            threading.Thread(target=self._ref_pump_loop, daemon=True, name="rt-ref-pump").start()
        else:
            set_ref_counting(False)
        ready = {"type": "ready", "worker_id": self.worker_id, "pid": os.getpid()}
        st = _direct.state()
        if st is not None and st.server is not None:
            ready["direct_addr"] = st.server.address
        self._send(ready)
        while not self._shutdown:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError):
                break
            t = msg["type"]
            if t == "resp":
                self._handle_resp(msg)
            elif t == "exec":
                self._exec_pool.submit(self._execute, msg)
            elif t == "cancel_stream":
                self._cancelled_streams.add(msg["task_id"])
            elif t == "stack_dump":
                self._send({"type": "stack_dump_result", "req_id": msg.get("req_id"), "stacks": _format_all_stacks(),
                            "pid": os.getpid(),
                            "current_task": self.current_task_id.hex() if self.current_task_id else None})
            elif t == "shutdown":
                break
        self._exec_pool.shutdown(wait=False, cancel_futures=True)
        _exit_flush()
        os._exit(0)


def _format_all_stacks() -> dict:
    """{"<thread name> (<ident>)": its formatted stack} for every live thread."""
    import sys

    names = {t.ident: t.name for t in threading.enumerate()}
    return {f"{names.get(ident, 'unknown')} ({ident})": "".join(traceback.format_stack(frame))
            for ident, frame in sys._current_frames().items()}


def _exit_flush():
    """The worker's last spans and metric increments, before it exits."""
    from ray_tpu_torch.util import metrics as _metrics
    from ray_tpu_torch.util import tracing as _tracing

    _tracing.shutdown()
    if _metrics._registry.metrics:
        _metrics._registry.flush_once()
    import sys

    for f in (sys.stdout, sys.stderr):
        try:
            f.flush()
        except (OSError, ValueError):
            pass  # the stream is closed


def redirect_worker_logs(worker_id: str):
    """Point this worker's stdout and stderr (the descriptors, so a child
    process's or an extension's writes land too) at its own file,
    ``<RT_LOG_DIR>/worker-<id>.log``; the head's log monitor streams the
    file to the driver. Without ``RT_LOG_DIR`` (a worker of an agent that
    joined from another host) the file goes under this host's session."""
    import sys

    d = os.environ.get("RT_LOG_DIR")
    if not d:
        from ray_tpu_torch.util.tracing import session_dir

        d = os.path.join(session_dir(), "logs")
    os.makedirs(d, exist_ok=True)
    fd = os.open(os.path.join(d, f"worker-{worker_id[:12]}.log"), os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    for f in (sys.stdout, sys.stderr):
        try:
            f.flush()
        except (OSError, ValueError):
            pass  # the inherited stream is closed
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
    sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)


def _drain_async_gen(loop, agen):
    """Convert an async generator to a sync iterator via the actor loop."""

    while True:
        fut = asyncio.run_coroutine_threadsafe(agen.__anext__(), loop)
        try:
            yield fut.result()
        except StopAsyncIteration:
            return


def spec_return_ids(spec):
    return [ObjectID.for_task_return(spec.task_id, i) for i in range(spec.num_returns)]


def _resolve(ref):
    """The function or class a (module, qualified name) blob names."""
    from ray_tpu_torch.core.serialization import resolve_code

    return resolve_code(*ref)


def _adopt_driver_main(main):
    """Import the driver's __main__ here as __mp_main__ (multiprocessing's
    own helpers), so its top-level functions and classes resolve."""
    if main is None:
        return
    from multiprocessing import spawn

    kind, value = main
    if kind == "name":
        spawn._fixup_main_from_name(value)
    else:
        spawn._fixup_main_from_path(value)


def worker_entry(conn, worker_id: str, node_id: str, env: dict | None = None, main=None, session_tag=None):
    """Process entry point (multiprocessing target). ``session_tag``: the
    head's tag for this worker's segments, so that the head-owned objects
    it writes outlive it."""
    if env:
        os.environ.update(env)  # before anything here can touch CUDA
    under_agent = os.environ.pop(AGENT_ENV, None)  # not for the processes this worker starts
    set_session_tag(session_tag)
    os.environ["RT_WORKER_ID"] = worker_id
    redirect_worker_logs(worker_id)
    _adopt_driver_main(main)
    client = WorkerClient(conn, worker_id, node_id)
    if under_agent:
        client.agent_frame = AGENT_FRAME
    set_fetch_hook(client._fetch_remote_segment)
    context.set_client(client)
    # the direct plane: owned objects and direct executions on this
    # worker's own socket; off when the head handed out no authkey
    dk = os.environ.get("RT_DIRECT_AUTHKEY")
    if dk:
        _direct.attach(bytes.fromhex(dk), node_hex=node_id, client=client, exec_handler=client._direct_exec_handler)
    try:
        client.run()
    finally:
        _exit_flush()
