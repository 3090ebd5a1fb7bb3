"""DeploymentHandle: the client-side router (port of
ray_tpu/serve/handle.py): power-of-two-choices replica selection on the
handle's own in-flight counts, handle-side queueing, the metric push and
model-id affinity for multiplexed requests.

The handle caches the RUNNING replica set (refreshed from the controller
when its version changes or on a short interval), tracks its own
in-flight count per replica, and enforces max_ongoing_requests
client-side: requests beyond capacity queue here — queue depth is the
autoscaler's upscale signal, pushed via record_handle_metrics.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from collections import deque

import ray_tpu_torch

_REFRESH_INTERVAL_S = 0.25


class DeploymentResponse:
    """Future for one request. Handles are ASYNC: .remote() never blocks the
    caller; requests beyond replica capacity queue inside the router and
    a dispatcher assigns them as slots free. `result()` blocks;
    `_to_object_ref()` unwraps for composition with ray_tpu_torch.get/wait;
    `cancel()` propagates to the replica task and releases the slot."""

    def __init__(self, router, replica_id=None, ref=None):
        self._router = router
        self._replica_id = replica_id
        self._ref = ref
        self._error = None
        self._done = False
        self._cancelled = False
        self._bound = threading.Event()
        self._bind_cbs: list = []
        if ref is not None:
            self._bound.set()

    # -- dispatcher side --
    def _fire_bind_cbs(self):
        cbs, self._bind_cbs = self._bind_cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception:
                pass

    def _bind(self, replica_id, ref):
        self._replica_id = replica_id
        self._ref = ref
        self._bound.set()
        self._fire_bind_cbs()

    def _fail(self, err: BaseException):
        self._error = err
        self._done = True
        self._bound.set()
        self._fire_bind_cbs()

    def _add_bind_callback(self, cb) -> bool:
        """Register cb() to run when the response binds or fails; returns
        False (without registering) if that already happened."""
        if self._bound.is_set():
            return False
        self._bind_cbs.append(cb)
        if self._bound.is_set() and cb in self._bind_cbs:
            # raced the bind: fire inline so the waiter can't be missed
            self._bind_cbs.remove(cb)
            return False
        return True

    def _settle(self):
        if not self._done:
            self._done = True
            if self._ref is not None:
                self._router._on_done(self._replica_id, self._ref)

    def _wait_bound(self, timeout_s: float | None):
        if not self._bound.wait(timeout=timeout_s):
            raise ray_tpu_torch.exceptions.GetTimeoutError(
                f"request still queued for a replica after {timeout_s}s"
            )
        if self._error is not None:
            raise self._error

    def result(self, timeout_s: float | None = None):
        """A timeout raises but does NOT cancel (poll-with-timeout keeps
        the request running; call cancel() to abort)."""
        t0 = time.time()
        self._wait_bound(timeout_s)
        remaining = None if timeout_s is None else max(0.0, timeout_s - (time.time() - t0))
        try:
            v = ray_tpu_torch.get(self._ref, timeout=remaining)
            self._settle()
            return v
        except ray_tpu_torch.exceptions.GetTimeoutError:
            raise  # still in flight: slot stays held until done/cancelled
        except BaseException:
            self._settle()
            raise

    def cancel(self):
        """Best-effort cancellation: a queued request is dropped before dispatch; a dispatched replica
        task is cancelled; the router slot frees either way."""
        self._cancelled = True
        if self._ref is None:
            # not yet bound: the DISPATCHER settles/skips it (settling
            # here would mark _done and leak the slot it's about to claim)
            return
        try:
            ray_tpu_torch.cancel(self._ref)
        except Exception:
            pass
        self._settle()

    def _to_object_ref(self, timeout_s: float | None = 60.0):
        self._wait_bound(timeout_s)
        return self._ref


class DeploymentResponseGenerator:
    """Streaming response: iterate per-item results as the replica yields
    them, over the runtime's streaming generators. ``item_timeout_s``
    bounds each item fetch (GetTimeoutError aborts the stream and frees
    the slot)."""

    def __init__(self, router, replica_id, gen):
        self._router = router
        self._replica_id = replica_id
        self._gen = gen
        self._done = False
        self._exhausted = False
        self.item_timeout_s: float | None = None

    def __iter__(self):
        try:
            while True:
                try:
                    # bounds the wait for the NEXT item too, not just the
                    # fetch of a produced one
                    item_ref = self._gen.next_ref(timeout_s=self.item_timeout_s)
                except StopIteration:
                    self._exhausted = True
                    break
                yield ray_tpu_torch.get(item_ref, timeout=self.item_timeout_s)
        finally:
            self._settle()

    def cancel(self):
        """Stop the replica-side generator (cooperative: it halts between
        yields) and release the router slot."""
        try:
            ray_tpu_torch.cancel(ray_tpu_torch.ObjectRef(self._gen.generator_id))
        except Exception:
            pass
        self._done = True
        self._router._on_done(self._replica_id, self._gen)

    def _settle(self):
        if not self._done:
            self._done = True
            if not self._exhausted:
                # abandoned/aborted mid-stream: stop the producer too
                try:
                    ray_tpu_torch.cancel(ray_tpu_torch.ObjectRef(self._gen.generator_id))
                except Exception:
                    pass
            self._router._on_done(self._replica_id, self._gen)

    def __del__(self):
        # backstop: a dropped, never-iterated stream must not leak its
        # replica slot forever (reap can't settle streaming entries)
        try:
            self._settle()
        except Exception:
            pass


class _Router:
    """Pow-2 replica choice + client-side admission control."""

    def __init__(self, controller, app_name: str, deployment: str):
        self._controller = controller
        self._app = app_name
        self._deployment = deployment
        self._handle_id = uuid.uuid4().hex[:8]
        self._lock = threading.Condition()
        self._version = -1
        self._replicas: list = []  # [(replica_id, actor)]
        self._max_ongoing = 1
        self._inflight: dict[str, int] = {}
        self._inflight_refs: dict = {}  # ref-id -> replica_id
        self._queued = 0
        self._pending_q: deque = deque()
        self._dispatcher = None
        self._last_refresh = 0.0
        self._last_push = 0.0
        self._last_push_ref = None  # latest metrics-push ref (see _push_metrics)
        from collections import OrderedDict

        # model_id -> last replica, LRU-capped so unbounded id
        # cardinality (per-user fine-tunes) can't grow forever; stale
        # replica ids are pruned on replica-set refresh
        self._model_affinity: OrderedDict = OrderedDict()

    # -- controller sync --

    def _refresh(self, force: bool = False):
        now = time.time()
        if not force and now - self._last_refresh < _REFRESH_INTERVAL_S:
            return
        self._last_refresh = now
        version, replicas, max_ongoing = ray_tpu_torch.get(
            self._controller.get_replicas.remote(self._app, self._deployment, self._version)
        )
        with self._lock:
            if version != self._version:
                self._version = version
                self._replicas = replicas
                self._max_ongoing = max(1, max_ongoing)
                live = {rid for rid, _ in replicas}
                self._inflight = {rid: self._inflight.get(rid, 0) for rid in live}
                for mid in [m for m, rid in self._model_affinity.items() if rid not in live]:
                    del self._model_affinity[mid]
                self._lock.notify_all()
        self._push_metrics()

    def _push_metrics(self):
        now = time.time()
        if now - self._last_push < _REFRESH_INTERVAL_S / 2:
            return
        self._last_push = now
        with self._lock:
            demand = self._queued + sum(self._inflight.values())
        try:
            # keep the latest push's ref alive: a dropped
            # ref frees the return immediately and loses the error channel;
            # holding the newest one lets a dead controller surface on the
            # next refresh instead of vanishing, and releases the previous
            # push's return as a side effect
            self._last_push_ref = self._controller.record_handle_metrics.remote(
                self._app, self._deployment, self._handle_id, demand
            )
        except Exception:
            pass

    # -- bookkeeping --

    def _on_done(self, replica_id, ref):
        with self._lock:
            if self._inflight_refs.pop(id(ref), None) is not None and replica_id in self._inflight:
                self._inflight[replica_id] = max(0, self._inflight[replica_id] - 1)
                self._lock.notify_all()
        self._push_metrics()

    def _waitable_refs(self):
        with self._lock:
            return [ref for ref, _rid, waitable in self._inflight_refs.values() if waitable]

    def _reap(self):
        """Settle finished in-flight refs without fetching their values
        (streaming entries settle through their generator's consumer)."""
        with self._lock:
            pending = [(k, ref, rid) for k, (ref, rid, waitable) in self._inflight_refs.items() if waitable]
        if not pending:
            return
        refs = [ref for _, ref, _ in pending]
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0, fetch_local=False)
        ready_ids = {id(r) for r in ready}
        with self._lock:
            for key, ref, rid in pending:
                if id(ref) in ready_ids and key in self._inflight_refs:
                    del self._inflight_refs[key]
                    if rid in self._inflight:
                        self._inflight[rid] = max(0, self._inflight[rid] - 1)
            if ready_ids:
                self._lock.notify_all()

    # -- the router --

    def _pick_replica(self, model_id: str | None = None):
        """Two random choices, take the lower local in-flight count; None
        if every replica is at max_ongoing_requests. Multiplexed requests
        stick to the replica that last served their model (its LRU cache
        already holds the model) whenever it has capacity."""
        candidates = [(rid, actor) for rid, actor in self._replicas if self._inflight.get(rid, 0) < self._max_ongoing]
        if not candidates:
            return None
        if model_id:
            sticky = self._model_affinity.get(model_id)
            for rid, actor in candidates:
                if rid == sticky:
                    return (rid, actor)
        if len(candidates) <= 2:
            picks = candidates
        else:
            picks = random.sample(candidates, 2)
        return min(picks, key=lambda c: self._inflight.get(c[0], 0))

    def submit(self, method_name: str, args: tuple, kwargs: dict, timeout_s: float | None = 60.0, stream: bool = False, multiplexed_model_id: str | None = None):
        """Non-streaming: ASYNC — enqueue and return an unbound
        DeploymentResponse immediately (a handle never blocks the
        caller; queue depth drives the autoscaler). Streaming keeps the
        synchronous admission path (a generator needs its ref up front)."""
        if stream:
            rid, actor = self._admit(multiplexed_model_id, time.time() + timeout_s if timeout_s else None, timeout_s)
            return self._dispatch_stream(rid, actor, method_name, args, kwargs, multiplexed_model_id)
        resp = DeploymentResponse(self)
        deadline = time.time() + timeout_s if timeout_s else None
        with self._lock:
            self._pending_q.append((resp, method_name, args, kwargs, multiplexed_model_id, deadline, timeout_s))
            self._queued += 1
            self._ensure_dispatcher()
            self._lock.notify_all()
        self._push_metrics()
        return resp

    def _ensure_dispatcher(self):
        t = self._dispatcher
        if t is None or not t.is_alive():
            self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True, name="rt-serve-dispatch")
            self._dispatcher.start()

    def _dispatch_loop(self):
        while True:
            with self._lock:
                if not self._pending_q:
                    # linger briefly for the next burst, then retire
                    self._lock.wait(timeout=5.0)
                    if not self._pending_q:
                        self._dispatcher = None
                        return
                item = self._pending_q.popleft()
            resp, method_name, args, kwargs, model_id, deadline, timeout_s = item
            if resp._cancelled:
                with self._lock:
                    self._queued -= 1
                resp._fail(ray_tpu_torch.exceptions.RayTpuError("request cancelled before dispatch"))
                continue
            try:
                rid, actor = self._admit(model_id, deadline, timeout_s)
            except BaseException as e:  # noqa: BLE001
                with self._lock:
                    self._queued -= 1
                resp._fail(e)
                continue
            with self._lock:
                self._queued -= 1
            try:
                ref = actor.handle_request.remote(method_name, args, kwargs, model_id)
            except Exception as e:
                with self._lock:
                    if rid in self._inflight:
                        self._inflight[rid] = max(0, self._inflight[rid] - 1)
                resp._fail(e)
                continue
            with self._lock:
                self._inflight_refs[id(ref)] = (ref, rid, True)
            resp._bind(rid, ref)
            if resp._cancelled:
                resp.cancel()  # raced: propagate to the dispatched task
            self._push_metrics()

    def _admit(self, multiplexed_model_id, deadline, timeout_s):
        """Blocking admission: wait for a replica with a free slot and
        claim it. Runs on the dispatcher thread for async requests."""
        self._refresh(force=not self._replicas)
        while True:
            with self._lock:
                pick = self._pick_replica(multiplexed_model_id) if self._replicas else None
                if pick is not None:
                    rid, actor = pick
                    self._inflight[rid] = self._inflight.get(rid, 0) + 1
                    break
            # At capacity: settle any finished requests, re-sync the
            # replica set, then BLOCK on our in-flight completions
            # (the object store's waiter condition wakes us the moment
            # one finishes — no fixed-interval polling). With nothing
            # of ours in flight the replicas are saturated by other
            # handles: sleep one refresh beat for topology/metrics.
            self._reap()
            self._refresh(force=True)
            with self._lock:
                if self._pick_replica() is not None:
                    continue
            refs = self._waitable_refs()
            remaining = None if deadline is None else max(0.0, deadline - time.time())
            if refs:
                wait_t = _REFRESH_INTERVAL_S if remaining is None else min(remaining, _REFRESH_INTERVAL_S)
                ray_tpu_torch.wait(refs, num_returns=1, timeout=wait_t, fetch_local=False)
                self._reap()
            else:
                time.sleep(0.02 if remaining is None else min(remaining, 0.02))
            if deadline and time.time() > deadline:
                # GetTimeoutError (a TimeoutError subclass): admission
                # timeouts now flow through result(), whose callers (e.g.
                # the proxy's 504 path) catch GetTimeoutError
                raise ray_tpu_torch.exceptions.GetTimeoutError(
                    f"no replica of {self._app}/{self._deployment} accepted the request within {timeout_s}s"
                )
        if multiplexed_model_id:
            with self._lock:
                self._model_affinity[multiplexed_model_id] = rid
                self._model_affinity.move_to_end(multiplexed_model_id)
                while len(self._model_affinity) > 1024:
                    self._model_affinity.popitem(last=False)
        self._push_metrics()
        return rid, actor

    def _dispatch_stream(self, rid, actor, method_name, args, kwargs, multiplexed_model_id):
        try:
            ref = actor.handle_request_streaming.options(num_returns="streaming").remote(method_name, args, kwargs, multiplexed_model_id)
        except Exception:
            with self._lock:
                if rid in self._inflight:
                    self._inflight[rid] = max(0, self._inflight[rid] - 1)
            raise
        with self._lock:
            self._inflight_refs[id(ref)] = (ref, rid, False)
        return DeploymentResponseGenerator(self, rid, ref)


class DeploymentHandle:
    """User-facing handle; `.remote()` routes one request.

    h = serve.get_app_handle("app")
    ref = h.remote(x) / h.method.remote(x); ref.result()
    """

    def __init__(self, controller, app_name: str, deployment: str, method_name: str = "__call__", stream: bool = False, multiplexed_model_id: str | None = None):
        self._controller = controller
        self._app = app_name
        self._deployment = deployment
        self._method = method_name
        self._stream = stream
        self._model_id = multiplexed_model_id
        self._router = _Router(controller, app_name, deployment)

    def options(self, method_name: str | None = None, stream: bool | None = None, multiplexed_model_id: str | None = None):
        """`stream=True` makes `.remote()` return a
        DeploymentResponseGenerator; `multiplexed_model_id` tags the
        request for a @serve.multiplexed deployment and keeps it sticky
        to the replica holding that model."""
        h = DeploymentHandle(
            self._controller,
            self._app,
            self._deployment,
            method_name or self._method,
            stream=self._stream if stream is None else stream,
            multiplexed_model_id=self._model_id if multiplexed_model_id is None else multiplexed_model_id,
        )
        h._router = self._router  # share the router: one in-flight view
        return h

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodProxy(self, name)

    def remote(self, *args, **kwargs):
        return self._router.submit(self._method, args, kwargs, stream=self._stream, multiplexed_model_id=self._model_id)


class _MethodProxy:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._router.submit(
            self._method, args, kwargs, stream=self._handle._stream, multiplexed_model_id=self._handle._model_id
        )
