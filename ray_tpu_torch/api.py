"""The public API (port of ray_tpu/api.py): ``init``/``shutdown``,
``@remote`` functions and actors, ``put``/``get``/``wait``/``cancel``,
named actors, ``kill`` and the cluster's resources.

``init`` starts a head runtime (``core/runtime.py``) with the host's
cards as its ``"GPU"`` resource: ``num_gpus`` (or ``num_tpus``, ray_tpu's
name) overrides the count, ``RT_NUM_GPUS`` too. ``init(address="auto" |
"host:port")`` attaches this process to a running head as a driver
(``core/driver_client.py``), and so does a plain ``init()`` where
``RT_HEAD_ADDRESS`` is set (a submitted job's entrypoint) unless sizing
arguments ask for a runtime of its own; ``address`` with sizing
arguments is refused.

A remote function or actor class travels to its worker by reference
(module and qualified name, ``core/serialization.py::code_ref``): it must
be defined at the top level of an importable module or of the driver's
script; ``.remote()`` raises TypeError for a lambda, a closure or a
function of a file-less ``__main__``.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import pickle
import threading

from ray_tpu_torch.core import context
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.core.payloads import encode_value
from ray_tpu_torch.core.serialization import Serialized, code_ref
from ray_tpu_torch.core.task_spec import ArgSpec

_init_lock = threading.Lock()


# ----------------------------------------------------------------------
# init / shutdown
# ----------------------------------------------------------------------
def init(
    address: str | None = None,
    *,
    num_cpus: int | None = None,
    num_gpus: int | None = None,
    num_tpus: int | None = None,
    resources: dict | None = None,
    local_mode: bool = False,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    labels: dict | None = None,
    log_to_driver: bool = True,
    _system_config: dict | None = None,
    **kwargs,
):
    import os as _os

    from ray_tpu_torch.core.runtime import Runtime

    with _init_lock:
        if context.is_initialized():
            if ignore_reinit_error:
                return context.get_client()
            raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True to allow")
        wants_own_runtime = (local_mode or num_cpus is not None or num_gpus is not None or num_tpus is not None
                             or resources)
        if address is not None and wants_own_runtime:
            # an attached driver can neither size nor localize the cluster
            raise ValueError("init(address=...) attaches to an existing cluster; num_cpus/num_gpus/num_tpus/"
                             "resources/local_mode cannot apply there")
        if address is None and not wants_own_runtime:
            # a job's entrypoint joins the running cluster; explicit sizing wins
            address = _os.environ.get("RT_HEAD_ADDRESS") or None
        if address is not None:
            from ray_tpu_torch.core.driver_client import connect_driver

            client = connect_driver(address)
            if namespace != "default":
                client.namespace = namespace
            context.set_client(client)
            return client
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        cards = num_gpus if num_gpus is not None else num_tpus
        if cards is not None:
            res["GPU"] = float(cards)
        system_config = dict(_system_config or {})
        if not log_to_driver:
            system_config.setdefault("log_to_driver", False)
        rt = Runtime(
            resources=res or None,
            local_mode=local_mode,
            namespace=namespace,
            system_config=system_config,
            labels=labels,
        )
        context.set_client(rt)
        return rt


def timeline(filename: str | None = None) -> list[dict]:
    """The head's task events as Chrome-trace "X" events, one per
    RUNNING -> terminal span (``util/timeline.py``); written to
    ``filename`` when given."""
    from ray_tpu_torch.util.timeline import timeline as _timeline

    return _timeline(filename)


def shutdown():
    client = context.maybe_client()
    if client is not None:
        # a head writes the usage report (a no-op unless
        # RT_USAGE_STATS_ENABLED=1); an attached driver's sparse view must
        # not overwrite the head's report in the same session directory
        if not getattr(client, "is_driver_attach", False):
            from ray_tpu_torch.util import usage

            try:
                usage.write_usage_stats(client)
            except OSError:
                pass  # an unwritable session directory must not keep the runtime up
        client.shutdown()
    context.set_client(None)


def is_initialized() -> bool:
    return context.is_initialized()


def _auto_init():
    if not context.is_initialized():
        init()
    return context.get_client()


# ----------------------------------------------------------------------
# object API
# ----------------------------------------------------------------------
def put(value) -> ObjectRef:
    client = _auto_init()
    if isinstance(value, ObjectRef):
        raise TypeError("put() does not accept ObjectRefs")
    return client.put_object(value)


def get(refs, *, timeout: float | None = None):
    import time as _time

    client = _auto_init()
    if isinstance(refs, ObjectRef):
        return client.get_object(refs.id, timeout=timeout)
    if isinstance(refs, (list, tuple)):
        # timeout is an overall deadline across the whole batch
        deadline = None if timeout is None else _time.monotonic() + timeout
        out = []
        for r in refs:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRefs, got {type(r)}")
            remaining = None if deadline is None else max(0.0, deadline - _time.monotonic())
            out.append(client.get_object(r.id, timeout=remaining))
        return out
    raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")


def wait(refs, *, num_returns: int = 1, timeout: float | None = None, fetch_local: bool = True):
    client = _auto_init()
    refs = list(refs)
    by_id = {r.id: r for r in refs}
    ready_ids, rest_ids = client.wait_ready([r.id for r in refs], num_returns=num_returns, timeout=timeout)
    return [by_id[i] for i in ready_ids], [by_id[i] for i in rest_ids]


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    from ray_tpu_torch.core import direct as _direct

    client = _auto_init()
    if _direct.cancel_owned(client, ref.id, force=force):
        return  # direct-plane call: cancel delivered to its worker
    client.cancel_task(ref.id, force=force)


def internal_free(refs):
    _auto_init().free_objects([r.id for r in refs])


# ----------------------------------------------------------------------
# task/actor options
# ----------------------------------------------------------------------
_VALID_OPTIONS = {
    "num_cpus",
    "num_gpus",
    "num_tpus",
    "resources",
    "memory",
    "num_returns",
    "max_retries",
    "retry_exceptions",
    "max_restarts",
    "max_task_retries",
    "max_concurrency",
    "max_pending_calls",
    "name",
    "namespace",
    "lifetime",
    "scheduling_strategy",
    "placement_group",
    "placement_group_bundle_index",
    "placement_group_capture_child_tasks",
    "runtime_env",
    "label_selector",
    "concurrency_groups",
    "accelerator_type",
}


def _with_trace(options: dict, name: str) -> dict:
    """Attach the caller's trace context to an outgoing submission and
    record the client-side span; one flag check when tracing is off."""
    from ray_tpu_torch.util import tracing

    if not tracing.enabled():
        return options
    import time as _time
    import uuid as _uuid

    ctx = tracing.child_context()
    span_id = _uuid.uuid4().hex[:16]
    now = _time.time_ns()
    tracing.record_span(f"submit::{name}", "client", ctx[0], span_id, ctx[1], now, now, {})
    return {**(options or {}), "_trace_ctx": (ctx[0], span_id)}


def _check_options(opts: dict):
    unknown = set(opts) - _VALID_OPTIONS
    if unknown:
        raise ValueError(f"unknown option(s): {sorted(unknown)}")


def _encode_args(args, kwargs):
    """Encode call arguments into ArgSpecs. Owned refs (direct call plane)
    are tagged with their owner address so the executing worker pulls them
    straight from the owner; `pins` are live ObjectRefs held until the call
    completes (the caller-side analogue of the head's pin_spec_args)."""
    from ray_tpu_torch.core import direct as _direct

    pins = []

    def one(a):
        if isinstance(a, ObjectRef):
            pins.append(a)
            k = a.id.binary()
            st = _direct.state()
            if st is not None and st.owned.owns(k):
                owner = st.self_owner
            else:
                owner = _direct.get_hint(k)
            return ArgSpec(ref=a.id, owner=owner)
        payload = encode_value(a)
        for c in payload.contained or []:
            pins.append(ObjectRef(c))
        return ArgSpec(payload=payload)

    arg_specs = [one(a) for a in args]
    kw_specs = {k: one(v) for k, v in (kwargs or {}).items()}
    return arg_specs, kw_specs, pins


def _num_returns(opts, default=1):
    nr = opts.get("num_returns", default)
    if nr in ("streaming", "dynamic"):
        return 1, True
    return int(nr), False


# ----------------------------------------------------------------------
# remote functions
# ----------------------------------------------------------------------
def _code_blob(target) -> tuple[str, Serialized]:
    """(id, blob) of a function or class sent by reference; TypeError when
    a worker could not import it."""
    ref = code_ref(target)
    header = pickle.dumps(ref, protocol=5)
    return hashlib.sha1(header).hexdigest(), Serialized(header=header)


def _remote_function_of(module: str, qualname: str, options: dict):
    from ray_tpu_torch.core.serialization import resolve_code

    return RemoteFunction(resolve_code(module, qualname), options)


def _actor_class_of(module: str, qualname: str, options: dict):
    from ray_tpu_torch.core.serialization import resolve_code

    return ActorClass(resolve_code(module, qualname), options)


class RemoteFunction:
    def __init__(self, fn, options: dict | None = None):
        if inspect.iscoroutinefunction(fn):
            raise TypeError("async functions can only be actor methods")
        self._fn = fn
        self._options = dict(options or {})
        self._blob = None
        self._func_id = None
        functools.update_wrapper(self, fn)

    @property
    def _rt_target(self):
        return self._fn

    def __reduce__(self):
        return (_remote_function_of, (*code_ref(self._fn), self._options))

    def _ensure_registered(self, client):
        if self._func_id is None:
            self._func_id, self._blob = _code_blob(self._fn)
        if not client.has_function(self._func_id):
            return self._blob
        return None

    def options(self, **opts) -> "RemoteFunction":
        _check_options(opts)
        merged = {**self._options, **opts}
        rf = RemoteFunction(self._fn, merged)
        rf._blob = self._blob
        rf._func_id = self._func_id
        return rf

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core import direct as _direct

        client = _auto_init()
        blob = self._ensure_registered(client)
        name = getattr(self._fn, "__name__", "task")
        num_returns, streaming = _num_returns(self._options)
        opts = _with_trace(self._options, name)
        if not streaming and _direct.state() is not None and _direct.raw_eligible(args, kwargs):
            # direct plane fast path: args ride the call frame as plain
            # values — ONE pickle for the whole submission (core/direct.py)
            refs = _direct.try_task_call(client, name, self._func_id, self._blob, None, None, opts, raw=(args, kwargs))
            if refs is not None:
                return refs[0] if num_returns == 1 else refs
        arg_specs, kw_specs, pins = _encode_args(args, kwargs)
        if not streaming:
            # direct plane: stream the task onto a leased worker, head out
            # of the loop (returns None -> head path)
            refs = _direct.try_task_call(client, name, self._func_id, self._blob, arg_specs, kw_specs, opts, pins=pins)
            if refs is not None:
                return refs[0] if num_returns == 1 else refs
        _direct.promote_argspecs(client, arg_specs, kw_specs)
        ids = client.submit_task(
            name=name,
            func_id=self._func_id,
            args=arg_specs,
            kwargs=kw_specs,
            num_returns=num_returns,
            streaming=streaming,
            func_blob=blob,
            options=opts,
        )
        if hasattr(client, "mark_function_sent"):
            client.mark_function_sent(self._func_id)
        if streaming:
            return ObjectRefGenerator(ids[0])
        refs = [ObjectRef(i) for i in ids]
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"remote function {self.__name__}() cannot be called directly; use .remote()")


# ----------------------------------------------------------------------
# actors
# ----------------------------------------------------------------------
class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, options: dict | None = None):
        self._handle = handle
        self._name = name
        self._options = dict(options or {})

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(self._handle, self._name, {**self._options, **opts})

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core import direct as _direct

        client = _auto_init()
        num_returns, streaming = _num_returns(self._options)
        opts = _with_trace(self._options, self._name)
        if not streaming and _direct.state() is not None and _direct.raw_eligible(args, kwargs):
            # direct plane fast path: args ride the call frame directly
            refs = _direct.try_actor_call(client, self._handle._actor_id, self._name, None, None, opts, raw=(args, kwargs))
            if refs is not None:
                return refs[0] if num_returns == 1 else refs
        arg_specs, kw_specs, pins = _encode_args(args, kwargs)
        if not streaming:
            # direct plane: straight to the actor's worker (core/direct.py)
            refs = _direct.try_actor_call(client, self._handle._actor_id, self._name, arg_specs, kw_specs, opts, pins=pins)
            if refs is not None:
                return refs[0] if num_returns == 1 else refs
        # head path: owned args move to the head store first, and the
        # direct lane drains so per-caller ordering holds across lanes
        _direct.promote_argspecs(client, arg_specs, kw_specs)
        _direct.head_lane_submit(self._handle._actor_id)
        ids = client.submit_actor_task(
            actor_id=self._handle._actor_id,
            method_name=self._name,
            args=arg_specs,
            kwargs=kw_specs,
            num_returns=num_returns,
            streaming=streaming,
            options=opts,
        )
        if streaming:
            return ObjectRefGenerator(ids[0])
        refs = [ObjectRef(i) for i in ids]
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ActorMethodNode

        return ActorMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_options: dict | None = None):
        self._actor_id = actor_id
        self._method_options = method_options or {}

    def __getattr__(self, name):
        # __rt_*__ names are runtime-builtin actor methods served by worker_main
        if name.startswith("_") and not (name.startswith("__rt_") and name.endswith("__")):
            raise AttributeError(name)
        return ActorMethod(self, name, self._method_options.get(name))

    def __ray_ready__(self):
        client = _auto_init()
        if hasattr(client, "actor_ready_ref"):
            return client.actor_ready_ref(self._actor_id)
        from ray_tpu_torch.core.runtime import _actor_ready_oid

        return ObjectRef(_actor_ready_oid(self._actor_id))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:16]})"

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and self._actor_id == other._actor_id

    def __hash__(self):
        return hash(self._actor_id)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_options))


class ActorClass:
    def __init__(self, cls, options: dict | None = None):
        self._cls = cls
        self._options = dict(options or {})
        self._blob = None
        self._class_id = None
        self.__name__ = cls.__name__

    @property
    def _rt_target(self):
        return self._cls

    def __reduce__(self):
        return (_actor_class_of, (*code_ref(self._cls), self._options))

    def options(self, **opts) -> "ActorClass":
        _check_options(opts)
        ac = ActorClass(self._cls, {**self._options, **opts})
        ac._blob = self._blob
        ac._class_id = self._class_id
        return ac

    def _ensure_registered(self, client):
        if self._class_id is None:
            self._class_id, self._blob = _code_blob(self._cls)
        if not client.has_function(self._class_id):
            return self._blob
        return None

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.core import direct as _direct

        client = _auto_init()
        blob = self._ensure_registered(client)
        arg_specs, kw_specs, _pins = _encode_args(args, kwargs)
        _direct.promote_argspecs(client, arg_specs, kw_specs)  # creation is head-path
        opts = dict(self._options)
        if any(inspect.iscoroutinefunction(m) for _, m in inspect.getmembers(self._cls, inspect.isfunction)):
            opts.setdefault("max_concurrency", 8)
        method_options = {}
        for name, m in inspect.getmembers(self._cls, inspect.isfunction):
            mo = getattr(m, "__ray_tpu_method_options__", None)
            if mo:
                method_options[name] = mo
        info = client.create_actor(
            name_desc=self._cls.__name__,
            func_id=self._class_id,
            args=arg_specs,
            kwargs=kw_specs,
            func_blob=blob,
            options=opts,
        )
        if hasattr(client, "mark_function_sent"):
            client.mark_function_sent(self._class_id)
        return ActorHandle(info["actor_id"], method_options)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"actor class {self.__name__} cannot be instantiated directly; use .remote()")


def method(**opts):
    """Per-method options decorator (ray_tpu's method)."""

    def deco(fn):
        fn.__ray_tpu_method_options__ = opts
        return fn

    return deco


# ----------------------------------------------------------------------
# the @remote decorator
# ----------------------------------------------------------------------
def remote(*args, **kwargs):
    if len(args) == 1 and not kwargs and (inspect.isfunction(args[0]) or inspect.isclass(args[0])):
        target = args[0]
        if inspect.isclass(target):
            return ActorClass(target)
        return RemoteFunction(target)
    _check_options(kwargs)
    opts = kwargs

    def deco(target):
        if inspect.isclass(target):
            return ActorClass(target, opts)
        return RemoteFunction(target, opts)

    return deco


# ----------------------------------------------------------------------
# actor management
# ----------------------------------------------------------------------
def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    client = _auto_init()
    info = client.get_actor_handle_info(name, namespace)
    if info is None:
        raise ValueError(f"actor {name!r} not found in namespace {namespace!r}")
    return ActorHandle(info["actor_id"])


def kill(handle: ActorHandle, *, no_restart: bool = True):
    _auto_init().kill_actor(handle._actor_id, no_restart=no_restart)


# ----------------------------------------------------------------------
# cluster info
# ----------------------------------------------------------------------
def nodes() -> list[dict]:
    return _auto_init().cluster_info("nodes")


def cluster_resources() -> dict:
    return _auto_init().cluster_info("cluster_resources")


def available_resources() -> dict:
    return _auto_init().cluster_info("available_resources")


def get_runtime_context():
    from ray_tpu_torch.core.context import get_runtime_context as _grc

    _auto_init()
    return _grc()
