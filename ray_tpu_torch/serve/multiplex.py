"""Model multiplexing: many models share a replica pool (port of
ray_tpu/serve/multiplex.py): ``@serve.multiplexed``, an LRU model cache
per replica, ``get_multiplexed_model_id()`` and the router's model-aware
replica choice. A replica lazily loads models through the decorated
loader, keeps at most ``max_num_models_per_replica`` alive (LRU eviction
calls the evicted model's ``__del__``/``close`` if present), and requests
carry their model id via ``handle.options(multiplexed_model_id=...)`` —
the router keeps the id sticky to the replica that last served it, so a
hot model stays loaded on one replica instead of thrashing every cache.

    @serve.deployment
    class ModelServer:
        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id: str):
            return load_model(model_id)

        async def __call__(self, request):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model(request)
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import threading
from collections import OrderedDict

_current_model_id: contextvars.ContextVar = contextvars.ContextVar("rt_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled."""
    return _current_model_id.get()


def _set_multiplexed_model_id(model_id: str):
    _current_model_id.set(model_id or "")


class _ModelCache:
    """Per-instance LRU of loaded models.

    Loads are SINGLE-FLIGHT per model id (concurrent first requests wait
    for one loader instead of double-loading and orphaning an instance).
    Eviction runs the victim's cleanup hook after a grace period: an
    in-flight request that fetched the model just before eviction keeps a
    live reference, and the delay lets it finish before cleanup frees
    backing resources (a full in-use refcount would need scoped usage
    that this API does not give callers)."""

    def __init__(self, loader, max_models: int, evict_grace_s: float = 30.0):
        self._loader = loader
        self._max = max(1, int(max_models))
        self._grace = float(evict_grace_s)
        self._models: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._loading: dict[str, threading.Event] = {}

    @staticmethod
    def _run_hook(victim):
        for name in ("shutdown", "close", "__del__"):
            hook = getattr(victim, name, None)
            if callable(hook):
                try:
                    res = hook()
                    if inspect.iscoroutine(res):
                        # async cleanup gets its own loop (we may be on a
                        # pool thread with none running)
                        threading.Thread(target=asyncio.run, args=(res,), daemon=True).start()
                except Exception:
                    pass
                return

    def _evict_lru(self) -> list:
        """Pop LRU victims; caller runs _dispose(victims) OUTSIDE the
        lock (a slow user cleanup hook must not stall unrelated hits)."""
        victims = []
        while len(self._models) > self._max:
            _, victim = self._models.popitem(last=False)
            victims.append(victim)
        return victims

    def _dispose(self, victims: list):
        for victim in victims:
            if self._grace <= 0:
                self._run_hook(victim)
            else:
                t = threading.Timer(self._grace, self._run_hook, args=(victim,))
                t.daemon = True
                t.start()

    def loaded_ids(self) -> list:
        with self._lock:
            return list(self._models)

    def _begin(self, model_id: str):
        """-> ("hit", model) | ("load", event) | ("wait", event)."""
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return ("hit", self._models[model_id])
            ev = self._loading.get(model_id)
            if ev is not None:
                return ("wait", ev)
            ev = self._loading[model_id] = threading.Event()
            return ("load", ev)

    def _commit(self, model_id: str, model, ev: threading.Event):
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            victims = self._evict_lru()
            self._loading.pop(model_id, None)
        ev.set()
        self._dispose(victims)

    def _abort(self, model_id: str, ev: threading.Event):
        with self._lock:
            self._loading.pop(model_id, None)
        ev.set()

    def get_sync(self, obj, model_id: str):
        while True:
            state, x = self._begin(model_id)
            if state == "hit":
                return x
            if state == "wait":
                x.wait(timeout=300.0)
                continue  # loader finished (or failed): re-check
            try:
                model = self._loader(obj, model_id)
                if inspect.iscoroutine(model):
                    raise TypeError("async loader called from sync context; declare the caller async and await it")
            except BaseException:
                self._abort(model_id, x)
                raise
            self._commit(model_id, model, x)
            return model

    async def get_async(self, obj, model_id: str):
        while True:
            state, x = self._begin(model_id)
            if state == "hit":
                return x
            if state == "wait":
                await asyncio.get_running_loop().run_in_executor(None, x.wait, 300.0)
                continue
            try:
                if inspect.iscoroutinefunction(self._loader):
                    model = await self._loader(obj, model_id)
                else:
                    # a sync loader (multi-second weight load) must not
                    # block every concurrent request on the replica's
                    # event loop; the singleflight event already
                    # serializes duplicate loads
                    model = await asyncio.get_running_loop().run_in_executor(
                        None, self._loader, obj, model_id
                    )
                    if inspect.iscoroutine(model):
                        model = await model
            except BaseException:
                self._abort(model_id, x)
                raise
            self._commit(model_id, model, x)
            return model


class _MultiplexWrapper:
    """Descriptor form of @serve.multiplexed (method decoration)."""

    def __init__(self, loader, max_models: int, evict_grace_s: float = 30.0):
        self._loader = loader
        self._max = max_models
        self._grace = evict_grace_s
        self.__name__ = getattr(loader, "__name__", "get_model")
        self._is_async = inspect.iscoroutinefunction(loader)

    def __reduce__(self):
        # per-process cache state never travels; rebuild on the replica
        return (_MultiplexWrapper, (self._loader, self._max, self._grace))

    _cache_create_lock = threading.Lock()

    def _cache(self, obj) -> _ModelCache:
        key = f"__serve_mux_{self.__name__}"
        c = obj.__dict__.get(key)
        if c is None:
            with _MultiplexWrapper._cache_create_lock:
                c = obj.__dict__.setdefault(key, _ModelCache(self._loader, self._max, self._grace))
        return c

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        cache = self._cache(obj)
        if self._is_async:

            async def bound(model_id: str | None = None):
                return await cache.get_async(obj, model_id if model_id is not None else get_multiplexed_model_id())

        else:

            def bound(model_id: str | None = None):
                return cache.get_sync(obj, model_id if model_id is not None else get_multiplexed_model_id())

        bound.loaded_ids = cache.loaded_ids
        bound.__name__ = self.__name__
        return bound


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3, evict_grace_s: float = 30.0):
    """Decorator: see module docstring.
    ``evict_grace_s`` delays the evicted model's cleanup hook so requests
    that fetched it just before eviction can finish (0 = immediate)."""

    def wrap(fn):
        return _MultiplexWrapper(fn, max_num_models_per_replica, evict_grace_s)

    if _fn is not None:
        return wrap(_fn)
    return wrap
