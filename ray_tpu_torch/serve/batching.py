"""Request batching: fuse concurrent single-item calls into one batch call
(port of ray_tpu/serve/batching.py).

``@serve.batch``: a decorated
method takes a LIST of requests and returns a list of results of the same
length; callers pass single items and get single results. Concurrent
callers (replica thread pool or coroutines) are fused: the batcher waits
up to ``batch_wait_timeout_s`` for up to ``max_batch_size`` items, then
invokes the wrapped function once.

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.01)
    def score(self, inputs: list) -> list: ...

    def __call__(self, req):        # N concurrent callers -> 1 score() call
        return self.score(req)

Sync callers block on their item's future; async callers (coroutine
context) can ``await wrapper.remote_async(item)``. Async wrapped functions
run on the batcher's private event loop.
"""

from __future__ import annotations

import asyncio
import inspect
import queue
import threading


class _Batcher:
    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max(1, int(max_batch_size))
        self._wait_s = float(batch_wait_timeout_s)
        self._q: queue.Queue = queue.Queue()
        self._started = threading.Lock()
        self._thread = None
        self._loop = None  # lazily created for async wrapped fns

    def submit(self, bound_args: tuple):
        import concurrent.futures

        fut = concurrent.futures.Future()
        # enqueue BEFORE ensuring the thread: the idle-exit path re-checks
        # queue emptiness under the same lock, so the item can't strand
        self._q.put((bound_args, fut))
        self._ensure_thread()
        return fut

    def _ensure_thread(self):
        with self._started:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="serve-batcher", daemon=True)
                self._thread.start()

    def _call_fn(self, self_obj, items: list):
        args = (self_obj, items) if self_obj is not _NO_SELF else (items,)
        result = self._fn(*args)
        if inspect.iscoroutine(result):
            if self._loop is None:
                self._loop = asyncio.new_event_loop()
                threading.Thread(target=self._loop.run_forever, name="serve-batcher-loop", daemon=True).start()
            result = asyncio.run_coroutine_threadsafe(result, self._loop).result()
        return result

    def _run(self):
        import time

        while True:
            try:
                bound_args, fut = self._q.get(timeout=30.0)
            except queue.Empty:
                # idle exit so short-lived instances don't each pin a
                # thread forever; submit() restarts on demand
                with self._started:
                    if self._q.empty():
                        self._thread = None
                        if self._loop is not None:
                            try:
                                self._loop.call_soon_threadsafe(self._loop.stop)
                            except Exception:
                                pass
                            self._loop = None
                        return
                continue
            batch = [(bound_args, fut)]
            deadline = time.monotonic() + self._wait_s
            while len(batch) < self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            self_obj = batch[0][0][0]
            items = [a[1] for a, _ in batch]
            try:
                results = self._call_fn(self_obj, items)
                if not isinstance(results, list) or len(results) != len(items):
                    raise TypeError(
                        f"@serve.batch function must return a list of length {len(items)}, got {type(results).__name__}"
                    )
            except BaseException as e:  # noqa: BLE001
                for _, f in batch:
                    if not f.done():
                        f.set_exception(e)
                continue
            for (_, f), r in zip(batch, results):
                if not f.done():
                    f.set_result(r)


_NO_SELF = object()


class _BatchWrapper:
    """Descriptor so the decorator works on both methods and functions."""

    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self._fn = fn
        self._max_batch_size = max_batch_size
        self._batch_wait_timeout_s = batch_wait_timeout_s
        self._batcher = _Batcher(fn, max_batch_size, batch_wait_timeout_s)
        self.__name__ = getattr(fn, "__name__", "batched")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __reduce__(self):
        # the batcher (locks, queue, thread) is per-process state: ship
        # only the wrapped fn + knobs, rebuild on the replica
        return (_BatchWrapper, (self._fn, self._max_batch_size, self._batch_wait_timeout_s))

    def _instance_batcher(self, obj) -> _Batcher:
        """One batcher per INSTANCE: items from different instances must
        never fuse (they would all run against batch[0]'s self)."""
        key = f"__serve_batcher_{self.__name__}"
        b = obj.__dict__.get(key)
        if b is None:
            b = obj.__dict__[key] = _Batcher(self._fn, self._max_batch_size, self._batch_wait_timeout_s)
        return b

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        batcher = self._instance_batcher(obj)

        def bound(item):
            return batcher.submit((obj, item)).result()

        async def bound_async(item):
            return await asyncio.wrap_future(batcher.submit((obj, item)))

        bound.remote_async = bound_async
        bound.__name__ = self.__name__
        return bound

    def __call__(self, item):
        return self._batcher.submit((_NO_SELF, item)).result()

    async def remote_async(self, item):
        return await asyncio.wrap_future(self._batcher.submit((_NO_SELF, item)))


def batch(_fn=None, *, max_batch_size: int = 10, batch_wait_timeout_s: float = 0.01):
    """Decorator: see module docstring. Usable bare (@serve.batch) or with
    arguments (@serve.batch(max_batch_size=...))."""

    def wrap(fn):
        return _BatchWrapper(fn, max_batch_size, batch_wait_timeout_s)

    if _fn is not None:
        return wrap(_fn)
    return wrap
