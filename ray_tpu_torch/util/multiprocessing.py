"""multiprocessing.Pool drop-in over ray_tpu_torch tasks (port of
ray_tpu/util/multiprocessing.py; reference:
python/ray/util/multiprocessing/pool.py) — Pool with
apply/apply_async/map/map_async/starmap/imap/imap_unordered over cluster
tasks instead of local processes.

The function travels by reference, as every task's code does on the port
(``core/serialization.py``): a module-level function, a
``functools.partial`` of one, or a picklable instance. A lambda or a
closure raises TypeError at the call, naming the difference. ray_tpu's
remote functions ``_run_chunk`` and ``_apply``, defined inside its
methods, are module-level here.
"""

from __future__ import annotations

import itertools

import ray_tpu_torch


class AsyncResult:
    def __init__(self, refs, single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: float | None = None):
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: float | None = None):
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")  # multiprocessing contract
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


@ray_tpu_torch.remote
def _run_chunk(fn, chunk, star, init, initargs, pool_key):
    if init is not None:
        # once-per-worker-process semantics (stdlib runs the
        # initializer in each worker's startup, not per task)
        import builtins

        done = getattr(builtins, "_rt_pool_inits", None)
        if done is None:
            done = builtins._rt_pool_inits = set()
        if pool_key not in done:
            done.add(pool_key)
            init(*initargs)
    return [fn(*args) if star else fn(args) for args in chunk]


@ray_tpu_torch.remote
def _apply(f, a, kw):
    return f(*a, **kw)


def _check_fn(fn, what: str = "function"):
    """TypeError at the call when a worker could not receive ``fn``."""
    from ray_tpu_torch.data.dataset import check_udf

    if fn is not None:
        check_udf(fn, f"Pool {what}")


class Pool:
    """Tasks are dispatched through one shared remote function; chunking
    matches multiprocessing semantics (chunksize items per task)."""

    def __init__(self, processes: int | None = None, initializer=None, initargs=()):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._processes = processes or int(ray_tpu_torch.cluster_resources().get("CPU", 4))
        _check_fn(initializer, "initializer")
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False
        self._run_chunk = _run_chunk
        import uuid

        self._pool_key = uuid.uuid4().hex

    # -- helpers --
    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable, chunksize):
        it = iter(iterable)
        while True:
            chunk = list(itertools.islice(it, chunksize))
            if not chunk:
                return
            yield chunk

    def _submit(self, fn, iterable, chunksize, star):
        _check_fn(fn)
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [
            self._run_chunk.remote(fn, chunk, star, self._initializer, self._initargs, self._pool_key)
            for chunk in self._chunks(items, chunksize)
        ], chunksize

    def _submit_lazy(self, fn, iterable, chunksize, star, max_inflight):
        """Generator of completed chunk refs with bounded in-flight chunks
        (keeps imap truly lazy over unbounded iterables)."""
        _check_fn(fn)
        inflight: list = []
        for chunk in self._chunks(iterable, chunksize):
            inflight.append(
                self._run_chunk.remote(fn, chunk, star, self._initializer, self._initargs, self._pool_key)
            )
            while len(inflight) >= max_inflight:
                yield inflight.pop(0)
        yield from inflight

    # -- API --
    def apply(self, fn, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None, callback=None, error_callback=None):
        self._check()
        _check_fn(fn)
        kwds = kwds or {}
        res = AsyncResult([_apply.remote(fn, args, kwds)], single=True)
        if callback is not None or error_callback is not None:
            import threading

            def waiter():
                try:
                    out = res.get()
                except Exception as e:  # noqa: BLE001
                    if error_callback is not None:
                        error_callback(e)
                    return
                if callback is not None:
                    callback(out)

            threading.Thread(target=waiter, daemon=True).start()
        return res

    def map(self, fn, iterable, chunksize=None):
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None):
        self._check()
        refs, _ = self._submit(fn, [(x,) for x in iterable], chunksize, star=True)
        return _FlattenResult(refs)

    def starmap(self, fn, iterable, chunksize=None):
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn, iterable, chunksize=None):
        self._check()
        refs, _ = self._submit(fn, iterable, chunksize, star=True)
        return _FlattenResult(refs)

    def imap(self, fn, iterable, chunksize=1):
        self._check()
        args = ((x,) for x in iterable)
        for ref in self._submit_lazy(fn, args, chunksize, star=True, max_inflight=self._processes * 2):
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn, iterable, chunksize=1):
        self._check()
        args = ((x,) for x in iterable)
        pending: list = []
        for ref in self._submit_lazy(fn, args, chunksize, star=True, max_inflight=self._processes * 2):
            pending.append(ref)
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1, timeout=0)
            for r in ready:
                yield from ray_tpu_torch.get(r)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(ready[0])

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()


class _FlattenResult(AsyncResult):
    def get(self, timeout: float | None = None):
        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        return [x for chunk in chunks for x in chunk]
