"""Async adapters over the blocking handle API (port of
ray_tpu/serve/_async_bridge.py). The runtime is thread-based, so two
bridges make handle results awaitable WITHOUT a blocked thread per
request:

  * unary: ``ObjectRef.future()`` (the runtime's seal callback) wrapped
    into the proxy's loop with ``asyncio.wrap_future``: no thread waits;
  * streaming: ONE pump thread multiplexes ALL open streams, polling each
    registered ``ObjectRefGenerator`` with a zero timeout and pushing
    ready values into per-stream asyncio queues, sleeping on the runtime's
    generator condition when nothing moved. Thread count is O(1) in the
    number of concurrent streams, which lets the async proxy hold
    hundreds of SSE connections.
"""

from __future__ import annotations

import asyncio
import threading
import time

from ray_tpu_torch.core import context
from ray_tpu_torch.exceptions import GetTimeoutError

_SENTINEL = object()


async def result_async(response, timeout_s: float | None = None):
    """Await a DeploymentResponse without blocking a thread."""
    loop = asyncio.get_running_loop()
    # async handles bind their replica ref from the dispatcher thread —
    # a loop-side notification (no parked executor thread per pending
    # request) wakes us when it happens; one deadline covers bind + result
    deadline = None if timeout_s is None else loop.time() + timeout_s
    if response._ref is None:
        bind_fut: asyncio.Future = loop.create_future()

        def _on_bind():
            loop.call_soon_threadsafe(lambda: bind_fut.done() or bind_fut.set_result(None))

        if response._add_bind_callback(_on_bind):
            try:
                await asyncio.wait_for(bind_fut, timeout=timeout_s)
            except asyncio.TimeoutError:
                raise GetTimeoutError(f"request still queued after {timeout_s}s") from None
        if response._error is not None:
            raise response._error
    fut = asyncio.wrap_future(response._ref.future())
    remaining = None if deadline is None else max(0.0, deadline - loop.time())
    try:
        value = await asyncio.wait_for(fut, timeout=remaining)
    except asyncio.TimeoutError:
        raise GetTimeoutError(f"request exceeded {timeout_s}s") from None
    finally:
        if fut.done() and not fut.cancelled():
            response._settle()
    return value


class _StreamPump:
    """Single background thread draining every registered stream."""

    def __init__(self):
        self._lock = threading.Lock()
        self._streams: dict[int, dict] = {}  # id -> state
        self._next = 0
        self._thread: threading.Thread | None = None
        self._stop = False

    def register(self, gen, loop) -> tuple[int, asyncio.Queue]:
        """gen: the stream's ObjectRefGenerator; the pump consumes it."""
        q: asyncio.Queue = asyncio.Queue(maxsize=64)
        with self._lock:
            sid = self._next
            self._next += 1
            self._streams[sid] = {
                "gen": gen,
                "loop": loop,
                "q": q,
                "dead": False,
                # puts scheduled via call_soon_threadsafe but not yet
                # applied on the loop: qsize() alone can't see them, so
                # backpressure counts both (guarded by cnt_lock)
                "inflight": 0,
                "cnt_lock": threading.Lock(),
            }
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._thread = threading.Thread(target=self._run, name="serve-stream-pump", daemon=True)
                self._thread.start()
        return sid, q

    def unregister(self, sid: int):
        with self._lock:
            self._streams.pop(sid, None)

    def _run(self):
        cond = getattr(context.get_client(), "_gen_cond", None)  # the head's; a worker's client has none
        while not self._stop:
            with self._lock:
                streams = list(self._streams.items())
            if not streams:
                with self._lock:
                    if not self._streams:
                        self._thread = None
                        return
                continue
            progressed = False
            for sid, st in streams:
                if st["dead"]:
                    continue
                # drain whatever is ready for this stream right now
                while True:
                    with st["cnt_lock"]:
                        backlog = st["q"].qsize() + st["inflight"]
                    if backlog >= 48:
                        break  # backpressure: consumer lagging; headroom
                        # below maxsize keeps sentinel/error pushes lossless
                    item_ref = st.pop("pending_item", None)
                    if item_ref is None:
                        try:
                            item_ref = st["gen"].next_ref(timeout_s=0)
                        except GetTimeoutError:
                            break  # nothing ready yet
                        except StopIteration:
                            self._push(st, _SENTINEL)
                            st["dead"] = True
                            break
                        except Exception as e:  # noqa: BLE001
                            self._push(st, e)
                            st["dead"] = True
                            break
                    progressed = True
                    try:
                        # near-zero timeout: a value needing a slow
                        # cross-node pull must not head-of-line block the
                        # SHARED pump — park it and retry next pass while
                        # other streams keep draining
                        value = item_ref.get(timeout=0.05)
                    except GetTimeoutError:
                        st["pending_item"] = item_ref
                        st["pending_since"] = st.get("pending_since") or time.monotonic()
                        if time.monotonic() - st["pending_since"] > 60.0:
                            self._push(st, TimeoutError("stream item fetch stalled >60s"))
                            st["dead"] = True
                        break
                    except BaseException as e:  # noqa: BLE001
                        self._push(st, e)
                        st["dead"] = True
                        break
                    st.pop("pending_since", None)
                    self._push(st, value)
            with self._lock:
                for sid, st in list(self._streams.items()):
                    if st["dead"]:
                        del self._streams[sid]
            if not progressed:
                # sleep on the generator condition: any stream item or
                # finish notifies it, so wakeups track real progress
                if cond is None:
                    time.sleep(0.005)
                else:
                    with cond:
                        cond.wait(timeout=0.05)

    def _push(self, st, value):
        loop, q = st["loop"], st["q"]

        def put():
            try:
                q.put_nowait(value)
            except asyncio.QueueFull:  # pragma: no cover - inflight accounting prevents this
                pass
            finally:
                with st["cnt_lock"]:
                    st["inflight"] -= 1

        with st["cnt_lock"]:
            st["inflight"] += 1
        try:
            loop.call_soon_threadsafe(put)
        except RuntimeError:
            with st["cnt_lock"]:
                st["inflight"] -= 1
            st["dead"] = True  # loop closed (proxy shutdown)


_pump = _StreamPump()


async def aiter_stream(gen_response, item_timeout_s: float | None = None):
    """Async-iterate a DeploymentResponseGenerator through the shared
    pump; cancels the producer on early exit (client disconnect)."""
    loop = asyncio.get_running_loop()
    sid, q = _pump.register(gen_response._gen, loop)
    try:
        while True:
            item = await asyncio.wait_for(q.get(), timeout=item_timeout_s)
            if item is _SENTINEL:
                gen_response._exhausted = True
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    except asyncio.TimeoutError:
        raise GetTimeoutError(f"stream item exceeded {item_timeout_s}s") from None
    finally:
        _pump.unregister(sid)
        gen_response._settle()
