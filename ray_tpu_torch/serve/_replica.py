"""Replica actor: hosts one instance of a deployment's user class (port
of ray_tpu/serve/_replica.py): a user-code event loop, handle_request and
handle_request_streaming, health checks and the graceful-shutdown hook
chain.

Sync callables run on the actor's max_concurrency thread pool; coroutines
and async generators run on ONE persistent replica event loop, so async
deployments don't pay a loop per request. Streaming methods yield through
the runtime's streaming-generator machinery back to the caller.

The deployment's code arrives by reference, as (module, qualified name)
(``deployment.py``), and the replica imports it in its worker
(``core/serialization.py::resolve_code``).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time


def _resolve_handle_markers(v):
    """Bound sub-deployments arrive as _HandleMarker; turn them into live
    DeploymentHandles inside the replica process (model composition)."""
    from ray_tpu_torch.serve.deployment import _HandleMarker

    if isinstance(v, _HandleMarker):
        import ray_tpu_torch
        from ray_tpu_torch.serve._controller import CONTROLLER_NAME
        from ray_tpu_torch.serve.handle import DeploymentHandle

        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return DeploymentHandle(controller, v.app_name, v.deployment)
    return v


class Replica:
    """Wraps the user callable. Instantiated as a ray_tpu_torch actor by the
    controller with max_concurrency = max_ongoing_requests + headroom for
    control calls (health/metrics)."""

    def __init__(self, deployment_name: str, replica_id: str, cls_or_fn, init_args, init_kwargs, user_config=None):
        from ray_tpu_torch.core.serialization import resolve_code

        cls_or_fn = resolve_code(*cls_or_fn)
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._ongoing = 0
        self._total = 0
        self._created_at = time.time()
        # one persistent loop for all async user code
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(target=self._loop.run_forever, name="serve-user-loop", daemon=True)
        self._loop_thread.start()
        init_args = tuple(_resolve_handle_markers(a) for a in (init_args or ()))
        init_kwargs = {k: _resolve_handle_markers(v) for k, v in (init_kwargs or {}).items()}
        if inspect.isfunction(cls_or_fn):
            self._callable = cls_or_fn
            self._is_function = True
        else:
            self._callable = cls_or_fn(*init_args, **init_kwargs)
            self._is_function = False
        if user_config is not None:
            self.reconfigure(user_config)

    # -- control plane --

    def check_health(self) -> bool:
        user_check = getattr(self._callable, "check_health", None)
        if user_check is not None and not self._is_function:
            user_check()
        return True

    def get_metrics(self) -> dict:
        with self._lock:
            return {
                "replica_id": self.replica_id,
                "ongoing_requests": self._ongoing,
                "total_requests": self._total,
                "uptime_s": time.time() - self._created_at,
            }

    def reconfigure(self, user_config):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    def _drain_hook(self):
        """The deployment's drain lifecycle hook, iff it matches the
        contract (accepts timeout_s — serve/llm.py LLMServer.drain): a
        user method merely NAMED drain with a different signature is not
        the hook and must not be mis-called."""
        if self._is_function:
            return None
        hook = getattr(self._callable, "drain", None)
        if not callable(hook):
            return None
        try:
            inspect.signature(hook).bind(timeout_s=0.0)
        except TypeError:
            return None
        return hook

    def prepare_shutdown(self, timeout_s: float = 5.0):
        """Drain in-flight requests, then run the deployment's cleanup
        hook — `drain(timeout_s=...)`/`shutdown()`/`close()`/`__del__`
        in that order. A contract-matching drain hook gets the WHOLE
        budget and owns the bounded finish-in-flight wait itself;
        otherwise this method waits for in-flight requests first."""
        deadline = time.time() + timeout_s
        drain = self._drain_hook()
        if drain is None:
            while time.time() < deadline:
                with self._lock:
                    if self._ongoing == 0:
                        break
                time.sleep(0.02)
        if not self._is_function:
            for name in ("drain", "shutdown", "close", "__del__"):
                if name == "drain":
                    hook, kwargs = drain, {"timeout_s": max(deadline - time.time(), 0.0)}
                else:
                    hook, kwargs = getattr(self._callable, name, None), {}
                if not callable(hook):
                    continue
                try:
                    res = hook(**kwargs)
                    if inspect.iscoroutine(res):
                        asyncio.run_coroutine_threadsafe(res, self._loop).result(timeout=timeout_s)
                except Exception:
                    pass
                break
        with self._lock:
            drained = self._ongoing == 0
        if drained:
            # only a drained loop may stop: an in-flight coroutine on a
            # stopped loop would hang its handler thread forever
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except Exception:
                pass
        return True

    # -- data plane --

    def _target(self, method_name: str):
        if self._is_function:
            return self._callable
        return getattr(self._callable, method_name)

    @staticmethod
    def _set_model_id(model_id):
        from ray_tpu_torch.serve.multiplex import _set_multiplexed_model_id

        _set_multiplexed_model_id(model_id or "")

    def _with_model_ctx(self, coro, model_id):
        """Carry the request's model id onto the actor event loop (the
        contextvar set in this pool thread doesn't cross threads)."""

        async def _inner():
            self._set_model_id(model_id)
            return await coro

        return _inner()

    def handle_request(self, method_name: str, args: tuple, kwargs: dict, multiplexed_model_id: str | None = None):
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            self._set_model_id(multiplexed_model_id)
            result = self._target(method_name)(*args, **(kwargs or {}))
            if inspect.iscoroutine(result):
                result = asyncio.run_coroutine_threadsafe(
                    self._with_model_ctx(result, multiplexed_model_id), self._loop
                ).result()
            return result
        finally:
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method_name: str, args: tuple, kwargs: dict, multiplexed_model_id: str | None = None):
        """Generator method: items stream back through the runtime's
        streaming-generator path. Called with num_returns='streaming'."""
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            self._set_model_id(multiplexed_model_id)
            result = self._target(method_name)(*args, **(kwargs or {}))
            if inspect.iscoroutine(result):
                result = asyncio.run_coroutine_threadsafe(
                    self._with_model_ctx(result, multiplexed_model_id), self._loop
                ).result()
            if inspect.isasyncgen(result):
                while True:
                    try:
                        item = asyncio.run_coroutine_threadsafe(result.__anext__(), self._loop).result()
                    except StopAsyncIteration:
                        return
                    yield item
            elif inspect.isgenerator(result):
                yield from result
            else:
                yield result  # unary fallback: stream of one
        finally:
            with self._lock:
                self._ongoing -= 1
