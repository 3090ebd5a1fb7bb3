"""Profiling helpers (port of ray_tpu/util/profiling.py): torch.profiler
captures and wall-time probes.

    with profile_trace("/tmp/prof"):        # a Chrome trace under /tmp/prof
        engine.step()

    port = start_profiler_server(0)         # GET /capture?ms=500 -> {"path": ...}

    prof = WallProfiler()
    with prof.span("step", sync_value=logits):
        ...
    prof.report()

ray_tpu captures XLA traces with ``jax.profiler``. Here a capture is
``torch.profiler`` with the CPU's activity and, where the process sees a
card, CUDA's (CUPTI): the trace names each kernel's ``__global__``
symbol. ``jax.profiler.start_server`` has no PyTorch twin, so
``start_profiler_server`` is one of the port's own: an HTTP endpoint that
records for the requested milliseconds and answers with the trace's path.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _trace_path(logdir: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    return os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Record what runs inside the block with torch.profiler and write a
    Chrome trace (``chrome://tracing``, Perfetto) under ``logdir`` when it
    ends; yields ``logdir``."""
    import torch

    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(_trace_path(logdir))


class _CaptureServer:
    """``GET /capture?ms=N``: record this process for N ms (at most 60 s)
    and answer ``{"path": trace}``; one capture at a time."""

    MAX_MS = 60_000

    def __init__(self, port: int, logdir: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        outer = self
        self.logdir = logdir
        self._busy = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code: int = 200):
                import json

                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path.rstrip("/") != "/capture":
                    return self._json({"error": "not found"}, 404)
                q = parse_qs(url.query)
                try:
                    ms = float(q.get("ms", ["1000"])[0])
                except ValueError:
                    return self._json({"error": "ms must be a number"}, 400)
                if not 0 < ms <= outer.MAX_MS:
                    return self._json({"error": f"ms must be in (0, {outer.MAX_MS}]"}, 400)
                if not outer._busy.acquire(blocking=False):
                    return self._json({"error": "a capture is already running"}, 409)
                try:
                    self._json({"path": outer.capture(ms / 1e3)})
                finally:
                    outer._busy.release()

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True, name="rt-profiler").start()

    def capture(self, seconds: float) -> str:
        import torch
        from torch._C._profiler import _ExperimentalConfig

        path = _trace_path(self.logdir)
        # the capture runs on the server's thread: every thread's ops, not its own
        with torch.profiler.profile(activities=_activities(),
                                    experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(path)
        return path

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


_capture_server: _CaptureServer | None = None


def start_profiler_server(port: int = 9999, logdir: str | None = None) -> int:
    """Start this process's on-demand capture endpoint on 127.0.0.1:``port``
    (0: an ephemeral one) and return its port; traces go under ``logdir``
    (default ``<session>/profiles``)."""
    global _capture_server
    if _capture_server is None:
        from ray_tpu_torch.util.tracing import session_dir

        _capture_server = _CaptureServer(port, logdir or os.path.join(session_dir(), "profiles"))
    return _capture_server.port


def stop_profiler_server():
    global _capture_server
    if _capture_server is not None:
        _capture_server.stop()
        _capture_server = None


def _sync_devices(value):
    """Wait for the card work behind every CUDA tensor in ``value`` (a
    tensor, or lists, tuples and dicts of them): the counterpart of
    ``jax.block_until_ready``."""
    import torch

    stack, devices = [value], set()
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    for d in devices:
        torch.cuda.synchronize(d)


class WallProfiler:
    """Named wall-time spans, each ending with its value's device work
    done, for quick triage."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                _sync_devices(sync_value)
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> dict:
        return {
            name: {"count": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
            for name, v in self.spans.items()
            if v
        }
