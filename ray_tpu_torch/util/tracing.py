"""Request tracing: spans written as JSONL under the session directory
(port of ray_tpu/util/tracing.py).

Spans have the OTel-compatible shape of ray_tpu's (name, kind, trace and
span ids, parent, start/end in ns, attributes), one file per process
under ``session_dir()/spans``; ``load_spans()`` merges them. The trace
context is a contextvar, so threads and asyncio tasks each carry their
own.

Enable with RT_TRACING=1 (or ``configure(True)``). Disabled, the hooks are
a single boolean check.

``session_dir`` is the port's own copy of ray_tpu/util/state.py's: the
session of process ``RT_SESSION_PID`` (default this one), under the
temporary directory that ``tempfile`` resolves (``TMPDIR``), in a
``ray_tpu_torch`` folder of its own.
"""

from __future__ import annotations

import contextvars
import json
import os
import tempfile
import threading
import time
import uuid

_enabled: bool | None = None
_current: contextvars.ContextVar = contextvars.ContextVar("rt_torch_trace_ctx", default=None)
_file_lock = threading.Lock()
_file = None


def session_dir(pid: int | None = None) -> str:
    """This session's directory (flight dumps, span files)."""
    pid = pid or int(os.environ.get("RT_SESSION_PID", os.getpid()))
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch", f"session_{pid}")


def configure(enabled: bool):
    global _enabled
    _enabled = bool(enabled)


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RT_TRACING", "0").lower() in ("1", "true", "on")
    return _enabled


def _ctx() -> tuple | None:
    return _current.get()


def set_context(ctx: tuple | None):
    """(trace_id, span_id) of the CURRENT span in this thread/task."""
    _current.set(ctx)


def child_context() -> tuple:
    """Context to attach to an outgoing call: same trace (new if none),
    caller's span as parent."""
    cur = _ctx()
    if cur is None:
        return (uuid.uuid4().hex[:16], None)
    return cur


def _span_file():
    global _file
    with _file_lock:
        if _file is None:
            import atexit

            d = os.path.join(session_dir(), "spans")
            os.makedirs(d, exist_ok=True)
            _file = open(os.path.join(d, f"spans-{os.getpid()}.jsonl"), "a", buffering=1)
            # flush-close at interpreter exit: the final spans must reach disk
            atexit.register(shutdown)
        return _file


def shutdown():
    """Flush and close this process's span file. Idempotent; recording a
    span afterwards reopens the same per-pid file (append mode)."""
    global _file
    with _file_lock:
        f, _file = _file, None
    if f is not None:
        try:
            f.flush()
            f.close()
        except (OSError, ValueError):
            pass


def record_span(name: str, kind: str, trace_id: str, span_id: str, parent_id, start_ns: int, end_ns: int, attrs: dict):
    try:
        _span_file().write(
            json.dumps(
                {
                    "name": name,
                    "kind": kind,
                    "trace_id": trace_id,
                    "span_id": span_id,
                    "parent_id": parent_id,
                    "start_ns": start_ns,
                    "end_ns": end_ns,
                    "attrs": attrs,
                }
            )
            + "\n"
        )
    except Exception:
        pass


class span:
    """Context manager: open a span under ``parent_ctx`` (or the current
    context), make it current inside the block."""

    def __init__(self, name: str, kind: str = "internal", parent_ctx: tuple | None = None, **attrs):
        self.name = name
        self.kind = kind
        self.parent_ctx = parent_ctx
        self.attrs = attrs

    def __enter__(self):
        ctx = self.parent_ctx if self.parent_ctx is not None else child_context()
        self.trace_id = ctx[0]
        self.parent_id = ctx[1]
        self.span_id = uuid.uuid4().hex[:16]
        self._saved = _ctx()
        set_context((self.trace_id, self.span_id))
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        set_context(self._saved)
        if exc_type is not None:
            self.attrs["error"] = repr(exc)
        record_span(
            self.name, self.kind, self.trace_id, self.span_id, self.parent_id, self.start_ns, time.time_ns(), self.attrs
        )
        return False


def load_spans(pid: int | None = None) -> list[dict]:
    """Every span file of the session, merged."""
    d = os.path.join(session_dir(pid), "spans")
    out: list[dict] = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for n in sorted(names):
        try:
            with open(os.path.join(d, n)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except (OSError, ValueError):
            continue
    return out
