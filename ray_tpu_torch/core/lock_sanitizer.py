"""Lock sanitizer (port of ray_tpu/core/lock_sanitizer.py): lockdep-style
deadlock diagnostics for the threaded head runtime.

The head's threads (the IO loop, the scheduler, the health loop, the
request pool, the autoscaler's launches) share the node registry. This
module is the Python counterpart of kernel lockdep:

- every instrumented lock records WHICH locks its acquiring thread
  already holds, building a global lock-ordering graph;
- a cycle in that graph (A taken under B somewhere, B taken under A
  elsewhere) is a potential deadlock, reported the FIRST time the
  inverted order is observed — no actual deadlock needed to find it;
- hold times above a threshold are recorded (long critical sections are
  the other classic cause of stalls).

Enable with RT_LOCK_SANITIZER=1 (checked once at runtime construction)
or wrap locks explicitly in tests:

    lock = make_lock("node")       # plain RLock unless sanitizing
    report()                       # {"cycles": [...], "slow_holds": [...]}
"""

from __future__ import annotations

import os
import threading
import time

SLOW_HOLD_S = 0.5

_graph: dict[str, set[str]] = {}  # edge a -> b: b was acquired while holding a
_cycles: list[tuple[str, str]] = []
_slow_holds: list[tuple[str, float]] = []
_state_lock = threading.Lock()
_tls = threading.local()


def enabled() -> bool:
    return os.environ.get("RT_LOCK_SANITIZER", "0").lower() in ("1", "true", "on")


def reset():
    with _state_lock:
        _graph.clear()
        _cycles.clear()
        _slow_holds.clear()


def report() -> dict:
    with _state_lock:
        return {
            "order_graph": {k: sorted(v) for k, v in _graph.items()},
            "cycles": list(_cycles),
            "slow_holds": list(_slow_holds),
        }


def _held() -> list:
    if not hasattr(_tls, "held"):
        _tls.held = []
    return _tls.held


def _reaches(src: str, dst: str) -> bool:
    """DFS: is dst reachable from src in the order graph?"""
    stack, seen = [src], set()
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_graph.get(n, ()))
    return False


class SanitizedLock:
    """RLock wrapper feeding the lock-order graph."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held()
        # reentrant re-acquire (self.name anywhere in held) cannot block —
        # recording it would manufacture false inversion cycles
        if held and all(h[0] != self.name for h in held):
            with _state_lock:
                for hname, _ in held:
                    if hname == self.name:
                        continue
                    # adding h -> self; if self -> h already reachable,
                    # the inverted order exists somewhere: potential deadlock
                    if _reaches(self.name, hname) and (self.name, hname) not in _cycles:
                        _cycles.append((self.name, hname))
                    _graph.setdefault(hname, set()).add(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            held.append((self.name, time.monotonic()))
        return ok

    def release(self):
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                name, t0 = held.pop(i)
                dt = time.monotonic() - t0
                if dt > SLOW_HOLD_S:
                    with _state_lock:
                        _slow_holds.append((name, dt))
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def make_lock(name: str):
    """A lock for runtime internals: sanitized when RT_LOCK_SANITIZER is
    on, a plain RLock otherwise (zero overhead in production)."""
    return SanitizedLock(name) if enabled() else threading.RLock()
