"""The memory monitor and its worker-killing policy (port of
ray_tpu/core/memory_monitor.py).

A thread in the head samples the host's memory every
``memory_monitor_refresh_ms`` (``/proc/meminfo``; cgroup v2's
``memory.max`` wins where it is tighter). Above
``memory_usage_threshold`` it kills (SIGKILL) the worker with the largest
RSS whose running tasks are all retriable, so the job degrades to retries
instead of the kernel's OOM killer taking the head. A leased worker of
the direct plane counts as retriable: a task with ``max_retries=0`` never
takes a lease, and its callers resubmit a dead lease's calls. Actors are
spared. One kill at a time: the next waits for the last victim's death
and a cooldown. It reads ``/proc`` and ``/sys`` and writes nothing there.
"""

from __future__ import annotations

import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

# kills by every monitor of this process: a caller that must see none
# (chip_smoke.py) reads it
kills_total = 0
_kills_lock = threading.Lock()


def system_memory() -> tuple[int, int]:
    """(available, total) bytes; (0, 0) where ``/proc`` is unreadable,
    which disables the monitor."""
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        return 0, 0
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw != "max":
            limit = int(raw)
            if 0 < limit < total:
                with open("/sys/fs/cgroup/memory.current") as f:
                    used = int(f.read())
                return max(0, limit - used), limit
    except (OSError, ValueError):
        pass  # no cgroup v2 limit here
    return avail, total


def proc_rss(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class MemoryMonitor:
    #: seconds between kills: the last victim dies and its memory returns
    #: before the next choice
    KILL_COOLDOWN_S = 2.0

    def __init__(self, runtime):
        self.rt = runtime
        self.cfg = runtime.cfg
        self._stopped = threading.Event()
        self.kills = 0
        self._last_victim = None
        self._last_kill_ts = 0.0

    def start(self):
        if self.cfg.memory_monitor_refresh_ms <= 0:
            return self
        if system_memory() == (0, 0):
            logger.info("memory monitor disabled: /proc/meminfo unavailable")
            return self
        threading.Thread(target=self._loop, daemon=True, name="rt-memory-monitor").start()
        return self

    def stop(self):
        self._stopped.set()

    def _loop(self):
        period = self.cfg.memory_monitor_refresh_ms / 1000.0
        while not self._stopped.wait(period):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — a failed sample is logged; the next one is taken
                logger.exception("memory monitor error")

    def usage_fraction(self) -> float:
        avail, total = system_memory()
        return 0.0 if total <= 0 else 1.0 - avail / total

    def check_once(self):
        global kills_total
        frac = self.usage_fraction()
        if frac < self.cfg.memory_usage_threshold:
            return
        if self._last_victim is not None:
            if time.monotonic() - self._last_kill_ts < self.KILL_COOLDOWN_S:
                return
            if self._last_victim.state != "dead" and self._last_victim.alive():
                return
            self._last_victim = None
        victim = self._pick_victim()
        if victim is None:
            return
        _node, w, rss = victim
        self.kills += 1
        with _kills_lock:
            kills_total += 1
        self._last_victim = w
        self._last_kill_ts = time.monotonic()
        logger.warning("memory usage %.1f%% >= %.0f%%: killing worker %s (rss=%dMB) to free memory", frac * 100,
                       self.cfg.memory_usage_threshold * 100, w.worker_id.hex()[:8], rss >> 20)
        self.rt.gcs.events.record("worker_oom_killed", worker_id=w.worker_id.hex(), rss=rss, usage=frac)
        # a local worker is killed here; an agent's worker by its agent
        getattr(w.proc, "kill", w.proc.terminate)()

    def _pick_victim(self):
        """The busy or leased worker with the largest RSS whose running
        tasks are all retriable."""
        best = None
        for node in self.rt.node_list():
            for w in list(node.workers.values()):
                if w.state not in ("busy", "leased"):
                    continue
                if w.state == "busy":
                    specs = [s for s, _ in list(w.running_tasks.values())]
                    if not specs or not all(s.max_retries > 0 for s in specs):
                        continue
                pid = getattr(w.proc, "pid", None)
                if not pid:
                    continue
                rss = proc_rss(pid)
                if best is None or rss > best[2]:
                    best = (node, w, rss)
        return best
