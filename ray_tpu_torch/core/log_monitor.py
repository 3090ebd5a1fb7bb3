"""The log monitor (port of ray_tpu/core/log_monitor.py): worker output
streamed back to the driver.

Each worker ``dup2``s its stdout and stderr into its own file,
``<session>/logs/worker-<id>.log``, when it starts (``core/worker_main.py
::redirect_worker_logs``): the zygote's children and a head-started
agent's workers alike, so a line a worker prints, or a child process of
it, lands in the file. One thread in the head tails every file of the
directory and writes each new line to the driver's stderr as
``(worker=<id>) <line>``, under ``log_to_driver`` (``_config.py``). New
files are found on each sweep; a truncated file restarts from zero.
``shutdown()`` stops the thread, then sweeps once more.
"""

from __future__ import annotations

import os
import sys
import threading


class LogMonitor:
    def __init__(self, session_logs_dir: str, out=None, interval_s: float = 0.25):
        self.dir = session_logs_dir
        self.out = out
        self.interval_s = interval_s
        self._offsets: dict[str, int] = {}
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self, clean: bool = True):
        """``clean``: drop the directory's old files first (a session's
        directory is keyed by the head's pid, which a second ``init()`` in
        one process reuses)."""
        if clean:
            try:
                for name in os.listdir(self.dir):
                    if name.endswith(".log"):
                        os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass  # no directory yet: no worker has started
        self._thread = threading.Thread(target=self._loop, daemon=True, name="rt-log-monitor")
        self._thread.start()
        return self

    def stop(self):
        """Stop and join the sweeping thread; ``poll_once()`` after it is
        the final flush."""
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self):
        while not self._stopped.wait(self.interval_s):
            try:
                self.poll_once()
            except (OSError, ValueError):
                pass  # the driver's stream went away: the next sweep tries again

    def poll_once(self):
        try:
            names = sorted(os.listdir(self.dir))
        except FileNotFoundError:
            return
        out = self.out or sys.stderr
        for name in names:
            if not name.endswith(".log"):
                continue
            path = os.path.join(self.dir, name)
            tag = name[len("worker-"):-len(".log")] if name.startswith("worker-") else name
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            pos = self._offsets.get(name, 0)
            if size < pos:
                pos = 0  # truncated or rotated
            if size == pos:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(pos)
                    chunk = f.read(1 << 20)
            except OSError:
                continue
            # a partial last line waits for its newline (at most 1 MiB of it)
            cut = chunk.rfind(b"\n") + 1
            if cut == 0 and len(chunk) < (1 << 20):
                continue
            chunk = chunk[:cut] if cut else chunk
            self._offsets[name] = pos + len(chunk)
            for line in chunk.decode(errors="replace").splitlines():
                print(f"(worker={tag}) {line}", file=out)
        try:
            out.flush()
        except (OSError, ValueError):
            pass  # the driver's stream is closed
