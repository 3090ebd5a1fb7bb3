"""The task timeline in Chrome-trace form (port of ray_tpu/util/timeline.py).

The head's task table keeps each task's (state, time) events; each
RUNNING -> terminal span becomes one complete ("X") event: rows (tid) are
workers, process groups (pid) nodes. Calls of the direct plane and actor
methods are in the table too: their workers flush batches of records to
the head (``task_events``), so they show a little after they ran. Open
the file in chrome://tracing or Perfetto.
"""

from __future__ import annotations

import json

TERMINAL = ("FINISHED", "FAILED", "CANCELLED")


def timeline(filename: str | None = None, client=None) -> list[dict]:
    from ray_tpu_torch.core import context

    c = client or context.get_client()
    tm = getattr(c, "task_manager", None)
    if tm is None:
        raise RuntimeError("timeline() reads the head's task table: call it in the head's process")
    with tm._lock:
        tasks = list(tm._tasks.values())
    events: list[dict] = []
    for st in tasks:
        run_start = None
        for state, ts in list(st.events):
            if state == "RUNNING":
                run_start = ts
            elif state in TERMINAL and run_start is not None:
                events.append({
                    "name": st.spec.name,
                    "ph": "X",
                    "ts": run_start * 1e6,
                    "dur": max(0.0, ts - run_start) * 1e6,
                    "pid": st.node_id.hex()[:8] if st.node_id else "head",
                    "tid": st.worker_id.hex()[:8] if st.worker_id else "?",
                    "cat": "actor_task" if st.spec.actor_id is not None else "task",
                    "args": {"status": state, "attempts": st.attempts_done},
                })
                run_start = None
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
