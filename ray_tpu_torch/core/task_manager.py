"""Task lifecycle (port of ray_tpu/core/task_manager.py): each task's
state, its retries after a worker's death or, with ``retry_exceptions``,
after an application error, and lineage: a lost output is rebuilt by
running its producing task again. The head owns every head-path task.
"""

from __future__ import annotations

import logging
import threading
import time

from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.exceptions import (
    ObjectLostError,
    TaskError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

TERMINAL = ("FINISHED", "FAILED", "CANCELLED")


class TaskState:
    __slots__ = ("spec", "status", "attempts_done", "node_id", "worker_id", "cancelled", "submitted_at", "events",
                 "external")

    def __init__(self, spec: TaskSpec):
        self.spec = spec
        # a record of a direct-plane call the head never dispatched: it has
        # no function, and only the call's owner can replay it
        self.external = False
        self.status = "PENDING"
        self.attempts_done = 0
        self.node_id = None
        self.worker_id = None
        self.cancelled = False
        self.submitted_at = time.time()
        self.events: list[tuple[str, float]] = [("PENDING", self.submitted_at)]

    def transition(self, status: str):
        self.status = status
        self.events.append((status, time.time()))


class TaskManager:
    def __init__(self, runtime):
        self.rt = runtime
        # RLock: pruning under the lock can cascade into lineage-release
        # paths that consult task state again on the same thread
        self._lock = threading.RLock()
        self._tasks: dict[TaskID, TaskState] = {}
        # lineage: an object id keeps its producing spec alive here (keyed
        # by ObjectID.task_id()); old terminal specs are pruned
        from collections import deque

        self._order: deque = deque()
        # lifetime totals: the table above is pruned, so the metrics'
        # counters read these (util/metrics.py::update_core_metrics)
        self.lifetime_submitted = 0
        self.lifetime_finished = 0

    def lifetime_counts(self) -> dict:
        with self._lock:
            return {"submitted": self.lifetime_submitted, "finished": self.lifetime_finished}

    def register(self, spec: TaskSpec) -> TaskState:
        st = TaskState(spec)
        self.rt.pin_spec_args(spec)  # args stay reachable while retryable
        with self._lock:
            self._tasks[spec.task_id] = st
            self._order.append(spec.task_id)
            self.lifetime_submitted += 1
            self._prune_locked()
        self.rt.gcs.events.record("task_submitted", task_id=spec.task_id.hex(), name=spec.name)
        return st

    def _prune_locked(self):
        from ray_tpu_torch._config import get_config
        from ray_tpu_torch.core.object_store import unlink_shm

        cap = get_config().max_lineage_tasks
        # a bounded pass: live entries keep the deque above the cap until
        # they turn terminal
        budget = 64
        while len(self._order) > cap and budget > 0:
            budget -= 1
            tid = self._order.popleft()
            st = self._tasks.get(tid)
            if st is None:
                continue
            if st.status not in TERMINAL:
                self._order.append(tid)  # still live; retry later
                continue
            del self._tasks[tid]
            # actor-creation specs outlive lineage pruning (restarts
            # re-resolve their args); their pins release on actor death
            if not st.spec.is_actor_creation:
                self.rt.unpin_spec_args(st.spec)
            # reclaim anonymous shm segments backing by-value args
            for a in st.spec.args:
                if a.payload is not None and a.payload.shm is not None:
                    unlink_shm(a.payload.shm.shm_name)
            for a in getattr(st.spec, "_kwargs", {}).values():
                if a.payload is not None and a.payload.shm is not None:
                    unlink_shm(a.payload.shm.shm_name)

    def record_external(self, records: list[dict], node_id=None, worker_id=None):
        """Batched records of direct-plane executions: a worker ran calls the
        head never dispatched (core/direct.py) and flushes them here, so the
        task table stays complete."""
        from ray_tpu_torch.core.ids import ActorID

        with self._lock:
            for r in records:
                tid = TaskID(r["task"])
                if tid in self._tasks:
                    continue
                spec = TaskSpec(
                    task_id=tid,
                    name=r.get("name", "direct"),
                    func_id="",
                    args=[],
                    actor_id=ActorID.from_hex(r["actor"]) if r.get("actor") else None,
                )
                st = TaskState(spec)
                st.external = True
                start, end = r.get("start", time.time()), r.get("end", time.time())
                st.submitted_at = start
                st.status = "FINISHED" if r.get("ok", True) else "FAILED"
                st.events = [("PENDING", start), ("RUNNING", start), (st.status, end)]
                st.attempts_done = 1
                st.node_id = node_id
                st.worker_id = worker_id
                self._tasks[tid] = st
                self._order.append(tid)
                self.lifetime_submitted += 1
                if st.status == "FINISHED":
                    self.lifetime_finished += 1
            self._prune_locked()

    def get(self, task_id: TaskID) -> TaskState | None:
        with self._lock:
            return self._tasks.get(task_id)

    def mark_running(self, task_id, node_id, worker_id):
        st = self.get(task_id)
        if st:
            st.node_id, st.worker_id = node_id, worker_id
            st.transition("RUNNING")

    def complete(self, task_id: TaskID):
        st = self.get(task_id)
        if st:
            st.transition("FINISHED")
            with self._lock:
                self.lifetime_finished += 1

    def handle_app_error(self, task_id: TaskID, err: TaskError) -> bool:
        """Application-level exception. Returns True if the task will be
        retried (retry_exceptions), else the error is final."""
        st = self.get(task_id)
        if st is None:
            return False
        spec = st.spec
        retry_on = spec.retry_exceptions
        should = False
        if retry_on is True:
            should = True
        elif isinstance(retry_on, (list, tuple)) and err.cause is not None:
            should = isinstance(err.cause, tuple(retry_on))
        if should and st.attempts_done < spec.max_retries:
            st.attempts_done += 1
            st.transition("RETRYING")
            logger.info("retrying %s after app error (attempt %d/%d)", spec.desc(), st.attempts_done, spec.max_retries)
            self.rt.resubmit(spec)
            return True
        st.transition("FAILED")
        return False

    def handle_worker_crash(self, task_id: TaskID, reason: str) -> bool:
        """System failure (worker died). Returns True if retried."""
        st = self.get(task_id)
        if st is None:
            return False
        spec = st.spec
        if not st.cancelled and st.attempts_done < spec.max_retries:
            st.attempts_done += 1
            st.transition("RETRYING")
            logger.info("retrying %s after worker crash (%s) attempt %d/%d", spec.desc(), reason, st.attempts_done, spec.max_retries)
            self.rt.resubmit(spec)
            return True
        st.transition("FAILED")
        err = WorkerCrashedError(f"task {spec.desc()}: worker died ({reason}); retries exhausted")
        for oid in self._return_ids(spec):
            self.rt.store.put_error(oid, err)
        return False

    def mark_cancelled(self, task_id: TaskID):
        st = self.get(task_id)
        if st:
            st.cancelled = True
            st.transition("CANCELLED")

    def _return_ids(self, spec: TaskSpec):
        if spec.streaming:
            return [spec.generator_id()]
        return spec.return_ids()

    # ---- lineage reconstruction ----
    def reconstruct(self, obj_id: ObjectID):
        """Run the producing task of an evicted object again."""
        if obj_id.is_put():
            raise ObjectLostError(f"object {obj_id.hex()[:16]} was created by put() and has no lineage to reconstruct")
        st = self.get(obj_id.task_id())
        if st is None:
            raise ObjectLostError(f"object {obj_id.hex()[:16]} lost and producing task unknown")
        if st.external:
            # a direct call's result sealed here: the owner holds its lineage
            # (direct.try_reconstruct), the head only a record with no function
            raise ObjectLostError(f"object {obj_id.hex()[:16]} lost; its direct call is replayed by its owner")
        with self._lock:
            if st.status == "RECONSTRUCTING":
                return  # already in flight
            st.transition("RECONSTRUCTING")
        logger.info("reconstructing %s via lineage", st.spec.desc())
        self.rt.resubmit(st.spec)

    def states(self, limit: int = 10_000) -> list[dict]:
        with self._lock:
            out = []
            for st in list(self._tasks.values())[-limit:]:
                out.append(
                    {
                        "task_id": st.spec.task_id.hex(),
                        "name": st.spec.name,
                        "status": st.status,
                        "attempts": st.attempts_done,
                        "node_id": st.node_id.hex() if st.node_id else None,
                        "submitted_at": st.submitted_at,
                        "is_actor_task": st.spec.actor_id is not None,
                    }
                )
            return out

    def num_nonterminal(self) -> int:
        with self._lock:
            return sum(1 for st in self._tasks.values() if st.status not in TERMINAL)
