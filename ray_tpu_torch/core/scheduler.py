"""The cluster scheduler (port of ray_tpu/core/scheduler.py): dependency
gating, the node-selection policies (hybrid pack-then-spread at
``scheduler_spread_threshold``, SPREAD, hard and soft node affinity,
label selectors, placement-group bundles) and the queues a task moves
through: waiting for its dependencies, ready, parked by shape while no
node can place it, then reserved on a node's dispatch queue.
"""

from __future__ import annotations

import itertools
import logging
import threading
from collections import deque

from ray_tpu_torch._config import get_config
from ray_tpu_torch.core.node import Node
from ray_tpu_torch.core.task_spec import TaskSpec

logger = logging.getLogger(__name__)


def matches_labels(node: Node, selector: dict[str, str]) -> bool:
    for k, v in (selector or {}).items():
        if v.startswith("!"):
            if str(node.labels.get(k)) == v[1:]:
                return False
        elif str(node.labels.get(k)) != v:
            return False
    return True


class SchedulingPolicy:
    """Node-selection policies. ``pick`` returns a node, "retry" (feasible
    but busy: keep it queued) or None (no node could ever hold it)."""

    def __init__(self):
        self._rr = itertools.count()

    def pick(self, spec: TaskSpec, nodes: list[Node]) -> Node | None:
        sched = spec.scheduling
        cfg = get_config()
        cands = [n for n in nodes if n.alive and matches_labels(n, sched.label_selector)]
        if sched.node_id is not None:
            cands = [n for n in cands if n.node_id.hex() == sched.node_id]
            return self._first_allocatable(spec, cands)
        if sched.placement_group is not None:
            pg_cands = []
            for n in cands:
                bundles = n.pg_bundles.get(sched.placement_group, {})
                if sched.bundle_index >= 0:
                    if sched.bundle_index in bundles:
                        pg_cands.append(n)
                elif bundles:
                    pg_cands.append(n)
            return self._first_bundle_allocatable(spec, pg_cands)
        res = sched.resources
        feasible = [n for n in cands if n.feasible(res)]
        if not feasible:
            return None
        allocatable = [n for n in feasible if n.can_allocate(res)]
        if not allocatable:
            return "retry"  # feasible but busy: keep queued
        if sched.scheduling_strategy == "SPREAD":
            allocatable.sort(key=lambda n: n.utilization())
            k = next(self._rr) % len(allocatable)
            low = [n for n in allocatable if abs(n.utilization() - allocatable[0].utilization()) < 1e-9]
            return low[k % len(low)]
        if sched.soft_node_id is not None:
            for n in allocatable:
                if n.node_id.hex() == sched.soft_node_id:
                    return n
        # hybrid: pack in node order until spread threshold, then least-utilized
        for n in allocatable:
            if n.utilization() < cfg.scheduler_spread_threshold:
                return n
        return min(allocatable, key=lambda n: n.utilization())

    def _first_allocatable(self, spec, cands):
        if not cands:
            return None
        for n in cands:
            if spec.scheduling.placement_group is not None or n.can_allocate(spec.scheduling.resources):
                return n
        return "retry"

    def _first_bundle_allocatable(self, spec, cands):
        if not cands:
            return None
        sched = spec.scheduling
        for n in cands:
            bundles = n.pg_bundles.get(sched.placement_group, {})
            idxs = [sched.bundle_index] if sched.bundle_index >= 0 else list(bundles)
            for i in idxs:
                avail = bundles.get(i, {})
                if all(avail.get(k, 0) >= v - 1e-9 for k, v in sched.resources.items() if v > 0):
                    return n
        return "retry"


class Scheduler:
    """Dependency-gated ready queue + per-node dispatch.

    waiting for its dependencies -> ready -> (resources reserved) a node's
    dispatch queue -> running on a worker.
    """

    def __init__(self, runtime):
        self.rt = runtime
        self.policy = SchedulingPolicy()
        self._lock = threading.Condition()
        self._waiting: dict = {}  # task_id -> (spec, set(pending obj ids))
        self._dep_index: dict = {}  # obj_id -> set(task_id)
        self._ready: deque[TaskSpec] = deque()
        # shapes that failed placement park here until the cluster's
        # capacity changes: without it a deep infeasible backlog makes
        # every pass O(backlog)
        self._parked: dict = {}  # shape -> [epoch, deque[TaskSpec]]
        self._capacity_epoch = 1
        self._last_unpark_all = 0.0
        self._infeasible_warned: set = set()
        self._wake = threading.Event()
        self._stopped = False

    def stop(self):
        self._stopped = True
        self._wake.set()

    def submit(self, spec: TaskSpec):
        deps = set()
        for a in spec.args:
            if a.ref is not None and not self.rt.store.contains(a.ref):
                deps.add(a.ref)
        with self._lock:
            if deps:
                self._waiting[spec.task_id] = (spec, deps)
                for d in deps:
                    self._dep_index.setdefault(d, set()).add(spec.task_id)
                # seal may have raced registration
                resolved = [d for d in deps if self.rt.store.contains(d)]
                for d in resolved:
                    self._resolve_dep_locked(d)
            else:
                self._ready.append(spec)
        self._wake.set()

    def on_object_sealed(self, obj_id):
        # lock-free fast path: most seals have no registered waiter.
        # submit() re-checks store.contains(dep) under the lock after
        # registering, so a seal that misses the index here is seen there
        if obj_id in self._dep_index:
            with self._lock:
                self._resolve_dep_locked(obj_id)
        self._wake.set()

    def _resolve_dep_locked(self, obj_id):
        for tid in self._dep_index.pop(obj_id, set()):
            entry = self._waiting.get(tid)
            if entry is None:
                continue
            spec, deps = entry
            deps.discard(obj_id)
            if not deps:
                del self._waiting[tid]
                self._ready.append(spec)

    def remove_task(self, task_id) -> bool:
        """Cancel support: pull a task out of the queues if still pending."""
        with self._lock:
            if task_id in self._waiting:
                del self._waiting[task_id]
                return True
            for i, s in enumerate(self._ready):
                if s.task_id == task_id:
                    del self._ready[i]
                    return True
            for shape, (ep, dq) in self._parked.items():
                for i, s in enumerate(dq):
                    if s.task_id == task_id:
                        del dq[i]
                        if not dq:
                            del self._parked[shape]
                        return True
        return False

    # ---- scheduling loop (runs on the runtime's scheduler thread) ----
    def run_loop(self):
        while not self._stopped:
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            if self._stopped:
                return
            try:
                self._schedule_once()
                self.rt.dispatch_all()
            except Exception:
                logger.exception("scheduler loop error")

    def wake(self):
        self._wake.set()

    def bump_capacity(self):
        """Cluster capacity changed (resource release, node add/remove,
        PG commit): parked shapes become placeable again."""
        self._capacity_epoch += 1
        self._wake.set()

    @staticmethod
    def _shape_key(spec):
        """Placement signature: specs with one key are interchangeable to
        the policy, so once one fails to place in a pass the rest are
        requeued without a pick() each."""
        s = spec.scheduling
        return (
            tuple(sorted(s.resources.items())),
            s.node_id,
            s.soft_node_id,
            s.placement_group,
            s.bundle_index,
            s.scheduling_strategy,
            tuple(sorted(s.label_selector.items())),
        )

    def _schedule_once(self):
        import time as _time

        cur = self._capacity_epoch
        with self._lock:
            ready, self._ready = self._ready, deque()
            # unpark shapes parked before the current capacity epoch (and
            # all of them every 2 s)
            if self._parked:
                force = _time.monotonic() - self._last_unpark_all > 2.0
                if force:
                    self._last_unpark_all = _time.monotonic()
                for shape in list(self._parked):
                    ep, dq = self._parked[shape]
                    if force or ep < cur:
                        ready.extend(dq)
                        del self._parked[shape]
        park: dict = {}
        blocked: set = set()
        nodes = self.rt.node_list()
        for spec in ready:
            shape = self._shape_key(spec)
            if shape in blocked:
                park[shape].append(spec)
                continue
            node = self.policy.pick(spec, nodes)
            if node is None:
                if shape not in self._infeasible_warned:
                    if len(self._infeasible_warned) > 10_000:
                        self._infeasible_warned.clear()
                    self._infeasible_warned.add(shape)
                    logger.warning(
                        "task %s is infeasible on the current cluster (resources=%s); queued",
                        spec.desc(),
                        spec.scheduling.resources,
                    )
                blocked.add(shape)
                park[shape] = deque([spec])
                continue
            if node == "retry":
                blocked.add(shape)
                park[shape] = deque([spec])
                continue
            if not self.rt.reserve_and_queue(node, spec):
                blocked.add(shape)
                park[shape] = deque([spec])
        with self._lock:
            for shape, dq in park.items():
                entry = self._parked.get(shape)
                if entry is not None:
                    entry[1].extend(dq)
                    entry[0] = cur  # re-confirmed unplaceable at this epoch
                else:
                    self._parked[shape] = [cur, dq]

    def take_ready_for(self, node, reserve, limit: int = 8) -> bool:
        """Completion fast path: the IO thread that just freed capacity on
        ``node`` moves plain DEFAULT-strategy ready tasks straight onto its
        dispatch queue, without the scheduler thread's hop. Constrained
        specs (PG, affinity, labels, SPREAD) stay for the policy pass."""
        candidates = []
        scan = limit * 4  # bounded prefix: O(1) per completion, not O(backlog)
        with self._lock:
            if not self._ready:
                return False
            kept = []
            scanned = 0
            while self._ready and scanned < scan and len(candidates) < limit:
                spec = self._ready.popleft()
                scanned += 1
                s = spec.scheduling
                if (
                    s.placement_group is None
                    and s.node_id is None
                    and s.soft_node_id is None
                    and not s.label_selector
                    and s.scheduling_strategy == "DEFAULT"
                ):
                    candidates.append(spec)
                else:
                    kept.append(spec)
            self._ready.extendleft(reversed(kept))
            if not candidates:
                return False
        placed = False
        leftovers = []
        for spec in candidates:
            if reserve(node, spec):
                placed = True
            else:
                leftovers.append(spec)
        if leftovers:
            with self._lock:
                self._ready.extendleft(reversed(leftovers))
        return placed

    def has_pending(self) -> bool:
        with self._lock:
            return bool(self._ready or self._waiting or self._parked)

    def pending_demand(self) -> list[dict]:
        """The resource requests of queued tasks not placed yet, parked ones
        included: the autoscaler's input (ray_tpu's ``pending_demand``)."""
        with self._lock:
            out = [dict(s.scheduling.resources) for s in self._ready]
            for _, dq in self._parked.values():
                out.extend(dict(s.scheduling.resources) for s in dq)
            return out
