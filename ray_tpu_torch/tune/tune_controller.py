"""TuneController: the trial-driving loop (port of
ray_tpu/tune/tune_controller.py). It launches trial actors under
resource limits (a trial's placement group admitted whole, or left
PENDING), consumes reported results, routes them through the scheduler
(stop/pause) and the searcher, stages and commits checkpoints, restarts
exploited (PBT) and failed trials from their checkpoints, and snapshots
the experiment for ``Tuner.restore``.

The card: a trial's resources pass ``"GPU"`` on (``"TPU"``, ray_tpu's
name, folded into it) as the actor option ``num_gpus``, from a flat dict
or a placement group's head bundle, so the trial actor's worker is bound
to the card (``CUDA_VISIBLE_DEVICES``); ray_tpu passes ``"TPU"`` alone.

The snapshot is written with the standard library's pickle (ray_tpu's
with a third-party pickler the card's machine lacks): ``Tuner.fit()``
refuses, before any trial starts, a search space or scheduler that holds
code without an importable name.

Checkpoints are staged under the runtime's session directory; ``run``
removes its trials' staged copies, and the staging root once it is
empty, when it returns or raises.
"""

from __future__ import annotations

import os
import queue
import shutil
import traceback
import uuid

import ray_tpu_torch
from ray_tpu_torch.train import context as _train_ctx
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.tune import schedulers as sched
from ray_tpu_torch.tune.trial import ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial

POLL_INTERVAL_S = float(os.environ.get("RT_TUNE_POLL_INTERVAL_S", "0.05"))


def _stage_root() -> str:
    """Session-scoped checkpoint staging dir: concurrent experiments (or
    other users' leftovers) can never collide on trial ids."""
    from ray_tpu_torch.util.tracing import session_dir

    return os.path.join(session_dir(), "trial_stage")


def _actor_options(res: dict) -> dict:
    """The trial actor's CPUs, and the card as ``num_gpus`` (``"TPU"`` folded in)."""
    from ray_tpu_torch.accelerators.gpu import fold_card

    res = fold_card(res)
    opts = {"num_cpus": res.get("CPU", 1)}
    if res.get("GPU"):
        opts["num_gpus"] = res["GPU"]
    return opts


@ray_tpu_torch.remote(max_concurrency=4)
class TrialActor:
    """Runs one trial's function in a thread; reports stream out via poll
    (same topology as train's TrainWorker)."""

    def __init__(self, trial_id: str, experiment_name: str):
        self.trial_id = trial_id
        self.experiment_name = experiment_name
        self._reports: queue.Queue = queue.Queue()
        self._status = "idle"

    def run(self, fn, config: dict, latest_checkpoint_path: str | None, trial_pg_hex: str | None = None):
        if trial_pg_hex:
            # the trial's gang reservation: a WorkerGroup spawned inside
            # this trial schedules its workers into bundles 1..N instead
            # of reserving a second placement group
            os.environ["RT_TRIAL_PG"] = trial_pg_hex
        ckpt = Checkpoint(latest_checkpoint_path) if latest_checkpoint_path else None
        ctx = _train_ctx.TrainContext(
            world_size=1,
            world_rank=0,
            local_rank=0,
            local_world_size=1,
            node_rank=0,
            experiment_name=self.experiment_name,
            trial_name=self.trial_id,
            trial_id=self.trial_id,
            report_fn=self._on_report,
            latest_checkpoint=ckpt,
        )
        _train_ctx.set_context(ctx)
        self._status = "running"
        try:
            fn(config)
            self._status = "finished"
        except BaseException:  # noqa: BLE001
            self._status = "error"
            raise RuntimeError(f"trial {self.trial_id} failed:\n{traceback.format_exc()}")
        return self.trial_id

    def _on_report(self, seq, metrics, checkpoint, checkpoint_dir_name):
        # stage checkpoint content NOW, inside the report call: report()
        # returns to user code which may delete the source dir (e.g. a
        # TemporaryDirectory) long before the controller polls
        staged = None
        if checkpoint is not None and os.path.isdir(checkpoint.path):
            staged = os.path.join(_stage_root(), self.trial_id, f"seq{seq}")
            shutil.copytree(checkpoint.path, staged, dirs_exist_ok=True)
        self._reports.put({"seq": seq, "metrics": metrics, "checkpoint_path": staged})

    def poll(self):
        out = []
        while True:
            try:
                out.append(self._reports.get_nowait())
            except queue.Empty:
                break
        return {"status": self._status, "reports": out}


class TuneController:
    def __init__(
        self,
        trainable,
        *,
        searcher,
        scheduler=None,
        metric: str | None = None,
        mode: str = "max",
        max_concurrent: int | None = None,
        run_dir: str,
        experiment_name: str,
        resources_per_trial: dict | None = None,
        max_failures_per_trial: int = 0,
        callbacks: list | None = None,
    ):
        self.trainable = trainable
        self.searcher = searcher
        self.scheduler = scheduler or sched.FIFOScheduler()
        self.metric = metric
        self.mode = mode
        self.max_concurrent = max_concurrent or 4
        self.run_dir = run_dir
        self.experiment_name = experiment_name
        self.resources = resources_per_trial or {"CPU": 1}
        self.max_failures = max_failures_per_trial
        self.trials: list[Trial] = []
        self._actors: dict[str, object] = {}
        self._run_refs: dict[str, object] = {}
        # PG-backed trials: trial_id -> PlacementGroup; trials whose gang
        # reservation is still PENDING wait here, not in RUNNING
        self._trial_pgs: dict[str, object] = {}
        self._awaiting_pg: list[Trial] = []
        self._failures: dict[str, int] = {}
        self._pending: dict[str, list] = {}  # undelivered reports per trial
        self._exhausted = False
        self._dirty = False
        os.makedirs(run_dir, exist_ok=True)
        self.callbacks = list(callbacks or [])
        self._cb_warned: set = set()
        for cb in self.callbacks:
            cb.setup(run_dir)

    # ---------------- experiment snapshots ----------------
    # Reference: tune/execution/experiment_state.py — periodic experiment
    # checkpoints enabling Tuner.restore after a crash/interrupt.
    SNAPSHOT_NAME = "experiment_state.pkl"
    SNAPSHOT_MIN_INTERVAL_S = 5.0  # reference throttles periodic snapshots too

    def save_snapshot(self, force: bool = False):
        import time as _time

        if not force and _time.monotonic() - getattr(self, "_last_snapshot_ts", 0.0) < self.SNAPSHOT_MIN_INTERVAL_S:
            return
        self._last_snapshot_ts = _time.monotonic()
        import pickle

        state = {
            "trials": self.trials,
            "searcher": self.searcher,
            "scheduler": self.scheduler,
            "exhausted": self._exhausted,
            "failures": self._failures,
            "metric": self.metric,
            "mode": self.mode,
            "max_concurrent": self.max_concurrent,
            "max_failures": self.max_failures,
        }
        path = os.path.join(self.run_dir, self.SNAPSHOT_NAME)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, path)
        self._dirty = False

    def load_snapshot(self, state: dict, *, resume_errored: bool = False, restart_errored: bool = False):
        """Adopt a saved experiment: live trials resume from their last
        checkpoint; terminal ones keep their results."""
        self.trials = state["trials"]
        for t in self.trials:
            # snapshots from before the Trial.resources field unpickle
            # without it (dataclass __init__ is skipped on unpickle)
            if not hasattr(t, "resources"):
                t.resources = None
        self.searcher = state["searcher"]
        if state.get("scheduler") is not None:
            self.scheduler = state["scheduler"]
        self._exhausted = state["exhausted"]
        self._failures = dict(state.get("failures", {}))
        self.max_concurrent = state.get("max_concurrent", self.max_concurrent)
        self.max_failures = state.get("max_failures", self.max_failures)
        for t in self.trials:
            if t.status in (RUNNING, PENDING):
                # RUNNING was in flight when the snapshot landed; PENDING
                # was queued for a gang reservation that died with the old
                # controller — both resume via the paused path
                t.status = PAUSED
            elif t.status == ERROR and restart_errored:
                t.status = PAUSED
                t.checkpoint_path = None
                t.iteration = 0
                t.metrics_history = []
                t.last_result = None  # stale scores must not feed PBT/grids
                t.error = None
                self._failures.pop(t.trial_id, None)
            elif t.status == ERROR and resume_errored:
                t.status = PAUSED
                t.error = None
                self._failures.pop(t.trial_id, None)

    def _notify(self, method: str, *args):
        """Dispatch one callback hook; a failing logger warns once instead
        of silently eating every record or killing the experiment."""
        import logging

        for cb in self.callbacks:
            try:
                getattr(cb, method)(*args)
            except Exception:
                key = (type(cb).__name__, method)
                if key not in self._cb_warned:
                    self._cb_warned.add(key)
                    logging.getLogger("ray_tpu_torch.tune").warning(
                        "callback %s.%s failed; suppressing further errors",
                        *key,
                        exc_info=True,
                    )

    # ---------------- PBT hook ----------------
    def request_exploit(self, trial: Trial, donor: Trial, new_config: dict):
        trial.restore_config = new_config
        trial.checkpoint_path = donor.checkpoint_path

    # ---------------- main loop ----------------
    def run(self) -> list[Trial]:
        try:
            return self._run()
        finally:
            self._remove_stage()

    def _remove_stage(self):
        """This experiment's staged checkpoint copies, and the staging root
        when no other experiment of the session stages there."""
        root = _stage_root()
        for t in self.trials:
            shutil.rmtree(os.path.join(root, t.trial_id), ignore_errors=True)
        try:
            os.rmdir(root)
        except OSError:
            pass  # absent, or another experiment's copies are in it

    def _run(self) -> list[Trial]:
        while True:
            # paused trials (PBT exploits, failure retries) get freed slots
            # BEFORE new suggestions — the population keeps training
            self._resume_paused()
            self._poll_awaiting_pg()
            self._maybe_launch()
            running = [t for t in self.trials if t.status == RUNNING]
            paused = [t for t in self.trials if t.status == PAUSED]
            waiting = self._awaiting_pg
            if not running and not paused and not waiting and self._exhausted:
                break
            if not running and not paused and not waiting and not self._exhausted and not self._maybe_launch():
                break
            self._poll_running()
            if self._dirty:
                self.save_snapshot()
        self.save_snapshot(force=True)
        self._notify("on_experiment_end", self.trials)
        return self.trials

    def _maybe_launch(self) -> bool:
        launched = False
        while self._active_count() < self.max_concurrent and not self._exhausted:
            tid = uuid.uuid4().hex[:8]
            cfg = self.searcher.suggest(tid)
            if cfg == "__WAIT__":
                break
            if cfg is None:
                self._exhausted = True
                break
            trial = Trial(config=cfg, trial_id=tid)
            self.trials.append(trial)
            self._start_trial(trial)
            launched = True
        return launched

    def _start_trial(self, trial: Trial):
        from ray_tpu_torch.tune.resources import PlacementGroupFactory

        if isinstance(self.resources, PlacementGroupFactory):
            # gang-reserve the trial's WHOLE footprint (driver + workers)
            # atomically (reference: tune/execution/placement_groups.py);
            # a trial that doesn't fit stays PENDING, never oversubscribes
            pg = self._trial_pgs.get(trial.trial_id)
            if pg is None:
                pg = self.resources.create(name=f"trial-{trial.trial_id}")
                self._trial_pgs[trial.trial_id] = pg
            if not pg.wait(timeout_seconds=0.05):
                trial.status = PENDING
                if trial not in self._awaiting_pg:
                    self._awaiting_pg.append(trial)
                return
            opts = {
                **_actor_options(self.resources.head_bundle),
                "placement_group": pg,
                "placement_group_bundle_index": 0,
            }
            pg_hex = pg.id.hex()
        else:
            # per-trial override (ResourceChangingScheduler) wins over the
            # experiment-wide resources_per_trial; getattr covers Trial
            # objects unpickled from pre-`resources`-field snapshots
            opts = _actor_options(getattr(trial, "resources", None) or self.resources)
            pg_hex = None
        actor = TrialActor.options(**opts).remote(trial.trial_id, self.experiment_name)
        config = trial.restore_config if trial.restore_config else trial.config
        trial.config = config
        trial.restore_config = None
        ref = actor.run.remote(self.trainable, config, trial.checkpoint_path, pg_hex)
        self._actors[trial.trial_id] = actor
        self._run_refs[trial.trial_id] = ref
        trial.status = RUNNING

    def _poll_awaiting_pg(self):
        """Retry PENDING gang reservations (capacity frees when finished
        trials return their placement groups). A reservation the CLUSTER
        cannot hold at all fails the trial instead of hanging the
        experiment silently (the autoscaler may still grow the cluster —
        infeasibility is judged against current total capacity)."""
        import time as _time

        for trial in list(self._awaiting_pg):
            pg = self._trial_pgs.get(trial.trial_id)
            if pg is not None and pg.wait(timeout_seconds=0.05):
                self._awaiting_pg.remove(trial)
                self._start_trial(trial)
                continue
            first = getattr(trial, "_pg_wait_since", None)
            if first is None:
                trial._pg_wait_since = _time.monotonic()
                continue
            if _time.monotonic() - first > 5.0 and self._pg_infeasible():
                trial.error = (
                    f"trial placement group {self.resources!r} exceeds total cluster "
                    "capacity; it can never be placed"
                )
                self._stop_trial(trial, ERROR)

    def _pg_infeasible(self) -> bool:
        from ray_tpu_torch.accelerators.gpu import fold_card

        total = ray_tpu_torch.cluster_resources()
        need = fold_card(self.resources.required_resources())
        return any(total.get(k, 0) < v for k, v in need.items() if v > 0)

    def _stop_trial(self, trial: Trial, status: str):
        actor = self._actors.pop(trial.trial_id, None)
        self._run_refs.pop(trial.trial_id, None)
        if trial in self._awaiting_pg:
            self._awaiting_pg.remove(trial)
        pg = self._trial_pgs.pop(trial.trial_id, None)
        if pg is not None:
            # return the gang reservation (paused trials re-reserve on
            # resume — holding bundles while paused would starve the
            # population, reference releases on pause too)
            from ray_tpu_torch.util.placement_group import remove_placement_group

            try:
                remove_placement_group(pg)
            except Exception:
                pass
        # stale reports die with the run — including their staged
        # checkpoint copies (otherwise /tmp accumulates one per dropped
        # report on STOP/PAUSE decisions)
        for rep in self._pending.pop(trial.trial_id, []) or []:
            src = rep.get("checkpoint_path")
            if src and "/trial_stage/" in src:
                shutil.rmtree(src, ignore_errors=True)
        if trial.is_finished or status in (TERMINATED, ERROR):
            shutil.rmtree(os.path.join(_stage_root(), trial.trial_id), ignore_errors=True)
        if actor is not None:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        trial.status = status
        self._dirty = True
        if trial.is_finished:
            self.searcher.on_trial_complete(trial.trial_id, result=trial.last_result, error=status == ERROR)
            self.scheduler.on_trial_complete(self, trial)
            self._notify("log_trial_end", trial)

    def _active_count(self) -> int:
        """Trials consuming a concurrency slot: RUNNING plus those whose
        gang reservation is queued (they hold a slot so max_concurrent
        bounds total admission, not just placed trials)."""
        return sum(t.status == RUNNING for t in self.trials) + len(self._awaiting_pg)

    def _resume_paused(self):
        for trial in self.trials:
            if trial.status == PAUSED and self._active_count() < self.max_concurrent:
                self._start_trial(trial)

    def _poll_running(self):
        """One scheduler decision per trial per tick: trials advance in
        lockstep even when a fast trial's reports all arrived at once, so
        comparative schedulers (ASHA/median/PBT) see contemporaneous
        snapshots (the reference delivers results one at a time too)."""
        running = [t for t in self.trials if t.status == RUNNING]
        if not running:
            return
        refs = [self._run_refs[t.trial_id] for t in running]
        ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=POLL_INTERVAL_S)
        for trial in running:
            actor = self._actors.get(trial.trial_id)
            if actor is None:
                continue
            pending = self._pending.setdefault(trial.trial_id, [])
            try:
                p = ray_tpu_torch.get(actor.poll.remote())
                pending.extend(p["reports"])
            except Exception:
                trial.error = "actor died"
                self._finish_or_retry(trial)
                continue
            decision = sched.CONTINUE
            if pending:
                decision = self._process_report(trial, pending.pop(0))
            if decision == sched.STOP:
                self._stop_trial(trial, TERMINATED)
                continue
            if decision == sched.PAUSE:
                self._stop_trial(trial, PAUSED)
                continue
            # completion check: only once every report has been consumed
            ref = self._run_refs.get(trial.trial_id)
            if not pending and ref is not None:
                ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
                if ready:
                    # the run may have finished (and enqueued reports)
                    # between our poll above and this check — drain again
                    try:
                        pending.extend(ray_tpu_torch.get(actor.poll.remote())["reports"])
                    except Exception:
                        pass
                    if pending:
                        continue  # process them on subsequent ticks
                    try:
                        ray_tpu_torch.get(ref)
                        self._stop_trial(trial, TERMINATED)
                    except Exception as e:
                        trial.error = str(e)
                        self._finish_or_retry(trial)

    def _process_report(self, trial: Trial, rep: dict) -> str:
        trial.iteration += 1
        metrics = dict(rep["metrics"])
        metrics.setdefault("training_iteration", trial.iteration)
        metrics["trial_id"] = trial.trial_id
        if rep["checkpoint_path"]:
            trial.checkpoint_path = self._commit_checkpoint(trial, rep["checkpoint_path"])
        trial.last_result = metrics
        trial.metrics_history.append(metrics)
        self._dirty = True
        self._notify("log_trial_result", trial, metrics)
        return self.scheduler.on_trial_result(self, trial, metrics)

    def _finish_or_retry(self, trial: Trial):
        n = self._failures.get(trial.trial_id, 0)
        if n < self.max_failures:
            self._failures[trial.trial_id] = n + 1
            self._stop_trial(trial, PAUSED)  # requeue from last checkpoint
        else:
            self._stop_trial(trial, ERROR)

    def _commit_checkpoint(self, trial: Trial, src: str) -> str:
        dest = os.path.join(self.run_dir, trial.trial_id, f"checkpoint_{trial.iteration:06d}")
        os.makedirs(dest, exist_ok=True)
        if os.path.isdir(src):
            shutil.copytree(src, dest, dirs_exist_ok=True)
            if "/trial_stage/" in src:
                shutil.rmtree(src, ignore_errors=True)  # reap the staging copy
        return dest
