"""TrainController: the training run's state machine (port of
ray_tpu/train/controller.py).

Each attempt starts a worker group, runs the backend's hooks and the
user loop, polls the workers and commits every report round that all
ranks have reached, in order: metrics from rank 0, the checkpoint the
union of every rank's files, copied into the run's directory and
registered with the top-k manager. A failed attempt restarts the whole
group from the latest committed checkpoint while the failure policy
allows; a scaling policy's resize is a restart that spends no failure.
The controller runs in the driver's process."""

from __future__ import annotations

import logging
import os
import shutil
import time

import ray_tpu_torch
from ray_tpu_torch.train._checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.errors import TrainingFailedError
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)

POLL_INTERVAL_S = float(os.environ.get("RT_TRAIN_POLL_INTERVAL_S", "0.05"))


class _ResizeRestart(Exception):
    """Internal signal: the scaling policy requested a new group size —
    restart at the boundary (checkpoint-resume), not a failure."""

    def __init__(self, num_workers: int, reason: str):
        super().__init__(f"resize to {num_workers} workers: {reason}")
        self.num_workers = num_workers


class TrainController:
    def __init__(
        self,
        train_fn,
        train_fn_config,
        scaling_config,
        run_config,
        backend_config,
        datasets: dict | None = None,
        scaling_policy=None,
    ):
        from ray_tpu_torch.train.scaling_policy import FixedScalingPolicy

        self.train_fn = train_fn
        self.train_fn_config = train_fn_config
        self.scaling = scaling_config
        self.scaling_policy = scaling_policy or FixedScalingPolicy(scaling_config)
        self.run_config = run_config
        self.backend_config = backend_config
        self.backend = backend_config.backend_cls()
        self.datasets = datasets or {}
        self.run_dir = os.path.join(run_config.storage_path, run_config.name)
        self.ckpt_manager = CheckpointManager(self.run_dir, run_config.checkpoint_config)
        self.metrics_history: list[dict] = []
        self.resume_checkpoint = None  # user-provided seed; never evicted
        self._restarts = 0
        self._coordinators: list = []  # this attempt's streaming_split coordinator actors
        # RunConfig.callbacks (the tune.callbacks API): the whole run logs
        # as one pseudo-trial keyed by the experiment name
        self._callbacks = list(getattr(run_config, "callbacks", None) or [])
        if self._callbacks:
            from types import SimpleNamespace

            self._cb_trial = SimpleNamespace(trial_id=run_config.name, config=dict(train_fn_config or {}))
            for cb in self._callbacks:
                try:
                    cb.setup(self.run_dir)
                except Exception:
                    pass

    # ---------------- main entry ----------------
    def run(self) -> Result:
        import dataclasses

        max_failures = self.run_config.failure_config.max_failures
        while True:
            # the scaling policy sizes each attempt (elastic policies fit
            # the current cluster)
            n = self.scaling_policy.workers_for_attempt()
            attempt_scaling = (
                dataclasses.replace(self.scaling, num_workers=n) if n != self.scaling.num_workers else self.scaling
            )
            group = WorkerGroup(
                attempt_scaling,
                self.run_config.name,
                env_vars=getattr(self.backend_config, "env_vars", None),
            )
            try:
                error = self._run_attempt(group)
            finally:
                try:
                    self.backend.on_shutdown(group, self.backend_config)
                except Exception:
                    pass
                group.shutdown()
                self._reap_coordinators()
                if group.attempt_uid is not None:
                    # reap this attempt's detached train-collective actor
                    from ray_tpu_torch.collective.collective import cleanup_group_actor
                    from ray_tpu_torch.train.collective import group_name_for_attempt

                    cleanup_group_actor(group_name_for_attempt(self.run_config.name, group.attempt_uid))
            if isinstance(error, _ResizeRestart):
                # elastic boundary: resume from the latest committed
                # checkpoint at the new size; not a failure, so it spends
                # no restart
                logger.info("elastic resize: %s", error)
                continue
            if error is None:
                self._finish_callbacks()
                latest = self.ckpt_manager.latest_checkpoint
                return Result(
                    metrics=self.metrics_history[-1] if self.metrics_history else None,
                    checkpoint=latest,
                    path=self.run_dir,
                    metrics_history=self.metrics_history,
                    best_checkpoints=self.ckpt_manager.best_checkpoints(),
                )
            self._restarts += 1
            if max_failures >= 0 and self._restarts > max_failures:
                return Result(
                    metrics=self.metrics_history[-1] if self.metrics_history else None,
                    checkpoint=self.ckpt_manager.latest_checkpoint,
                    path=self.run_dir,
                    error=TrainingFailedError(
                        f"training failed after {self._restarts - 1} restart(s)", error
                    ),
                    metrics_history=self.metrics_history,
                    best_checkpoints=self.ckpt_manager.best_checkpoints(),
                )
            logger.warning(
                "worker group failed (%s); restart %d/%s from %s",
                error,
                self._restarts,
                max_failures if max_failures >= 0 else "inf",
                self.ckpt_manager.latest_checkpoint,
            )

    # ---------------- one worker-group attempt ----------------
    def _run_attempt(self, group: WorkerGroup):
        latest = self.ckpt_manager.latest_checkpoint or self.resume_checkpoint
        group.start(
            latest_checkpoint_path=latest.path if latest else None,
            dataset_split_fn=self._split_datasets,
        )
        self.backend.on_start(group, self.backend_config)
        self.backend.on_training_start(group, self.backend_config)

        run_refs = group.run_train_async(self.train_fn, self.train_fn_config)
        pending_rounds: dict[int, dict[int, dict]] = {}  # seq -> rank -> report
        state = {"committed": 0}
        done = [False] * len(group)

        from ray_tpu_torch.train.scaling_policy import ResizeDecision

        while not all(done):
            ready, _ = ray_tpu_torch.wait(run_refs, num_returns=len(run_refs), timeout=POLL_INTERVAL_S)
            try:
                self._drain_and_commit(group, pending_rounds, state)
            except Exception as e:  # worker died hard
                return e
            for ref in ready:
                i = run_refs.index(ref)
                if not done[i]:
                    try:
                        ray_tpu_torch.get(ref)
                        done[i] = True
                    except Exception as e:
                        return e
            # resize only between rounds of a still-running group: a
            # decision landing after completion must not discard the
            # finished attempt
            if not all(done):
                decision = self.scaling_policy.poll_running(len(group))
                if isinstance(decision, ResizeDecision) and decision.num_workers != len(group):
                    return _ResizeRestart(decision.num_workers, decision.reason)
        # drain any reports that landed after the loop observed completion
        try:
            self._drain_and_commit(group, pending_rounds, state)
        except Exception:
            pass
        return None

    def _drain_and_commit(self, group, pending_rounds, state):
        """Poll all workers; commit every round (in order) that every rank
        has reached."""
        polls = group.poll()
        for rank, p in enumerate(polls):
            for rep in p["reports"]:
                pending_rounds.setdefault(rep["seq"], {})[rank] = rep
        nxt = state["committed"] + 1
        while len(pending_rounds.get(nxt, ())) == len(group):
            self._commit_round(pending_rounds.pop(nxt))
            state["committed"] = nxt
            nxt += 1

    # ---------------- checkpoint commit ----------------
    def _commit_round(self, rank_reports: dict[int, dict]):
        """Metrics from rank 0; checkpoint = union of every rank's files
        (rank 0 wins name clashes), so per-rank checkpoint files land in
        one directory."""
        metrics = dict(rank_reports[0]["metrics"])
        ckpt = None
        if any(r["checkpoint_path"] for r in rank_reports.values()):
            dest = self.ckpt_manager.new_checkpoint_dir(rank_reports[0].get("checkpoint_dir_name"))
            for rank in sorted(rank_reports, reverse=True):  # rank 0 last => wins
                src = rank_reports[rank]["checkpoint_path"]
                if src and os.path.isdir(src):
                    shutil.copytree(src, dest, dirs_exist_ok=True)
            ckpt = Checkpoint(dest)
            self.ckpt_manager.register_checkpoint(ckpt, metrics)
            metrics["checkpoint_dir_name"] = os.path.basename(dest)
        metrics.setdefault("training_iteration", len(self.metrics_history) + 1)
        metrics["timestamp"] = time.time()
        self.metrics_history.append(metrics)
        for cb in self._callbacks:
            try:
                cb.log_trial_result(self._cb_trial, metrics)
            except Exception:
                pass

    def _reap_coordinators(self):
        """Kill the attempt's split coordinators once its workers are gone:
        each is an actor with a worker of its own, which would otherwise
        live until the runtime's shutdown (a fit inside a Tune trial makes
        one per trial)."""
        for coord in self._coordinators:
            try:
                ray_tpu_torch.kill(coord)
            except Exception:
                pass
        self._coordinators = []

    def _finish_callbacks(self):
        for cb in self._callbacks:
            try:
                cb.log_trial_end(self._cb_trial)
                cb.on_experiment_end([self._cb_trial])
            except Exception:
                pass

    def _split_datasets(self, n: int):
        if not self.datasets:
            return [None] * n
        shards = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                pieces = ds.streaming_split(n)
                coords = (getattr(p, "_coord", None) for p in pieces)
                self._coordinators.extend({id(c): c for c in coords if c is not None}.values())
                for i, piece in enumerate(pieces):
                    shards[i][name] = piece
            else:
                for i in range(n):
                    shards[i][name] = ds
        return shards
