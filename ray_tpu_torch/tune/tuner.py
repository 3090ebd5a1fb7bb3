"""Tuner: the public entry (port of ray_tpu/tune/tuner.py): ``Tuner``,
``TuneConfig``, ``Tuner.restore`` and ``can_restore``, ``run``,
``with_parameters`` and a trainer as the trainable.

Trainables travel by reference, as the port's train loops do: a
module-level function or class, a ``functools.partial`` of one, or a
picklable instance (``with_parameters``, ``with_resources`` and a
trainer's ``_FitTrainer`` are module-level classes here, where ray_tpu's
are closures). A lambda or closure trainable, and a ``sample_from``
lambda, raise TypeError at ``fit()`` before any trial starts; so does
anything else in the experiment's snapshot (stdlib pickle) that does not
pickle. ``Tuner.restore`` reads that snapshot with ``pickle``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ray_tpu_torch.tune.resources import _WithResources
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclass
class TuneConfig:
    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    search_alg: Searcher | None = None
    scheduler: object = None
    seed: int | None = None


class Tuner:
    def __init__(
        self,
        trainable,
        *,
        param_space: dict | None = None,
        tune_config: TuneConfig | None = None,
        run_config=None,
    ):
        from ray_tpu_torch.train.config import RunConfig

        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_state: dict | None = None
        self._restore_opts: dict = {}

    # ---------------- restore ----------------
    @staticmethod
    def can_restore(path: str) -> bool:
        from ray_tpu_torch.tune.tune_controller import TuneController

        return os.path.exists(os.path.join(path, TuneController.SNAPSHOT_NAME))

    @classmethod
    def restore(
        cls,
        path: str,
        trainable,
        *,
        resume_errored: bool = False,
        restart_errored: bool = False,
        param_space: dict | None = None,
        run_config=None,
    ) -> "Tuner":
        """Resume an experiment from its run_dir snapshot (reference:
        Tuner.restore + tune/execution/experiment_state.py). Live trials
        continue from their last committed checkpoint; errored trials are
        resumed/restarted per the flags; finished trials keep results."""
        import pickle

        from ray_tpu_torch.train.config import RunConfig
        from ray_tpu_torch.tune.tune_controller import TuneController

        snap_path = os.path.join(path, TuneController.SNAPSHOT_NAME)
        with open(snap_path, "rb") as f:
            state = pickle.load(f)
        if run_config is None:
            run_config = RunConfig()
        # the experiment identity always comes from the snapshot path;
        # everything else (callbacks, failure config) is re-suppliable
        run_config.name = os.path.basename(os.path.normpath(path))
        run_config.storage_path = os.path.dirname(os.path.normpath(path))
        tuner = cls(
            trainable,
            param_space=param_space,
            tune_config=TuneConfig(metric=state.get("metric"), mode=state.get("mode", "max")),
            run_config=run_config,
        )
        tuner._restore_state = state
        tuner._restore_opts = {"resume_errored": resume_errored, "restart_errored": restart_errored}
        return tuner

    def fit(self) -> ResultGrid:
        import ray_tpu_torch

        tc = self.tune_config
        searcher = tc.search_alg or BasicVariantGenerator(num_samples=tc.num_samples, seed=tc.seed)
        searcher.set_search_properties(tc.metric, tc.mode, self.param_space)
        scheduler = tc.scheduler
        if scheduler is not None:
            # schedulers built without an explicit metric inherit TuneConfig's
            # (otherwise result.get(None) silently degrades them to FIFO)
            if getattr(scheduler, "metric", "absent") is None:
                scheduler.metric = tc.metric
            if getattr(scheduler, "mode", None) is None:
                scheduler.mode = tc.mode

        trainable, resources = _normalize_trainable(self.trainable)
        # before any runtime or trial starts: the trainable must travel to
        # the trial actors, and the snapshot must pickle
        _check_trainable(trainable)
        _check_snapshot(self.param_space, searcher, scheduler)
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        run_dir = os.path.join(self.run_config.storage_path, self.run_config.name)
        controller = TuneController(
            trainable,
            searcher=searcher,
            scheduler=scheduler,
            metric=tc.metric,
            mode=tc.mode,
            max_concurrent=tc.max_concurrent_trials,
            run_dir=run_dir,
            experiment_name=self.run_config.name,
            resources_per_trial=resources,
            max_failures_per_trial=self.run_config.failure_config.max_failures,
            callbacks=list(self.run_config.callbacks or []),
        )
        if self._restore_state is not None:
            controller.load_snapshot(self._restore_state, **self._restore_opts)
            self._restore_state = None
        trials = controller.run()
        return ResultGrid(trials, run_dir)


def _check_trainable(trainable):
    """TypeError naming the difference when a worker could not import the
    trainable's code (a lambda or a closure), looked for inside the
    port's wrappers."""
    from ray_tpu_torch.data.dataset import check_udf

    while isinstance(trainable, (_WithResources, _WithParameters)):
        trainable = trainable.trainable if isinstance(trainable, _WithResources) else trainable.fn
    if isinstance(trainable, _FitTrainer):
        check_udf(trainable.base.train_loop_per_worker, "train_loop_per_worker")
    else:
        check_udf(trainable, "trainable")


def _check_snapshot(space: dict, searcher, scheduler):
    """TypeError naming the difference when the experiment's snapshot
    (stdlib pickle, read by ``Tuner.restore``) could not hold the search
    space, the searcher or the scheduler: a ``sample_from`` lambda or
    closure, or other code without an importable name, anywhere in them."""
    import pickle

    from ray_tpu_torch.core.serialization import _DIFFERENCE

    try:
        pickle.dumps({"space": space, "searcher": searcher, "scheduler": scheduler}, protocol=5)
    except Exception as e:  # noqa: BLE001
        raise TypeError(f"the experiment's snapshot (param_space, searcher {searcher!r}, scheduler {scheduler!r}) "
                        f"does not pickle ({e}): Tuner.restore needs it. Use functions and classes defined at the "
                        f"top level of a module, in sample_from too. {_DIFFERENCE}") from e


class _FitTrainer:
    """A trainer as a trainable: re-fits a copy of the trainer with the
    trial's config merged into ``train_loop_config``, then reports the
    fit's history to the trial (ray_tpu's ``fit_trainer`` closure as a
    module-level class, so that it travels to the trial actor)."""

    def __init__(self, base):
        self.base = base

    def __call__(self, config):
        from ray_tpu_torch.train import context as _ctx
        from ray_tpu_torch.train import report

        base = self.base
        merged = dict(base.train_loop_config or {})
        merged.update(config)
        trainer = type(base)(
            base.train_loop_per_worker,
            train_loop_config=merged,
            scaling_config=base.scaling_config,
            run_config=base.run_config,
            backend_config=base.backend_config,
            datasets=base.datasets,
        )
        outer_ctx = _ctx.get_context()
        result = trainer.fit(raise_on_error=False)
        _ctx.set_context(outer_ctx)  # the trial's context, whatever the fit left in this process
        if result.error is not None:
            # the worker's error rides along, so the trial's error names it
            raise result.error from getattr(result.error, "training_error", None)
        for m in result.metrics_history:
            report(dict(m))


def _normalize_trainable(trainable):
    """Function trainables run as-is; a DataParallelTrainer instance becomes
    a ``_FitTrainer`` that re-fits with the trial's config merged into
    train_loop_config (reference: Tuner(trainer) integration)."""
    from ray_tpu_torch.train.trainer import DataParallelTrainer

    if isinstance(trainable, DataParallelTrainer):
        base = trainable
        fit_trainer = _FitTrainer(base)
        explicit = getattr(base, "_tune_resources", None)
        if explicit is not None:
            return fit_trainer, explicit
        # ray_tpu's branch for a TPU slice trainer (use_tpu with a
        # topology) has no counterpart: the port's ScalingConfig raises
        # on it. Gang-reserve the trainer's WHOLE footprint per trial:
        # driver bundle + one bundle per train worker, each with the
        # worker's resources ("GPU" among them: one card admits one
        # trainer trial at a time, the rest wait PENDING)
        from ray_tpu_torch.tune.resources import PlacementGroupFactory

        sc = base.scaling_config
        bundles = [{"CPU": 0.5}] + [dict(sc._worker_resources) for _ in range(sc.num_workers)]
        return fit_trainer, PlacementGroupFactory(bundles)
    if callable(trainable):
        return trainable, getattr(trainable, "_tune_resources", {"CPU": 1})
    raise TypeError(f"unsupported trainable: {type(trainable)}")


class _WithParameters:
    """A trainable with bound values (ray_tpu's ``with_parameters``
    closure as a module-level class: it carries its values with it to
    the trial actor)."""

    def __init__(self, fn, params: dict):
        self.fn = fn
        self.params = params
        if hasattr(fn, "_tune_resources"):
            self._tune_resources = fn._tune_resources

    def __call__(self, config):
        return self.fn(config, **self.params)


def with_parameters(fn, **params):
    """Bind large objects to a trainable (reference: tune.with_parameters)."""
    return _WithParameters(fn, params)


def run(trainable, *, config=None, num_samples=1, metric=None, mode="max", scheduler=None, search_alg=None, **kw):
    """Legacy API (reference: tune.run, tune/tune.py:1161)."""
    t = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric, mode=mode, num_samples=num_samples, scheduler=scheduler, search_alg=search_alg
        ),
    )
    return t.fit()
