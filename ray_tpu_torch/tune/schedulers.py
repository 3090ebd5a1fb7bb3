"""Trial schedulers (port of ray_tpu/tune/schedulers.py): FIFO, ASHA,
median stopping, PBT, PB2 (its GP bandit in numpy) and the
resource-changing scheduler over the port's ``cluster_resources()``.
Decisions are returned to the controller per reported result; given the
same results (and seed), each decides exactly what ray_tpu's does.
"""

from __future__ import annotations

import numpy as np

CONTINUE = "CONTINUE"
STOP = "STOP"
PAUSE = "PAUSE"


class TrialScheduler:
    def on_trial_result(self, controller, trial, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, controller, trial):
        pass


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference: schedulers/hyperband.py
    / async_hyperband): rungs at grace_period * reduction_factor^k; a trial
    reaching a rung stops unless in the top 1/reduction_factor of metric
    values recorded at that rung."""

    def __init__(
        self,
        metric: str = None,
        mode: str = "max",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
        time_attr: str = "training_iteration",
    ):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.eta = reduction_factor
        self.time_attr = time_attr
        self.rungs: dict[int, dict[str, float]] = {}  # rung -> trial -> value
        r = grace_period
        while r < max_t:
            self.rungs[r] = {}
            r *= reduction_factor

    def _sign(self, v):
        return v if self.mode == "max" else -v

    def on_trial_result(self, controller, trial, result):
        t = result.get(self.time_attr, trial.iteration)
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        for rung in sorted(self.rungs, reverse=True):
            if t >= rung:
                # record on the FIRST result at-or-past the milestone, so
                # time_attrs that skip exact rung values still participate
                if trial.trial_id not in self.rungs[rung]:
                    self.rungs[rung][trial.trial_id] = self._sign(metric)
                # re-evaluate the trial's recorded value at its latest rung
                # every report: a trial that passed a rung early (before
                # peers arrived) still stops once the cutoff moves above it
                vals = self.rungs[rung]
                if trial.trial_id not in vals or len(vals) < self.eta:
                    return CONTINUE
                cutoff = np.percentile(list(vals.values()), (1 - 1 / self.eta) * 100)
                return CONTINUE if vals[trial.trial_id] >= cutoff else STOP
        return CONTINUE


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-mean metric is worse than the median of
    other trials' running means at the same step (reference:
    schedulers/median_stopping_rule.py)."""

    def __init__(self, metric=None, mode="max", grace_period=1, min_samples_required=3, time_attr="training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self.histories: dict[str, list[float]] = {}

    def on_trial_result(self, controller, trial, result):
        metric = result.get(self.metric)
        t = result.get(self.time_attr, trial.iteration)
        if metric is None:
            return CONTINUE
        h = self.histories.setdefault(trial.trial_id, [])
        h.append(float(metric))
        if t <= self.grace:
            return CONTINUE
        # other trials' running means so far (clipped to this trial's step
        # when they are ahead; used as-is when behind — poll order must not
        # decide whether a comparison happens)
        means = [
            float(np.mean(v[: len(h)]))
            for k, v in self.histories.items()
            if k != trial.trial_id and len(v) > self.grace
        ]
        if len(means) < self.min_samples:
            return CONTINUE
        med = float(np.median(means))
        mine = float(np.mean(h))
        worse = mine < med if self.mode == "max" else mine > med
        return STOP if worse else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: schedulers/pbt.py): every perturbation_interval, the
    bottom-quantile trial clones the checkpoint + config of a top-quantile
    trial (exploit), then perturbs mutation hyperparams (explore: x1.2 /
    x0.8, or resample)."""

    def __init__(
        self,
        metric=None,
        mode="max",
        perturbation_interval: int = 5,
        hyperparam_mutations: dict | None = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        time_attr: str = "training_iteration",
        seed: int | None = None,
    ):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.time_attr = time_attr
        self.rng = np.random.default_rng(seed)
        self.last_perturb: dict[str, int] = {}

    def _score(self, trial):
        v = trial.metric_at(self.metric)
        if v is None:
            return None
        return v if self.mode == "max" else -v

    def on_trial_result(self, controller, trial, result):
        t = result.get(self.time_attr, trial.iteration)
        if t - self.last_perturb.get(trial.trial_id, 0) < self.interval:
            return CONTINUE
        self.last_perturb[trial.trial_id] = t
        trials = [tr for tr in controller.trials if self._score(tr) is not None]
        if len(trials) < 2:
            return CONTINUE
        ranked = sorted(trials, key=self._score)
        k = max(1, int(len(ranked) * self.quantile))
        bottom = ranked[:k]
        top = ranked[-k:]
        if trial in bottom and trial not in top:
            donor = top[int(self.rng.integers(0, len(top)))]
            if donor.checkpoint_path is None:
                return CONTINUE  # nothing to exploit yet; keep training
            new_config = self._explore(dict(donor.config))
            controller.request_exploit(trial, donor, new_config)
            return PAUSE  # controller restarts the trial with the new state
        return CONTINUE

    def _explore(self, config: dict) -> dict:
        for k, spec in self.mutations.items():
            if self.rng.random() < self.resample_p or k not in config:
                if isinstance(spec, list):
                    config[k] = spec[int(self.rng.integers(0, len(spec)))]
                elif callable(spec):
                    config[k] = spec()
                else:
                    config[k] = spec.sample(self.rng)
            elif isinstance(config[k], (int, float)) and not isinstance(config[k], bool):
                factor = 1.2 if self.rng.random() > 0.5 else 0.8
                config[k] = type(config[k])(config[k] * factor)
            elif isinstance(spec, list):
                config[k] = spec[int(self.rng.integers(0, len(spec)))]
        return config


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: tune/schedulers/pb2.py; Parker-
    Holder et al. 2020): PBT where EXPLORE is not a random x0.8/x1.2
    perturbation but a GP-bandit suggestion — a Gaussian process is fit on
    (hyperparams -> observed reward improvement) across the population's
    recent perturbation intervals, and the exploited trial's new config
    maximizes the UCB acquisition over the bounded search space. Much more
    sample-efficient than PBT at small population sizes, where random
    perturbations rarely hit good regions.

    hyperparam_bounds: {name: (low, high)} continuous bounds (the PB2
    formulation is continuous); pass hyperparam_mutations for any
    categorical params to keep them on PBT's resample/perturb explore.
    """

    def __init__(
        self,
        metric=None,
        mode="max",
        perturbation_interval: int = 5,
        hyperparam_bounds: dict | None = None,
        quantile_fraction: float = 0.25,
        time_attr: str = "training_iteration",
        seed: int | None = None,
        ucb_kappa: float = 2.0,
        num_candidates: int = 256,
        hyperparam_mutations: dict | None = None,
    ):
        super().__init__(
            metric=metric,
            mode=mode,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations=hyperparam_mutations or {},
            quantile_fraction=quantile_fraction,
            time_attr=time_attr,
            seed=seed,
        )
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds={name: (low, high), ...}")
        self.bounds = {k: (float(lo), float(hi)) for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = float(ucb_kappa)
        self.num_candidates = int(num_candidates)
        # observations: rows of (normalized hyperparams, reward delta)
        self._obs_x: list[list[float]] = []
        self._obs_y: list[float] = []
        self._last_score: dict[str, float] = {}

    # -- data collection: reward improvement per interval, tagged with the
    # config that produced it --
    def on_trial_result(self, controller, trial, result):
        score = self._score(trial)
        if score is not None:
            t = result.get(self.time_attr, trial.iteration)
            # snapshot the score only at interval BOUNDARIES: y is then
            # the whole interval's improvement under trial.config, not a
            # single noisy step delta
            if t - self.last_perturb.get(trial.trial_id, 0) >= self.interval:
                prev = self._last_score.get(trial.trial_id)
                if prev is not None:
                    self._obs_x.append(self._normalize(trial.config))
                    self._obs_y.append(score - prev)
                    if len(self._obs_y) > 512:  # bounded memory, recent wins
                        self._obs_x.pop(0)
                        self._obs_y.pop(0)
                self._last_score[trial.trial_id] = score
        decision = super().on_trial_result(controller, trial, result)
        if decision == PAUSE:
            # exploited: the trial resumes from the DONOR's checkpoint, so
            # its next score jump reflects the clone, not training under
            # the suggested config — drop the baseline or the GP learns
            # self-confirming inflated improvements
            self._last_score.pop(trial.trial_id, None)
        return decision

    def _normalize(self, config: dict) -> list[float]:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / max(hi - lo, 1e-12))
        return out

    def _denormalize(self, x, config: dict | None = None) -> dict:
        out = {}
        for xi, (k, (lo, hi)) in zip(x, self.bounds.items()):
            v = lo + float(xi) * (hi - lo)
            # integer-valued hyperparams (batch size, layer count) keep
            # their type across exploits, like PBT's type-preserving explore
            if config is not None and isinstance(config.get(k), int) and not isinstance(config.get(k), bool):
                v = int(round(v))
            out[k] = v
        return out

    # -- GP-UCB explore for bounded params (categoricals first go
    # through PBT's resample/perturb when hyperparam_mutations given) --
    def _explore(self, config: dict) -> dict:
        if self.mutations:
            config = super()._explore(dict(config))
        cand = self.rng.random((self.num_candidates, len(self.bounds)))
        if len(self._obs_y) >= 3:
            X = np.asarray(self._obs_x, dtype=np.float64)
            y = np.asarray(self._obs_y, dtype=np.float64)
            y = (y - y.mean()) / (y.std() + 1e-9)
            # GP with RBF kernel (PB2 uses a time-varying SE kernel; the
            # bounded-recency observation window plays the decay role)
            ls = 0.2
            noise = 1e-2

            def k_rbf(A, B):
                d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
                return np.exp(-d2 / (2 * ls * ls))

            K = k_rbf(X, X) + noise * np.eye(len(X))
            try:
                L = np.linalg.cholesky(K)
                alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
                Ks = k_rbf(X, cand)  # [n_obs, n_cand]
                mu = Ks.T @ alpha
                v = np.linalg.solve(L, Ks)
                var = np.clip(1.0 - (v * v).sum(0), 1e-9, None)
                ucb = mu + self.kappa * np.sqrt(var)
                best = cand[int(np.argmax(ucb))]
            except np.linalg.LinAlgError:
                best = cand[int(self.rng.integers(0, len(cand)))]
        else:
            best = cand[int(self.rng.integers(0, len(cand)))]
        new = dict(config)
        new.update(self._denormalize(best, config))
        return new


class DistributeResources:
    """Default resources_allocation_function (reference:
    tune/schedulers/resource_changing_scheduler.py DistributeResources):
    split the cluster's CPUs evenly across unfinished trials — finished
    trials release their share, so survivors grow over time.

    The integer remainder goes to the earliest live trials in submission
    order, NOT to the best-ranked ones (a deliberate deviation from the
    reference): a metric-rank flip between two trials' reports would make
    BOTH claim the same slack CPU, and the oversubscribed relaunch could
    never be placed — deadlocking the experiment. Submission order is
    stable between reports, so the proposed totals never exceed the
    cluster."""

    def __init__(self, metric: str | None = None, mode: str = "max"):
        # metric/mode kept for call-site compatibility with the reference
        # signature; allocation is metric-independent (see class docstring)
        self.metric = metric
        self.mode = mode

    def __call__(self, controller, trial, result: dict) -> dict | None:
        import ray_tpu_torch

        total = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        live = [t for t in controller.trials if not t.is_finished]
        if not live:
            return None
        # while the searcher may still suggest trials, keep one 1-CPU slot
        # free: growing the lone live trial to the whole cluster would make
        # a later suggestion unplaceable (and the controller's blocking
        # poll would never shrink the hog)
        slots = len(live) if getattr(controller, "_exhausted", True) else len(live) + 1
        if total < slots:
            return None
        base, slack = divmod(total, slots)
        bonus = 1 if trial in live[:slack] else 0
        return {"CPU": base + bonus}


class ResourceChangingScheduler(TrialScheduler):
    """Wrap a base scheduler and grow/shrink each trial's resources at
    checkpoint boundaries (reference:
    tune/schedulers/resource_changing_scheduler.py).

    Every `reallocate_interval` results per trial, the allocation function
    proposes a resource dict; if it differs from the trial's current one,
    the trial is PAUSED (checkpointing it) and relaunched by the
    controller with the new footprint — the same pause/resume seam PBT
    exploitation uses, so no new trial-actor machinery."""

    def __init__(self, base_scheduler: TrialScheduler | None = None, resources_allocation_function=None, metric: str | None = None, mode: str | None = None, reallocate_interval: int = 1):
        # metric/mode default to None (NOT "max") so a base scheduler's own
        # explicit mode survives construction; the Tuner injects the
        # experiment's metric/mode into None attributes, which the setters
        # below then propagate
        self.base = base_scheduler or FIFOScheduler()
        self.alloc = resources_allocation_function or DistributeResources(metric, mode or "max")
        self.interval = max(1, reallocate_interval)
        self._since: dict[str, int] = {}
        self.metric = metric  # via the propagating setters below
        self.mode = mode

    # the Tuner injects its metric/mode into the scheduler when unset
    # (tuner.py); this wrapper IS the experiment's scheduler, so those
    # values must reach the wrapped scheduler and the default allocator
    # too — or a metric-less base ASHA silently no-ops (result.get(None)).
    # A base constructed with an EXPLICIT metric is treated as fully
    # self-configured: neither its metric nor its mode is ever overwritten
    # (the user may deliberately schedule on a different metric than the
    # experiment reports best on).
    def _base_self_configured(self) -> bool:
        return getattr(self.base, "metric", None) is not None and not getattr(self, "_base_adopted", False)

    @property
    def metric(self):
        return self._metric

    @metric.setter
    def metric(self, value):
        self._metric = value
        if value is not None:
            if hasattr(self.base, "metric") and not self._base_self_configured():
                self.base.metric = value
                self._base_adopted = True  # keep following wrapper updates
            if isinstance(self.alloc, DistributeResources):
                self.alloc.metric = value

    @property
    def mode(self):
        return self._mode

    @mode.setter
    def mode(self, value):
        self._mode = value
        if value is not None:
            if hasattr(self.base, "mode") and not self._base_self_configured():
                self.base.mode = value
            if isinstance(self.alloc, DistributeResources):
                self.alloc.mode = value

    def on_trial_result(self, controller, trial, result):
        decision = self.base.on_trial_result(controller, trial, result)
        if decision != CONTINUE:
            return decision
        current = trial.resources or controller.resources
        if not isinstance(current, dict):
            # PlacementGroupFactory trials gang-reserve a fixed footprint;
            # _start_trial ignores per-trial overrides there, so pausing
            # would only burn progress — no-op (the reference's PGF path
            # rebuilds factories instead; out of scope here)
            return CONTINUE
        if trial.checkpoint_path is None:
            # resizing relaunches from the last checkpoint; without one the
            # trial would restart from scratch (same guard as PBT exploit)
            return CONTINUE
        self._since[trial.trial_id] = self._since.get(trial.trial_id, 0) + 1
        if self._since[trial.trial_id] < self.interval:
            return CONTINUE
        self._since[trial.trial_id] = 0
        new = self.alloc(controller, trial, result)
        if new is None:
            return CONTINUE
        if new == {k: current.get(k) for k in new}:
            return CONTINUE
        # merge: keys the allocator didn't mention (e.g. TPU) keep their
        # current values rather than being dropped
        trial.resources = {**current, **new}
        return PAUSE

    def on_trial_complete(self, controller, trial):
        self.base.on_trial_complete(controller, trial)
