"""Exact parity of the port's searchers, schedulers and domains with
ray_tpu's, without a runtime: ``ray_tpu_torch/tune/search.py``,
``schedulers.py`` and ``search_space.py`` against ``ray_tpu/tune``'s, held
with ``==`` (no tolerance) on scripted inputs.

- Searchers: one seed and one scripted stream of completed results (some
  errored, some without the metric) interleaved with suggestions; the
  suggestion sequences of ``BasicVariantGenerator`` (grid x random, nested
  keys, a ``sample_from``), ``TPESearcher``, ``BayesOptSearcher`` and
  ``ConcurrencyLimiter`` (its waits included) must be equal.
- Schedulers: ASHA, median stopping, PBT (the exploit's donor and the
  explored config, seeded) and PB2 decide on one scripted stream of trial
  results against a stub controller that applies each decision as
  ``TuneController`` does (a stop ends the trial, a pause restarts it with
  the exploited config); every decision must be equal.
- Every domain's ``sample`` over one generator.
"""

import numpy as np
import pytest
import torch_tune_defs as defs

from ray_tpu import tune as jtune
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import trial as jtrial
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import trial as ttrial

MODS = {"ray_tpu": (jtune, jsched, jtrial), "ray_tpu_torch": (ttune, tsched, ttrial)}


def both(fn):
    """``fn(tune, schedulers, trial)`` on each package; the two outputs."""
    return [fn(*MODS[p]) for p in MODS]


def assert_equal(fn):
    ref, port = both(fn)
    assert port == ref
    return port


# ---------------------------------------------------------------- domains
def test_every_domain_samples_equal():
    def draws(tune, _s, _t):
        domains = [tune.choice([1, "a", None, 3.5]), tune.uniform(-2, 3), tune.quniform(0, 10, 0.5),
                   tune.loguniform(1e-4, 1e-1), tune.randint(3, 17), tune.lograndint(1, 1000), tune.randn(1.0, 2.0)]
        rng = np.random.default_rng(0)
        out = [[d.sample(rng) for d in domains] for _ in range(50)]
        out.append(tune.sample_from(defs.derived).sample(rng, {"a": 4}))
        return out

    out = assert_equal(draws)
    assert len({repr(row) for row in out[:-1]}) == 50  # the draws move


# ---------------------------------------------------------------- searchers
def _space(tune):
    return {"a": tune.uniform(0, 1), "y": tune.loguniform(1e-3, 1.0), "k": tune.choice(["p", "q", "r"]),
            "n": tune.randint(0, 8), "s": tune.sample_from(defs.derived), "lit": 5}


def _objective(cfg) -> float:
    return (cfg["a"] - 0.3) ** 2 + abs(np.log10(cfg["y"]) + 1.5) + {"p": 0.0, "q": 0.2, "r": 0.5}[cfg["k"]] \
        + 0.01 * cfg["n"]


def _drive(searcher, n_trials=20):
    """Suggest two ahead of each completion; every fifth completion errors,
    every seventh lacks the metric. The suggestion stream, waits included."""
    out, live = [], []
    i = done = 0
    while i < n_trials or live:
        while i < n_trials and len(live) < 2:
            tid = f"t{i}"
            cfg = searcher.suggest(tid)
            out.append((tid, cfg))
            i += 1
            if cfg is None or cfg == "__WAIT__":
                break
            live.append((tid, cfg))
        if not live:
            break
        tid, cfg = live.pop(0)
        done += 1
        if done % 5 == 0:
            searcher.on_trial_complete(tid, error=True)
        elif done % 7 == 0:
            searcher.on_trial_complete(tid, result={"other": 1.0})
        else:
            searcher.on_trial_complete(tid, result={"loss": _objective(cfg)})
    return out


def test_basic_variant_generator_grid_times_random_equal():
    def run(tune, _s, _t):
        space = {"g": tune.grid_search([1, 2, 3]), "a": tune.uniform(0, 1), "c": tune.choice(["x", "y"]),
                 "d": tune.loguniform(1e-3, 1), "e": tune.randint(0, 10), "r": tune.randn(),
                 "nested": {"h": tune.quniform(0, 1, 0.1), "i": 7}, "s": tune.sample_from(defs.derived), "lit": "v"}
        gen = tune.BasicVariantGenerator(num_samples=3, seed=11)
        gen.set_search_properties("loss", "min", space)
        out = []
        while (cfg := gen.suggest(f"t{len(out)}")) is not None:
            out.append(cfg)
        return out

    out = assert_equal(run)
    assert len(out) == 9 and [c["g"] for c in out[:3]] == [1, 2, 3]


@pytest.mark.parametrize("mode", ["min", "max"])
def test_tpe_searcher_suggestions_equal(mode):
    def run(tune, _s, _t):
        tpe = tune.TPESearcher(num_samples=20, metric="loss", mode=mode, n_startup_trials=5, n_candidates=32, seed=3)
        tpe.set_search_properties(None, None, _space(tune))
        return _drive(tpe)

    out = assert_equal(run)
    assert sum(cfg is not None for _, cfg in out) == 20


@pytest.mark.parametrize("mode", ["min", "max"])
def test_bayesopt_searcher_suggestions_equal(mode):
    def run(tune, _s, _t):
        bo = tune.BayesOptSearcher(num_samples=16, metric="loss", mode=mode, n_startup_trials=4, n_candidates=64,
                                   seed=5)
        bo.set_search_properties(None, None, _space(tune))
        return _drive(bo, n_trials=16)

    out = assert_equal(run)
    assert sum(cfg is not None for _, cfg in out) == 16


def test_concurrency_limiter_suggestions_equal():
    def run(tune, _s, _t):
        outs = []
        for inner in (tune.BasicVariantGenerator(num_samples=6, seed=2),
                      tune.TPESearcher(num_samples=12, metric="loss", mode="min", n_startup_trials=3,
                                       n_candidates=16, seed=9)):
            lim = tune.ConcurrencyLimiter(inner, max_concurrent=1)
            lim.set_search_properties("loss", "min", _space(tune))
            outs.append(_drive(lim, n_trials=14))
        return outs

    outs = assert_equal(run)
    assert any(cfg == "__WAIT__" for _, cfg in outs[0])  # the limiter held a suggestion back


def test_optuna_search_raises_import_error_where_absent():
    try:
        import optuna  # noqa: F401
    except ImportError:
        for tune in (jtune, ttune):
            with pytest.raises(ImportError, match="optuna"):
                tune.OptunaSearch(metric="loss", mode="min")
    else:
        pytest.skip("optuna is installed here")


# ---------------------------------------------------------------- schedulers
class StubController:
    """What a scheduler reads of ``TuneController``: its trials, the
    experiment's resources, whether the searcher is exhausted, and the
    PBT exploit hook (recorded)."""

    def __init__(self, trials):
        self.trials = trials
        self.resources = {"CPU": 1}
        self._exhausted = True
        self.exploits: list = []

    def request_exploit(self, trial, donor, new_config):
        trial.restore_config = new_config
        trial.checkpoint_path = donor.checkpoint_path
        self.exploits.append((trial.trial_id, donor.trial_id, sorted(new_config.items())))


def _stream(sched_mod, trial_mod, scheduler, configs, steps=12, seed=42):
    """Round-robin reports of scripted metrics (a seeded noise matrix plus
    a config term) through ``scheduler``, applied as the controller
    applies them; every decision, and the exploits."""
    noise = np.random.default_rng(seed).normal(size=(len(configs), steps))
    trials = [trial_mod.Trial(config=dict(c), trial_id=f"t{i}") for i, c in enumerate(configs)]
    ctrl = StubController(trials)
    decisions = []
    for step in range(steps):
        for i, trial in enumerate(trials):
            if trial.is_finished:
                continue
            trial.iteration += 1
            metrics = {"acc": float(noise[i, step] + 10.0 * trial.config.get("lr", 0.0) + 0.1 * step),
                       "training_iteration": trial.iteration, "step": step + 1}
            trial.checkpoint_path = f"ckpt/{trial.trial_id}/{step}"
            trial.last_result = metrics
            trial.metrics_history.append(metrics)
            decision = scheduler.on_trial_result(ctrl, trial, metrics)
            decisions.append((trial.trial_id, step, decision, sorted(trial.config.items())))
            if decision == sched_mod.STOP:
                trial.status = trial_mod.TERMINATED
                scheduler.on_trial_complete(ctrl, trial)
            elif decision == sched_mod.PAUSE:
                trial.config, trial.restore_config = trial.restore_config or trial.config, None
    return decisions, ctrl.exploits


def _configs(n=8):
    rng = np.random.default_rng(7)
    return [{"lr": float(rng.uniform(0.0, 0.1)), "bs": int(rng.choice([16, 32, 64])), "wd": float(rng.uniform(0, 0.1)),
             "opt": str(rng.choice(["adam", "sgd"]))} for _ in range(n)]


def test_asha_decisions_equal():
    def run(tune, sched, trial):
        return _stream(sched, trial, tune.ASHAScheduler(metric="acc", mode="max", max_t=10, grace_period=1,
                                                        reduction_factor=3), _configs())

    (decisions, _) = assert_equal(run)
    assert any(d[2] == "STOP" for d in decisions) and any(d[2] == "CONTINUE" for d in decisions)


def test_median_stopping_decisions_equal():
    def run(tune, sched, trial):
        return _stream(sched, trial, tune.MedianStoppingRule(metric="acc", mode="min", grace_period=2,
                                                             min_samples_required=3), _configs())

    (decisions, _) = assert_equal(run)
    assert any(d[2] == "STOP" for d in decisions)


def test_pbt_exploits_and_explores_equal():
    def run(tune, sched, trial):
        pbt = tune.PopulationBasedTraining(
            metric="acc", mode="max", perturbation_interval=2, quantile_fraction=0.25, resample_probability=0.3,
            hyperparam_mutations={"lr": [0.001, 0.01, 0.1], "bs": [16, 32, 64], "wd": tune.uniform(0.0, 0.1),
                                  "mom": defs.pbt_callable_spec},
            seed=0)
        return _stream(sched, trial, pbt, _configs())

    decisions, exploits = assert_equal(run)
    assert len(exploits) >= 3 and any(d[2] == "PAUSE" for d in decisions)


def test_pb2_exploits_and_gp_explores_equal():
    def run(tune, sched, trial):
        pb2 = tune.PB2(metric="acc", mode="max", perturbation_interval=2, quantile_fraction=0.25,
                       hyperparam_bounds={"lr": (0.0, 0.1), "wd": (0.0, 0.1)}, num_candidates=64,
                       hyperparam_mutations={"opt": ["adam", "sgd"]}, seed=1)
        decisions, exploits = _stream(sched, trial, pb2, _configs(), steps=16)
        return decisions, exploits, pb2._obs_x, pb2._obs_y

    decisions, exploits, obs_x, obs_y = assert_equal(run)
    assert len(obs_y) >= 3 and len(exploits) >= 3  # the GP bandit explored
