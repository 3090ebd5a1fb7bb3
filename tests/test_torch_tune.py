"""Tune on the port's runtime (``ray_tpu_torch.tune``) against ray_tpu's, on
the CPU: the 20 cases of ``tests/test_tune.py``.

Each case is parametrised over both packages. Each parameter runs the
case's own assertions on its package, with a fresh runtime of that
package (as ray_tpu's ``rt_start``); the port's parameter also holds its
output against ray_tpu's on the same inputs: the set of trial configs and
the committed metrics less their timestamps and trial ids, where the
case's outcome does not depend on the order in which reports arrive (a
scheduler that compares trials, and a searcher that learns from finished
ones while others run, decide by that order in both packages;
``test_torch_tune_parity.py`` holds their decisions on scripted streams).
Trainables live in ``tests/torch_tune_defs.py`` (trainables travel by
reference on the port) and take their package's name from the config.
Every ``fit()`` runs under a bound (``T``) so that a hang fails its test
only."""

import glob
import importlib
import json
import sys
import threading
import time

import pytest
import torch_tune_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu import train as jtrain
from ray_tpu import tune as jtune
from ray_tpu_torch import train as ttrain
from ray_tpu_torch import tune as ttune

PKGS = ("ray_tpu", "ray_tpu_torch")
MODS = {"ray_tpu": (ray_tpu, jtrain, jtune), "ray_tpu_torch": (ray_tpu_torch, ttrain, ttune)}
T = 150  # seconds: the bound on a fit
DROP = ("timestamp", "trial_id", "checkpoint_dir_name")  # per run, not per input
_REF: dict = {}
_MAIN = {a: getattr(sys.modules["__main__"], a, None) for a in ("__spec__", "__file__")}


@pytest.fixture(autouse=True)
def main_module_kept():
    """Both packages' nodes hide ``__main__``'s ``__spec__`` and ``__file__``
    while they start a worker; with both runtimes in this process the one
    that restores last may write back the other's None. Put them back."""
    yield
    main = sys.modules["__main__"]
    for attr, val in _MAIN.items():
        if val is not None and getattr(main, attr, None) is None:
            setattr(main, attr, val)


@pytest.fixture(params=PKGS)
def pkg(request):
    """A fresh runtime of the parameter's package (4 CPUs), as rt_start."""
    rt = MODS[request.param][0]
    rt.shutdown()
    rt.init(num_cpus=4)
    yield request.param
    rt.shutdown()


def bounded(fn, timeout=T):
    """``fn()`` in a thread, bounded by ``timeout``."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"did not return within {timeout} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def fit(tuner, timeout=T):
    return bounded(tuner.fit, timeout)


def config_of(cfg: dict) -> tuple:
    return tuple(sorted((k, v) for k, v in cfg.items() if k not in ("pkg", "marker")))


def metrics_of(m: dict) -> dict:
    return {k: v for k, v in m.items() if k not in DROP}


def outcome(grid) -> list:
    """Every trial's config and committed metrics, in config order."""
    return sorted((config_of(t.config), [sorted(metrics_of(m).items()) for m in t.metrics_history])
                  for t in grid._trials)


def configs(grid) -> list:
    return sorted(config_of(t.config) for t in grid._trials)


def check_same(pkg, key, out):
    """Cache ray_tpu's ``out``; hold the port's against it."""
    if pkg == "ray_tpu":
        _REF[key] = out
    elif key in _REF:
        assert out == _REF[key], (out, _REF[key])
    return out


def _run_cfg(pkg, tmp_path, **kw):
    return MODS[pkg][1].RunConfig(name="exp", storage_path=str(tmp_path), **kw)


def tuner(pkg, trainable, space, tmp_path, run_config=None, **tc):
    tune = MODS[pkg][2]
    return tune.Tuner(trainable, param_space={**space, "pkg": pkg}, tune_config=tune.TuneConfig(**tc),
                      run_config=run_config or _run_cfg(pkg, tmp_path))


# ---------------------------------------------------------------- test_tune.py's cases
def test_grid_and_random_search(pkg, tmp_path):
    tune = MODS[pkg][2]
    grid = fit(tuner(pkg, defs.grid_random, {"a": tune.grid_search([1, 2, 3]), "b": tune.uniform(0, 1)}, tmp_path,
                     metric="score", mode="max", num_samples=2, seed=7))
    assert len(grid) == 6  # 3 grid values x 2 samples
    best = grid.get_best_result("score", "max")
    assert best.metrics["score"] > 30  # a=3 variant wins
    df = grid.get_dataframe()
    assert set(df["config/a"]) == {1, 2, 3}
    check_same(pkg, "grid", outcome(grid))


def test_choice_randint(pkg, tmp_path):
    tune = MODS[pkg][2]
    grid = fit(tuner(pkg, defs.choice_randint, {"c": tune.choice([100, 200]), "i": tune.randint(0, 10)}, tmp_path,
                     metric="v", mode="max", num_samples=4, seed=0))
    for r in grid:
        assert r.metrics["v"] >= 100
    check_same(pkg, "choice", outcome(grid))


def test_asha_stops_bad_trials(pkg, tmp_path):
    tune = MODS[pkg][2]
    grid = fit(tuner(pkg, defs.asha_linear, {"q": tune.grid_search([0.01, 0.02, 1.0, 2.0])}, tmp_path,
                     metric="acc", mode="max",
                     scheduler=tune.ASHAScheduler(metric="acc", mode="max", max_t=20, grace_period=2,
                                                  reduction_factor=2)))
    best = grid.get_best_result("acc", "max")
    assert best.metrics["acc"] == 40.0  # q=2.0 survives to max_t
    iters = {r.metrics["trial_id"]: r.metrics["training_iteration"] for r in grid}
    assert min(iters.values()) < 20  # at least one trial stopped early
    # which trials a rung stops depends on the order reports arrive in
    check_same(pkg, "asha", (configs(grid), sorted(metrics_of(best.metrics).items())))


def test_median_stopping(pkg, tmp_path):
    tune = MODS[pkg][2]
    grid = fit(tuner(pkg, defs.median_constant, {"g": tune.grid_search([1.0, 1.0, 1.0, -5.0])}, tmp_path,
                     metric="m", mode="max",
                     scheduler=tune.MedianStoppingRule(metric="m", mode="max", grace_period=2,
                                                       min_samples_required=2)))
    assert len(grid) == 4
    worst = [r for r in grid if r.metrics["m"] == -5.0][0]
    assert worst.metrics["training_iteration"] < 10
    check_same(pkg, "median", configs(grid))


def test_pbt_exploit(pkg, tmp_path):
    tune = MODS[pkg][2]
    grid = fit(tuner(pkg, defs.pbt_weights, {"lr": tune.grid_search([0.001, 1.0])}, tmp_path,
                     metric="w", mode="max",
                     scheduler=tune.PopulationBasedTraining(metric="w", mode="max", perturbation_interval=3,
                                                            hyperparam_mutations={"lr": [0.001, 1.0, 2.0]},
                                                            quantile_fraction=0.5, seed=0)))
    assert len(grid) == 2
    # the weak trial must have been exploited onto the strong config path
    best = grid.get_best_result("w", "max")
    assert best.metrics["w"] > 1.0
    assert all(r.metrics["w"] > 0.2 for r in grid), [r.metrics for r in grid]
    check_same(pkg, "pbt", len(grid))


def test_concurrency_limiter(pkg, tmp_path):
    tune = MODS[pkg][2]
    searcher = tune.ConcurrencyLimiter(tune.BasicVariantGenerator(num_samples=4, seed=1), max_concurrent=1)
    grid = fit(tuner(pkg, defs.report_x, {"v": tune.uniform(0, 1)}, tmp_path, metric="x", mode="max",
                     search_alg=searcher))
    assert len(grid) == 4
    check_same(pkg, "limiter", outcome(grid))


def test_with_parameters_and_run(pkg, tmp_path, monkeypatch):
    tune = MODS[pkg][2]
    monkeypatch.setenv("RT_STORAGE_PATH", str(tmp_path))  # tune.run's default RunConfig
    big = list(range(1000))
    grid = bounded(lambda: tune.run(tune.with_parameters(defs.with_data, data=big),
                                    config={"k": tune.grid_search([1, 2]), "pkg": pkg}, metric="n", mode="max"))
    assert sorted(r.metrics["n"] for r in grid) == [1001, 1002]
    check_same(pkg, "with_parameters", outcome(grid))


def test_tuner_over_trainer(pkg, tmp_path):
    _, train, tune = MODS[pkg]
    trainer = train.DataParallelTrainer(defs.inverse_lr_loss, train_loop_config={"pkg": pkg},
                                        scaling_config=train.ScalingConfig(num_workers=1),
                                        run_config=_run_cfg(pkg, tmp_path / "inner"))
    grid = fit(tune.Tuner(trainer, param_space={"lr": tune.grid_search([1.0, 10.0])},
                          tune_config=tune.TuneConfig(metric="loss", mode="min"),
                          run_config=_run_cfg(pkg, tmp_path)))
    best = grid.get_best_result("loss", "min")
    assert best.metrics["loss"] == 10.0
    check_same(pkg, "over_trainer", outcome(grid))


def test_trial_failure_isolated(pkg, tmp_path):
    tune = MODS[pkg][2]
    grid = fit(tuner(pkg, defs.fails_at_two, {"v": tune.grid_search([1, 2, 3])}, tmp_path, metric="v", mode="max"))
    assert grid.num_errors == 1
    assert grid.get_best_result("v", "max").metrics["v"] == 3
    check_same(pkg, "failure", (outcome(grid), sorted(t.status for t in grid._trials),
                                ["boom" in str(e) for e in grid.errors]))


def test_logger_callbacks_write_files(pkg, tmp_path):
    """Json/CSV/TensorBoard callbacks produce per-trial artifacts."""
    _, train, tune = MODS[pkg]
    cbs = [tune.JsonLoggerCallback(), tune.CSVLoggerCallback(), tune.TensorBoardLoggerCallback()]
    grid = fit(tuner(pkg, defs.three_scores, {"m": tune.grid_search([1.0, 2.0])}, tmp_path,
                     run_config=train.RunConfig(name="cbexp", storage_path=str(tmp_path), callbacks=cbs),
                     metric="score", mode="max"))
    files = []
    for t in grid._trials:
        d = f"{tmp_path}/cbexp/{t.trial_id}"
        lines = [json.loads(x) for x in open(f"{d}/result.json")]
        assert [r["score"] for r in lines] == [0.0, t.config["m"], 2 * t.config["m"]]
        csv_body = open(f"{d}/progress.csv").read()
        assert "score" in csv_body and csv_body.count("\n") == 4  # header + 3 rows
        assert glob.glob(f"{d}/events.out.tfevents.*"), "no TB event file"
        files.append((t.config["m"], [metrics_of(r) for r in lines], csv_body.splitlines()[0]))
    # offline mode constructs fine; ONLINE mode stays rejected (no egress)
    tune.WandbLoggerCallback()
    with pytest.raises(NotImplementedError, match="offline"):
        tune.WandbLoggerCallback(mode="online")
    check_same(pkg, "callbacks", sorted(files))


@pytest.mark.parametrize("which", PKGS)
def test_placement_group_factory_basics(which):
    tune = MODS[which][2]
    f = tune.PlacementGroupFactory([{"CPU": 0.5}, {"CPU": 1}, {"CPU": 1}])
    assert f.head_bundle == {"CPU": 0.5}
    assert f.required_resources() == {"CPU": 2.5}
    with pytest.raises(ValueError):
        tune.PlacementGroupFactory([])
    check_same(which, "pgf", (repr(f), f.bundles))


def test_pending_pg_placed_after_capacity_frees(pkg):
    """A queued gang reservation is granted when another group returns its
    bundles (the pending-PG kick on remove)."""
    pgmod = importlib.import_module(pkg + ".util.placement_group")
    pg1 = pgmod.placement_group([{"CPU": 2}, {"CPU": 2}])  # fills the 4-CPU node
    assert pg1.wait(timeout_seconds=10)
    pg2 = pgmod.placement_group([{"CPU": 2}, {"CPU": 2}])
    queued = pg2.wait(timeout_seconds=0.2)
    assert not queued
    pgmod.remove_placement_group(pg1)
    assert pg2.wait(timeout_seconds=10), "freed capacity never reached the queued group"
    pgmod.remove_placement_group(pg2)


@pytest.mark.parametrize("which", PKGS)
def test_two_worker_trainer_trials_serialize_on_small_cluster(which, tmp_path):
    """Two 2-worker-trainer trials on a 3-CPU cluster gang-reserve {driver +
    2 workers} each and therefore SERIALIZE (execution windows disjoint)
    instead of oversubscribing."""
    rt, train, tune = MODS[which]
    rt.shutdown()
    rt.init(num_cpus=3)
    try:
        trainer = train.DataParallelTrainer(defs.timestamps, train_loop_config={"pkg": which},
                                            scaling_config=train.ScalingConfig(num_workers=2),
                                            run_config=_run_cfg(which, tmp_path / "inner"))
        grid = fit(tune.Tuner(trainer, param_space={"tag": tune.grid_search(["a", "b"])},
                              tune_config=tune.TuneConfig(metric="ts", mode="max", max_concurrent_trials=2),
                              run_config=_run_cfg(which, tmp_path)))
        assert grid.num_errors == 0
        windows = []
        for res in grid:
            ts = [m["ts"] for m in res.metrics_history]
            windows.append((min(ts), max(ts)))
        (a0, a1), (b0, b1) = sorted(windows)
        assert a1 <= b0, f"trials overlapped: {windows} — gang reservation failed to serialize them"
        check_same(which, "serialize", (configs(grid), sorted(
            [sorted((k, v) for k, v in metrics_of(m).items() if k != "ts") for m in t.metrics_history]
            for t in grid._trials)))
    finally:
        rt.shutdown()


def test_infeasible_trial_pg_errors_instead_of_hanging(pkg, tmp_path):
    tune = MODS[pkg][2]
    grid = fit(tuner(pkg, tune.with_resources(defs.report_one, tune.PlacementGroupFactory([{"CPU": 64}])),
                     {"v": tune.grid_search([1])}, tmp_path, metric="x", mode="max"))
    assert grid.num_errors == 1
    check_same(pkg, "infeasible", (configs(grid), [str(e) for e in grid.errors]))


def test_wandb_mlflow_offline_loggers(pkg, tmp_path):
    """File-backed offline modes: wandb offline run dirs and the mlruns/
    file-store layout; online modes stay rejected (zero egress)."""
    tune = MODS[pkg][2]
    with pytest.raises(NotImplementedError):
        tune.WandbLoggerCallback(mode="online")
    with pytest.raises(NotImplementedError):
        tune.MLflowLoggerCallback(tracking_uri="http://mlflow:5000")
    grid = fit(tuner(pkg, defs.inverse_lr_steps, {"lr": tune.grid_search([1.0, 2.0])}, tmp_path,
                     run_config=_run_cfg(pkg, tmp_path, callbacks=[tune.WandbLoggerCallback(project="p"),
                                                                  tune.MLflowLoggerCallback()]),
                     metric="loss", mode="min"))
    assert grid.num_errors == 0
    run_dir = tmp_path / "exp"
    wandb_runs = list((run_dir / "wandb").glob("offline-run-*"))
    assert len(wandb_runs) == 2
    hist = (wandb_runs[0] / "files" / "wandb-history.jsonl").read_text().splitlines()
    assert len(hist) == 3 and "loss" in json.loads(hist[0])
    ml_runs = [d for d in (run_dir / "mlruns" / "0").iterdir() if d.is_dir()]
    assert len(ml_runs) == 2
    metric = (ml_runs[0] / "metrics" / "loss").read_text().splitlines()
    assert len(metric) == 3 and len(metric[0].split()) == 3  # ts value step
    assert (ml_runs[0] / "tags" / "mlflow.runStatus").read_text() == "FINISHED"
    wb = sorted([sorted(metrics_of(json.loads(x)).items()) for x in
                 (d / "files" / "wandb-history.jsonl").read_text().splitlines()] for d in wandb_runs)
    ml = sorted([x.split()[1:] for x in (d / "metrics" / "loss").read_text().splitlines()] for d in ml_runs)
    check_same(pkg, "offline_loggers", (outcome(grid), wb, ml))


def test_pb2_gp_bandit_explore(pkg, tmp_path):
    """PB2: the exploit step's new config comes from a GP-UCB suggestion
    over observed reward improvements, and the population's lr migrates
    toward the optimum of a toy objective (reward rate peaks at lr=0.3)."""
    tune = MODS[pkg][2]
    sched = tune.PB2(metric="w", mode="max", perturbation_interval=4, hyperparam_bounds={"lr": (0.0, 1.0)},
                     quantile_fraction=0.5, seed=0)
    grid = fit(tuner(pkg, defs.pb2_peak, {"lr": tune.grid_search([0.02, 0.95, 0.6, 0.08])}, tmp_path,
                     metric="w", mode="max", scheduler=sched, max_concurrent_trials=4))
    assert grid.num_errors == 0
    assert len(sched._obs_y) >= 3, len(sched._obs_y)
    best = grid.get_best_result("w", "max")
    assert best.metrics["w"] > 20 * 0.3, best.metrics
    final_lrs = [r.metrics.get("lr") for r in grid if r.metrics.get("lr") is not None]
    assert any(abs(lr - 0.3) < 0.25 for lr in final_lrs), final_lrs
    check_same(pkg, "pb2", len(grid))


def test_tpe_searcher_beats_random_on_quadratic(pkg, tmp_path):
    """TPE: after startup trials, suggestions concentrate near the optimum
    of a quadratic objective, beating pure random sampling's best."""
    tune = MODS[pkg][2]
    tpe = tune.TPESearcher(num_samples=24, metric="loss", mode="min", n_startup_trials=6, seed=3)
    grid = fit(tuner(pkg, defs.quadratic, {"x": tune.uniform(0, 1), "y": tune.uniform(0, 1)}, tmp_path / "tpe",
                     metric="loss", mode="min", search_alg=tpe, max_concurrent_trials=2))
    assert grid.num_errors == 0 and len(grid) == 24
    tpe_best = grid.get_best_result("loss", "min").metrics["loss"]
    assert tpe_best < 0.02, tpe_best
    losses = [r.metrics["loss"] for r in grid]
    assert min(losses[8:]) <= min(losses[:6]), losses
    # the six startup suggestions are random draws before any result: the same in both packages
    check_same(pkg, "tpe", [config_of(t.config) for t in grid._trials[:6]])


def test_bayesopt_searcher_beats_random_on_quadratic(pkg, tmp_path):
    """Native GP-EI search: converges near the optimum and handles a
    categorical dimension through the one-hot kernel."""
    tune = MODS[pkg][2]
    space = {"x": tune.uniform(0, 1), "y": tune.uniform(0, 1), "kind": tune.choice(["good", "bad"])}
    bo = tune.BayesOptSearcher(num_samples=24, metric="loss", mode="min", n_startup_trials=6, seed=3)
    res = fit(tuner(pkg, defs.quadratic_kind, space, tmp_path / "bo", metric="loss", mode="min", search_alg=bo,
                    max_concurrent_trials=2))
    assert res.num_errors == 0 and len(res) == 24
    best = res.get_best_result("loss", "min")
    assert best.metrics["loss"] < 0.05, best.metrics["loss"]
    assert best.config["kind"] == "good"
    check_same(pkg, "bayesopt", [config_of(t.config) for t in res._trials[:6]])


def test_tpe_with_asha_is_bohb_shaped(pkg, tmp_path):
    """BOHB composition: TPE proposals + ASHA multi-fidelity elimination
    run together and find a good config."""
    tune = MODS[pkg][2]
    grid = fit(tuner(pkg, defs.bohb_acc, {"q": tune.uniform(0, 1)}, tmp_path, metric="acc", mode="max",
                     search_alg=tune.TPESearcher(num_samples=12, metric="acc", mode="max", n_startup_trials=4,
                                                 seed=0),
                     scheduler=tune.ASHAScheduler(metric="acc", mode="max", max_t=8, grace_period=2,
                                                  reduction_factor=2)))
    assert grid.num_errors == 0
    best = grid.get_best_result("acc", "max")
    assert best.metrics["acc"] > 8 * 0.8  # near q=0.5 survived to max_t
    check_same(pkg, "bohb", [config_of(t.config) for t in grid._trials[:4]])


def test_resource_changing_scheduler_grows_trials(pkg, tmp_path):
    """Trials are paused and relaunched from their last checkpoint with a
    bigger CPU footprint once the allocator proposes one: on a 4-CPU
    cluster, 2 live trials grow from 1 CPU to 2 without losing progress."""
    tune = MODS[pkg][2]
    sched = tune.ResourceChangingScheduler(
        resources_allocation_function=tune.DistributeResources(metric="acc", mode="max"),
        metric="acc", mode="max", reallocate_interval=2)
    grid = fit(tuner(pkg, defs.growing, {"q": tune.grid_search([1.0, 2.0])}, tmp_path, metric="acc", mode="max",
                     scheduler=sched))
    assert len(grid) == 2
    for r in grid:
        assert r.metrics["acc"] in (8.0, 16.0)  # both ran to completion
    overrides = [t.resources for t in grid._trials if t.resources]
    assert overrides and all(r["CPU"] >= 2 for r in overrides), overrides
    assert all(r.metrics["training_iteration"] >= 8 for r in grid)
    check_same(pkg, "resource_changing", (configs(grid), sorted(r.metrics["acc"] for r in grid)))


# ---------------------------------------------------------------- the slice: a Tuner over each package's JaxTrainer
STEP_RTOL = 3e-5  # tests/test_torch_train.py: loss per step, relative, f32


@pytest.fixture(scope="module")
def jax_tiny_params():
    """ray_tpu's initial tiny-Llama weights, f32, from PRNGKey(0)."""
    from functools import partial

    import jax
    import numpy as np

    from ray_tpu.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.tiny(dtype="float32")
    return jax.tree.map(np.asarray, jax.jit(partial(init_params, cfg))(jax.random.PRNGKey(0)))


def test_tuner_over_jax_trainer_trains_tiny_llama(pkg, tmp_path, jax_tiny_params):
    """The slice as a whole: a Tuner over each package's JaxTrainer trains
    the tiny Llama on the CPU at two learning rates. ray_tpu's loop jits its
    step; the port's steps parallel/train_step.py from ray_tpu's initial
    weights. Each trial's three losses compare within STEP_RTOL."""
    _, train, tune = MODS[pkg]
    if pkg == "ray_tpu":
        loop, config = defs.jax_tiny_llama_lr, {}
    else:
        loop, config = defs.torch_tiny_llama_lr, {"params": jax_tiny_params}
    trainer = train.JaxTrainer(loop, train_loop_config={"pkg": pkg, **config},
                               scaling_config=train.ScalingConfig(num_workers=1),
                               run_config=_run_cfg(pkg, tmp_path / "inner"),
                               backend_config=train.backend.JaxConfig(distributed="never"))
    grid = fit(tune.Tuner(trainer, param_space={"lr": tune.grid_search([1e-3, 3e-3])},
                          tune_config=tune.TuneConfig(metric="loss", mode="min"), run_config=_run_cfg(pkg, tmp_path)))
    assert grid.num_errors == 0 and len(grid) == 2
    losses = {t.config["lr"]: [m["loss"] for m in t.metrics_history] for t in grid._trials}
    for lr, ls in losses.items():
        assert [m["step"] for m in grid._trials[0].metrics_history] == [1, 2, 3] and ls[-1] < ls[0], (lr, ls)
    assert losses[1e-3][0] == losses[3e-3][0]  # step 1's loss comes before any update
    if pkg == "ray_tpu":
        _REF["slice"] = losses
    elif "slice" in _REF:
        want = _REF["slice"]
        assert losses.keys() == want.keys()
        for lr in want:
            assert all(abs(a - b) <= STEP_RTOL * abs(b) for a, b in zip(losses[lr], want[lr])), (lr, losses, want)


# ---------------------------------------------------------------- the port's rules
def _closure_trainable():
    def local(config):
        pass

    return local


def test_lambda_and_closure_trainables_raise_at_fit(tmp_path):
    """A lambda or closure trainable, one inside with_parameters or
    with_resources, a trainer's lambda loop, and a lambda in the search
    space (in sample_from, in a grid, or a plain value in a nested list)
    raise TypeError at fit(), before any runtime or trial starts."""
    ray_tpu_torch.shutdown()
    cfg = ttrain.RunConfig(name="l", storage_path=str(tmp_path))
    bad = [lambda config: None, _closure_trainable(), ttune.with_parameters(lambda config, x: None, x=1),
           ttune.with_resources(_closure_trainable(), {"CPU": 1}),
           ttrain.DataParallelTrainer(lambda config: None, run_config=cfg)]
    for trainable in bad:
        with pytest.raises(TypeError, match="by reference"):
            ttune.Tuner(trainable, run_config=cfg).fit()
    for space in ({"v": ttune.sample_from(lambda spec: 1)}, {"v": ttune.grid_search([lambda: 1])},
                  {"n": {"v": [lambda: 1]}}):
        with pytest.raises(TypeError, match="snapshot.*param_space.*by reference"):
            ttune.Tuner(defs.report_x, param_space=space, run_config=cfg).fit()
    with pytest.raises(TypeError, match="snapshot.*by reference"):
        ttune.Tuner(defs.report_x, param_space={"v": 1}, run_config=cfg, tune_config=ttune.TuneConfig(
            scheduler=ttune.PopulationBasedTraining(hyperparam_mutations={"v": lambda: 2}))).fit()
    assert not ray_tpu_torch.is_initialized()  # raised before any runtime or trial started


def card_back(timeout=10.0) -> bool:
    """Whether the card is back in the runtime's available resources
    within ``timeout``: a stopped trial's actor is killed and its process
    reaped asynchronously."""
    deadline = time.monotonic() + timeout
    while ray_tpu_torch.available_resources().get("GPU") != 1.0:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def test_trial_actor_bound_to_the_card_and_free_of_jax(tmp_path):
    """A trial that asks for "GPU" (or "TPU", ray_tpu's name, folded into
    it), from a flat dict or a placement group's head bundle, runs in an
    actor forked with CUDA_VISIBLE_DEVICES, as a num_gpus actor is; one
    that asks for none sees no binding. Every trial's worker is a port
    worker holding no jax, cloudpickle or ray_tpu module, with ray_tpu's
    runtime (and jax) in this process."""
    assert "jax" in sys.modules
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)  # one card as a resource (none for CUDA here)
    try:
        cases = [({"CPU": 1, "GPU": 1}, "0"), ({"CPU": 1, "TPU": 1}, "0"),
                 (ttune.PlacementGroupFactory([{"CPU": 1, "GPU": 1}]), "0"),
                 (ttune.PlacementGroupFactory([{"CPU": 1, "TPU": 1}, {"CPU": 1}]), "0"), ({"CPU": 1}, None)]
        for res, visible in cases:
            grid = fit(ttune.Tuner(ttune.with_resources(defs.worker_facts, res), param_space={"pkg": "ray_tpu_torch"},
                                   run_config=ttrain.RunConfig(name="card", storage_path=str(tmp_path))))
            m = grid[0].metrics
            assert grid.num_errors == 0 and m["visible"] == visible, (res, m)
            assert m["bad"] == [] and m["port_worker"], m
            assert card_back(), ray_tpu_torch.available_resources()
    finally:
        ray_tpu_torch.shutdown()


def test_trainer_trials_with_the_card_run_one_at_a_time(tmp_path):
    """A trainer whose worker asks for the card gang-reserves [{"CPU": 0.5},
    {"CPU": 1, "GPU": 1}] per trial: with one card, the trials run one at a
    time (the rest wait PENDING), each train worker bound to it."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        trainer = ttrain.DataParallelTrainer(defs.card_timestamps, train_loop_config={"pkg": "ray_tpu_torch"},
                                             scaling_config=ttrain.ScalingConfig(
                                                 num_workers=1, resources_per_worker={"CPU": 1, "GPU": 1}),
                                             run_config=ttrain.RunConfig(name="inner", storage_path=str(tmp_path)))
        grid = fit(ttune.Tuner(trainer, param_space={"tag": ttune.grid_search(["a", "b", "c"])},
                               tune_config=ttune.TuneConfig(metric="ts", mode="max"),
                               run_config=ttrain.RunConfig(name="exp", storage_path=str(tmp_path))))
        assert grid.num_errors == 0 and len(grid) == 3
        windows = sorted((min(m["ts"] for m in r.metrics_history), max(m["ts"] for m in r.metrics_history))
                         for r in grid)
        assert all(a[1] <= b[0] for a, b in zip(windows, windows[1:])), windows
        assert all(m["visible"] == "0" for r in grid for m in r.metrics_history)
        assert card_back(), ray_tpu_torch.available_resources()
    finally:
        ray_tpu_torch.shutdown()
