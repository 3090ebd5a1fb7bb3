"""The actor utilities and ``Tuner.restore`` on the port's runtime against
ray_tpu's, on the CPU: the 6 cases of ``tests/test_ecosystem.py``
(ActorPool, Queue, multiprocessing.Pool, joblib, two ``Tuner.restore``
cases), each parametrised over both packages with a fresh runtime per
parameter; the port's parameter also holds its output against ray_tpu's.
Actor classes and functions live in ``tests/torch_tune_defs.py`` (code
travels by reference on the port).

Then the port's rules: a ``multiprocessing.Pool`` lambda raises TypeError
at the call, ``ray_tpu_torch.workflow`` raises ImportError on import, and
the restore snapshot round-trips under the standard library's pickle."""

import os
import pickle
import sys
import threading

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
T = 150  # seconds: the bound on a fit or a pool's results
_REF: dict = {}
_MAIN = {a: getattr(sys.modules["__main__"], a, None) for a in ("__spec__", "__file__")}


@pytest.fixture(autouse=True)
def main_module_kept():
    """As ``tests/test_torch_trainer.py``'s: put ``__main__``'s ``__spec__``
    and ``__file__`` back after each test."""
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


def check_same(pkg, key, out):
    """Cache ray_tpu's ``out``; hold the port's against it."""
    if pkg == "ray_tpu":
        _REF[key] = out
    elif key in _REF:
        assert out == _REF[key], (out, _REF[key])
    return out


def util(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.util.{name}")


# ---------------------------------------------------------------- test_ecosystem.py's cases
def test_actor_pool_map_ordered_and_unordered(pkg):
    rt = MODS[pkg][0]
    doubler = rt.remote(defs.Doubler)
    pool = util(pkg, "actor_pool").ActorPool([doubler.remote() for _ in range(3)])
    out = bounded(lambda: list(pool.map(lambda a, v: a.double.remote(v), range(8))))
    assert out == [2 * i for i in range(8)]  # submission order preserved
    out2 = sorted(bounded(lambda: list(pool.map_unordered(lambda a, v: a.double.remote(v), range(8)))))
    assert out2 == sorted(2 * i for i in range(8))
    assert pool.has_free() and not pool.has_next()
    check_same(pkg, "pool", (out, out2))


def test_queue_blocking_and_batches(pkg):
    rt = MODS[pkg][0]
    qmod = util(pkg, "queue")
    q = qmod.Queue(maxsize=3)
    q.put(1)
    q.put_nowait_batch([2, 3])
    assert q.qsize() == 3 and q.full()
    with pytest.raises(qmod.Full):
        q.put_nowait(4)
    assert q.get() == 1
    assert q.get_nowait_batch(2) == [2, 3]
    assert q.empty()
    with pytest.raises(qmod.Empty):
        q.get_nowait()
    with pytest.raises(qmod.Empty):
        q.get(timeout=0.2)
    # blocking get unblocks when a producer task puts
    ref = rt.remote(defs.producer).remote(q)
    assert q.get(timeout=10) == "prod"
    assert rt.get(ref, timeout=T)
    q.shutdown()


def test_multiprocessing_pool(pkg):
    Pool = util(pkg, "multiprocessing").Pool

    def run():
        with Pool(processes=2) as p:
            return (p.map(defs.sq, range(10)), p.apply(defs.add, (3, 4)), p.map_async(defs.sq, range(5)).get(timeout=60),
                    p.starmap(defs.add, [(1, 2), (3, 4)]), list(p.imap(defs.sq, range(4))),
                    sorted(p.imap_unordered(defs.sq, range(4))))

    out = bounded(run)
    assert out == ([x * x for x in range(10)], 7, [0, 1, 4, 9, 16], [3, 7], [0, 1, 4, 9], [0, 1, 4, 9])
    check_same(pkg, "mp", out)


def test_joblib_backend(pkg):
    joblib = pytest.importorskip("joblib")
    util(pkg, "joblib").register_ray()
    with joblib.parallel_backend(pkg, n_jobs=2):
        out = bounded(lambda: joblib.Parallel()(joblib.delayed(defs.sq)(i) for i in range(6)))
    assert out == [0, 1, 4, 9, 16, 25]


# ---------------------------------------------------------------- tune restore
def _history(grid) -> list:
    return sorted((t.config["lr"], t.status, [m["iter_seen"] for m in t.metrics_history],
                   [m["score"] for m in t.metrics_history]) for t in grid._trials)


def test_tuner_restore_resumes_errored_trials(pkg, tmp_path):
    _, train, tune = MODS[pkg]
    marker = str(tmp_path / "fixed.marker")
    run_dir = str(tmp_path / "exp")
    tuner = tune.Tuner(defs.resumable, param_space={"lr": tune.grid_search([1.0, 10.0]), "marker": marker, "pkg": pkg},
                       tune_config=tune.TuneConfig(metric="score", mode="max"),
                       run_config=train.RunConfig(name="restoreme", storage_path=run_dir))
    grid = bounded(tuner.fit)
    assert all(t.status == "ERROR" for t in grid._trials)
    # each trial crashed at iteration 3, having banked checkpoints 0..2
    assert all(t.iteration == 3 for t in grid._trials)
    first = _history(grid)

    exp_path = f"{run_dir}/restoreme"
    assert tune.Tuner.can_restore(exp_path)
    open(marker, "w").close()  # "fix the bug"
    grid2 = bounded(tune.Tuner.restore(exp_path, defs.resumable, resume_errored=True).fit)
    assert all(t.status == "TERMINATED" for t in grid2._trials)
    for t in grid2._trials:
        iters = [m["iter_seen"] for m in t.metrics_history]
        assert iters[-1] == 5
        # resumed from the checkpoint, not from scratch: iteration 3 comes
        # right after the pre-crash history without repeating 0..2
        assert iters.count(0) == 1
    scores = sorted(t.last_result["score"] for t in grid2._trials)
    assert scores == [5.0, 50.0]
    check_same(pkg, "resume", (first, _history(grid2)))


def test_tuner_restore_restart_errored(pkg, tmp_path):
    _, train, tune = MODS[pkg]
    marker = str(tmp_path / "m2.marker")
    run_dir = str(tmp_path / "exp2")
    tuner = tune.Tuner(defs.resumable, param_space={"lr": 2.0, "marker": marker, "pkg": pkg},
                       tune_config=tune.TuneConfig(metric="score", mode="max"),
                       run_config=train.RunConfig(name="hard", storage_path=run_dir))
    bounded(tuner.fit)
    open(marker, "w").close()
    grid = bounded(tune.Tuner.restore(f"{run_dir}/hard", defs.resumable, restart_errored=True).fit)
    (trial,) = grid._trials
    assert trial.status == "TERMINATED"
    iters = [m["iter_seen"] for m in trial.metrics_history]
    assert iters[-1] == 5 and iters.count(0) >= 1  # restarted from scratch
    check_same(pkg, "restart", _history(grid))


# ---------------------------------------------------------------- the port's rules
def test_pool_lambda_and_closure_raise_at_the_call():
    def local(x):
        return x

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        Pool = util("ray_tpu_torch", "multiprocessing").Pool
        p = Pool(processes=2)
        for fn in (lambda x: x, local):
            with pytest.raises(TypeError, match="by reference"):
                p.map(fn, range(3))
            with pytest.raises(TypeError, match="by reference"):
                p.apply_async(fn, (1,))
        with pytest.raises(TypeError, match="by reference"):
            Pool(processes=1, initializer=lambda: None)
        assert bounded(lambda: p.map(defs.sq, range(3))) == [0, 1, 4]
    finally:
        ray_tpu_torch.shutdown()


def test_workflow_stub_raises_import_error():
    for name in ("ray_tpu.workflow", "ray_tpu_torch.workflow"):
        with pytest.raises(ImportError, match="removed"):
            __import__(name)


def test_snapshot_round_trips_under_stdlib_pickle(tmp_path):
    """The experiment's snapshot is the standard library's pickle: it loads
    with ``pickle`` alone, its trials, searcher and scheduler intact, and
    is written atomically (no temporary file left). The checkpoints the
    trial actors staged are reaped, and the staging root goes when the
    experiment ends."""
    from ray_tpu_torch.tune.tune_controller import _stage_root

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        sched = ttune.ASHAScheduler(metric="score", mode="max", max_t=10)
        tuner = ttune.Tuner(defs.resumable,
                            param_space={"lr": ttune.grid_search([1.0, 3.0]), "marker": str(tmp_path / "never"),
                                         "pkg": "ray_tpu_torch", "a": 1, "s": ttune.sample_from(defs.derived)},
                            tune_config=ttune.TuneConfig(metric="score", mode="max", scheduler=sched),
                            run_config=ttrain.RunConfig(name="snap", storage_path=str(tmp_path)))
        grid = bounded(tuner.fit)
        assert not os.path.exists(_stage_root())  # each trial's staged copies reaped, then the root
    finally:
        ray_tpu_torch.shutdown()
    path = tmp_path / "snap" / "experiment_state.pkl"
    assert sorted(os.listdir(tmp_path / "snap")) == sorted(["experiment_state.pkl", *[t.trial_id for t in grid._trials]])
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert [t.trial_id for t in state["trials"]] == [t.trial_id for t in grid._trials]
    assert [t.status for t in state["trials"]] == ["ERROR", "ERROR"]
    assert [t.config["s"] for t in state["trials"]] == [3, 3]
    assert type(state["searcher"]).__module__ == "ray_tpu_torch.tune.search"
    assert state["scheduler"].rungs.keys() == sched.rungs.keys()
    assert pickle.loads(pickle.dumps(state))["metric"] == "score"
