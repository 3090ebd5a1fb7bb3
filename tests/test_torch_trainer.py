"""The trainers on the port's runtime (``ray_tpu_torch.train``) against
ray_tpu's, on the CPU: the 13 cases of ``tests/test_train.py``.

A case that runs on both packages is parametrised over both. Each
parameter runs the case's own assertions on its package, with a fresh
runtime of that package (as ray_tpu's ``rt_start``); the port's parameter
also holds its output against ray_tpu's on the same inputs: the
committed metrics (less their timestamps), the checkpoint files, the
steps and world sizes at the ends of an elastic run. Loops live in
``tests/torch_train_defs.py`` (loops travel by reference on the port)
and take their package's name from their config.

- The elastic cases add nodes with ``add_node(remote=False)`` on the
  port (``add_node``'s default, a node agent, is not ported: ROADMAP.md,
  multi-host agents).
- ``test_jax_trainer_single_worker_mesh``: ray_tpu's JaxTrainer jits its
  step over a one-device mesh; the port's trains the same tiny Llama on
  the CPU (``device="cpu"``) from ray_tpu's initial weights, passed as
  numpy through ``train_loop_config`` and converted in the worker. Both
  run in f32, so the four losses compare within
  ``tests/test_torch_train.py``'s step tolerance (3e-5 relative).
- ``test_repeated_elasticity_chaos_cycles`` runs on the port alone, with
  the reference's assertions: ray_tpu's case fails in whole runs and
  alone (ROADMAP.md, queue 3 item 4), so ray_tpu is no oracle for it.
- ``test_worker_reuse_arrow_stress`` sets a knob of ray_tpu's runtime
  (``RT_DEBUG_REUSE_ACTOR_WORKERS``); the port has no such knob (its
  actors always take a never-used worker), so its parameter runs the
  three dataset-fed fits on its default worker policy.

Then the port's own rules: ``jax_checkpoint`` round trips (sync and
async), ``use_tpu`` with a ``topology`` raises, a lambda or closure loop
raises TypeError at ``fit()``, and a worker that asks for ``"GPU"``
through its bundle is bound to the card. Every fit runs under a bound
(``T``) so that a hang fails its test only."""

import json
import os
import sys
import threading
import time
from functools import partial

import numpy as np
import pytest
import torch
import torch_train_defs as defs

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu import train as jtrain
from ray_tpu_torch import data as tdata
from ray_tpu_torch import train as ttrain

PKGS = ("ray_tpu", "ray_tpu_torch")
MODS = {"ray_tpu": (ray_tpu, jtrain, jdata), "ray_tpu_torch": (ray_tpu_torch, ttrain, tdata)}
T = 150  # seconds: the bound on a fit
STEP_RTOL = 3e-5  # tests/test_torch_train.py: loss per step, relative, f32
_REF: dict = {}


_MAIN = {a: getattr(sys.modules["__main__"], a, None) for a in ("__spec__", "__file__")}


@pytest.fixture(autouse=True)
def main_module_kept():
    """Both packages' nodes hide ``__main__``'s ``__spec__`` and ``__file__``
    (set to None) while they start a worker, each under its own lock. With
    both runtimes in this process the two can overlap, and the one that
    restores last may write back the other's None; torch's first lazy
    import of ``torch._dynamo`` (an optimizer's constructor) then fails in
    ``inspect`` on a ``__main__`` with a None file. Put them back after
    each test."""
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


def fit(trainer, timeout=T, **kw):
    """``trainer.fit(**kw)`` in a thread, bounded by ``timeout``."""
    box = {}

    def run():
        try:
            box["out"] = trainer.fit(**kw)
        except BaseException as e:  # noqa: BLE001
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"fit() did not return within {timeout} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def history(result) -> list:
    return [{k: v for k, v in m.items() if k not in ("timestamp", "checkpoint_dir_name")}
            for m in result.metrics_history]


def check_same(pkg, key, out):
    """Cache ray_tpu's ``out``; hold the port's against it."""
    if pkg == "ray_tpu":
        _REF[key] = out
    elif key in _REF:
        assert out == _REF[key], (out, _REF[key])
    return out


def trainer(pkg, loop, tmp_path, name="t", num_workers=1, config=None, run_kw=None, **kw):
    _, train, _ = MODS[pkg]
    return train.DataParallelTrainer(
        loop,
        train_loop_config={"pkg": pkg, **(config or {})},
        scaling_config=kw.pop("scaling_config", None) or train.ScalingConfig(num_workers=num_workers),
        run_config=train.RunConfig(name=name, storage_path=str(tmp_path), **(run_kw or {})),
        **kw,
    )


# ---------------------------------------------------------------- test_train.py's cases
def test_single_worker_metrics(pkg, tmp_path):
    result = fit(trainer(pkg, defs.single_worker_metrics, tmp_path))
    assert result.error is None
    assert result.metrics["loss"] == 8.0
    assert len(result.metrics_history) == 3
    check_same(pkg, "single", history(result))


def test_multi_worker_context_and_rank0_metrics(pkg, tmp_path):
    result = fit(trainer(pkg, defs.multi_worker_context, tmp_path, num_workers=3))
    assert result.metrics["rank"] == 0  # metrics come from rank 0
    check_same(pkg, "multi", history(result))


def test_checkpoint_roundtrip(pkg, tmp_path):
    result = fit(trainer(pkg, defs.checkpoint_roundtrip, tmp_path, num_workers=2))
    assert result.checkpoint is not None
    files = sorted(os.listdir(result.checkpoint.path))
    # union of every rank's files in one directory (sharded-ckpt semantics)
    assert files == ["model_rank0.json", "model_rank1.json"]
    contents = [json.load(open(os.path.join(result.checkpoint.path, f))) for f in files]
    check_same(pkg, "ckpt", (history(result), contents))


def test_failure_retry_resumes_from_checkpoint(pkg, tmp_path):
    train = MODS[pkg][1]
    marker = str(tmp_path / "attempts")
    result = fit(trainer(pkg, defs.failure_retry, tmp_path, config={"marker": marker},
                         run_kw=dict(failure_config=train.FailureConfig(max_failures=1))))
    assert result.error is None
    # attempt 1: steps 0,1 then crash; attempt 2 resumes at 2 -> 2,3
    steps = [m["step"] for m in result.metrics_history]
    assert steps == [0, 1, 2, 3]
    assert os.path.getsize(marker) == 2
    check_same(pkg, "retry", history(result))


def test_failure_exhausts_policy(pkg, tmp_path):
    train = MODS[pkg][1]
    with pytest.raises(train.TrainingFailedError) as info:
        fit(trainer(pkg, defs.always_fails, tmp_path, run_kw=dict(failure_config=train.FailureConfig(max_failures=0))))
    err = info.value
    check_same(pkg, "exhausts", (str(err), "always fails" in str(err.training_error)))


def test_topk_checkpoint_retention(pkg, tmp_path):
    train = MODS[pkg][1]
    result = fit(trainer(pkg, defs.topk_scores, tmp_path, run_kw=dict(
        checkpoint_config=train.CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="score"))))
    kept = result.best_checkpoints
    assert len(kept) == 2
    scores = sorted(m["score"] for _, m in kept)
    # best (0.9) + latest (0.3) survive
    assert scores == [0.3, 0.9]
    best = result.get_best_checkpoint("score")
    assert best is not None and os.path.isdir(best.path)
    on_disk = sorted(d for d in os.listdir(tmp_path / "t") if d.startswith("checkpoint_"))
    check_same(pkg, "topk", (scores, len(on_disk), history(result)))


def test_train_collectives(pkg, tmp_path):
    result = fit(trainer(pkg, defs.train_collectives, tmp_path, num_workers=2))
    assert result.metrics["got"] == 42
    assert result.metrics["sum"] == [3.0, 3.0, 3.0]
    check_same(pkg, "collectives", history(result))


@pytest.fixture(scope="module")
def jax_tiny_params():
    """ray_tpu's initial tiny-Llama weights, f32, from PRNGKey(0): the tree
    its JaxTrainer loop initialises in its worker."""
    import jax

    from ray_tpu.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.tiny(dtype="float32")
    return jax.tree.map(np.asarray, jax.jit(partial(init_params, cfg))(jax.random.PRNGKey(0)))


def test_jax_trainer_single_worker_mesh(pkg, tmp_path, jax_tiny_params):
    """JaxTrainer end to end: ray_tpu jits its step on a worker-local mesh;
    the port steps parallel/train_step.py in its worker on ray_tpu's
    initial weights. Four losses each, equal within STEP_RTOL."""
    rt, train, _ = MODS[pkg]
    if pkg == "ray_tpu":
        loop, config = defs.jax_tiny_llama, {"dtype": "float32"}
        backend = jtrain.backend.JaxConfig(distributed="never")
    else:
        loop, config = defs.torch_tiny_llama, {"dtype": "float32", "device": "cpu", "params": jax_tiny_params}
        backend = ttrain.backend.JaxConfig(distributed="never")
    result = fit(train.JaxTrainer(
        loop,
        train_loop_config={"pkg": pkg, **config},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(name="t", storage_path=str(tmp_path)),
        backend_config=backend,
    ))
    assert result.metrics["last_loss"] < result.metrics["first_loss"]
    losses = result.metrics["losses"]
    if pkg == "ray_tpu":
        _REF["jax_losses"] = losses
    else:
        assert result.metrics["device"] == "cpu"
        want = _REF.get("jax_losses")
        if want is not None:
            assert all(abs(a - b) <= STEP_RTOL * abs(b) for a, b in zip(losses, want)), (losses, want)


def _client(pkg):
    return MODS[pkg][0].core.context.get_client()


def _add_node(pkg, res):
    """ray_tpu's default node (an agent) or the port's in-process node."""
    c = _client(pkg)
    return c.add_node(res) if pkg == "ray_tpu" else c.add_node(res, remote=False)


@pytest.fixture(params=PKGS)
def pkg2(request):
    """A fresh runtime of the parameter's package with 2 CPUs (the elastic cases)."""
    rt = MODS[request.param][0]
    rt.shutdown()
    rt.init(num_cpus=2)
    yield request.param
    rt.shutdown()


class Commits:
    """A RunConfig callback (the tune.callbacks API) in the driver: the
    metrics the controller commits, in order. The elastic cases change the
    cluster only once a step has been committed at the world size they
    wait for; a step that rank 0 reported but the other rank had not (a
    round not yet committed) is lost with the node, so a signal from the
    loop itself races the commit."""

    def __init__(self):
        self.rows: list = []
        self.lock = threading.Lock()

    def setup(self, run_dir):
        pass

    def log_trial_result(self, trial, metrics):
        with self.lock:
            self.rows.append(dict(metrics))

    def log_trial_end(self, trial):
        pass

    def on_experiment_end(self, trials):
        pass

    def wait(self, pred, timeout=150.0, done=None):
        """The first committed metrics matching ``pred`` (None on timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not (done is not None and done.is_set()):
            with self.lock:
                hit = next((m for m in self.rows if pred(m)), None)
            if hit is not None:
                return hit
            time.sleep(0.1)
        return None


def _elastic(pkg, tmp_path, config, commits, max_failures=None, poll_interval_s=1.0):
    _, train, _ = MODS[pkg]
    scaling = train.ScalingConfig(num_workers=2, resources_per_worker={"CPU": 2})
    run_kw = dict(callbacks=[commits])
    if max_failures is not None:
        run_kw["failure_config"] = train.FailureConfig(max_failures=max_failures)
    return trainer(pkg, defs.elastic_steps, tmp_path, config=config, scaling_config=scaling, run_kw=run_kw,
                   scaling_policy=train.ElasticScalingPolicy(scaling, min_workers=1, max_workers=2,
                                                            poll_interval_s=poll_interval_s))


def test_elastic_scaling_shrinks_on_node_loss_then_regrows(pkg2, tmp_path):
    """Losing a node mid-run resumes at a smaller world size from the
    checkpoint, then grows back when capacity returns, with no lost or
    duplicated steps."""
    pkg = pkg2
    client = _client(pkg)
    extra = _add_node(pkg, {"CPU": 2.0})  # second worker's capacity, up front
    commits = Commits()

    def chaos_capacity():
        # the node loss only once the 2-worker phase has committed a step
        commits.wait(lambda m: m["world_size"] == 2 and m["step"] >= 1)
        client.remove_node(extra.node_id, graceful=False)  # shrink mid-run
        time.sleep(3.5)
        _add_node(pkg, {"CPU": 2.0})  # capacity returns: regrow

    threading.Thread(target=chaos_capacity, daemon=True).start()
    result = fit(_elastic(pkg, tmp_path, {"total": 20, "sleep": 0.4}, commits, max_failures=3))
    assert result.error is None
    sizes = [m["world_size"] for m in result.metrics_history]
    steps = [m["step"] for m in result.metrics_history]
    assert sizes[0] == 2, f"should start at 2 workers: {sizes}"
    assert 1 in sizes, f"group never SHRANK after the node loss: {sizes}"
    assert sizes[-1] == 2, f"group never regrew after capacity returned: {sizes}"
    assert sizes.index(1) < len(sizes) - list(reversed(sizes)).index(2) - 1
    assert steps == sorted(set(steps)) and steps[-1] == 19, steps
    check_same(pkg, "shrink", (steps, sizes[0], sizes[-1], 1 in sizes))


def test_elastic_scaling_grows_group_when_node_joins(pkg2, tmp_path):
    """A node added mid-run makes the worker group grow at the next
    restart boundary."""
    pkg = pkg2
    commits = Commits()

    def add_node_later():
        # the node joins once the 1-worker phase has committed a step (ray_tpu's case sleeps 2.5 s, which a
        # loaded host can spend before the first attempt is sized)
        commits.wait(lambda m: m["world_size"] == 1)
        _add_node(pkg, {"CPU": 2.0})

    threading.Thread(target=add_node_later, daemon=True).start()
    result = fit(_elastic(pkg, tmp_path, {"total": 10, "sleep": 0.4}, commits))
    assert result.error is None
    sizes = [m["world_size"] for m in result.metrics_history]
    steps = [m["step"] for m in result.metrics_history]
    assert sizes[0] == 1, f"should start at 1 worker (only 2 CPUs): {sizes}"
    assert sizes[-1] == 2, f"group never grew after the node joined: {sizes}"
    assert steps == sorted(set(steps)) and steps[-1] == 9, steps
    check_same(pkg, "grow", (steps, sizes[0], sizes[-1]))


def _dataset_fits(pkg, tmp_path, n_fits, prefix):
    _, train, data = MODS[pkg]
    rows = [{"x": float(i)} for i in range(600)]
    out = []
    for i in range(n_fits):
        res = fit(trainer(pkg, defs.dataset_rows, tmp_path, name=f"{prefix}{i}", datasets={"train": data.from_items(rows)}),
                  raise_on_error=False)
        assert res.error is None, f"fit #{i}: {res.error}"
        out.append(res.metrics["n"])
    return out


def test_second_dataset_fit_same_session(pkg, tmp_path):
    """Two dataset-fed fits in one session (the second on a fresh actor
    worker, as ray_tpu's regression case)."""
    assert check_same(pkg, "second_fit", _dataset_fits(pkg, tmp_path, 2, "f")) == [600, 600]


def test_repeated_elasticity_chaos_cycles(tmp_path):
    """grow -> shrink (node kill) -> regrow across 3 cycles under
    worker-channel chaos (the port's ``to_worker`` and ``done`` sites, the
    counterparts of ray_tpu's ``to_worker`` and ``from_worker``), with
    each step committed exactly once, in order. On the port alone (module
    docstring)."""
    from ray_tpu_torch.core import rpc_chaos

    pkg = "ray_tpu_torch"
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        client = _client(pkg)
        extra = _add_node(pkg, {"CPU": 2.0})
        total = 24
        done = threading.Event()
        cycles_done = [0]
        commits = Commits()

        def wait_committed(target, prev_step):
            """The first step newer than prev_step that the controller
            committed at the target world size, or None on timeout: each
            transition waits until the previous phase has provably landed
            in the metrics stream."""
            hit = commits.wait(lambda m: m["world_size"] == target and m["step"] > prev_step, done=done)
            return None if hit is None else hit["step"]

        def chaos_cycles():
            rpc_chaos.inject("to_worker", delay_s=0.005)
            rpc_chaos.inject("done", delay_s=0.005)
            node, last = extra, -1
            for _ in range(3):
                last_c = wait_committed(2, last)
                if last_c is None:
                    return
                last = last_c
                client.remove_node(node.node_id, graceful=False)  # shrink
                last_c = wait_committed(1, last)
                if last_c is None:
                    return
                last = last_c
                node = _add_node(pkg, {"CPU": 2.0})  # regrow
                cycles_done[0] += 1

        threading.Thread(target=chaos_cycles, daemon=True).start()
        result = fit(_elastic(pkg, tmp_path, {"total": total, "sleep": 0.3}, commits, max_failures=8,
                              poll_interval_s=0.5), timeout=240)
        done.set()
        rpc_chaos.clear()
        assert result.error is None
        steps = [m["step"] for m in result.metrics_history]
        sizes = [m["world_size"] for m in result.metrics_history]
        assert steps == list(range(total)), steps
        shrinks = sum(1 for a, b in zip(sizes, sizes[1:]) if a == 2 and b == 1)
        regrows = sum(1 for a, b in zip(sizes, sizes[1:]) if a == 1 and b == 2)
        assert cycles_done[0] >= 3, f"chaos thread completed {cycles_done[0]} cycles"
        assert shrinks >= 2 and regrows >= 2, (sizes, shrinks, regrows)
    finally:
        rpc_chaos.clear()
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("which", PKGS)
def test_worker_reuse_arrow_stress(which, tmp_path, monkeypatch):
    """Three dataset-fed fits in one session. ray_tpu's case sets
    RT_DEBUG_REUSE_ACTOR_WORKERS=1 so its actors land on workers that ran
    Data block tasks; the port has no such knob (every actor takes a
    never-used worker), so its parameter runs the fits on that default
    policy, and its block reads are numpy slices, not Arrow's."""
    rt = MODS[which][0]
    rt.shutdown()
    if which == "ray_tpu":
        monkeypatch.setenv("RT_DEBUG_REUSE_ACTOR_WORKERS", "1")
    try:
        rt.init(num_cpus=4)
        assert check_same(which, "reuse", _dataset_fits(which, tmp_path, 3, "s")) == [600, 600, 600]
    finally:
        rt.shutdown()


# ---------------------------------------------------------------- the port's rules
def _adamw_tree(device="cpu"):
    """A parameter tree after two AdamW steps, and its optimizer."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 8, generator=g, device=device, requires_grad=True),
              "layers": {"b": torch.randn(8, generator=g, device=device).bfloat16().requires_grad_(True)}}
    opt = torch.optim.AdamW([params["w"], params["layers"]["b"]], lr=1e-2, weight_decay=0.01)
    for _ in range(2):
        opt.zero_grad()
        ((params["w"] ** 2).sum() + params["layers"]["b"].float().sum()).backward()
        opt.step()
    return params, opt


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    else:
        assert a == b


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _step_from(tree):
    """One more AdamW step from a saved tree: the new parameters."""
    w = tree["params"]["w"].clone().requires_grad_(True)
    b = tree["params"]["layers"]["b"].clone().requires_grad_(True)
    opt = torch.optim.AdamW([w, b], lr=1e-2, weight_decay=0.01)
    opt.load_state_dict(_clone(tree["opt"]))
    ((w**2).sum() + b.float().sum()).backward()
    opt.step()
    return {"w": w.detach(), "b": b.detach()}


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_jax_checkpoint_round_trips_params_and_adamw_state(tmp_path, async_save):
    """Parameters (f32 and bf16), an AdamW state_dict and a step survive
    save_pytree/restore_pytree exactly, and the restored state takes the
    same next step as the saved one; async_save copies before it returns."""
    from ray_tpu_torch.train import jax_checkpoint

    params, opt = _adamw_tree()
    tree = {"params": params, "opt": opt.state_dict(), "step": 2}
    snap = _clone(tree)
    handle = jax_checkpoint.save_pytree(str(tmp_path), tree, async_save=async_save)
    if async_save:
        with torch.no_grad():
            params["w"].zero_()  # the save took its copy before returning
        handle.wait_until_finished(timeout=T)
    else:
        assert handle is None
    assert os.listdir(tmp_path) == ["state"]
    back = jax_checkpoint.restore_pytree(str(tmp_path), target=snap, device="cpu")
    _equal_trees(back, snap)
    _equal_trees(_step_from(back), _step_from(snap))
    with pytest.raises(ValueError, match="target"):
        jax_checkpoint.restore_pytree(str(tmp_path), target={**snap, "params": {"w": snap["params"]["w"]}},
                                      device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device axes"):
        jax_checkpoint.restore_pytree(str(tmp_path), shardings={}, device="cpu")


def test_use_tpu_with_topology_raises():
    with pytest.raises(NotImplementedError, match="no counterpart on one H100"):
        ttrain.ScalingConfig(use_tpu=True, topology="2x2")
    assert ttrain.ScalingConfig(resources_per_worker={"TPU": 1})._worker_resources == {"GPU": 1, "CPU": 1.0}
    assert ttrain.ScalingConfig(use_gpu=True)._worker_resources == {"CPU": 1.0}  # use_gpu reserves nothing


def test_lambda_and_closure_loops_raise_at_fit(tmp_path):
    def local(config):
        pass

    ray_tpu_torch.shutdown()
    for loop in (lambda config: None, local):
        t = ttrain.DataParallelTrainer(loop, run_config=ttrain.RunConfig(name="l", storage_path=str(tmp_path)))
        with pytest.raises(TypeError, match="by reference"):
            t.fit()
    assert not ray_tpu_torch.is_initialized()  # raised before any runtime or worker started


def test_gpu_worker_is_bound_to_its_card(tmp_path):
    """A worker asking for "GPU" through resources_per_worker (its
    placement-group bundle) is forked with CUDA_VISIBLE_DEVICES, as a
    num_gpus actor is. With no CUDA here it trains on the CPU, and
    JaxConfig(distributed="always") builds a one-rank gloo group."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)  # one card as a resource (none for CUDA here)
    try:
        for res in ({"CPU": 1, "GPU": 1}, {"CPU": 1, "TPU": 1}):
            result = fit(ttrain.JaxTrainer(
                defs.card_env, train_loop_config={"pkg": "ray_tpu_torch"},
                scaling_config=ttrain.ScalingConfig(num_workers=1, resources_per_worker=res),
                run_config=ttrain.RunConfig(name="gpu", storage_path=str(tmp_path)),
                backend_config=ttrain.backend.JaxConfig(distributed="always")))
            assert result.metrics["visible"] == "0" and result.metrics["device"] == "cpu", result.metrics
            assert result.metrics["backend"] == "gloo"
            assert ray_tpu_torch.available_resources().get("GPU") == 1.0  # the card came back
        result = fit(ttrain.DataParallelTrainer(
            defs.card_env, train_loop_config={"pkg": "ray_tpu_torch"},
            run_config=ttrain.RunConfig(name="cpu", storage_path=str(tmp_path))))
        assert result.metrics["visible"] is None and result.metrics["backend"] is None, result.metrics
    finally:
        ray_tpu_torch.shutdown()


def test_jax_checkpoint_through_a_restart(tmp_path):
    """A worker saves a tree with jax_checkpoint and reports it; the
    controller commits a copy; a second fit resumed from it restores the
    tree in its worker."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        cfg = ttrain.RunConfig(name="jc", storage_path=str(tmp_path))
        first = fit(ttrain.DataParallelTrainer(defs.jax_checkpoint_loop, run_config=cfg))
        assert os.listdir(first.checkpoint.path) == ["state"]
        second = fit(ttrain.DataParallelTrainer(defs.jax_checkpoint_loop, run_config=ttrain.RunConfig(
            name="jc2", storage_path=str(tmp_path)), resume_from_checkpoint=first.checkpoint))
        assert second.metrics["restored_step"] == 3 and second.metrics["w"] == [0.0, 1.0, 2.0, 3.0]
    finally:
        ray_tpu_torch.shutdown()
