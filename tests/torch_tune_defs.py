"""Trainables, train loops, actor classes and functions for the Tune and
actor-utility tests (``tests/test_torch_tune.py``,
``test_torch_tune_parity.py``, ``test_torch_ecosystem.py``).

The port sends a trainable, a loop, an actor class or a task's function
to its workers by reference (module and qualified name), so they live
here at module level, where both packages' workers import them; ray_tpu's
tests define them inline. A trainable takes its package's name from
``config["pkg"]`` and imports that package's ``tune`` or ``train``. No jax
at module level: a port worker imports this module (the ray_tpu-only loop
imports jax inside itself)."""

from __future__ import annotations

import importlib
import json
import os
import sys
import tempfile
import time

import numpy as np


def _tune(config):
    return importlib.import_module(config["pkg"] + ".tune")


def _train(config):
    return importlib.import_module(config["pkg"] + ".train")


# ---------------------------------------------------------------- test_tune.py's trainables
def grid_random(config):
    _tune(config).report({"score": config["a"] * 10 + config["b"]})


def choice_randint(config):
    _tune(config).report({"v": config["c"] + config["i"]})


def asha_linear(config):
    tune = _tune(config)
    for step in range(20):
        tune.report({"acc": config["q"] * (step + 1)})


def median_constant(config):
    tune = _tune(config)
    for _ in range(10):
        tune.report({"m": config["g"]})


def _load(tune, default):
    ckpt = tune.get_checkpoint()
    if ckpt is None:
        return default
    with open(os.path.join(ckpt.path, "s.json")) as f:
        return json.load(f)


def _save(tune, state: dict):
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "s.json"), "w") as f:
        json.dump(state, f)
    return tune.Checkpoint.from_directory(d)


def pbt_weights(config):
    tune = _tune(config)
    st = _load(tune, {"step": 0, "w": 0.0})
    step, w = st["step"], st["w"]
    while step < 12:
        w += config["lr"]
        step += 1
        tune.report({"w": w}, checkpoint=_save(tune, {"step": step, "w": w}))


def report_x(config):
    _tune(config).report({"x": config["v"]})


def with_data(config, data=None):
    _tune(config).report({"n": len(data) + config["k"]})


def inverse_lr_loss(config):
    _train(config).report({"loss": 100.0 / config["lr"]})


def fails_at_two(config):
    if config["v"] == 2:
        raise ValueError("boom")
    _tune(config).report({"v": config["v"]})


def three_scores(config):
    train = _train(config)
    for i in range(3):
        train.report({"score": i * config["m"]})


def timestamps(config):
    train = _train(config)
    for _ in range(4):
        train.report({"ts": time.time(), "tag": config["tag"]})
        time.sleep(0.3)


def report_one(config):
    _tune(config).report({"x": 1})


def inverse_lr_steps(config):
    tune = _tune(config)
    for i in range(3):
        tune.report({"loss": 1.0 / (config["lr"] * (i + 1))})


def pb2_peak(config):
    tune = _tune(config)
    st = _load(tune, {"step": 0, "w": 0.0})
    step, w = st["step"], st["w"]
    while step < 20:
        w += 1.0 - min(1.0, abs(config["lr"] - 0.3) / 0.3)  # peak at 0.3
        step += 1
        tune.report({"w": w, "lr": config["lr"]}, checkpoint=_save(tune, {"step": step, "w": w}))


def quadratic(config):
    _tune(config).report({"loss": (config["x"] - 0.7) ** 2 + (config["y"] - 0.2) ** 2})


def quadratic_kind(config):
    bump = 0.0 if config["kind"] == "good" else 0.5
    _tune(config).report({"loss": (config["x"] - 0.7) ** 2 + (config["y"] - 0.2) ** 2 + bump})


def bohb_acc(config):
    tune = _tune(config)
    for step in range(8):
        tune.report({"acc": (1.0 - abs(config["q"] - 0.5)) * (step + 1)})


def growing(config):
    tune = _tune(config)
    step = _load(tune, {"step": 0})["step"]
    while step < 8:
        step += 1
        tune.report({"acc": config["q"] * step}, checkpoint=_save(tune, {"step": step}))


# ---------------------------------------------------------------- test_ecosystem.py's actors and functions
class Doubler:
    def double(self, x):
        time.sleep(0.01 * (5 - x % 5))
        return 2 * x


def producer(q):
    time.sleep(0.3)
    q.put("prod")
    return True


def sq(x):
    return x * x


def add(a, b):
    return a + b


def resumable(config):
    """Checkpoints every iteration; crashes at iteration 3 unless the
    'fixed' marker exists. On resume it continues from the checkpoint."""
    train = _train(config)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with open(os.path.join(ckpt.path, "state.json")) as f:
            start = json.load(f)["iteration"] + 1
    for it in range(start, 6):
        if it == 3 and not os.path.exists(config["marker"]):
            raise RuntimeError("transient failure at iteration 3")
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"iteration": it}, f)
            train.report({"score": it * config["lr"], "iter_seen": it}, checkpoint=train.Checkpoint(d))


# ---------------------------------------------------------------- the scripted parity inputs
def derived(spec):
    """A ``sample_from`` function: a value derived from the config so far."""
    return spec["a"] * 2 + 1


def pbt_callable_spec():
    """A PBT mutation given as a callable."""
    return 0.125


# ---------------------------------------------------------------- the slice: a Tuner over JaxTrainer
def tiny_batch() -> dict:
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 512, (8, 32)).astype(np.int32),
            "targets": rng.integers(0, 512, (8, 32)).astype(np.int32)}


def jax_tiny_llama_lr(config):
    """ray_tpu's JaxTrainer loop at the trial's learning rate (jax imported
    here, in ray_tpu's worker): three steps of the tiny Llama, each
    reported."""
    from functools import partial

    import jax
    import optax

    from ray_tpu import train
    from ray_tpu.models.llama import LlamaConfig, init_params, loss_fn, param_logical_axes
    from ray_tpu.parallel.mesh import create_mesh
    from ray_tpu.parallel.train_step import make_train_step, shard_batch

    cfg = LlamaConfig.tiny(dtype="float32")
    mesh = create_mesh(dp=-1)
    init_fn, compile_step, _ = make_train_step(partial(loss_fn, config=cfg), optax.adamw(config["lr"]), mesh,
                                               param_logical_axes(cfg))
    state, shardings = init_fn(jax.random.PRNGKey(0), partial(init_params, cfg))
    step = compile_step(shardings)
    batch = shard_batch(tiny_batch(), mesh)
    for i in range(3):
        state, m = step(state, batch)
        train.report({"step": i + 1, "loss": float(m["loss"])})


def torch_tiny_llama_lr(config):
    """The same loop on the port, from ray_tpu's initial weights (numpy,
    through the loop's config) converted in the worker, on the CPU."""
    from functools import partial

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import LlamaConfig, loss_fn, param_logical_axes
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step, to_device
    from ray_tpu_torch.weights import params_from_jax

    cfg = LlamaConfig.tiny(dtype="float32")
    init_fn, step_fn = make_train_step(partial(loss_fn, config=cfg), adamw(config["lr"]),
                                       param_axes=param_logical_axes(cfg), device="cpu")
    state = init_fn(0, lambda _: params_from_jax(config["params"], "cpu"))
    batch = to_device(tiny_batch(), "cpu")
    for i in range(3):
        state, m = step_fn(state, batch)
        train.report({"step": i + 1, "loss": m["loss"].item()})


# ---------------------------------------------------------------- the port's rules
def worker_facts(config):
    """The jax, jaxlib, cloudpickle and ray_tpu modules the trial's worker
    holds, whether it is a port worker, and the card it is bound to."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "cloudpickle"))
    _tune(config).report({"bad": bad, "port_worker": "ray_tpu_torch.core.worker_main" in sys.modules,
                          "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid()})


def card_timestamps(config):
    """A train loop that reports its window and the card it is bound to."""
    train = _train(config)
    for _ in range(3):
        train.report({"ts": time.time(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})
        time.sleep(0.2)
