"""RLlib's learning cases on the port (``ray_tpu_torch.rllib``), on the CPU.

Twins of ``tests/test_rllib.py``'s PPO learns, PPO remote runners, IMPALA
learns and IMPALA multi-learner, and ``tests/test_appo_marwil.py``'s APPO
learns, with ray_tpu's configurations, seeds, iteration caps and
thresholds. Draws differ from jax's (``torch.Generator``s), so each holds
the threshold, not ray_tpu's trajectory. Remote env runners and learner
actors run on the port's runtime (a fresh one per test, 4 CPUs); the
learners' gradients are averaged through the collective API. Every case
runs under a bound (``bounded``), so a wait that never ends fails the
case instead of the suite. Learners run with ``device="cpu"``."""

import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch

BOUND_S = 240


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """In-process learners and runners on one intra-op thread: beside
    other test processes, torch's default pool (a thread per core) spins
    against theirs and an update slows by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bounded(fn, seconds=BOUND_S):
    """``fn()`` in a thread joined within ``seconds``; its result, or its
    exception re-raised."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.fixture
def rt_start():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _ppo_config(num_env_runners=0):
    from ray_tpu_torch.rllib import PPOConfig

    return (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=num_env_runners, num_envs_per_env_runner=8 if num_env_runners == 0 else 4)
        .training(lr=1e-3, gamma=0.98, lambda_=0.8, train_batch_size=2048, minibatch_size=256, num_epochs=20)
        .debugging(seed=0)
        .learners(device="cpu")
    )


def _impala_config(cls_name="IMPALAConfig"):
    import ray_tpu_torch.rllib as rl

    return (
        getattr(rl, cls_name)()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
        .training(lr=1e-3, train_batch_size=4000, entropy_coeff=0.005, rollout_fragment_length=100,
                  vf_loss_coeff=0.25)
        .debugging(seed=0)
        .learners(device="cpu")
    )


def _best_return(algo, iterations, stop_at=None):
    best = 0.0
    try:
        for _ in range(iterations):
            r = algo.train()
            best = max(best, r["env_runners"]["episode_return_mean"])
            if stop_at is not None and best >= stop_at:
                break
    finally:
        algo.stop()
    return best


def test_ppo_cartpole_learns():
    """BASELINE config #1: PPO on CartPole reaches ray_tpu's threshold."""
    best = bounded(lambda: _best_return(_ppo_config().build_algo(), 15, stop_at=150))
    assert best >= 120, f"PPO failed to learn CartPole: best={best}"


def test_ppo_remote_env_runners(rt_start):
    best = bounded(lambda: _best_return(_ppo_config(num_env_runners=2).build_algo(), 8))
    assert best >= 40, f"best={best}"


def test_impala_cartpole_learns():
    best = bounded(lambda: _best_return(_impala_config().build_algo(), 22, stop_at=60))
    assert best >= 40, f"IMPALA failed to learn: best={best}"


def test_impala_multi_learner(rt_start):
    """BASELINE config #5's shape: a multi-learner group with a gradient
    allreduce and the async sampling pipeline. Both learners hold equal
    weights after the updates."""
    cfg = _impala_config()
    cfg.num_env_runners = 2
    cfg.num_envs_per_env_runner = 4
    cfg.num_learners = 2

    def run():
        algo = cfg.build_algo()
        try:
            rets = [algo.train()["env_runners"]["episode_return_mean"] for _ in range(6)]
            actors = algo.learner_group._actors
            weights = ray_tpu_torch.get([a.get_weights.remote() for a in actors], timeout=60)
            syncs = ray_tpu_torch.get([a.sync_ms.remote() for a in actors], timeout=60)
        finally:
            algo.stop()
        return rets, weights, syncs

    rets, (w0, w1), syncs = bounded(run)
    assert np.isfinite(rets[-1])
    assert rets[-1] > 21, f"returns not improving: {rets}"
    for k in w0:
        np.testing.assert_array_equal(w0[k].numpy(), w1[k].numpy())
    assert [len(s) for s in syncs] == [6, 6]  # one allreduce per update (one minibatch a shard)


def test_appo_cartpole_learns():
    best = bounded(lambda: _best_return(_impala_config("APPOConfig").build_algo(), 22, stop_at=60))
    assert best >= 40, f"APPO failed to learn: best={best}"
