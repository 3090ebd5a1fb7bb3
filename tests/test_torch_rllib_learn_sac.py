"""RLlib's SAC, BC and MARWIL learning cases on the port
(``ray_tpu_torch.rllib``), on the CPU.

Twins of ``tests/test_sac_connectors.py``'s SAC learns Pendulum and BC
clones the expert, and ``tests/test_appo_marwil.py``'s MARWIL upweights
high-advantage actions and MARWIL with beta = 0 clones, with ray_tpu's
configurations, seeds, iteration caps and thresholds. Draws differ from
jax's (``torch.Generator``s), so each case holds the threshold, not
ray_tpu's trajectory. ray_tpu's BC and MARWIL cases start a runtime
around the algorithm; it runs no remote actor there, so these do not.
Every case runs under a bound (``bounded``); learners run with
``device="cpu"`` on one torch thread."""

import numpy as np
import pytest
import torch
from test_torch_rllib_learn import bounded, one_torch_thread  # noqa: F401 (fixture)


def test_sac_pendulum_learns():
    """Random play on Pendulum scores about -1200; SAC must clearly beat it
    within the budget, and alpha's tuning moves the temperature."""
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig

    cfg = (SACConfig().environment("Pendulum-v1").env_runners(num_envs_per_env_runner=4, rollout_fragment_length=256)
           .training(lr=3e-4, train_batch_size=256).learners(device="cpu"))
    cfg.num_steps_sampled_before_learning_starts = 1000
    cfg.train_intensity = 128.0
    cfg.model = {"fcnet_hiddens": (64, 64)}
    cfg.seed = 0

    def run():
        algo = cfg.build()
        best, r = -1e9, None
        try:
            for _ in range(130):
                r = algo.train()
                ret = r["env_runners"]["episode_return_mean"]
                if np.isfinite(ret):
                    best = max(best, ret)
                if best > -900.0:
                    break
        finally:
            algo.stop()
        return best, r

    best, r = bounded(run)
    assert best > -900.0, f"SAC failed to learn: best return {best:.1f}"
    assert r["learner"]["alpha"] != pytest.approx(0.1, abs=1e-4)


def test_bc_clones_expert_policy(tmp_path):
    """BC recovers the expert's action mapping from a recorded dataset: the
    expert picks action 1 when obs[0] > 0, else 0; the cloned policy
    reproduces it deterministically."""
    from ray_tpu_torch.rllib.algorithms.bc import BCConfig
    from ray_tpu_torch.rllib.offline import write_episodes

    rng = np.random.default_rng(0)
    episodes = []
    for _ in range(150):
        T = 8
        obs = rng.uniform(-1, 1, (T + 1, 4)).astype(np.float32)
        episodes.append({"obs": obs, "actions": (obs[:T, 0] > 0).astype(np.int64), "rewards": np.ones(T, np.float32),
                         "logp": np.zeros(T, np.float32), "terminated": True})
    ds = str(tmp_path / "expert")
    write_episodes(ds, episodes)
    cfg = BCConfig().environment("CartPole-v1").training(lr=3e-3, train_batch_size=128).learners(device="cpu")
    cfg.input_ = ds
    cfg.updates_per_iter = 80
    cfg.model = {"fcnet_hiddens": (32, 32)}

    def run():
        algo = cfg.build()
        try:
            r = None
            for _ in range(5):
                r = algo.train()
            test_obs = rng.uniform(-1, 1, (64, 4)).astype(np.float32)
            ln = algo.learner_group._local
            with torch.no_grad():
                out = ln.module(torch.as_tensor(test_obs))
                acts = ln.module.action_dist_cls.deterministic(out["action_dist_inputs"]).numpy()
        finally:
            algo.stop()
        return r, test_obs, acts

    r, test_obs, acts = bounded(run)
    assert r["learner"]["bc_logp_mean"] > -0.2, r["learner"]  # near-certain cloning
    want = (test_obs[:, 0] > 0).astype(np.int64)
    assert (acts == want).mean() > 0.95, (acts[:10], want[:10])


def _mixed_quality_dataset(tmp_path, n_episodes=200, T=8, seed=0):
    """The recorded behavior is a 50/50 coin flip; reward == action. An
    imitator that clones the behavior (BC, beta = 0) stays near 50/50;
    advantage re-weighting must tilt toward action 1."""
    from ray_tpu_torch.rllib.offline import write_episodes

    rng = np.random.default_rng(seed)
    episodes = []
    for _ in range(n_episodes):
        obs = rng.uniform(-1, 1, (T + 1, 4)).astype(np.float32)
        actions = rng.integers(0, 2, T)
        episodes.append({"obs": obs, "actions": actions, "rewards": actions.astype(np.float32),
                         "logp": np.full(T, np.log(0.5), np.float32), "terminated": True})
    ds = str(tmp_path / "mixed")
    write_episodes(ds, episodes)
    return ds


def _marwil_p1(tmp_path, beta, iterations):
    """ray_tpu's MARWIL case: (last result, P(a = 1) on 256 held-out obs)."""
    from ray_tpu_torch.rllib import MARWILConfig

    cfg = MARWILConfig().environment("CartPole-v1").training(lr=3e-3, train_batch_size=256).learners(device="cpu")
    cfg.input_ = _mixed_quality_dataset(tmp_path)
    cfg.beta = beta
    cfg.updates_per_iter = 120
    cfg.model = {"fcnet_hiddens": (32, 32)}
    cfg.seed = 0

    def run():
        algo = cfg.build_algo()
        try:
            r = None
            for _ in range(iterations):
                r = algo.train()
            obs = np.random.default_rng(7).uniform(-1, 1, (256, 4)).astype(np.float32)
            with torch.no_grad():
                out = algo.learner_group._local.module(torch.as_tensor(obs))
            probs = torch.softmax(out["action_dist_inputs"], dim=-1).numpy()
        finally:
            algo.stop()
        return r, float(probs[:, 1].mean())

    return bounded(run)


def test_marwil_upweights_high_advantage_actions(tmp_path):
    """MARWIL with beta > 0 beats the behavior policy it was trained from:
    on held-out obs it picks the rewarded action far more often than the
    dataset's 50/50."""
    r, p1 = _marwil_p1(tmp_path, beta=2.0, iterations=4)
    assert r["dataset_transitions"] == 200 * 8
    assert np.isfinite(r["learner"]["ma_adv_norm"])
    assert p1 > 0.75, f"MARWIL stayed near behavior policy: P(a=1)={p1:.3f}"


def test_marwil_beta_zero_reduces_to_cloning(tmp_path):
    """beta = 0 removes the advantage weighting: the policy stays close to
    the recorded 50/50 behavior."""
    _, p1 = _marwil_p1(tmp_path, beta=0.0, iterations=3)
    assert 0.35 < p1 < 0.65, f"beta=0 should clone the 50/50 behavior, got P(a=1)={p1:.3f}"
