"""RLlib's DQN-family learning cases on the port (``ray_tpu_torch.rllib``),
on the CPU.

Twins of ``tests/test_rllib.py``'s DQN learns CartPole, prioritized DQN
learns, the offline learner recovers the optimal action and DQN's offline
training step end to end, and ``tests/test_sac_connectors.py``'s CQL
against DQN on offline data, with ray_tpu's configurations, seeds,
iteration caps and thresholds. Draws differ from jax's
(``torch.Generator``s), so each case holds the threshold, not ray_tpu's
trajectory. Then the port's own: DQN with two remote env runners, whose
modules follow the epsilon schedule (``set_exploration`` reaches each
runner's distribution). Every case runs under a bound (``bounded``);
learners run with ``device="cpu"`` on one torch thread."""

import numpy as np
import pytest
import torch
from test_torch_rllib_learn import bounded, one_torch_thread, rt_start  # noqa: F401 (fixtures)
from test_torch_rllib_offpolicy import dqn_config


def _best_return(algo, iterations, stop_at):
    best = 0.0
    try:
        for _ in range(iterations):
            r = algo.train()
            best = max(best, r["env_runners"]["episode_return_mean"])
            if best >= stop_at:
                break
    finally:
        algo.stop()
    return best


def test_dqn_cartpole_learns():
    """VERDICT done-criterion: DQN learns CartPole off-policy."""
    best = bounded(lambda: _best_return(dqn_config().build_algo(), 80, stop_at=120))
    assert best >= 100, f"DQN failed to learn CartPole: best={best}"


def test_dqn_prioritized_replay_learns():
    best = bounded(lambda: _best_return(dqn_config(prioritized_replay=True).build_algo(), 60, stop_at=80))
    assert best >= 60, f"prioritized DQN stuck: best={best}"


def _reward_is_action_dataset(path, n_episodes, seed=0):
    """ray_tpu's synthetic dataset: obs uniform in [0, 1)^2, actions a coin
    flip, reward == action (the optimal policy always acts 1)."""
    from ray_tpu_torch.rllib.offline import write_episodes

    rng = np.random.default_rng(seed)
    episodes = []
    for _ in range(n_episodes):
        T = 6
        actions = rng.integers(0, 2, T)
        episodes.append({"obs": rng.random((T + 1, 2)).astype(np.float32), "actions": actions,
                         "rewards": actions.astype(np.float32), "logp": np.zeros(T, np.float32),
                         "terminated": True})
    write_episodes(path, episodes)
    return path


def test_offline_learner_recovers_optimal_action(tmp_path):
    """A learner trained purely from a recorded synthetic dataset (reward ==
    action) recovers the optimal action: the TD math over offline
    transitions, apart from the env plumbing."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQNConfig, DQNLearner, QModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
    from ray_tpu_torch.rllib.offline import read_episodes
    from ray_tpu_torch.rllib.utils.replay_buffers import EpisodeReplayBuffer

    ds = _reward_is_action_dataset(str(tmp_path / "offline_ds"), 200)
    assert len(read_episodes(ds)) == 200
    lcfg = DQNConfig().learners(device="cpu")
    lcfg.lr = 1e-2
    lcfg.gamma = 0.9
    spec = RLModuleSpec(QModule, gym.spaces.Box(-1, 1, (2,), np.float32), gym.spaces.Discrete(2),
                        {"fcnet_hiddens": (32,)})

    def run():
        ln = DQNLearner(spec, lcfg)
        ln.build(seed=0)
        buf = EpisodeReplayBuffer(10_000)
        for ep in read_episodes(ds):
            buf.add(ep)
        assert len(buf) == 1200
        for i in range(300):
            ln.update_dqn(buf.sample(64))
            if i % 100 == 0:
                ln.sync_target()
        with torch.no_grad():
            return ln.module(torch.as_tensor([[0.5, 0.5]]))["action_dist_inputs"].numpy()

    q = bounded(run)
    assert float(q[0, 1]) > float(q[0, 0]) + 0.3, q


def test_dqn_offline_training_step_end_to_end(tmp_path):
    """The offline path through DQN.training_step: record CartPole
    experience online, then an offline DQN trains from the dataset and
    evaluates greedily (no new experience enters its buffer)."""
    from ray_tpu_torch.rllib import DQNConfig
    from ray_tpu_torch.rllib.offline import read_episodes

    ds = str(tmp_path / "cartpole_ds")

    def run():
        rec = (DQNConfig().environment("CartPole-v1")
               .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=256).debugging(seed=0)
               .offline_data(output=ds).learners(device="cpu"))
        algo = rec.build_algo()
        for _ in range(4):
            algo.train()
        algo.stop()
        n_recorded = sum(len(e["actions"]) for e in read_episodes(ds))
        assert n_recorded >= 800
        off = DQNConfig().environment("CartPole-v1").debugging(seed=1).offline_data(input_=ds).learners(device="cpu")
        off.training(lr=1e-3, offline_updates_per_iter=30, train_batch_size=64)
        algo2 = off.build_algo()
        buf_before = len(algo2.replay)
        assert buf_before == n_recorded  # the dataset loaded once, whole
        r = None
        try:
            for _ in range(3):
                r = algo2.train()
        finally:
            algo2.stop()
        return r, n_recorded, buf_before, len(algo2.replay)

    r, n_recorded, buf_before, buf_after = bounded(run)
    assert r["learner"]["num_updates"] == 30
    assert r["offline_transitions"] == n_recorded
    assert buf_after == buf_before, "offline buffer must not grow from eval rollouts"
    # greedy eval ran through the runners (a policy good enough never to
    # terminate within the window reports NaN return: still "ran")
    assert "episode_return_mean" in r["env_runners"]


def test_cql_conservative_vs_dqn_on_offline_data(tmp_path):
    """CQL, trained on the same narrow offline dataset as plain offline DQN,
    (a) still recovers the logged-optimal action and (b) assigns lower Q
    to the out-of-distribution action than DQN does."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.algorithms.cql.cql import CQLConfig, CQLLearner
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQNConfig, DQNLearner, QModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
    from ray_tpu_torch.rllib.offline import read_episodes
    from ray_tpu_torch.rllib.utils.replay_buffers import EpisodeReplayBuffer

    # narrow behavior policy: never takes action 2 (OOD); reward == action
    ds = _reward_is_action_dataset(str(tmp_path / "narrow"), 150)
    spec = RLModuleSpec(QModule, gym.spaces.Box(-1, 1, (2,), np.float32), gym.spaces.Discrete(3),
                        {"fcnet_hiddens": (32,)})  # action 2 exists but is never logged

    def train(learner_cls, cfg):
        cfg.lr = 1e-2
        cfg.gamma = 0.9
        ln = learner_cls(spec, cfg.learners(device="cpu"))
        ln.build(seed=0)
        buf = EpisodeReplayBuffer(10_000)
        for ep in read_episodes(ds):
            buf.add(ep)
        for i in range(300):
            ln.update_dqn(buf.sample(64))
            if i % 100 == 0:
                ln.sync_target()
        with torch.no_grad():
            return ln.module(torch.as_tensor([[0.5, 0.5]]))["action_dist_inputs"].numpy()[0]

    q_dqn, q_cql = bounded(lambda: (train(DQNLearner, DQNConfig()), train(CQLLearner, CQLConfig())))
    # both recover the logged-optimal action among the in-distribution ones
    assert q_cql[1] > q_cql[0], q_cql
    # conservatism: the never-logged action's gap to the best logged one is
    # larger under CQL than under plain DQN
    gap_dqn = q_dqn[1] - q_dqn[2]
    gap_cql = q_cql[1] - q_cql[2]
    assert gap_cql > gap_dqn, (q_dqn, q_cql)
    assert q_cql[2] < q_cql[1], q_cql  # the OOD action never preferred


def test_dqn_remote_env_runners_follow_the_epsilon_schedule(rt_start):
    """Two remote env runners: each iteration's epsilon (the linear
    schedule) reaches every runner's module, and the samples they send
    fill the replay buffer."""
    cfg = dqn_config(num_env_runners=2, num_envs_per_env_runner=2, epsilon_timesteps=1000)

    def run():
        algo = cfg.build_algo()
        try:
            seen = []
            for _ in range(3):
                r = algo.train()
                seen.append((r["epsilon"], algo.env_runner_group.get_exploration("eps"), len(algo.replay)))
        finally:
            algo.stop()
        return seen

    seen = bounded(run)
    for eps, on_runners, _ in seen:
        assert on_runners == [pytest.approx(eps)] * 2, seen
    assert seen[0][0] == 1.0 and seen[1][0] < seen[0][0] and seen[2][0] < seen[1][0], seen
    assert 0 < seen[0][2] < seen[1][2] < seen[2][2], seen
