"""RLlib's off-policy and offline half on the port (``ray_tpu_torch.rllib``),
on the CPU: the unit and mechanics cases.

Twins of ``tests/test_rllib.py``'s three replay-buffer cases, DQN's
checkpoint round trip and the online run that records a dataset;
``tests/test_sac_connectors.py``'s SAC module shapes and SAC checkpoint
round trip; ``tests/test_appo_marwil.py``'s MARWIL offline-only refusal.
ray_tpu's seeds and settings stand; the port's modules hold their
parameters, so a case reads them from the state dict (``q.0.w``) where
ray_tpu's reads its pytree. Then the rules: an on-policy algorithm
refuses ``offline_data(input_=...)`` and ``input_`` with ``output``
conflicts, in ray_tpu's exception types and words; the single-learner
algorithms refuse remote learners in ray_tpu's words; offline DQN refuses
a dataset larger than its buffer and an empty one; a Q-module pickles
under the standard library; the new learners ask for the card by
default, and (``cuda``-marked) one DQN and one SAC update on the card
equal the host's. The learning cases are in ``tests/test_torch_rllib_learn_dqn.py``
and ``tests/test_torch_rllib_learn_sac.py``; the numbers against
ray_tpu's in ``tests/test_torch_rllib_offpolicy_parity.py``. Learners
run with ``device="cpu"``: the card is their default. gymnasium is
imported where a case needs it, so the card's cases run without it."""

import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_rllib_learn import one_torch_thread  # noqa: F401 (fixture)


# ---------------------------------------------------------------- replay buffers
def test_episode_replay_buffer_transitions():
    from ray_tpu_torch.rllib import EpisodeReplayBuffer

    buf = EpisodeReplayBuffer(capacity=100)
    seg = {
        "obs": np.arange(10, dtype=np.float32).reshape(5, 2),  # T=4 (+1 bootstrap)
        "actions": np.array([0, 1, 0, 1]),
        "rewards": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
        "terminated": True,
    }
    rows = buf.add(seg)
    assert len(rows) == 4 and len(buf) == 4
    b = buf.sample(32)
    assert b["obs"].shape == (32, 2) and b["next_obs"].shape == (32, 2)
    # only the final transition of a terminated episode is done
    for o, no, d in zip(b["obs"], b["next_obs"], b["done"]):
        assert no[0] == o[0] + 2
        assert d == (1.0 if o[0] == 6 else 0.0)


def test_replay_buffer_ring_wraparound():
    from ray_tpu_torch.rllib import EpisodeReplayBuffer

    buf = EpisodeReplayBuffer(capacity=8)
    for i in range(5):
        buf.add({"obs": np.full((4, 1), i, np.float32), "actions": np.zeros(3, np.int64),
                 "rewards": np.zeros(3, np.float32), "terminated": False})
    assert len(buf) == 8  # capped
    vals = set(buf.sample(64)["obs"][:, 0].tolist())
    assert vals <= {3.0, 4.0, 2.0}  # oldest rows overwritten


def test_prioritized_buffer_biases_high_td():
    from ray_tpu_torch.rllib import PrioritizedEpisodeReplayBuffer

    buf = PrioritizedEpisodeReplayBuffer(capacity=64, alpha=1.0, beta=0.4)
    rows = buf.add({"obs": np.arange(33, dtype=np.float32).reshape(33, 1), "actions": np.zeros(32, np.int64),
                    "rewards": np.zeros(32, np.float32), "terminated": False})
    # one transition gets a huge TD error
    tds = np.full(len(rows), 0.01)
    tds[7] = 100.0
    buf.update_priorities(rows, tds)
    picked = buf.sample(256)["batch_indices"]
    frac = float(np.mean(picked == rows[7]))
    assert frac > 0.5, f"high-priority row sampled only {frac:.0%}"
    b = buf.sample(64)
    assert b["weights"].min() > 0 and b["weights"].max() <= 1.0


# ---------------------------------------------------------------- DQN
def dqn_config(**overrides):
    """ray_tpu's ``_dqn_config`` (tests/test_rllib.py), learner on the CPU."""
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (DQNConfig().environment("CartPole-v1").env_runners(num_envs_per_env_runner=4, rollout_fragment_length=256)
           .debugging(seed=0).learners(device="cpu"))
    cfg.training(lr=1e-3, train_batch_size=64, num_steps_sampled_before_learning_starts=1000,
                 target_network_update_freq=250, initial_epsilon=1.0, final_epsilon=0.05, epsilon_timesteps=5000,
                 train_intensity=8.0, model={"fcnet_hiddens": (64, 64)})
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def test_dqn_checkpoint_roundtrip(tmp_path):
    algo = dqn_config().build_algo()
    for _ in range(3):
        algo.train()
    path = algo.save_to_path(str(tmp_path / "dqn_ckpt"))
    algo2 = dqn_config().build_algo()
    algo2.restore_from_path(path)
    w1 = algo.learner_group.get_weights()
    w2 = algo2.learner_group.get_weights()
    np.testing.assert_allclose(w1["q.0.w"].numpy(), w2["q.0.w"].numpy())
    # target params restored too
    t1 = algo._learner.target.state_dict()
    t2 = algo2._learner.target.state_dict()
    np.testing.assert_allclose(t1["q.0.w"].numpy(), t2["q.0.w"].numpy())
    algo.stop()
    algo2.stop()


def test_dqn_online_run_writes_offline_dataset(tmp_path):
    """config.offline_data(output=...) records every sampled episode."""
    from ray_tpu_torch.rllib import DQNConfig
    from ray_tpu_torch.rllib.offline import read_episodes

    ds = str(tmp_path / "recorded")
    cfg = (DQNConfig().environment("CartPole-v1").env_runners(num_envs_per_env_runner=2, rollout_fragment_length=64)
           .debugging(seed=0).offline_data(output=ds).learners(device="cpu"))
    algo = cfg.build_algo()
    for _ in range(3):
        algo.train()
    algo.stop()
    eps = read_episodes(ds)
    assert len(eps) >= 3
    total = sum(len(e["actions"]) for e in eps)
    assert total >= 150  # ~3 x 64 steps recorded
    assert all(e["obs"].shape[1] == 4 for e in eps)  # CartPole obs dim


# ---------------------------------------------------------------- SAC
def test_sac_module_shapes():
    import gymnasium as gym

    from ray_tpu_torch.rllib.algorithms.sac import SACModule

    env = gym.make("Pendulum-v1")
    m = SACModule(env.observation_space, env.action_space, {"fcnet_hiddens": (16, 16)})
    assert {k.split(".")[0] for k in m.state_dict()} == {"pi", "q1", "q2", "log_alpha"}
    obs = torch.zeros((5, 3))
    with torch.no_grad():
        out = m(obs)
        q = m.q_values(m.q1, obs, torch.zeros((5, 1)))
    assert out["action_dist_inputs"].shape == (5, 2)  # mean + log_std
    assert q.shape == (5,)


def test_sac_checkpoint_roundtrip(tmp_path):
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig

    cfg = SACConfig().environment("Pendulum-v1").training(train_batch_size=32).learners(device="cpu")
    cfg.num_steps_sampled_before_learning_starts = 64
    cfg.rollout_fragment_length = 64
    cfg.model = {"fcnet_hiddens": (8,)}
    algo = cfg.build()
    algo.train()
    algo.train()
    path = algo.save_to_path(str(tmp_path / "ck"))
    algo2 = cfg.build()
    algo2.restore_from_path(path)
    for a, b in ((algo._learner.module, algo2._learner.module), (algo._learner.target_q, algo2._learner.target_q)):
        s1, s2 = a.state_dict(), b.state_dict()
        assert s1.keys() == s2.keys()
        for k in s1:
            np.testing.assert_allclose(s1[k].numpy(), s2[k].numpy())
    # Adam's state covers every parameter, log_alpha included
    assert len(algo2._learner.optimizer.state) == len(list(algo2._learner.module.parameters()))
    algo.stop()
    algo2.stop()


# ---------------------------------------------------------------- MARWIL
def test_marwil_requires_offline_input():
    from ray_tpu_torch.rllib import MARWILConfig

    cfg = MARWILConfig().environment("CartPole-v1").learners(device="cpu")
    with pytest.raises(ValueError, match="offline"):
        cfg.build_algo()


# ------------------------------------------------------- the rules
@pytest.mark.parametrize("name", ["PPOConfig", "IMPALAConfig", "APPOConfig"])
def test_on_policy_algorithms_refuse_offline_input(name, tmp_path):
    import ray_tpu_torch.rllib as rl

    cfg = getattr(rl, name)().environment("CartPole-v1").learners(device="cpu").offline_data(input_=str(tmp_path))
    algo = name[: -len("Config")]
    with pytest.raises(NotImplementedError, match=rf"^{algo} does not support offline_data\(input_=\.\.\.\); "
                                                  r"use an off-policy algorithm \(DQN\)$"):
        cfg.build_algo()


def test_offline_input_with_output_conflicts(tmp_path):
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (DQNConfig().environment("CartPole-v1").learners(device="cpu")
           .offline_data(input_=str(tmp_path / "in"), output=str(tmp_path / "out")))
    with pytest.raises(ValueError, match=r"offline_data\(input_=\.\.\., output=\.\.\.\) conflict: offline mode "
                                         "evaluates greedily"):
        cfg.build_algo()


@pytest.mark.parametrize("name", ["DQN", "CQL", "SAC", "BC", "MARWIL"])
def test_single_learner_algorithms_refuse_remote_learners(name, tmp_path):
    import ray_tpu_torch.rllib as rl

    env = "Pendulum-v1" if name == "SAC" else "CartPole-v1"
    cfg = getattr(rl, name + "Config")().environment(env).learners(num_learners=1, device="cpu")
    if name in ("CQL", "BC", "MARWIL"):
        cfg.offline_data(input_=str(tmp_path))
    words = (f"{name} runs a single (local) learner; scale sampling with num_env_runners"
             if name in ("DQN", "SAC") else f"{name} runs a single (local) learner")
    if name == "CQL":
        words = "DQN runs a single (local) learner; scale sampling with num_env_runners"  # CQL's setup is DQN's
    with pytest.raises(NotImplementedError) as e:
        cfg.build_algo()
    assert str(e.value) == words


def _dataset(path, n_episodes, T=6):
    from ray_tpu_torch.rllib.offline import write_episodes

    rng = np.random.default_rng(0)
    eps = [{"obs": rng.random((T + 1, 4)).astype(np.float32), "actions": rng.integers(0, 2, T),
            "rewards": np.ones(T, np.float32), "logp": np.zeros(T, np.float32), "terminated": True}
           for _ in range(n_episodes)]
    write_episodes(path, eps)
    return path


@pytest.mark.parametrize("case", ["oversized", "empty"])
def test_offline_dqn_refuses_oversized_and_empty_datasets(case, tmp_path):
    from ray_tpu_torch.rllib import DQNConfig

    ds = str(tmp_path / "ds")
    if case == "oversized":
        _dataset(ds, 20)  # 120 transitions
        match = r"exceeds replay_buffer_capacity \(100\)"
    else:
        (tmp_path / "ds").mkdir()
        (tmp_path / "ds" / "episodes-empty-00000.jsonl").write_text("")
        match = "contained no transitions"
    cfg = DQNConfig().environment("CartPole-v1").learners(device="cpu").offline_data(input_=ds)
    cfg.replay_buffer_capacity = 100
    with pytest.raises(ValueError, match=match):
        cfg.build_algo()


def test_q_module_pickles_with_its_epsilon():
    """The epsilon-greedy distribution is a module-level class with ``eps``
    on the instance, so a Q-module pickles under the standard library and
    two modules keep their own epsilon."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.algorithms.dqn import EpsilonGreedy, QModule

    obs, act = gym.spaces.Box(-1, 1, (4,), np.float32), gym.spaces.Discrete(2)
    a, b = QModule(obs, act, {"fcnet_hiddens": (8,), "epsilon": 0.3}), QModule(obs, act, {"fcnet_hiddens": (8,)})
    a.action_dist_cls.eps = 0.7
    assert b.action_dist_cls.eps == 0.1
    back = pickle.loads(pickle.dumps(a))
    assert isinstance(back.action_dist_cls, EpsilonGreedy) and back.action_dist_cls.eps == 0.7
    assert all(torch.equal(back.state_dict()[k], v) for k, v in a.state_dict().items())


@pytest.mark.parametrize("name", ["dqn", "sac"])
def test_off_policy_learners_default_to_the_card(name):
    """No ``device``: the learner asks for the card (and raises without one)."""
    import gymnasium as gym

    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNLearner, QModule
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig, SACLearner, SACModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    obs = gym.spaces.Box(-1, 1, (3,), np.float32)
    if name == "dqn":
        cls, spec, cfg = DQNLearner, RLModuleSpec(QModule, obs, gym.spaces.Discrete(2), {}), DQNConfig()
    else:
        cls, spec, cfg = SACLearner, RLModuleSpec(SACModule, obs, gym.spaces.Box(-2, 2, (1,), np.float32)), SACConfig()
    if torch.cuda.is_available():
        assert cls(spec, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(spec, cfg)


# CartPole-v1's and Pendulum-v1's spaces without gymnasium
CARTPOLE = (SimpleNamespace(shape=(4,)), SimpleNamespace(n=2))
PENDULUM = (SimpleNamespace(shape=(3,)), SimpleNamespace(shape=(1,), low=np.array([-2.0], np.float32),
                                                         high=np.array([2.0], np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dqn", "sac"])
def test_off_policy_update_on_cuda_equals_the_hosts(name):
    """ray_tpu's default widths (256, 256), f32: the learner's parameters on
    ``cuda``; one update there (SAC: on the host's noise) equals the
    same update on the host within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_tpu_torch.rllib import EpisodeReplayBuffer
    from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNLearner, QModule
    from ray_tpu_torch.rllib.algorithms.sac import SACConfig, SACLearner, SACModule
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    (obs_space, act_space), cls, module, cfg = {
        "dqn": (CARTPOLE, DQNLearner, QModule, DQNConfig()),
        "sac": (PENDULUM, SACLearner, SACModule, SACConfig())}[name]
    spec = RLModuleSpec(module, obs_space, act_space, {})
    card, hst = cls(spec, cfg), cls(spec, cfg.copy().learners(device="cpu"))
    for ln in (card, hst):
        ln.build(seed=0)
    assert {p.device.type for p in card.module.parameters()} == {"cuda"}
    rng = np.random.default_rng(0)
    buf = EpisodeReplayBuffer(10_000)
    for _ in range(20):
        T = 50
        actions = rng.integers(0, 2, T) if name == "dqn" else rng.uniform(-2, 2, (T, 1)).astype(np.float32)
        buf.add({"obs": rng.normal(size=(T + 1, obs_space.shape[0])).astype(np.float32), "actions": actions,
                 "rewards": rng.normal(size=T).astype(np.float32), "terminated": True})
    batch = buf.sample(cfg.train_batch_size)
    if name == "dqn":
        (mc, tdc), (mh, tdh) = card.update_dqn(batch), hst.update_dqn(batch)
        np.testing.assert_allclose(tdc, tdh, rtol=1e-4, atol=1e-5)
    else:
        noise = hst.draw_noise(cfg.train_batch_size)
        mc, mh = card.update_sac(batch, noise=noise), hst.update_sac(batch, noise=noise)
        for k, v in hst.target_q.state_dict().items():
            np.testing.assert_allclose(card.target_q.state_dict()[k].cpu().numpy(), v.numpy(), atol=1e-4)
    assert mc.keys() == mh.keys()
    for k in mh:
        assert mc[k] == pytest.approx(mh[k], rel=1e-4, abs=1e-5), (k, mc, mh)
    for k, v in hst.module.state_dict().items():
        np.testing.assert_allclose(card.module.state_dict()[k].cpu().numpy(), v.numpy(), atol=1e-4)
