"""RLlib's on-policy half on the port (``ray_tpu_torch.rllib``), on the CPU:
the unit and mechanics cases.

Twins of ``tests/test_rllib.py``'s categorical, vtrace, mlp shapes, PPO
checkpoint round trip, both multi-agent cases and the offline JSON round
trip; ``tests/test_appo_marwil.py``'s two APPO mechanics cases; and
``tests/test_sac_connectors.py``'s four connector cases and the
squashed-Gaussian logp case. ray_tpu's seeds, caps and thresholds stand;
draws come from ``torch.Generator``s, not jax keys, so where a case
samples, it holds ray_tpu's threshold and not its trajectory (ROADMAP.md,
Differences kept on purpose). The learning cases are in
``tests/test_torch_rllib_learn.py``; the numbers against ray_tpu's in
``tests/test_torch_rllib_parity.py``; the off-policy and offline half's
in ``tests/test_torch_rllib_offpolicy*.py`` and
``tests/test_torch_rllib_learn_{dqn,sac}.py``. Then the port's rules: a
missing gymnasium is named, and (on the card) the learner's parameters
live on ``cuda``.
Learners run with ``device="cpu"``: the card is their default."""

import sys

import gymnasium as gym
import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.connectors import (
    CastToFloat32,
    ClipActions,
    ConnectorPipeline,
    FlattenObs,
    NormalizeObs,
    RescaleActions,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """In-process learners and runners on one intra-op thread: beside
    other test processes, torch's default pool (a thread per core) spins
    against theirs and an update slows by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- units
def test_categorical_distribution():
    from ray_tpu_torch.rllib.core.distributions import Categorical

    logits = torch.tensor([[2.0, 0.0, -1.0], [0.0, 0.0, 0.0]])
    lp = Categorical.logp(logits, torch.tensor([0, 2]))
    assert lp.shape == (2,)
    np.testing.assert_allclose(float(lp[1]), np.log(1 / 3), rtol=1e-5)
    ent = Categorical.entropy(logits)
    np.testing.assert_allclose(float(ent[1]), np.log(3), rtol=1e-5)
    assert float(Categorical.kl(logits, logits)[0]) == pytest.approx(0.0, abs=1e-6)
    samples = Categorical.sample(torch.Generator().manual_seed(0), logits[:1].repeat(2000, 1))
    assert np.bincount(samples.numpy(), minlength=3).argmax() == 0  # the argmax class dominates


def test_vtrace_on_policy_reduces_to_discounted_returns():
    from ray_tpu_torch.rllib.algorithms.impala.impala import vtrace

    rng = np.random.default_rng(0)
    N, T = 3, 10
    gamma = 0.9
    rewards = rng.normal(size=(N, T)).astype(np.float32)
    values = rng.normal(size=(N, T)).astype(np.float32)
    bootstrap = rng.normal(size=(N,)).astype(np.float32)
    logp = rng.normal(size=(N, T)).astype(np.float32)
    t = torch.as_tensor
    vs, _ = vtrace(t(logp), t(logp), t(rewards), t(values), t(bootstrap), torch.ones(N, T), torch.ones(N, T),
                   gamma, rho_clip=1.0, c_clip=1.0)
    expected = np.zeros((N, T))
    for i in range(N):
        acc = bootstrap[i]
        for s in range(T - 1, -1, -1):
            acc = rewards[i, s] + gamma * acc
            expected[i, s] = acc
    np.testing.assert_allclose(vs.numpy(), expected, rtol=1e-4, atol=1e-4)


def test_mlp_module_shapes():
    from ray_tpu_torch.rllib.core.rl_module import MLPModule

    env = gym.make("CartPole-v1")
    m = MLPModule(env.observation_space, env.action_space, {"fcnet_hiddens": (32, 32)})
    out = m(torch.zeros((5, 4)))
    assert out["action_dist_inputs"].shape == (5, 2)
    assert out["vf"].shape == (5,)
    assert isinstance(m, torch.nn.Module) and all(p.dtype == torch.float32 for p in m.parameters())
    env.close()


def _ppo_config():
    from ray_tpu_torch.rllib import PPOConfig

    return (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
        .training(lr=1e-3, gamma=0.98, lambda_=0.8, train_batch_size=2048, minibatch_size=256, num_epochs=20)
        .debugging(seed=0)
        .learners(device="cpu")
    )


def test_ppo_checkpoint_roundtrip(tmp_path):
    algo = _ppo_config().build_algo()
    algo.train()
    w0 = algo.learner_group.get_weights()
    path = algo.save_to_path(str(tmp_path / "ckpt"))
    algo2 = _ppo_config().build_algo()
    algo2.restore_from_path(path)
    assert algo2.iteration == algo.iteration
    w1 = algo2.learner_group.get_weights()
    assert w0.keys() == w1.keys()
    for k in w0:
        torch.testing.assert_close(w0[k], w1[k], rtol=0, atol=0)
    # the optimizer's moments came back too: one more identical update each
    s0, s1 = algo.learner_group.get_state(), algo2.learner_group.get_state()
    for k, v in s0["opt_state"]["state"].items():
        torch.testing.assert_close(v["exp_avg"], s1["opt_state"]["state"][k]["exp_avg"], rtol=0, atol=0)
    algo.stop()
    algo2.stop()


# ----------------------------------------------------------- multi-agent
class _TwoAgentTag:
    """Tiny 2-agent env: both agents see [pos], 'even' is rewarded for
    action 0 and 'odd' for action 1; an episode ends after 20 steps."""

    def reset(self, *, seed=None, options=None):
        self.t = 0
        return {"even": np.array([0.0], np.float32), "odd": np.array([0.0], np.float32)}, {}

    def step(self, action_dict):
        self.t += 1
        obs = {a: np.array([self.t / 20.0], np.float32) for a in ("even", "odd")}
        rewards = {"even": 1.0 if int(action_dict["even"]) == 0 else 0.0,
                   "odd": 1.0 if int(action_dict["odd"]) == 1 else 0.0}
        done = self.t >= 20
        return (obs, rewards, {"even": done, "odd": done, "__all__": done},
                {"even": False, "odd": False, "__all__": False}, {})


def _specs(hiddens):
    from ray_tpu_torch.rllib import MLPModule, RLModuleSpec

    obs_space = gym.spaces.Box(-1, 1, (1,), np.float32)
    act_space = gym.spaces.Discrete(2)
    return {pid: RLModuleSpec(MLPModule, obs_space, act_space, {"fcnet_hiddens": hiddens})
            for pid in ("p_even", "p_odd")}


def test_multi_agent_env_runner_routes_per_policy():
    from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnvRunner

    specs = _specs((16,))
    runner = MultiAgentEnvRunner(_TwoAgentTag, specs, policy_mapping_fn=lambda aid: f"p_{aid}", seed=1)
    runner.set_weights({pid: spec.build().init(i).state_dict() for i, (pid, spec) in enumerate(specs.items())})
    batches, metrics = runner.sample(45)
    assert set(batches) == {"p_even", "p_odd"}
    assert metrics["num_episodes"] == 2  # 45 steps = 2 full episodes + a partial one
    for pid, segs in batches.items():
        assert sum(len(s["actions"]) for s in segs) == 45, pid
        for s in segs:
            assert s["obs"].shape[0] == len(s["actions"]) + 1  # the bootstrap row


def test_multi_agent_two_policy_learning_smoke():
    """Each policy learns its own reward scheme from a few PPO updates on
    its routed batches (ray_tpu's seeds, 12 rounds, > 0.8)."""
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig, PPOLearner, gae
    from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnvRunner

    def rows_of(s, gamma, lam):
        adv = gae(s, s["vf_preds"][-1], gamma, lam)  # ray_tpu's case bootstraps from the last value
        return {"obs": s["obs"][:-1], "actions": s["actions"], "logp": s["logp"], "advantages": adv,
                "value_targets": (adv + s["vf_preds"]).astype(np.float32), "vf_preds": s["vf_preds"]}

    specs = _specs((32,))
    cfg = PPOConfig().debugging(seed=0).learners(device="cpu")
    cfg.num_epochs, cfg.minibatch_size, cfg.lr = 4, 64, 3e-3
    learners = {}
    for i, (pid, spec) in enumerate(specs.items()):
        ln = PPOLearner(spec, cfg)
        ln.build(seed=i)
        learners[pid] = ln
    runner = MultiAgentEnvRunner(_TwoAgentTag, specs, policy_mapping_fn=lambda aid: f"p_{aid}", seed=0)

    def mean_reward(batches):
        return {pid: float(np.mean(np.concatenate([s["rewards"] for s in segs]))) for pid, segs in batches.items()}

    first = None
    for _ in range(12):
        runner.set_weights({pid: ln.get_weights() for pid, ln in learners.items()})
        batches, _ = runner.sample(200)
        if first is None:
            first = mean_reward(batches)
        for pid, segs in batches.items():
            rows = [rows_of(s, cfg.gamma, cfg.lambda_) for s in segs]
            batch = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
            adv = batch["advantages"]
            batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
            learners[pid].update(batch, minibatch_size=cfg.minibatch_size, num_epochs=cfg.num_epochs)
    runner.set_weights({pid: ln.get_weights() for pid, ln in learners.items()})
    batches, _ = runner.sample(200)
    last = mean_reward(batches)
    assert last["p_even"] > max(0.8, first["p_even"]), (first, last)
    assert last["p_odd"] > max(0.8, first["p_odd"]), (first, last)


# --------------------------------------------------------------- offline
def test_offline_json_roundtrip(tmp_path):
    from ray_tpu_torch.rllib.offline import read_episodes, write_episodes

    eps = [{"obs": np.arange(8, dtype=np.float32).reshape(4, 2), "actions": np.array([0, 1, 0]),
            "rewards": np.array([1.0, 0.0, 1.0], np.float32), "logp": np.array([-0.1, -0.2, -0.3], np.float32),
            "terminated": True}]
    write_episodes(str(tmp_path / "ds"), eps)
    back = read_episodes(str(tmp_path / "ds"))
    assert len(back) == 1
    np.testing.assert_allclose(back[0]["obs"], eps[0]["obs"])
    np.testing.assert_array_equal(back[0]["actions"], eps[0]["actions"])
    assert back[0]["terminated"] is True


def test_env_runner_output_records_episodes(tmp_path):
    """``offline_data(output=...)``: every sampled episode reaches the
    JSONL shards (the env runner's import of the writer)."""
    from ray_tpu_torch.rllib.offline import read_episodes

    algo = _ppo_config().offline_data(output=str(tmp_path / "rec")).build_algo()
    segs, _ = algo.env_runner_group.sample(256)
    algo.stop()
    eps = read_episodes(str(tmp_path / "rec"))
    assert len(eps) == len(segs) and sum(len(e["actions"]) for e in eps) > 200
    for e, s in zip(eps, segs):
        np.testing.assert_array_equal(e["obs"], s["obs"])
        np.testing.assert_array_equal(e["actions"], s["actions"])


# ------------------------------------------------------------------ APPO
def _appo_small():
    from ray_tpu_torch.rllib import APPOConfig

    cfg = APPOConfig().environment("CartPole-v1").debugging(seed=0).learners(device="cpu")
    cfg.model = {"fcnet_hiddens": (16,)}
    return cfg


def test_appo_loss_matches_ppo_surrogate_on_policy():
    """With target == behavior == current policy the IMPACT ratio is 1, so
    the surrogate is V-trace's policy gradient at ratio 1 and mean_kl 0."""
    algo = _appo_small().build_algo()
    try:
        learner = algo.learner_group._local
        segments, _ = algo.env_runner_group.sample(200)
        batch = algo._build_sequences(segments)
        old_logp, old_inputs = learner.target_forward(torch.as_tensor(batch["obs"]), torch.as_tensor(batch["actions"]))
        m = batch["mask"] > 0
        np.testing.assert_allclose(old_logp.numpy()[m], batch["logp"][m], atol=1e-4)
        b = dict(batch, old_logp=old_logp.numpy(), old_inputs=old_inputs.numpy(),
                 kl_coeff=np.full((len(batch["obs"]),), 1.0, np.float32))
        _, aux = learner.compute_losses({k: torch.as_tensor(v) for k, v in b.items()})
        assert float(aux["mean_kl"]) < 1e-6
        assert np.isfinite(float(aux["total_loss"]))
    finally:
        algo.stop()


def test_appo_target_network_refresh_and_kl_adaptation():
    cfg = _appo_small()
    cfg.use_kl_loss = True
    cfg.kl_target = 1e-12  # any real KL overshoots: the coefficient must grow
    cfg.target_network_update_freq = 2
    cfg.train_batch_size = 400
    cfg.rollout_fragment_length = 50
    algo = cfg.build_algo()
    try:
        learner = algo.learner_group._local
        leaf0 = next(learner.target.parameters()).detach().clone()
        algo.train()  # update 1: the target is not refreshed yet (freq 2)
        torch.testing.assert_close(next(learner.target.parameters()), leaf0, rtol=0, atol=0)
        coeff_after_1 = learner._kl_coeff
        algo.train()  # update 2: KL > target, the coefficient grows; then a hard refresh
        assert learner._kl_coeff > coeff_after_1
        for t, p in zip(learner.target.parameters(), learner.module.parameters()):
            torch.testing.assert_close(t, p, rtol=0, atol=0)
    finally:
        algo.stop()


# ------------------------------------------------------------ connectors
def test_pipeline_composition_and_editing():
    p = ConnectorPipeline(FlattenObs(), CastToFloat32())
    out = p(np.ones((4, 2, 3), dtype=np.float64))
    assert out.shape == (4, 6) and out.dtype == np.float32
    p.prepend(NormalizeObs())
    assert isinstance(p.connectors[0], NormalizeObs)
    assert p.remove(NormalizeObs) and not p.remove(NormalizeObs)


def test_normalize_obs_converges_to_unit_scale():
    c = NormalizeObs()
    rng = np.random.default_rng(0)
    for _ in range(50):
        c(rng.normal(5.0, 3.0, size=(32, 4)))
    out = c(rng.normal(5.0, 3.0, size=(1000, 4)))
    assert abs(float(out.mean())) < 0.2
    assert 0.8 < float(out.std()) < 1.2
    c2 = NormalizeObs()
    c2.set_state(c.get_state())
    np.testing.assert_allclose(c2.mean, c.mean)


def test_action_connectors():
    clip = ClipActions(low=-1.0, high=1.0)
    np.testing.assert_allclose(clip(np.array([[-3.0, 0.5, 2.0]])), [[-1.0, 0.5, 1.0]])
    rescale = RescaleActions(low=np.array([0.0]), high=np.array([10.0]))
    np.testing.assert_allclose(rescale(np.array([[-1.0], [0.0], [1.0]])), [[0.0], [5.0], [10.0]])


def test_squashed_gaussian_logp_matches_sample():
    from ray_tpu_torch.rllib.core.distributions import make_squashed_gaussian

    dist = make_squashed_gaussian(np.array([-2.0]), np.array([2.0]))
    inputs = torch.tensor([[0.3, -0.5]])  # mean, log_std
    a = dist.sample(torch.Generator().manual_seed(0), inputs)
    assert float(dist.low[0]) <= float(a[0, 0]) <= float(dist.high[0])
    assert np.isfinite(float(dist.logp(inputs, a)[0]))
    np.testing.assert_allclose(dist.deterministic(inputs).numpy(), 2.0 * np.tanh([[0.3]]), atol=1e-5)


def test_connectors_in_env_runner():
    """Obs flow through env_to_module (stored transformed), actions through
    module_to_env before env.step."""
    from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModuleSpec
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    env = gym.make("Pendulum-v1")
    spec = RLModuleSpec(MLPModule, env.observation_space, env.action_space, {"fcnet_hiddens": (8,)})
    norm = NormalizeObs()
    runner = SingleAgentEnvRunner(spec, "Pendulum-v1", num_envs=2, env_to_module=ConnectorPipeline(norm, CastToFloat32()),
                                  module_to_env=ClipActions(low=env.action_space.low, high=env.action_space.high))
    runner.set_weights(spec.build().state_dict())
    segs, metrics = runner.sample(40)
    assert metrics["num_env_steps"] >= 40
    assert norm.count > 0  # the normalizer saw the obs stream
    for s in segs:
        assert np.all(np.abs(np.asarray(s["obs"])) <= norm.clip + 1e-6)


# ------------------------------------------------------- the port's rules
def test_missing_gymnasium_is_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError, match="gymnasium"):
        _ppo_config().build_algo()


def test_learner_defaults_to_the_card():
    """No ``device``: the learner asks for the card (and raises without one)."""
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig, PPOLearner

    spec = _specs((8,))["p_even"]
    if torch.cuda.is_available():
        assert PPOLearner(spec, PPOConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PPOLearner(spec, PPOConfig())


@pytest.mark.cuda
def test_learner_parameters_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig, PPOLearner

    ln = PPOLearner(_specs((8,))["p_even"], PPOConfig())
    ln.build(0)
    assert {p.device.type for p in ln.module.parameters()} == {"cuda"}
