"""RLlib's off-policy and offline numbers on the port against ray_tpu's, on
the CPU (JAX on the CPU).

Both packages get the same seeded numpy inputs, and the port's modules
get ray_tpu's params through ``params_from_jax``. Checked: the replay
buffers, exactly (the same adds and seed give the same rows, indices, IS
weights and sum tree); ``QModule``'s and ``SACModule``'s forwards; DQN's
TD loss, metrics, ``|td|`` and gradients with double Q on and off and
with IS weights, then one Adam step; CQL's, BC's and MARWIL's losses and
gradients; MARWIL's returns-to-go, its batch draws and ``ma_adv_norm``
after N updates of the whole algorithm; one whole SAC update given jax's
noise, reproduced from ray_tpu's own key splits (its gradients, losses,
new parameters, ``target_q`` and ``log_alpha``); ``EpsilonGreedy``'s
logp, deterministic action and entropy, and its sample's greedy share; a
JSONL dataset written by ray_tpu's writer filling each package's buffer
with the same rows. ray_tpu's learners are called as its code calls them
(their jitted grad and update functions). Tolerances: float32,
``atol 1e-5, rtol 1e-5`` unless a line says otherwise (parameters after
Adam steps: ``atol 2e-6``; the SAC losses and gradients, which sum
terms of ~10^1: ``rtol 1e-5, atol 1e-4``; MARWIL's gradients with its
exponent clip active: ``rtol 1e-5`` and an ``atol`` of 1e-6 of each
leaf's largest magnitude)."""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms.bc.bc import BCConfig as JBCConfig
from ray_tpu.rllib.algorithms.bc.bc import BCLearner as JBCLearner
from ray_tpu.rllib.algorithms.cql.cql import CQLConfig as JCQLConfig
from ray_tpu.rllib.algorithms.cql.cql import CQLLearner as JCQLLearner
from ray_tpu.rllib.algorithms.dqn.dqn import DQNConfig as JDQNConfig
from ray_tpu.rllib.algorithms.dqn.dqn import DQNLearner as JDQNLearner
from ray_tpu.rllib.algorithms.dqn.dqn import QModule as JQModule
from ray_tpu.rllib.algorithms.dqn.dqn import make_epsilon_greedy
from ray_tpu.rllib.algorithms.marwil.marwil import MARWILConfig as JMARWILConfig
from ray_tpu.rllib.algorithms.marwil.marwil import MARWILLearner as JMARWILLearner
from ray_tpu.rllib.algorithms.sac.sac import SACConfig as JSACConfig
from ray_tpu.rllib.algorithms.sac.sac import SACLearner as JSACLearner
from ray_tpu.rllib.algorithms.sac.sac import SACModule as JSACModule
from ray_tpu.rllib.core.rl_module import MLPModule as JMLPModule
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
from ray_tpu.rllib.utils import replay_buffers as jrb
from ray_tpu_torch.rllib.algorithms.bc.bc import BCConfig, BCLearner
from ray_tpu_torch.rllib.algorithms.cql.cql import CQLConfig, CQLLearner
from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQNConfig, DQNLearner, EpsilonGreedy, QModule
from ray_tpu_torch.rllib.algorithms.marwil.marwil import MARWILConfig, MARWILLearner, returns_to_go
from ray_tpu_torch.rllib.algorithms.sac.sac import SACConfig, SACLearner, SACModule
from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModuleSpec, params_from_jax
from ray_tpu_torch.rllib.utils import replay_buffers as trb
from test_torch_rllib_learn import one_torch_thread  # noqa: F401 (fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
OBS = gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)
ACT = gym.spaces.Discrete(3)
PEND_OBS = gym.spaces.Box(-8.0, 8.0, (3,), np.float32)
PEND_ACT = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
HIDDENS = {"fcnet_hiddens": (32, 32)}


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **(tol or TOL))


def host(tree):
    return jax.tree.map(np.asarray, tree)


def close_tree(module_or_state, jtree, leaf_scale=None, **tol):
    """Every leaf of ray_tpu's tree against the port's state dict; with
    ``leaf_scale``, each leaf's ``atol`` is that fraction of its largest
    magnitude."""
    state = module_or_state if isinstance(module_or_state, dict) else module_or_state.state_dict()
    ref = params_from_jax(host(jtree))
    assert state.keys() == ref.keys()
    for k, v in ref.items():
        if leaf_scale is not None:
            tol = dict(rtol=1e-5, atol=leaf_scale * float(v.abs().max()))
        close(state[k], v, **tol)


def grads_of(module) -> dict:
    """The parameters' gradients; a parameter the loss does not reach (BC's
    value tower) has none, where jax's gradient is zeros."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in module.named_parameters()}


def episodes(seed, lengths, obs_dim=4, n_actions=3, continuous=False):
    rng = np.random.default_rng(seed)
    out = []
    for i, T in enumerate(lengths):
        actions = (rng.uniform(-2, 2, (T, 1)).astype(np.float32) if continuous
                   else rng.integers(0, n_actions, T))
        out.append({"obs": rng.normal(size=(T + 1, obs_dim)).astype(np.float32), "actions": actions,
                    "rewards": rng.normal(size=T).astype(np.float32), "logp": np.zeros(T, np.float32),
                    "terminated": i % 2 == 0})
    return out


# ---------------------------------------------------------------- buffers
@pytest.mark.parametrize("kind", ["uniform", "prioritized"])
def test_replay_buffers_exact(kind):
    """The same adds (wrapping the ring), samples and priority updates give
    the same batches, bit for bit, and the same sum tree."""
    mk = {"uniform": lambda m: m.EpisodeReplayBuffer(50, seed=3),
          "prioritized": lambda m: m.PrioritizedEpisodeReplayBuffer(50, alpha=0.7, beta=0.5, seed=3)}[kind]
    jb, tb = mk(jrb), mk(trb)
    rng = np.random.default_rng(4)
    for round_ in range(4):
        for ep in episodes(10 + round_, [9, 1, 14, 5]):
            assert jb.add(ep) == tb.add(ep)
        assert len(jb) == len(tb)
        jbatch, tbatch = jb.sample(32), tb.sample(32)
        assert jbatch.keys() == tbatch.keys()
        for k in jbatch:
            assert jbatch[k].dtype == tbatch[k].dtype, k
            np.testing.assert_array_equal(tbatch[k], jbatch[k])
        if kind == "prioritized":
            tds = rng.normal(size=32) * 3
            jb.update_priorities(jbatch["batch_indices"], tds)
            tb.update_priorities(tbatch["batch_indices"], tds)
            np.testing.assert_array_equal(tb._tree._tree, jb._tree._tree)
            assert tb._max_priority == jb._max_priority


@pytest.mark.parametrize("kind", ["uniform", "prioritized"])
def test_jsonl_from_ray_tpu_fills_the_same_rows(tmp_path, kind):
    """ray_tpu's JsonWriter writes the dataset; each package's reader fills
    its own buffer: the same rows and the same samples."""
    from ray_tpu.rllib.offline import JsonReader as JReader
    from ray_tpu.rllib.offline import write_episodes as jwrite
    from ray_tpu_torch.rllib.offline import fill_replay

    ds = str(tmp_path / "ds")
    jwrite(ds, episodes(5, [7, 3, 12, 1, 6]))
    mk = {"uniform": lambda m: m.EpisodeReplayBuffer(100, seed=1),
          "prioritized": lambda m: m.PrioritizedEpisodeReplayBuffer(100, seed=1)}[kind]
    jb, tb = mk(jrb), mk(trb)
    n = sum(len(jb.add(ep)) for ep in JReader(ds))
    assert fill_replay(tb, ds, refuse_overflow=True) == n == 29
    for k in jb._arrays:
        np.testing.assert_array_equal(tb._arrays[k], jb._arrays[k])
    jbatch, tbatch = jb.sample(16), tb.sample(16)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k], jbatch[k])


# ---------------------------------------------------------------- modules
def test_q_module_forward():
    jm = JQModule(OBS, ACT, HIDDENS)
    params = jm.init(jax.random.PRNGKey(0))
    tm = QModule(OBS, ACT, HIDDENS)
    tm.load_state_dict(params_from_jax(host(params)))
    obs = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    jo = jm.forward(params, jnp.asarray(obs))
    with torch.no_grad():
        to = tm(torch.as_tensor(obs))
    close(to["action_dist_inputs"], jo["action_dist_inputs"])
    close(to["vf"], jo["vf"])


def test_sac_module_forward_and_q_values():
    jm = JSACModule(PEND_OBS, PEND_ACT, HIDDENS)
    params = jm.init(jax.random.PRNGKey(0))
    tm = SACModule(PEND_OBS, PEND_ACT, HIDDENS)
    tm.load_state_dict(params_from_jax(host(params)))
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(64, 3)).astype(np.float32)
    act = rng.uniform(-2, 2, (64, 1)).astype(np.float32)
    with torch.no_grad():
        close(tm(torch.as_tensor(obs))["action_dist_inputs"], jm.forward(params, jnp.asarray(obs))["action_dist_inputs"])
        for q in ("q1", "q2"):
            close(tm.q_values(getattr(tm, q), torch.as_tensor(obs), torch.as_tensor(act)),
                  jm.q_values(params[q], jnp.asarray(obs), jnp.asarray(act)))


def test_epsilon_greedy():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(256, 4)).astype(np.float32)
    actions = rng.integers(0, 4, 256)
    jd, td = make_epsilon_greedy(0.3), EpsilonGreedy(0.3)
    close(td.logp(torch.as_tensor(q), torch.as_tensor(actions)), jd.logp(jnp.asarray(q), jnp.asarray(actions)))
    np.testing.assert_array_equal(td.deterministic(torch.as_tensor(q)).numpy(), np.asarray(jd.deterministic(q)))
    np.testing.assert_array_equal(td.entropy(torch.as_tensor(q)).numpy(), np.asarray(jd.entropy(q)))
    # the sample: the greedy action with probability 1 - eps + eps / n;
    # within 5 binomial standard deviations of it on 20000 draws
    n, p = 20_000, 1 - 0.3 + 0.3 / 4
    qs = torch.as_tensor(np.tile(q[:1], (n, 1)))
    share = float((td.sample(torch.Generator().manual_seed(0), qs) == int(np.argmax(q[0]))).float().mean())
    assert abs(share - p) < 5 * np.sqrt(p * (1 - p) / n), share


# ---------------------------------------------------------------- DQN and CQL
def _q_learners(jcls, jcfg, tcls, tcfg, double_q=True):
    for c in (jcfg, tcfg):
        c.model, c.double_q, c.lr, c.gamma = dict(HIDDENS), double_q, 1e-2, 0.9
    jl = jcls(JSpec(JQModule, OBS, ACT, jcfg.model), jcfg)
    jl.build(seed=0)
    tl = tcls(RLModuleSpec(QModule, OBS, ACT, tcfg.model), tcfg.learners(device="cpu"))
    tl.build(seed=0)
    tl.set_weights(params_from_jax(host(jl.params)))
    # a target network other than the online one: ray_tpu's init from seed 1
    jl.target_params = JQModule(OBS, ACT, jcfg.model).init(jax.random.PRNGKey(1))
    tl.target.load_state_dict(params_from_jax(host(jl.target_params)))
    return jl, tl


def _transitions(n=128, seed=6, weights=False):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.normal(size=(n, 4)).astype(np.float32), "actions": rng.integers(0, 3, n),
         "rewards": rng.normal(size=n).astype(np.float32), "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
         "done": (rng.random(n) < 0.2).astype(np.float32)}
    if weights:
        b["weights"] = rng.uniform(0.1, 1.0, n).astype(np.float32)
        b["batch_indices"] = np.arange(n)
    return b


def _td_parity(jl, tl, batch):
    jg, jaux = jl._td_grad(jl.params, jl.target_params,
                           {k: jnp.asarray(v) for k, v in batch.items() if k != "batch_indices"})
    tl.optimizer.zero_grad(set_to_none=False)
    loss, taux = tl.compute_losses(tl._device_batch(batch))
    loss.backward()
    assert jaux.keys() == taux.keys()
    for k in jaux:
        close(taux[k].detach(), jaux[k])
    close_tree(grads_of(tl.module), jg)


@pytest.mark.parametrize("double_q", [True, False], ids=["double_q", "max_q"])
@pytest.mark.parametrize("weights", [False, True], ids=["uniform", "is_weights"])
def test_td_core(double_q, weights):
    jl, tl = _q_learners(JDQNLearner, JDQNConfig(), DQNLearner, DQNConfig(), double_q)
    _td_parity(jl, tl, _transitions(weights=weights))


def test_dqn_adam_steps_and_target_sync():
    """Three update_dqn calls (metrics, |td|, parameters), then sync_target."""
    jl, tl = _q_learners(JDQNLearner, JDQNConfig(), DQNLearner, DQNConfig())
    for i in range(3):
        batch = _transitions(seed=20 + i, weights=True)
        jm, jtd = jl.update_dqn(batch)
        tm, ttd = tl.update_dqn(batch)
        assert jm.keys() == tm.keys()
        for k in jm:
            close(tm[k], jm[k])
        assert ttd.dtype == np.float32
        close(ttd, jtd)
        close_tree(tl.module, jl.params, atol=2e-6, rtol=1e-5)
    jl.sync_target()
    tl.sync_target()
    close_tree(tl.target, jl.target_params, atol=2e-6, rtol=1e-5)
    state = tl.get_state()
    assert state["target_params"].keys() == tl.module.state_dict().keys()


def test_cql_losses_and_gradients():
    jcfg, tcfg = JCQLConfig(), CQLConfig()
    jcfg.cql_alpha = tcfg.cql_alpha = 0.7
    jl, tl = _q_learners(JCQLLearner, jcfg, CQLLearner, tcfg)
    _td_parity(jl, tl, _transitions(weights=True))


# ---------------------------------------------------------------- BC and MARWIL
def _pg_learners(jcls, jcfg, tcls, tcfg, act_space=ACT):
    jcfg.model = tcfg.model = dict(HIDDENS)
    jl = jcls(JSpec(JMLPModule, OBS, act_space, jcfg.model), jcfg)
    jl.build(seed=0)
    tl = tcls(RLModuleSpec(MLPModule, OBS, act_space, tcfg.model), tcfg.learners(device="cpu"))
    tl.build(seed=0)
    tl.set_weights(params_from_jax(host(jl.params)))
    return jl, tl


def _grad_parity(jl, tl, batch, leaf_scale=None):
    jg, jaux = jl._grad_fn(jl.params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl.optimizer.zero_grad(set_to_none=False)
    loss, taux = tl.compute_losses(tl._device_batch(batch))
    loss.backward()
    assert jaux.keys() == taux.keys()
    for k in jaux:
        close(taux[k].detach(), jaux[k])
    close_tree(grads_of(tl.module), jg, leaf_scale)


@pytest.mark.parametrize("act_space", [ACT, gym.spaces.Box(-1.0, 1.0, (2,), np.float32)], ids=["discrete", "box"])
def test_bc_losses_and_gradients(act_space):
    jl, tl = _pg_learners(JBCLearner, JBCConfig(), BCLearner, BCConfig(), act_space)
    rng = np.random.default_rng(8)
    n = 128
    actions = rng.integers(0, 3, n) if hasattr(act_space, "n") else rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    _grad_parity(jl, tl, {"obs": rng.normal(size=(n, 4)).astype(np.float32), "actions": actions})


@pytest.mark.parametrize("ma_adv_norm", [100.0, 0.05], ids=["start_scale", "clip_active"])
def test_marwil_losses_and_gradients(ma_adv_norm):
    """At the moving average's start (100) and at a small one (0.05) where
    some exponents hit the +-20 clip: those rows weigh up to e^20, the
    gradients' terms reach 10^5 and cancel, so each leaf is held within
    1e-6 of its largest magnitude there."""
    jcfg, tcfg = JMARWILConfig(), MARWILConfig()
    jcfg.beta = tcfg.beta = 2.0
    jl, tl = _pg_learners(JMARWILLearner, jcfg, MARWILLearner, tcfg)
    rng = np.random.default_rng(9)
    n = 128
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32), "actions": rng.integers(0, 3, n),
             "returns": (3.0 * rng.normal(size=n)).astype(np.float32),
             "ma_adv_norm": np.full((n,), ma_adv_norm, np.float32)}
    _grad_parity(jl, tl, batch, leaf_scale=1e-6 if ma_adv_norm < 1 else None)


def test_marwil_returns_draws_and_moving_average(tmp_path):
    """The whole algorithm on one dataset: returns-to-go equal ray_tpu's
    bit for bit; then, from ray_tpu's weights, N training steps (each
    draws its batches from ``default_rng(seed)``) give the same
    ``ma_adv_norm``, metrics and parameters."""
    from ray_tpu.rllib import MARWILConfig as JAlgoConfig
    from ray_tpu.rllib.offline import write_episodes as jwrite
    from ray_tpu_torch.rllib import MARWILConfig as TAlgoConfig

    ds = str(tmp_path / "ds")
    jwrite(ds, episodes(11, [8, 30, 1, 17, 9], n_actions=2))
    cfgs = []
    for c in (JAlgoConfig(), TAlgoConfig().learners(device="cpu")):
        c.environment("CartPole-v1").offline_data(input_=ds)
        c.model, c.updates_per_iter, c.train_batch_size, c.seed, c.rollout_fragment_length = (
            {"fcnet_hiddens": (16,)}, 4, 32, 5, 20)
        cfgs.append(c)
    ja, ta = cfgs[0].build_algo(), cfgs[1].build_algo()
    try:
        obs, actions, returns = returns_to_go(ds, cfgs[1].gamma)
        np.testing.assert_array_equal(obs, ja._obs)
        np.testing.assert_array_equal(actions, ja._actions)
        np.testing.assert_array_equal(returns, ja._returns)
        jl, tl = ja.learner_group._local, ta.learner_group._local
        tl.set_weights(params_from_jax(host(jl.params)))
        for _ in range(3):
            jr, tr = ja.train()["learner"], ta.train()["learner"]
            assert jr.keys() == tr.keys()
            for k in jr:
                close(tr[k], jr[k])
        assert tl.ma_adv_norm != cfgs[1].ma_adv_norm_start
        close(tl.ma_adv_norm, jl.ma_adv_norm)
        close_tree(tl.module, jl.params, atol=2e-6, rtol=1e-5)
        assert tl.get_state()["ma_adv_norm"] == tl.ma_adv_norm
    finally:
        ja.stop()
        ta.stop()


# ---------------------------------------------------------------- SAC
def _sac_learners():
    jcfg, tcfg = JSACConfig(), SACConfig()
    jcfg.model = tcfg.model = dict(HIDDENS)
    jl = JSACLearner(JSpec(JSACModule, PEND_OBS, PEND_ACT, jcfg.model), jcfg)
    jl.build(seed=0)
    tl = SACLearner(RLModuleSpec(SACModule, PEND_OBS, PEND_ACT, tcfg.model), tcfg.learners(device="cpu"))
    tl.build(seed=0)
    tl.set_weights(params_from_jax(host(jl.params)))
    tl.target_q.load_state_dict(params_from_jax(host(jl.target_q)))
    return jl, tl


def _pendulum_batch(n=64, seed=12):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 3)).astype(np.float32), "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": (-3.0 * rng.random(n)).astype(np.float32), "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
            "done": (rng.random(n) < 0.1).astype(np.float32)}


def _jax_noise(key, rows, act_dim=1):
    """ray_tpu's update: ``self._key, k = split(self._key)``, then in its
    losses ``k1, k2 = split(k)``: the actor's noise from k1, the target's
    from k2. Returns (next key, k, noise_pi, noise_next)."""
    key, k = jax.random.split(key)
    k1, k2 = jax.random.split(k)
    return key, k, np.asarray(jax.random.normal(k1, (rows, act_dim))), np.asarray(jax.random.normal(k2, (rows, act_dim)))


def test_sac_update_equals_ray_tpus_given_its_noise():
    """Two whole SAC updates: the gradients of the combined loss (each
    fence: critics, actor, alpha), then the metrics, the parameters,
    ``log_alpha`` and the polyak targets after each Adam step."""
    jl, tl = _sac_learners()
    close(tl.module.log_alpha.detach(), jl.params["log_alpha"])
    grad_fn = dict(zip(jl._update_fn.__wrapped__.__code__.co_freevars,
                       (c.cell_contents for c in jl._update_fn.__wrapped__.__closure__)))["grad_fn"]
    for i in range(2):
        batch = _pendulum_batch(seed=12 + i)
        _, k, noise_pi, noise_next = _jax_noise(jl._key, len(batch["obs"]))
        jmb = {k2: jnp.asarray(v) for k2, v in batch.items()}
        jg, jaux = grad_fn(jl.params, jl.target_q, jmb, k)
        tl.optimizer.zero_grad(set_to_none=False)
        total, taux = tl.losses(tl._device_batch(batch), torch.as_tensor(noise_pi), torch.as_tensor(noise_next))
        total.backward()
        for k2 in jaux:
            close(taux[k2].detach(), jaux[k2], rtol=1e-5, atol=1e-4)
        close_tree(grads_of(tl.module), jg, rtol=1e-5, atol=1e-4)
        jm = jl.update_sac(batch)
        tm = tl.update_sac(batch, noise=(noise_pi, noise_next))
        assert jm.keys() == tm.keys()
        for k2 in jm:
            close(tm[k2], jm[k2], rtol=1e-5, atol=1e-4)
        close_tree(tl.module, jl.params, atol=2e-6, rtol=1e-5)
        close_tree(tl.target_q, jl.target_q, atol=2e-6, rtol=1e-5)
    assert float(tl.module.log_alpha) != float(np.log(np.float32(0.1)))  # alpha moved off 0.1
    state = tl.get_state()
    assert state["target_q"].keys() == {f"{q}.{k}" for q in ("q1", "q2") for k in tl.module.q1.state_dict()}
