"""RLlib's numbers on the port against ray_tpu's, on the CPU (JAX on the CPU).

Both packages get the same seeded numpy inputs, and the port's modules get
ray_tpu's params through ``params_from_jax``. Checked: ``MLPModule``'s
forward (logits and values); each distribution's logp, entropy and KL
(categorical, diagonal Gaussian, squashed Gaussian); PPO's, IMPALA's and
APPO's losses and stats on one fixed batch; ``vtrace`` on random and on
on-policy inputs; one Adam step with clipping active (a whole-batch
update, compared on the parameters and the metrics); PPO's GAE train
batch; a JSONL episode file written by one package and read by the other.
ray_tpu's learners are called as its own tests call them
(``compute_losses(params, batch)`` unjitted, ``update`` through its jitted
step). Tolerances: float32, ``atol 1e-5, rtol 1e-5`` unless a line says
otherwise (the parameters after the Adam step: ``atol 2e-6``; a
loss summed over ~10^3 terms: ``rtol 1e-5, atol 1e-4``)."""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms.appo.appo import APPOConfig as JAPPOConfig
from ray_tpu.rllib.algorithms.appo.appo import APPOLearner as JAPPOLearner
from ray_tpu.rllib.algorithms.impala.impala import IMPALAConfig as JIMPALAConfig
from ray_tpu.rllib.algorithms.impala.impala import IMPALALearner as JIMPALALearner
from ray_tpu.rllib.algorithms.impala.impala import vtrace as jvtrace
from ray_tpu.rllib.algorithms.ppo.ppo import PPO as JPPO
from ray_tpu.rllib.algorithms.ppo.ppo import PPOConfig as JPPOConfig
from ray_tpu.rllib.algorithms.ppo.ppo import PPOLearner as JPPOLearner
from ray_tpu.rllib.core import distributions as jdist
from ray_tpu.rllib.core.rl_module import MLPModule as JMLPModule
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JSpec
from ray_tpu_torch.rllib.algorithms.appo.appo import APPOConfig, APPOLearner
from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALAConfig, IMPALALearner, vtrace
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig, PPOLearner
from ray_tpu_torch.rllib.core import distributions as tdist
from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModuleSpec, params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
OBS = gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)
ACT = gym.spaces.Discrete(2)
BOX = gym.spaces.Box(-2.0, 2.0, (3,), np.float32)
HIDDENS = {"fcnet_hiddens": (32, 32)}


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **(tol or TOL))


def _pair(act_space=ACT, seed=0):
    """ray_tpu's module and params, and the port's module holding them."""
    jm = JMLPModule(OBS, act_space, HIDDENS)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = MLPModule(OBS, act_space, HIDDENS)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("act_space", [ACT, BOX], ids=["discrete", "box"])
def test_mlp_forward(act_space):
    jm, params, tm = _pair(act_space)
    obs = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    jo = jm.forward(params, jnp.asarray(obs))
    with torch.no_grad():
        to = tm(torch.as_tensor(obs))
    close(to["action_dist_inputs"], jo["action_dist_inputs"])
    close(to["vf"], jo["vf"])


def test_distributions():
    rng = np.random.default_rng(2)
    logits_p, logits_q = rng.normal(size=(2, 128, 5)).astype(np.float32)
    actions = rng.integers(0, 5, 128)
    j, t = jnp.asarray, torch.as_tensor
    close(tdist.Categorical.logp(t(logits_p), t(actions)), jdist.Categorical.logp(j(logits_p), j(actions)))
    close(tdist.Categorical.entropy(t(logits_p)), jdist.Categorical.entropy(j(logits_p)))
    close(tdist.Categorical.kl(t(logits_p), t(logits_q)), jdist.Categorical.kl(j(logits_p), j(logits_q)))
    gp, gq = rng.normal(size=(2, 128, 6)).astype(np.float32)
    gp[:, 3:] *= 10  # log-stds beyond the [-20, 2] clip on some rows
    ga = rng.normal(size=(128, 3)).astype(np.float32)
    close(tdist.DiagGaussian.logp(t(gp), t(ga)), jdist.DiagGaussian.logp(j(gp), j(ga)), rtol=1e-5, atol=1e-4)
    close(tdist.DiagGaussian.entropy(t(gp)), jdist.DiagGaussian.entropy(j(gp)))
    close(tdist.DiagGaussian.kl(t(gp), t(gq)), jdist.DiagGaussian.kl(j(gp), j(gq)), rtol=1e-5, atol=1e-4)
    low, high = np.array([-2.0, 0.0, -1.0]), np.array([2.0, 1.0, 3.0])
    tsq, jsq = tdist.make_squashed_gaussian(low, high), jdist.make_squashed_gaussian(low, high)
    sa = (low + (high - low) * rng.uniform(0.01, 0.99, size=(128, 3))).astype(np.float32)
    gs = rng.normal(size=(128, 6)).astype(np.float32) * 0.5
    close(tsq.logp(t(gs), t(sa)), jsq.logp(j(gs), j(sa)), rtol=1e-5, atol=1e-4)
    close(tsq.deterministic(t(gs)), jsq.deterministic(j(gs)))


def _vtrace_inputs(seed, on_policy):
    rng = np.random.default_rng(seed)
    N, T = 4, 12
    b = rng.normal(size=(N, T)).astype(np.float32) * 0.5
    tgt = b if on_policy else (b + rng.normal(size=(N, T)).astype(np.float32) * 0.5)
    mask = np.ones((N, T), np.float32)
    mask[1, 7:] = 0.0
    nonterminal = np.ones((N, T), np.float32)
    nonterminal[2, 5] = 0.0
    return (b, tgt, rng.normal(size=(N, T)).astype(np.float32), rng.normal(size=(N, T)).astype(np.float32),
            rng.normal(size=(N,)).astype(np.float32), mask, nonterminal)


@pytest.mark.parametrize("on_policy", [False, True], ids=["random", "on_policy"])
def test_vtrace(on_policy):
    args = _vtrace_inputs(3, on_policy)
    jvs, jpg = jvtrace(*map(jnp.asarray, args), 0.97, 1.0, 1.0)
    tvs, tpg = vtrace(*map(torch.as_tensor, args), 0.97, 1.0, 1.0)
    close(tvs, jvs)
    close(tpg, jpg)


def _learners(jcls, jcfg, tcls, tcfg, hiddens=HIDDENS):
    jcfg.model = tcfg.model = dict(hiddens)
    jl = jcls(JSpec(JMLPModule, OBS, ACT, jcfg.model), jcfg)
    jl.build(seed=0)
    tl = tcls(RLModuleSpec(MLPModule, OBS, ACT, tcfg.model), tcfg.learners(device="cpu"))
    tl.build(seed=0)
    tl.set_weights(params_from_jax(jax.tree.map(np.asarray, jl.params)))
    return jl, tl


def _ppo_batch(n=256, seed=4):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32), "actions": rng.integers(0, 2, n),
            "logp": (np.log(0.5) + rng.normal(size=n) * 0.3).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32), "value_targets": rng.normal(size=n).astype(np.float32),
            "vf_preds": rng.normal(size=n).astype(np.float32)}


def _seq_batch(N=6, T=20, seed=5):
    rng = np.random.default_rng(seed)
    mask = np.ones((N, T), np.float32)
    mask[0, 15:] = 0.0
    nonterminal = np.ones((N, T), np.float32)
    nonterminal[3, T - 1] = 0.0
    return {"obs": rng.normal(size=(N, T + 1, 4)).astype(np.float32), "actions": rng.integers(0, 2, (N, T)),
            "rewards": rng.normal(size=(N, T)).astype(np.float32),
            "logp": (np.log(0.5) + rng.normal(size=(N, T)) * 0.3).astype(np.float32), "mask": mask,
            "nonterminal": nonterminal}


def _losses(jl, tl, batch):
    _, jaux = jl.compute_losses(jl.params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        _, taux = tl.compute_losses({k: torch.as_tensor(v) for k, v in batch.items()})
    assert jaux.keys() == taux.keys()
    for k in jaux:
        close(taux[k], jaux[k], rtol=1e-5, atol=1e-4)


def test_ppo_losses():
    jcfg, tcfg = JPPOConfig(), PPOConfig()
    for c in (jcfg, tcfg):
        c.entropy_coeff, c.vf_clip_param = 0.01, 0.5  # every term live, the value clip active
    _losses(*_learners(JPPOLearner, jcfg, PPOLearner, tcfg), _ppo_batch())


def test_impala_losses():
    _losses(*_learners(JIMPALALearner, JIMPALAConfig(), IMPALALearner, IMPALAConfig()), _seq_batch())


@pytest.mark.parametrize("use_kl_loss", [False, True])
def test_appo_losses(use_kl_loss):
    jcfg, tcfg = JAPPOConfig(), APPOConfig()
    jcfg.use_kl_loss = tcfg.use_kl_loss = use_kl_loss
    jl, tl = _learners(JAPPOLearner, jcfg, APPOLearner, tcfg)
    batch = _seq_batch()
    # a target policy other than the current one: ray_tpu's init from seed 1
    other = JMLPModule(OBS, ACT, jcfg.model).init(jax.random.PRNGKey(1))
    jl.target_params = other
    tl.target.load_state_dict(params_from_jax(jax.tree.map(np.asarray, other)))
    jold_logp, jold_inputs = jl._target_forward(other, jnp.asarray(batch["obs"]), jnp.asarray(batch["actions"]))
    told_logp, told_inputs = tl.target_forward(torch.as_tensor(batch["obs"]), torch.as_tensor(batch["actions"]))
    close(told_logp, jold_logp)
    close(told_inputs, jold_inputs)
    batch = dict(batch, old_logp=np.asarray(jold_logp), old_inputs=np.asarray(jold_inputs),
                 kl_coeff=np.full((6,), 0.7, np.float32))
    _losses(jl, tl, batch)


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_one_clipped_adam_step(algo):
    """One whole-batch update with the global-norm clip active (optax's
    ``clip_by_global_norm`` then adam): the parameters and the metrics."""
    if algo == "ppo":
        jcfg, tcfg, batch = JPPOConfig(), PPOConfig(), _ppo_batch()
        jl, tl = _learners(JPPOLearner, jcfg, PPOLearner, tcfg)
    else:
        jcfg, tcfg, batch = JIMPALAConfig(), IMPALAConfig(), _seq_batch()
        jl, tl = _learners(JIMPALALearner, jcfg, IMPALALearner, tcfg)
    for ln in (jl, tl):
        ln.config.grad_clip = 0.02  # far below these gradients' norm: the clip scales every step
        ln.config.lr = 1e-2
    jl.optimizer = jl._make_optimizer()
    jl.opt_state = jl.optimizer.init(jl.params)
    tl.optimizer = torch.optim.Adam(tl.module.parameters(), lr=1e-2)
    grads, _ = jl._grad_fn(jl.params, {k: jnp.asarray(v) for k, v in batch.items()})
    norm = float(jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree.leaves(grads))))
    assert norm > 5 * 0.02, norm
    jm = jl.update(batch, num_epochs=2, shuffle=False)
    tm = tl.update(batch, num_epochs=2, shuffle=False)
    for k, v in params_from_jax(jax.tree.map(np.asarray, jl.params)).items():
        close(tl.module.state_dict()[k], v, atol=2e-6, rtol=1e-5)
    for k in jm:
        close(tm[k], jm[k], rtol=1e-5, atol=1e-4)


def test_ppo_gae_train_batch():
    """PPO's train batch (GAE per segment, the bootstrap forward, the
    standardized advantages) from the same segments and weights."""
    from types import SimpleNamespace

    jm, params, tm = _pair()
    rng = np.random.default_rng(6)
    segments = []
    for i, T in enumerate([7, 30, 1, 12]):
        segments.append({"obs": rng.normal(size=(T + 1, 4)).astype(np.float32), "actions": rng.integers(0, 2, T),
                         "rewards": rng.normal(size=T).astype(np.float32),
                         "logp": rng.normal(size=T).astype(np.float32),
                         "vf_preds": rng.normal(size=T).astype(np.float32), "terminated": np.asarray(i % 2 == 0)})
    jcfg, tcfg = JPPOConfig(), PPOConfig()
    jstub = SimpleNamespace(config=jcfg, _vf_fwd=jax.jit(lambda p, o: jm.forward(p, o)["vf"]))
    tstub = SimpleNamespace(config=tcfg, _vf_module=MLPModule(OBS, ACT, HIDDENS))
    jb = JPPO._build_train_batch(jstub, segments, params)
    tb = PPO._build_train_batch(tstub, segments, tm.state_dict())
    assert jb.keys() == tb.keys()
    for k in jb:
        close(tb[k], jb[k])


@pytest.mark.parametrize("writer", ["ray_tpu", "ray_tpu_torch"])
def test_jsonl_across_packages(tmp_path, writer):
    from ray_tpu.rllib.offline import read_episodes as jread
    from ray_tpu.rllib.offline import write_episodes as jwrite
    from ray_tpu_torch.rllib.offline import read_episodes as tread
    from ray_tpu_torch.rllib.offline import write_episodes as twrite

    rng = np.random.default_rng(7)
    eps = [{"obs": rng.normal(size=(T + 1, 4)).astype(np.float32), "actions": rng.integers(0, 2, T),
            "rewards": rng.normal(size=T).astype(np.float32), "logp": rng.normal(size=T).astype(np.float32),
            "terminated": bool(T % 2)} for T in (3, 8, 5)]
    write, read = (jwrite, tread) if writer == "ray_tpu" else (twrite, jread)
    write(str(tmp_path / "ds"), eps)
    back = read(str(tmp_path / "ds"))
    assert len(back) == 3
    for e, b in zip(eps, back):
        for k in ("obs", "actions", "rewards", "logp"):
            np.testing.assert_array_equal(b[k], e[k])
        assert b["terminated"] is e["terminated"]
