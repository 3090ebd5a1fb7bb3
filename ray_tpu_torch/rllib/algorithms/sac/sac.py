"""SAC: soft actor-critic for continuous control (port of
ray_tpu/rllib/algorithms/sac/sac.py): twin Q networks with
polyak-averaged targets, a tanh-squashed Gaussian policy, and an entropy
temperature tuned toward ``target_entropy`` (-|A| by default).

The policy, the twin critics and ``log_alpha`` are one module, and one
Adam steps them all from one combined loss whose fences keep the three
apart: the critics' targets are computed without gradient, so the
critic loss never reaches ``pi``; the actor loss calls the critics
through ``torch.func.functional_call`` on detached parameters, so it
never reaches the critics; alpha's loss sees only the detached logp.
The reparameterisation noise is an argument of ``losses`` (drawn from
the learner's ``torch.Generator`` on its device, seeded ``seed + 1`` as
ray_tpu seeds its key), so a test can feed ray_tpu's draws.
"""

from __future__ import annotations

import copy
import itertools
import math

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.distributions import DiagGaussian, make_squashed_gaussian
from ray_tpu_torch.rllib.core.learner import Learner, host_state, read_once
from ray_tpu_torch.rllib.core.rl_module import MLPModule, Tower
from ray_tpu_torch.rllib.utils.replay_buffers import EpisodeReplayBuffer


class SACModule(MLPModule):
    """A policy tower (obs -> mean || log_std), twin Q towers
    (obs || action -> scalar) and the entropy temperature ``log_alpha``.
    ``action_dist_inputs`` are the raw Gaussian's; the squashing lives in
    the distribution."""

    def __init__(self, observation_space, action_space, model_config=None):
        if not hasattr(action_space, "shape") or hasattr(action_space, "n"):
            raise ValueError("SAC requires a continuous (Box) action space")
        super().__init__(observation_space, action_space, model_config)
        self.action_dist_cls = make_squashed_gaussian(action_space.low, action_space.high)

    def _make_towers(self):
        self.act_dim = int(np.prod(self.action_space.shape))
        qs = (self.obs_dim + self.act_dim, *self.hiddens, 1)
        self.pi = Tower.of((self.obs_dim, *self.hiddens, 2 * self.act_dim))
        self.q1 = Tower.of(qs)
        self.q2 = Tower.of(qs)
        self.log_alpha = nn.Parameter(torch.zeros(()))

    def init(self, seed: int = 0) -> "SACModule":
        gen = torch.Generator().manual_seed(seed)
        self._init_tower(self.pi, gen, 0.01)
        self._init_tower(self.q1, gen, 1.0)
        self._init_tower(self.q2, gen, 1.0)
        with torch.no_grad():
            self.log_alpha.zero_()
        return self

    def forward(self, obs):
        obs = obs.reshape(obs.shape[0], -1).float()
        out = self.pi(obs)
        return {"action_dist_inputs": out, "vf": torch.zeros(obs.shape[0], device=obs.device)}

    def q_values(self, q_tower, obs, actions, params: dict | None = None):
        """Q(obs, actions) [B] through ``q_tower``, or through the tower's
        structure on ``params`` (its named parameters) when given."""
        obs = obs.reshape(obs.shape[0], -1).float()
        x = torch.cat([obs, actions.reshape(obs.shape[0], -1).float()], dim=-1)
        out = q_tower(x) if params is None else torch.func.functional_call(q_tower, params, (x,))
        return out[..., 0]


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.tau = 0.005  # polyak target mix-in per update
        self.initial_alpha = 0.1
        self.target_entropy = "auto"  # -> -act_dim
        self.num_steps_sampled_before_learning_starts = 1_000
        self.rollout_fragment_length = 64
        # updates per iteration = new_env_steps * train_intensity /
        # train_batch_size; the default equals the batch size: about one
        # gradient step per env step, SAC's standard replay ratio
        self.train_intensity = 256.0
        self.module_class = SACModule

    @property
    def algo_class(self):
        return SAC


class SACLearner(Learner):
    """One update: the combined actor/critic/alpha loss with its fences,
    one Adam step, then the polyak map onto ``target_q``."""

    def build(self, seed: int = 0):
        super().build(seed)  # Adam over every parameter, log_alpha included
        cfg = self.config
        with torch.no_grad():
            self.module.log_alpha.copy_(torch.log(torch.tensor(cfg.initial_alpha, dtype=torch.float32)))
        self.target_q = nn.ModuleDict({"q1": copy.deepcopy(self.module.q1),
                                       "q2": copy.deepcopy(self.module.q2)}).requires_grad_(False)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        act_dim = self.module.act_dim
        self.target_entropy = -float(act_dim) if cfg.target_entropy == "auto" else float(cfg.target_entropy)
        dist = self.module.action_dist_cls
        self._low, self._high = dist.low.to(self.device), dist.high.to(self.device)

    def sample_squashed(self, obs, noise):
        """The reparameterized squashed action for ``noise`` [B, A] and its
        logp, computed from u directly (no atanh round trip)."""
        out = self.module.pi(obs.reshape(obs.shape[0], -1).float())
        mean, log_std = DiagGaussian._split(out)
        u = mean + torch.exp(log_std) * noise
        t = torch.tanh(u)
        scale = (self._high - self._low) * 0.5
        a = (self._high + self._low) * 0.5 + scale * t
        base = torch.sum(-0.5 * (((u - mean) / torch.exp(log_std)) ** 2 + 2 * log_std + math.log(2 * math.pi)), dim=-1)
        logp = base - torch.sum(torch.log(scale * (1.0 - t**2) + 1e-9), dim=-1)
        return a, logp

    def losses(self, batch, noise_pi, noise_next):
        """(total loss, metrics) of one batch; ``noise_pi`` reparameterizes
        the actor's action at obs, ``noise_next`` the target's at next_obs."""
        cfg = self.config
        m = self.module
        log_alpha = m.log_alpha
        alpha = torch.exp(log_alpha)
        alpha_sg = alpha.detach()

        # critic: targets from the current policy at s' and the target Qs
        with torch.no_grad():
            a2, logp2 = self.sample_squashed(batch["next_obs"], noise_next)
            q1_t = m.q_values(self.target_q["q1"], batch["next_obs"], a2)
            q2_t = m.q_values(self.target_q["q2"], batch["next_obs"], a2)
            soft_target = torch.minimum(q1_t, q2_t) - alpha_sg * logp2
            y = batch["rewards"] + cfg.gamma * (1.0 - batch["done"]) * soft_target
        q1 = m.q_values(m.q1, batch["obs"], batch["actions"])
        q2 = m.q_values(m.q2, batch["obs"], batch["actions"])
        critic_loss = torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)

        # actor: maximize the soft value through frozen critics
        a_pi, logp_pi = self.sample_squashed(batch["obs"], noise_pi)
        frozen = {name: {k: v.detach() for k, v in tower.named_parameters()} for name, tower in (("q1", m.q1),
                                                                                               ("q2", m.q2))}
        q_pi = torch.minimum(m.q_values(m.q1, batch["obs"], a_pi, frozen["q1"]),
                             m.q_values(m.q2, batch["obs"], a_pi, frozen["q2"]))
        actor_loss = torch.mean(alpha_sg * logp_pi - q_pi)

        # temperature: drive E[logp] toward -target_entropy
        alpha_loss = -torch.mean(log_alpha * (logp_pi + self.target_entropy).detach())

        total = critic_loss + actor_loss + alpha_loss
        return total, {"total_loss": total, "critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha_loss": alpha_loss, "alpha": alpha, "qf_mean": torch.mean(q1),
                       "entropy_proxy": -torch.mean(logp_pi)}

    def draw_noise(self, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(noise_pi, noise_next), standard normals [rows, act_dim] from the
        learner's generator."""
        shape = (rows, self.module.act_dim)
        return tuple(torch.randn(shape, generator=self._gen, device=self.device) for _ in range(2))

    def step(self, batch: dict, noise=None) -> dict:
        """One update on a sampled batch; ``noise``: (noise_pi,
        noise_next), else drawn. Returns the metrics as device scalars."""
        mb = self._device_batch(batch)
        noise_pi, noise_next = self.draw_noise(len(batch["obs"])) if noise is None else (
            torch.as_tensor(n, dtype=torch.float32).to(self.device) for n in noise)
        self.optimizer.zero_grad(set_to_none=False)
        total, aux = self.losses(mb, noise_pi, noise_next)
        total.backward()
        self._clip([p.grad for p in self.module.parameters()])
        self.optimizer.step()
        tau = self.config.tau
        with torch.no_grad():
            for t, o in zip(self.target_q.parameters(),
                            itertools.chain(self.module.q1.parameters(), self.module.q2.parameters())):
                t.copy_((1.0 - tau) * t + tau * o)
        return aux

    def update_sac(self, batch: dict, noise=None) -> dict:
        """``step``, its metrics read from the device in one copy."""
        return read_once(self.step(batch, noise))[0]

    def get_state(self) -> dict:
        state = super().get_state()
        state["target_q"] = host_state(self.target_q)
        return state

    def set_state(self, state: dict):
        super().set_state(state)
        if "target_q" in state:
            self.target_q.load_state_dict(state["target_q"])


class SAC(Algorithm):
    learner_cls = SACLearner

    def setup(self):
        cfg = self.config
        if cfg.num_learners > 0:
            raise NotImplementedError("SAC runs a single (local) learner; scale sampling with num_env_runners")
        super().setup()
        self.replay = EpisodeReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)

    @property
    def _learner(self) -> SACLearner:
        return self.learner_group._local

    def training_step(self) -> dict:
        cfg = self.config
        segments, runner_metrics = self.env_runner_group.sample(cfg.rollout_fragment_length)
        new_steps = 0
        for seg in segments:
            new_steps += len(self.replay.add(seg))
        self._total_env_steps += new_steps

        result = self._merge_runner_metrics(runner_metrics)
        if self._total_env_steps < cfg.num_steps_sampled_before_learning_starts or len(self.replay) < cfg.train_batch_size:
            result["learner"] = {"num_updates": 0}
            return result

        num_updates = max(1, int(new_steps * cfg.train_intensity / cfg.train_batch_size))
        metrics = {}
        for _ in range(num_updates):
            metrics = self._learner.update_sac(self.replay.sample(cfg.train_batch_size))
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result["learner"] = {"num_updates": num_updates, **metrics}
        result["num_env_steps_sampled_lifetime"] = self._total_env_steps
        return result
