"""DQN (port of ray_tpu/rllib/algorithms/dqn/dqn.py).

Off-policy Q-learning over an episode replay buffer: env runners fill the
buffer; the learner draws uniform or prioritized transition batches and
takes double-Q TD steps against a periodically synced target network.
Exploration is epsilon-greedy in the env runner (the Q-module's action
"distribution"). In offline mode (``offline_data(input_=...)``) the
buffer is filled once from a recorded dataset and the env runners only
evaluate, greedily.

``EpsilonGreedy`` is a module-level class with ``eps`` on the instance
(ray_tpu makes a class per module inside a function and sets its class
attribute): the port's modules carry no class without an importable
name. Its draws come from the runner's ``torch.Generator``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, host_state, read_once
from ray_tpu_torch.rllib.core.rl_module import MLPModule, Tower
from ray_tpu_torch.rllib.utils.replay_buffers import EpisodeReplayBuffer, PrioritizedEpisodeReplayBuffer


class EpsilonGreedy:
    """Epsilon-greedy as a distribution over Q-values [..., n_actions]:
    a uniform action with probability ``eps``, else the greedy one."""

    def __init__(self, epsilon: float):
        self.eps = float(epsilon)

    def sample(self, gen: torch.Generator, q_values):
        greedy = torch.argmax(q_values, dim=-1)
        rand = torch.randint(0, q_values.shape[-1], greedy.shape, generator=gen, device=q_values.device)
        explore = torch.rand(greedy.shape, generator=gen, device=q_values.device) < self.eps
        return torch.where(explore, rand, greedy)

    def logp(self, q_values, actions):
        n = q_values.shape[-1]
        greedy = torch.argmax(q_values, dim=-1)
        hit = torch.full(greedy.shape, 1.0 - self.eps + self.eps / n, device=q_values.device)
        p = torch.where(actions.long() == greedy, hit, torch.full_like(hit, self.eps / n))
        return torch.log(p)

    @staticmethod
    def deterministic(q_values):
        return torch.argmax(q_values, dim=-1)

    @staticmethod
    def entropy(q_values):
        return torch.zeros(q_values.shape[:-1], device=q_values.device)


class QModule(MLPModule):
    """MLP Q-network: ``action_dist_inputs`` ARE the Q-values; exploration
    is epsilon-greedy over them. One tower, ``q``."""

    def __init__(self, observation_space, action_space, model_config=None):
        if not hasattr(action_space, "n"):
            raise ValueError("DQN requires a Discrete action space")
        super().__init__(observation_space, action_space, model_config)
        self.action_dist_cls = EpsilonGreedy(self.model_config.get("epsilon", 0.1))

    def _make_towers(self):
        self.q = Tower.of((self.obs_dim, *self.hiddens, self.out_dim))

    def init(self, seed: int = 0) -> "QModule":
        self._init_tower(self.q, torch.Generator().manual_seed(seed), 0.01)
        return self

    def forward(self, obs):
        obs = obs.reshape(obs.shape[0], -1).float()
        q = self.q(obs)
        return {"action_dist_inputs": q, "vf": torch.max(q, dim=-1).values}


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.train_batch_size = 64
        self.replay_buffer_capacity = 50_000
        self.prioritized_replay = False
        self.prioritized_alpha = 0.6
        self.prioritized_beta = 0.4
        self.num_steps_sampled_before_learning_starts = 500
        self.target_network_update_freq = 500  # env steps between target syncs
        self.double_q = True
        # epsilon-greedy schedule: linear initial -> final over
        # epsilon_timesteps env steps
        self.initial_epsilon = 1.0
        self.final_epsilon = 0.05
        self.epsilon_timesteps = 10_000
        self.rollout_fragment_length = 64
        self.train_intensity = 2.0  # learner sgd steps per env step / batch size
        # offline mode: TD updates per train() iteration drawn from the
        # recorded dataset; env runners only evaluate (explore=False)
        self.offline_updates_per_iter = 50
        self.module_class = QModule

    @property
    def algo_class(self):
        return DQN


class DQNLearner(Learner):
    """(Double-)Q TD steps against a target network (``self.target``, a
    frozen copy of the module, refreshed by ``sync_target``)."""

    def build(self, seed: int = 0):
        super().build(seed)
        self.target = copy.deepcopy(self.module).requires_grad_(False)

    def _td_core(self, batch):
        """The shared (double-)Q TD computation: (q [B, A], q_taken, td,
        the IS-weighted TD loss). CQL adds its penalty to this one
        definition."""
        cfg = self.config
        q = self.module(batch["obs"])["action_dist_inputs"]
        q_taken = torch.gather(q, -1, batch["actions"].long()[:, None])[:, 0]
        with torch.no_grad():  # the target is a constant of the gradient
            q_next_target = self.target(batch["next_obs"])["action_dist_inputs"]
            if cfg.double_q:
                # the online net picks the argmax, the target net evaluates it
                next_a = torch.argmax(self.module(batch["next_obs"])["action_dist_inputs"], dim=-1)
                q_next = torch.gather(q_next_target, -1, next_a[:, None])[:, 0]
            else:
                q_next = torch.max(q_next_target, dim=-1).values
        target = batch["rewards"] + cfg.gamma * (1.0 - batch["done"]) * q_next
        td = q_taken - target
        weights = batch.get("weights", torch.ones_like(td))  # prioritized IS correction
        return q, q_taken, td, torch.mean(weights * torch.square(td))

    def compute_losses(self, batch):
        _, q_taken, td, loss = self._td_core(batch)
        return loss, {"total_loss": loss, "qf_mean": torch.mean(q_taken), "td_abs": torch.abs(td)}

    def update_dqn(self, batch: dict) -> tuple[dict, np.ndarray]:
        """One TD step; returns (metrics, |td| per row for the priorities),
        read from the device in one copy."""
        aux = self.apply_gradients_step(self._device_batch(batch))
        td_abs = aux.pop("td_abs")
        metrics, (td_host,) = read_once(aux, td_abs)
        return metrics, td_host

    @torch.no_grad()
    def sync_target(self):
        self.target.load_state_dict(self.module.state_dict())

    def get_state(self) -> dict:
        state = super().get_state()
        state["target_params"] = host_state(self.target)
        return state

    def set_state(self, state: dict):
        super().set_state(state)
        if "target_params" in state:
            self.target.load_state_dict(state["target_params"])


class DQN(Algorithm):
    learner_cls = DQNLearner
    supports_offline_input = True

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._total_env_steps / max(1, cfg.epsilon_timesteps))
        return cfg.initial_epsilon + frac * (cfg.final_epsilon - cfg.initial_epsilon)

    def setup(self):
        cfg = self.config
        cfg.model = {**cfg.model, "epsilon": cfg.initial_epsilon}
        if cfg.num_learners > 0:
            raise NotImplementedError("DQN runs a single (local) learner; scale sampling with num_env_runners")
        super().setup()
        if cfg.prioritized_replay:
            self.replay = PrioritizedEpisodeReplayBuffer(
                cfg.replay_buffer_capacity, alpha=cfg.prioritized_alpha, beta=cfg.prioritized_beta, seed=cfg.seed
            )
        else:
            self.replay = EpisodeReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._steps_since_target_sync = 0
        self._offline = bool(cfg.input_)
        if self._offline:
            from ray_tpu_torch.rllib.offline import fill_replay

            self._offline_transitions = fill_replay(self.replay, cfg.input_, refuse_overflow=True)

    @property
    def _learner(self) -> DQNLearner:
        return self.learner_group._local

    def _learn(self, num_updates: int) -> dict:
        metrics = {}
        for _ in range(num_updates):
            batch = self.replay.sample(self.config.train_batch_size)
            metrics, td_abs = self._learner.update_dqn(batch)
            if self.config.prioritized_replay:
                self.replay.update_priorities(batch["batch_indices"], td_abs)
        return metrics

    def training_step(self) -> dict:
        if self._offline:
            return self._offline_training_step()
        cfg = self.config
        eps = self._epsilon()
        self.env_runner_group.set_exploration(eps=eps)
        segments, runner_metrics = self.env_runner_group.sample(cfg.rollout_fragment_length)
        row_ids = []
        for seg in segments:
            row_ids.extend(self.replay.add(seg))
        new_steps = len(row_ids)
        self._total_env_steps += new_steps
        self._steps_since_target_sync += new_steps

        result = self._merge_runner_metrics(runner_metrics)
        if self._total_env_steps < cfg.num_steps_sampled_before_learning_starts or len(self.replay) < cfg.train_batch_size:
            # warm-up: no update ran, the weights are unchanged
            result["learner"] = {"num_updates": 0}
            result["epsilon"] = eps
            return result

        num_updates = max(1, int(new_steps * cfg.train_intensity / cfg.train_batch_size))
        metrics = self._learn(num_updates)
        if self._steps_since_target_sync >= cfg.target_network_update_freq:
            self._learner.sync_target()
            self._steps_since_target_sync = 0
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result["learner"] = {"num_updates": num_updates, **metrics}
        result["num_env_steps_sampled_lifetime"] = self._total_env_steps
        result["epsilon"] = eps
        return result

    def _offline_training_step(self) -> dict:
        """Train from the recorded dataset; the env is used for greedy
        evaluation only: no new experience enters the buffer."""
        cfg = self.config
        metrics = {}
        for _ in range(cfg.offline_updates_per_iter):
            metrics = self._learn(1)
            self._steps_since_target_sync += 1
            if self._steps_since_target_sync >= max(1, cfg.target_network_update_freq // cfg.train_batch_size):
                self._learner.sync_target()
                self._steps_since_target_sync = 0
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self.env_runner_group.set_exploration(eps=0.0)
        _, runner_metrics = self.env_runner_group.sample(cfg.rollout_fragment_length, explore=False)
        result = self._merge_runner_metrics(runner_metrics)
        result["learner"] = {"num_updates": cfg.offline_updates_per_iter, **metrics}
        result["offline_transitions"] = self._offline_transitions
        return result
