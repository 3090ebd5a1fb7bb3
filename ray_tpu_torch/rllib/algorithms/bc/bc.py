"""BC: behavior cloning from recorded episodes (port of
ray_tpu/rllib/algorithms/bc/bc.py). The loss is the negative log
likelihood of the dataset's actions under the policy, for any module
whose distribution has ``logp``: discrete (categorical logits) and
continuous (diagonal Gaussian) both clone.

Offline-only: ``config.offline_data(input_=path)`` is required; the env
runners only evaluate the cloned policy, greedily.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.utils.replay_buffers import EpisodeReplayBuffer


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 256
        self.updates_per_iter = 50
        self.replay_buffer_capacity = 1_000_000

    @property
    def algo_class(self):
        return BC


class BCLearner(Learner):
    """Supervised: maximize the logp of the dataset's actions."""

    def compute_losses(self, batch):
        out = self.module.forward_train(batch)
        logp = self.module.action_dist_cls.logp(out["action_dist_inputs"], batch["actions"])
        loss = -torch.mean(logp)
        return loss, {"total_loss": loss, "bc_logp_mean": torch.mean(logp)}


class BC(Algorithm):
    learner_cls = BCLearner
    supports_offline_input = True

    def setup(self):
        cfg = self.config
        self._require_offline_only()
        super().setup()
        self.replay = EpisodeReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        from ray_tpu_torch.rllib.offline import fill_replay

        self._dataset_transitions = fill_replay(self.replay, cfg.input_)

    @property
    def _learner(self) -> BCLearner:
        return self.learner_group._local

    def training_step(self) -> dict:
        cfg = self.config
        metrics: dict = {}
        for _ in range(cfg.updates_per_iter):
            metrics = self._learner.update(self.replay.sample(cfg.train_batch_size))
        result = self._offline_eval_result(metrics, cfg.updates_per_iter)
        result["dataset_transitions"] = self._dataset_transitions
        return result
