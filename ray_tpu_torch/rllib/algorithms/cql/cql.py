"""CQL: conservative Q-learning for offline RL (port of
ray_tpu/rllib/algorithms/cql/cql.py). The discrete-action form over the
DQN machinery: the TD loss gains the CQL(H) penalty

    cql_alpha * E_s[ logsumexp_a Q(s, a) - Q(s, a_data) ]

which pushes down the Q-values of actions absent from the dataset and
pushes up the logged ones'. Offline-only: ``input_`` is required and the
env runners evaluate greedily.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig, DQNLearner


class CQLConfig(DQNConfig):
    def __init__(self):
        super().__init__()
        self.cql_alpha = 1.0  # conservative penalty weight
        self.lr = 5e-4

    @property
    def algo_class(self):
        return CQL


class CQLLearner(DQNLearner):
    """DQN's TD step (its ``_td_core``, IS weights included) plus the
    conservative penalty, in one backward."""

    def compute_losses(self, batch):
        q, q_taken, td, td_loss = self._td_core(batch)
        # logsumexp over all actions minus the dataset action's Q
        conservative = torch.mean(torch.logsumexp(q, dim=-1) - q_taken)
        loss = td_loss + self.config.cql_alpha * conservative
        return loss, {"total_loss": loss, "td_loss": td_loss, "cql_penalty": conservative,
                      "qf_mean": torch.mean(q_taken), "td_abs": torch.abs(td)}


class CQL(DQN):
    learner_cls = CQLLearner
    supports_offline_input = True

    def setup(self):
        if not self.config.input_:
            raise ValueError("CQL is offline-only: configure offline_data(input_=<episode dataset path>)")
        super().setup()
