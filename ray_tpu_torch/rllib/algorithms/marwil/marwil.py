"""MARWIL: monotonic advantage re-weighted imitation learning, offline
(port of ray_tpu/rllib/algorithms/marwil/marwil.py).

A value head regresses the Monte-Carlo returns of the recorded episodes,
and the policy clones the dataset's actions weighted by
``exp(beta * normalized advantage)``, so better-than-baseline transitions
are imitated harder; ``beta = 0`` is plain behavior cloning. The returns
are computed per episode at load time on the host (``returns_to_go``),
the dataset lives as flat [M, ...] arrays, and the advantage scale's
moving average is host state sent with each batch as a column.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 256
        self.updates_per_iter = 50
        self.beta = 1.0  # 0 => behavior cloning
        self.vf_coeff = 1.0
        # update rate of the squared-advantage moving average that
        # normalizes the exponent's scale
        self.ma_adv_norm_rate = 1e-2
        self.ma_adv_norm_start = 100.0

    @property
    def algo_class(self):
        return MARWIL


class MARWILLearner(Learner):
    def build(self, seed: int = 0):
        super().build(seed)
        self.ma_adv_norm = float(self.config.ma_adv_norm_start)

    def compute_losses(self, batch):
        cfg = self.config
        out = self.module.forward_train(batch)
        logp = self.module.action_dist_cls.logp(out["action_dist_inputs"], batch["actions"])
        adv = batch["returns"] - out["vf"]
        vf_loss = torch.mean(adv**2)
        # the exponent uses the running scale, not the batch's, so the
        # weighting is stable across minibatches; clipped for safety
        scale = torch.rsqrt(torch.clamp(batch["ma_adv_norm"][0], min=1e-8))
        weights = torch.exp(torch.clamp(cfg.beta * adv.detach() * scale, -20.0, 20.0))
        policy_loss = -torch.mean(weights * logp)
        total = policy_loss + cfg.vf_coeff * vf_loss
        return total, {"total_loss": total, "policy_loss": policy_loss, "vf_loss": vf_loss,
                       "mean_sqd_adv": torch.mean(adv.detach() ** 2), "mean_weight": torch.mean(weights)}

    def update_marwil(self, batch: dict) -> dict:
        batch = dict(batch)
        batch["ma_adv_norm"] = np.full((len(batch["returns"]),), self.ma_adv_norm, np.float32)
        metrics = self.update(batch)
        rate = self.config.ma_adv_norm_rate
        self.ma_adv_norm += rate * (metrics["mean_sqd_adv"] - self.ma_adv_norm)
        metrics["ma_adv_norm"] = self.ma_adv_norm
        return metrics

    def get_state(self) -> dict:
        state = super().get_state()
        state["ma_adv_norm"] = self.ma_adv_norm
        return state

    def set_state(self, state: dict):
        super().set_state(state)
        self.ma_adv_norm = float(state.get("ma_adv_norm", self.ma_adv_norm))


def returns_to_go(path: str, gamma: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(obs [M, ...], actions [M], Monte-Carlo returns-to-go [M]) of every
    transition of the episode dataset at ``path``. An episode cut by the
    horizon (not terminated) keeps its observed return: offline data has
    no bootstrap target. An empty dataset raises."""
    from ray_tpu_torch.rllib.offline import JsonReader

    obs_rows, act_rows, ret_rows = [], [], []
    for ep in JsonReader(path):
        rewards = np.asarray(ep["rewards"], np.float32)
        T = len(rewards)
        if T == 0:
            continue
        returns = np.zeros(T, np.float32)
        acc = 0.0
        for t in range(T - 1, -1, -1):
            acc = rewards[t] + gamma * acc
            returns[t] = acc
        obs_rows.append(np.asarray(ep["obs"], np.float32)[:T])
        act_rows.append(np.asarray(ep["actions"]))
        ret_rows.append(returns)
    if not obs_rows:
        raise ValueError(f"offline input {path!r} contained no transitions")
    return np.concatenate(obs_rows), np.concatenate(act_rows), np.concatenate(ret_rows)


class MARWIL(Algorithm):
    learner_cls = MARWILLearner
    supports_offline_input = True

    def setup(self):
        cfg = self.config
        self._require_offline_only()
        super().setup()
        self._obs, self._actions, self._returns = returns_to_go(cfg.input_, cfg.gamma)
        self._rng = np.random.default_rng(cfg.seed)

    @property
    def _learner(self) -> MARWILLearner:
        return self.learner_group._local

    def training_step(self) -> dict:
        cfg = self.config
        metrics: dict = {}
        for _ in range(cfg.updates_per_iter):
            idx = self._rng.integers(0, len(self._returns), cfg.train_batch_size)
            batch = {"obs": self._obs[idx], "actions": self._actions[idx], "returns": self._returns[idx]}
            metrics = self._learner.update_marwil(batch)
        result = self._offline_eval_result(metrics, cfg.updates_per_iter)
        result["dataset_transitions"] = int(len(self._returns))
        return result
