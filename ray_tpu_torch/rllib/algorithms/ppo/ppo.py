"""PPO (port of ray_tpu/rllib/algorithms/ppo/ppo.py): clipped surrogate,
clipped value loss and entropy over GAE advantages, standardized over the
train batch. One learner step per minibatch; sampling stays on CPU env
runners."""

from __future__ import annotations

import time

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.num_epochs = 10
        self.minibatch_size = 128
        self.train_batch_size = 2000
        self.grad_clip = 0.5

    @property
    def algo_class(self):
        return PPO


class PPOLearner(Learner):
    def compute_losses(self, batch):
        cfg = self.config
        out = self.module.forward_train(batch)
        dist = self.module.action_dist_cls
        inputs = out["action_dist_inputs"]
        logp = dist.logp(inputs, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        policy_loss = -torch.mean(surrogate)

        vf = out["vf"]
        vf_err = (vf - batch["value_targets"]) ** 2
        vf_clipped = batch["vf_preds"] + torch.clamp(vf - batch["vf_preds"], -cfg.vf_clip_param, cfg.vf_clip_param)
        vf_err_clipped = (vf_clipped - batch["value_targets"]) ** 2
        vf_loss = 0.5 * torch.mean(torch.maximum(vf_err, vf_err_clipped))

        entropy = torch.mean(dist.entropy(inputs))
        total = policy_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"total_loss": total, "policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": entropy,
                       "mean_kl": torch.mean(batch["logp"] - logp)}


def gae(segment: dict, bootstrap_value: float, gamma: float, lambda_: float) -> np.ndarray:
    """Generalized advantage estimates of one segment; the value past its
    end is 0 after a terminal, else ``bootstrap_value``."""
    v = segment["vf_preds"]
    v_next = np.append(v[1:], 0.0 if segment["terminated"] else bootstrap_value)
    delta = segment["rewards"] + gamma * v_next - v
    adv = np.zeros(len(v), dtype=np.float32)
    acc = 0.0
    for t in range(len(v) - 1, -1, -1):
        acc = delta[t] + gamma * lambda_ * acc
        adv[t] = acc
    return adv


class PPO(Algorithm):
    learner_cls = PPOLearner

    def setup(self):
        super().setup()
        self._vf_module = self.module_spec.build()  # bootstrap values on the host

    def training_step(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        segments, runner_metrics = self.env_runner_group.sample(cfg.train_batch_size)
        self._total_env_steps += sum(len(s["actions"]) for s in segments)
        t1 = time.perf_counter()
        batch = self._build_train_batch(segments, self.learner_group.get_weights())
        learner_metrics = self.learner_group.update(batch, minibatch_size=cfg.minibatch_size,
                                                    num_epochs=cfg.num_epochs, seed=cfg.seed + self.iteration)
        t2 = time.perf_counter()
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result = self._merge_runner_metrics(runner_metrics)
        result["learners"] = self._merge_learner_metrics(learner_metrics)
        result["timers"] = {"sample_s": t1 - t0, "learn_s": t2 - t1, "sync_s": time.perf_counter() - t2}
        return result

    @torch.no_grad()
    def _build_train_batch(self, segments: list[dict], weights: dict) -> dict:
        """GAE per segment, then a flat row batch. The bootstrap value of a
        cut or truncated segment is a forward pass on its final obs."""
        cfg = self.config
        self._vf_module.load_state_dict(weights)
        boot_obs = torch.as_tensor(np.stack([s["obs"][-1] for s in segments]))
        boot_vals = self._vf_module(boot_obs)["vf"].numpy()
        obs, actions, logp, advs, targets, vf_preds = [], [], [], [], [], []
        for s, bv in zip(segments, boot_vals):
            adv = gae(s, bv, cfg.gamma, cfg.lambda_)
            obs.append(s["obs"][:-1])
            actions.append(s["actions"])
            logp.append(s["logp"])
            vf_preds.append(s["vf_preds"])
            advs.append(adv)
            targets.append(adv + s["vf_preds"])
        adv_all = np.concatenate(advs)
        adv_all = (adv_all - adv_all.mean()) / (adv_all.std() + 1e-8)
        return {
            "obs": np.concatenate(obs),
            "actions": np.concatenate(actions),
            "logp": np.concatenate(logp),
            "advantages": adv_all.astype(np.float32),
            "value_targets": np.concatenate(targets).astype(np.float32),
            "vf_preds": np.concatenate(vf_preds).astype(np.float32),
        }
