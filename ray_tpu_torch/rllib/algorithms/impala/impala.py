"""IMPALA (port of ray_tpu/rllib/algorithms/impala/impala.py): an
actor-learner with V-trace correction; sampling overlaps learning one
iteration deep when there are remote env runners.

The learner consumes fixed-length [N, T] sequences. V-trace targets
(Espeholt et al. 2018) are computed in the loss in float32; ray_tpu's
reversed ``lax.scan`` is a reversed loop over T here.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rho_clip = 1.0
        self.c_clip = 1.0
        self.rollout_fragment_length = 50
        self.train_batch_size = 500
        self.grad_clip = 40.0
        self.num_epochs = 1
        self.minibatch_size = None

    @property
    def algo_class(self):
        return IMPALA


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, bootstrap_value, mask, nonterminal, gamma, rho_clip, c_clip):
    """V-trace targets and policy-gradient advantages over [N, T] sequences.

    values: [N, T] value estimates; bootstrap_value: [N]; nonterminal:
    [N, T], 0 where the transition at t enters a terminal state (no value
    bootstraps across an episode boundary). Returns (vs, pg_advantages),
    both [N, T] and outside the graph; padded steps (mask == 0) pass
    through their value estimate.
    """
    rho = torch.exp(target_logp - behavior_logp)
    rho_bar = torch.clamp(rho, max=rho_clip) * mask
    c_bar = torch.clamp(rho, max=c_clip) * mask
    v_next = torch.cat([values[:, 1:], bootstrap_value[:, None]], dim=1) * nonterminal
    delta = rho_bar * (rewards + gamma * v_next - values)
    vs_minus_v = torch.empty_like(values)
    carry = torch.zeros_like(values[:, 0])  # vs_{t+1} - V(x_{t+1}); a terminal at t cuts the recursion
    for t in range(values.shape[1] - 1, -1, -1):
        carry = delta[:, t] + gamma * c_bar[:, t] * nonterminal[:, t] * carry
        vs_minus_v[:, t] = carry
    vs = values + vs_minus_v
    vs_next = torch.cat([vs[:, 1:], bootstrap_value[:, None]], dim=1) * nonterminal
    pg_adv = rho_bar * (rewards + gamma * vs_next - values)
    return vs, pg_adv


class IMPALALearner(Learner):
    def _forward_sequences(self, batch):
        """The module over every [N, T+1] obs: (dist inputs [N, T, A],
        values [N, T], bootstrap values [N])."""
        N, T = batch["rewards"].shape
        out = self.module(batch["obs"].reshape((N * (T + 1),) + tuple(batch["obs"].shape[2:])))
        inputs = out["action_dist_inputs"].reshape(N, T + 1, -1)[:, :-1]
        values_all = out["vf"].reshape(N, T + 1)
        return inputs, values_all[:, :-1], values_all[:, -1]

    def compute_losses(self, batch):
        cfg = self.config
        inputs, values, bootstrap = self._forward_sequences(batch)
        dist = self.module.action_dist_cls
        target_logp = dist.logp(inputs, batch["actions"])
        mask = batch["mask"]
        vs, pg_adv = vtrace(batch["logp"], target_logp.detach(), batch["rewards"], values.detach(),
                            bootstrap.detach(), mask, batch["nonterminal"], cfg.gamma, cfg.rho_clip, cfg.c_clip)
        denom = torch.clamp(torch.sum(mask), min=1.0)
        policy_loss = -torch.sum(target_logp * pg_adv * mask) / denom
        vf_loss = 0.5 * torch.sum(((vs - values) ** 2) * mask) / denom
        entropy = torch.sum(dist.entropy(inputs) * mask) / denom
        total = policy_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"total_loss": total, "policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": entropy}


class IMPALA(Algorithm):
    learner_cls = IMPALALearner

    def setup(self):
        super().setup()
        self._inflight = None  # a one-iteration-deep sample pipeline

    def training_step(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        if self._inflight is not None:
            segments, runner_metrics = self.env_runner_group.collect(self._inflight)
            self._inflight = None
        else:
            segments, runner_metrics = self.env_runner_group.sample(cfg.train_batch_size)
        if cfg.num_env_runners > 0:
            # off-policy: the next sample runs on current (soon stale)
            # weights while the learners update; V-trace corrects
            self._inflight = self.env_runner_group.sample_async(cfg.train_batch_size)
        self._total_env_steps += sum(len(s["actions"]) for s in segments)
        t1 = time.perf_counter()
        batch = self._build_sequences(segments)
        learner_metrics = self.learner_group.update(batch, num_epochs=cfg.num_epochs, shuffle=False)
        t2 = time.perf_counter()
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        result = self._merge_runner_metrics(runner_metrics)
        result["learners"] = self._merge_learner_metrics(learner_metrics)
        result["timers"] = {"sample_s": t1 - t0, "learn_s": t2 - t1, "sync_s": time.perf_counter() - t2}
        return result

    def _build_sequences(self, segments: list[dict]) -> dict:
        """Chunk segments into fragments of ``rollout_fragment_length`` and
        pad to [N, T(+1)] arrays. Nothing is discarded: a segment longer
        than T becomes several rows, each bootstrapping from its own next
        obs. ``nonterminal[i, t] == 0`` marks a transition into a terminal
        state (only ever the last real step of a fragment)."""
        return build_sequences(segments, self.config.rollout_fragment_length)


def build_sequences(segments: list[dict], T: int) -> dict:
    chunks = []  # (segment, start, length, is_final_chunk)
    for s in segments:
        n = len(s["actions"])
        for t0 in range(0, n, T):
            t1 = min(t0 + T, n)
            chunks.append((s, t0, t1 - t0, t1 == n))
    obs_shape = segments[0]["obs"].shape[1:]
    N = len(chunks)
    obs = np.zeros((N, T + 1) + obs_shape, np.float32)
    actions = np.zeros((N, T) + segments[0]["actions"].shape[1:], segments[0]["actions"].dtype)
    rewards = np.zeros((N, T), np.float32)
    logp = np.zeros((N, T), np.float32)
    mask = np.zeros((N, T), np.float32)
    nonterminal = np.ones((N, T), np.float32)
    for i, (s, t0, t, final) in enumerate(chunks):
        obs[i, : t + 1] = s["obs"][t0 : t0 + t + 1]
        obs[i, t + 1 :] = s["obs"][t0 + t]  # repeat the last obs into the padding
        actions[i, :t] = s["actions"][t0 : t0 + t]
        rewards[i, :t] = s["rewards"][t0 : t0 + t]
        logp[i, :t] = s["logp"][t0 : t0 + t]
        mask[i, :t] = 1.0
        if final and bool(s["terminated"]):
            nonterminal[i, t - 1] = 0.0
    return {"obs": obs, "actions": actions, "rewards": rewards, "logp": logp, "mask": mask, "nonterminal": nonterminal}
