"""APPO (port of ray_tpu/rllib/algorithms/appo/appo.py): IMPALA's
actor-learner architecture with a PPO clipped surrogate anchored on a
periodically refreshed target ("old") policy.

V-trace importance weights are taken between the BEHAVIOR policy (the
sampler's logp, possibly several updates stale) and the TARGET policy,
and the PPO ratio current/target is
``clip(pi_b / pi_old, 0, 2) * pi_cur / pi_b`` (the IMPACT estimator, Luo
et al. 2020). The target network's logp and dist inputs for the whole
train batch are computed once per update and attached to the batch as
plain [N, T(, A)] columns, so minibatch slicing needs no special case;
the adaptive KL coefficient rides as a column too.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALA, IMPALAConfig, IMPALALearner, vtrace
from ray_tpu_torch.rllib.core.learner import host_state


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.clip_param = 0.4
        self.use_kl_loss = False
        self.kl_coeff = 1.0
        self.kl_target = 0.01
        # target refresh cadence, in learner update() calls; tau = 1 is a
        # hard copy (the reference default), tau < 1 polyak-mixes
        self.target_network_update_freq = 1
        self.tau = 1.0
        self.num_epochs = 1

    @property
    def algo_class(self):
        return APPO


class APPOLearner(IMPALALearner):
    """IMPALA's learner with a target network and the PPO surrogate."""

    def build(self, seed: int = 0):
        super().build(seed)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._updates = 0
        self._kl_coeff = float(self.config.kl_coeff)

    @torch.no_grad()
    def target_forward(self, obs, actions):
        """The target policy's (logp [N, T], dist inputs [N, T, A]) over a
        batch's [N, T+1] obs."""
        N, Tp1 = obs.shape[0], obs.shape[1]
        out = self.target(obs.reshape((N * Tp1,) + tuple(obs.shape[2:])))
        inputs = out["action_dist_inputs"].reshape(N, Tp1, -1)[:, :-1]
        return self.module.action_dist_cls.logp(inputs, actions), inputs

    def update(self, batch: dict, **kw) -> dict:
        old_logp, old_inputs = self.target_forward(torch.as_tensor(batch["obs"]).to(self.device),
                                                   torch.as_tensor(batch["actions"]).to(self.device))
        batch = dict(batch)
        batch["old_logp"] = old_logp.cpu().numpy()
        batch["old_inputs"] = old_inputs.cpu().numpy()
        batch["kl_coeff"] = np.full((len(batch["old_logp"]),), self._kl_coeff, np.float32)
        metrics = super().update(batch, **kw)

        self._updates += 1
        cfg = self.config
        if self._updates % cfg.target_network_update_freq == 0:
            with torch.no_grad():
                for t, p in zip(self.target.parameters(), self.module.parameters()):
                    t.copy_(p if cfg.tau >= 1.0 else (1.0 - cfg.tau) * t + cfg.tau * p)
        if cfg.use_kl_loss and "mean_kl" in metrics:
            # the reference's 2x / 0.5x adaptive rule
            if metrics["mean_kl"] > 2.0 * cfg.kl_target:
                self._kl_coeff *= 1.5
            elif metrics["mean_kl"] < 0.5 * cfg.kl_target:
                self._kl_coeff *= 0.5
            metrics["kl_coeff"] = self._kl_coeff
        return metrics

    def compute_losses(self, batch):
        cfg = self.config
        inputs, values, bootstrap = self._forward_sequences(batch)
        dist = self.module.action_dist_cls
        curr_logp = dist.logp(inputs, batch["actions"])
        behavior_logp = batch["logp"]
        old_logp = batch["old_logp"]
        mask = batch["mask"]
        # advantages for the TARGET policy: V-trace with target-vs-behavior weights
        vs, pg_adv = vtrace(behavior_logp, old_logp, batch["rewards"], values.detach(), bootstrap.detach(), mask,
                            batch["nonterminal"], cfg.gamma, cfg.rho_clip, cfg.c_clip)
        # current/target ratio through the behavior anchor (IMPACT)
        is_ratio = torch.clamp(torch.exp(behavior_logp - old_logp), 0.0, 2.0)
        ratio = is_ratio * torch.exp(curr_logp - behavior_logp)
        denom = torch.clamp(torch.sum(mask), min=1.0)
        surrogate = torch.minimum(pg_adv * ratio,
                                  pg_adv * torch.clamp(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param))
        policy_loss = -torch.sum(surrogate * mask) / denom
        vf_loss = 0.5 * torch.sum(((vs - values) ** 2) * mask) / denom
        entropy = torch.sum(dist.entropy(inputs) * mask) / denom
        mean_kl = torch.sum(dist.kl(batch["old_inputs"], inputs) * mask) / denom
        total = policy_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy
        if cfg.use_kl_loss:
            total = total + batch["kl_coeff"][0] * mean_kl
        return total, {"total_loss": total, "policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": entropy,
                       "mean_kl": mean_kl}

    def get_state(self) -> dict:
        state = super().get_state()
        state["target_params"] = host_state(self.target)
        state["kl_coeff"] = self._kl_coeff
        state["num_updates"] = self._updates
        return state

    def set_state(self, state: dict):
        super().set_state(state)
        if "target_params" in state:
            self.target.load_state_dict(state["target_params"])
        self._kl_coeff = float(state.get("kl_coeff", self._kl_coeff))
        # the refresh cadence too, or the first refresh after a restore
        # would drift up to 2 * freq - 1 updates stale
        self._updates = int(state.get("num_updates", self._updates))


class APPO(IMPALA):
    learner_cls = APPOLearner

    def setup(self):
        cfg = self.config
        if cfg.use_kl_loss and cfg.num_learners > 0:
            # each learner actor would adapt kl_coeff from its own shard's
            # mean_kl while gradients are allreduced: a mixed objective
            raise NotImplementedError(
                "use_kl_loss with remote learners is not supported: the adaptive "
                "kl_coeff is per-learner state; run num_learners=0 or disable use_kl_loss"
            )
        super().setup()
