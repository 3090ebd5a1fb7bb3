"""Action distributions as functions over distribution inputs (port of
ray_tpu/rllib/core/distributions.py), in float32.

A distribution is a namespace of static functions keyed on the module's
output tensor ("logits", or mean and log-std concatenated), so the
learner's loss and the env runner's sampling share them. Samples draw
from an explicit ``torch.Generator`` (on the tensors' device), where
ray_tpu splits a jax PRNG key: the draws differ, the laws are the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Categorical:
    """Discrete actions from unnormalized logits [..., n_actions]."""

    @staticmethod
    def sample(gen: torch.Generator, logits):
        # Gumbel-max: argmax(logits + Gumbel noise) is a categorical draw
        u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
        return torch.argmax(logits - torch.log(-torch.log(u.clamp_min(1e-20))), dim=-1)

    @staticmethod
    def logp(logits, actions):
        logp_all = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp_all, -1, actions.long()[..., None])[..., 0]

    @staticmethod
    def entropy(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    @staticmethod
    def kl(logits_p, logits_q):
        logp = torch.log_softmax(logits_p, dim=-1)
        logq = torch.log_softmax(logits_q, dim=-1)
        return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)

    @staticmethod
    def deterministic(logits):
        return torch.argmax(logits, dim=-1)


class DiagGaussian:
    """Continuous actions; inputs [..., 2*dim] = concat(mean, log_std)."""

    @staticmethod
    def _split(inputs):
        mean, log_std = torch.chunk(inputs, 2, dim=-1)
        return mean, torch.clamp(log_std, -20.0, 2.0)

    @staticmethod
    def sample(gen: torch.Generator, inputs):
        mean, log_std = DiagGaussian._split(inputs)
        noise = torch.randn(mean.shape, generator=gen, device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def logp(inputs, actions):
        mean, log_std = DiagGaussian._split(inputs)
        var = torch.exp(2 * log_std)
        return torch.sum(-0.5 * ((actions - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi)), dim=-1)

    @staticmethod
    def entropy(inputs):
        _, log_std = DiagGaussian._split(inputs)
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)

    @staticmethod
    def kl(inputs_p, inputs_q):
        mp, lp = DiagGaussian._split(inputs_p)
        mq, lq = DiagGaussian._split(inputs_q)
        return torch.sum(lq - lp + (torch.exp(2 * lp) + (mp - mq) ** 2) / (2 * torch.exp(2 * lq)) - 0.5, dim=-1)

    @staticmethod
    def deterministic(inputs):
        mean, _ = DiagGaussian._split(inputs)
        return mean


def make_squashed_gaussian(low, high):
    """Tanh-squashed diagonal gaussian scaled to [low, high] (the SAC
    policy distribution): the bounds are baked into the class, so env
    runners use it through the generic interface."""
    low_a = torch.as_tensor(np.asarray(low, dtype=np.float32))
    high_a = torch.as_tensor(np.asarray(high, dtype=np.float32))
    scale = (high_a - low_a) * 0.5
    mid = (high_a + low_a) * 0.5

    class SquashedGaussian:
        low = low_a
        high = high_a

        @staticmethod
        def _squash(u):
            return mid.to(u.device) + scale.to(u.device) * torch.tanh(u)

        @staticmethod
        def sample(gen: torch.Generator, inputs):
            return SquashedGaussian._squash(DiagGaussian.sample(gen, inputs))

        @staticmethod
        def logp(inputs, actions):
            # invert the squash; the clip keeps atanh finite at the bounds
            s, m = scale.to(actions.device), mid.to(actions.device)
            t = torch.clamp((actions - m) / s, -0.999999, 0.999999)
            base = DiagGaussian.logp(inputs, torch.atanh(t))
            # |d a / d u| = scale * (1 - tanh(u)^2)
            return base - torch.sum(torch.log(s * (1.0 - t**2) + 1e-9), dim=-1)

        @staticmethod
        def deterministic(inputs):
            mean, _ = DiagGaussian._split(inputs)
            return SquashedGaussian._squash(mean)

        @staticmethod
        def entropy(inputs):
            # the gaussian's entropy, an upper bound (metrics only)
            return DiagGaussian.entropy(inputs)

    return SquashedGaussian
