"""Elastic training: worker-group sizing decisions (port of
ray_tpu/train/scaling_policy.py).

A resize is a restart boundary: the controller tears the group down as
it does on a failure (the restart budget untouched) and the new group,
at the new size, resumes from the latest committed checkpoint."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class NoopDecision:
    reason: str = ""


@dataclass
class ResizeDecision:
    num_workers: int
    reason: str = ""


class ScalingPolicy:
    """Decision hooks.

    - workers_for_attempt(): group size for the NEXT worker-group start.
    - poll_running(): consulted periodically while a group trains; a
      ResizeDecision triggers a checkpoint-resume restart at the new size.
    """

    def __init__(self, scaling_config):
        self.scaling_config = scaling_config

    def workers_for_attempt(self) -> int:
        return self.scaling_config.num_workers

    def poll_running(self, group_size: int):
        return NoopDecision()


class FixedScalingPolicy(ScalingPolicy):
    """Always the configured size (the reference default)."""


class ElasticScalingPolicy(ScalingPolicy):
    """Fit the group to cluster capacity within [min_workers, max_workers].

    Sizing uses AVAILABLE capacity, never the cluster total: co-tenant
    jobs hold resources too, and a resize targeting capacity someone else
    owns would tear down a working group for a placement that can never
    succeed. At attempt start the previous group has already released its
    bundles, so available reflects what this job can actually reserve.
    While running, upscale when the AVAILABLE headroom fits extra workers
    (a node joined / a tenant left); downscale only when the cluster
    TOTAL can no longer hold the current group (a node died — the failure
    path usually fires first). poll_interval_s throttles the checks."""

    def __init__(self, scaling_config, min_workers: int = 1, max_workers: int | None = None, poll_interval_s: float = 1.0):
        super().__init__(scaling_config)
        self.min_workers = max(1, int(min_workers))
        self.max_workers = int(max_workers) if max_workers else max(scaling_config.num_workers, self.min_workers)
        self.poll_interval_s = poll_interval_s
        self._last_poll = 0.0

    def _fit(self, resources: dict) -> int:
        res = self.scaling_config._worker_resources
        fit = None
        for k, per in res.items():
            if per > 0:
                fit_k = int(resources.get(k, 0) // per)
                fit = fit_k if fit is None else min(fit, fit_k)
        return self.max_workers if fit is None else fit

    def _clamp(self, n: int) -> int:
        return max(self.min_workers, min(self.max_workers, n))

    def workers_for_attempt(self) -> int:
        import ray_tpu_torch

        return self._clamp(self._fit(ray_tpu_torch.available_resources()))

    def poll_running(self, group_size: int):
        import time

        import ray_tpu_torch

        now = time.monotonic()
        if now - self._last_poll < self.poll_interval_s:
            return NoopDecision()
        self._last_poll = now
        headroom = self._fit(ray_tpu_torch.available_resources())
        target = self._clamp(group_size + headroom)
        if target > group_size:
            return ResizeDecision(target, reason=f"headroom for {target - group_size} more workers")
        total_fit = self._clamp(self._fit(ray_tpu_torch.cluster_resources()))
        if total_fit < group_size:
            return ResizeDecision(total_fit, reason=f"cluster now fits only {total_fit} workers")
        return NoopDecision()
