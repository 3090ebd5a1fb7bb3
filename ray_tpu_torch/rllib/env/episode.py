"""Episode container (port of ray_tpu/rllib/env/episode.py): numpy
arrays, moved to the learner's device only inside its update."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Episode:
    obs: list = field(default_factory=list)  # len T+1 (includes final obs)
    actions: list = field(default_factory=list)  # len T
    rewards: list = field(default_factory=list)
    logp: list = field(default_factory=list)  # behavior log-probs
    vf_preds: list = field(default_factory=list)
    is_terminated: bool = False  # env terminal (vs truncated/cut)

    def __len__(self) -> int:
        return len(self.actions)

    @property
    def total_reward(self) -> float:
        return float(sum(self.rewards))

    def to_batch(self) -> dict:
        """Stacked numpy views: obs has T+1 rows (last = bootstrap obs)."""
        return {
            "obs": np.asarray(self.obs, dtype=np.float32),
            "actions": np.asarray(self.actions),
            "rewards": np.asarray(self.rewards, dtype=np.float32),
            "logp": np.asarray(self.logp, dtype=np.float32),
            "vf_preds": np.asarray(self.vf_preds, dtype=np.float32),
            "terminated": np.asarray(self.is_terminated),
        }
