"""Result returned by Trainer.fit() (port of ray_tpu/train/result.py)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ray_tpu_torch.train._checkpoint import Checkpoint


@dataclass
class Result:
    metrics: dict | None
    checkpoint: Checkpoint | None
    path: str | None
    error: BaseException | None = None
    metrics_history: list = field(default_factory=list)
    best_checkpoints: list = field(default_factory=list)
    # the trial's resolved param config (tune results; None for train)
    config: dict | None = None

    def get_best_checkpoint(self, metric: str, mode: str = "max") -> Checkpoint | None:
        best, best_v = None, None
        for ckpt, m in self.best_checkpoints:
            if metric not in m:
                continue
            v = float(m[metric])
            if best_v is None or (v > best_v if mode == "max" else v < best_v):
                best, best_v = ckpt, v
        return best
