"""Trial state (port of ray_tpu/tune/trial.py)."""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclass
class Trial:
    config: dict
    trial_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    last_result: dict | None = None
    metrics_history: list = field(default_factory=list)
    checkpoint_path: str | None = None
    error: str | None = None
    iteration: int = 0
    # PBT bookkeeping
    restore_config: dict | None = None
    # per-trial resource override (ResourceChangingScheduler); None ->
    # the controller-wide resources_per_trial
    resources: dict | None = None

    @property
    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def metric_at(self, metric: str):
        if self.last_result is None:
            return None
        return self.last_result.get(metric)
