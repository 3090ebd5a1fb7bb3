"""ResultGrid (port of ray_tpu/tune/result_grid.py). pandas is imported
only by ``get_dataframe``."""

from __future__ import annotations

from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.tune.trial import ERROR, Trial


class ResultGrid:
    def __init__(self, trials: list[Trial], path: str):
        self._trials = trials
        self.path = path
        self._results = [
            Result(
                metrics=t.last_result,
                checkpoint=Checkpoint(t.checkpoint_path) if t.checkpoint_path else None,
                path=path,
                error=RuntimeError(t.error) if t.error else None,
                metrics_history=t.metrics_history,
                config=dict(t.config) if t.config else None,
            )
            for t in trials
        ]

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self):
        return [r.error for r in self._results if r.error]

    @property
    def num_errors(self):
        return len(self.errors)

    def get_best_result(self, metric: str | None = None, mode: str = "max") -> Result:
        best, best_v = None, None
        for r in self._results:
            if r.metrics is None or metric not in r.metrics:
                continue
            v = float(r.metrics[metric])
            if best_v is None or (v > best_v if mode == "max" else v < best_v):
                best, best_v = r, v
        if best is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        return best

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for t, r in zip(self._trials, self._results):
            row = dict(r.metrics or {})
            row.update({f"config/{k}": v for k, v in t.config.items()})
            row["trial_id"] = t.trial_id
            row["status"] = t.status
            rows.append(row)
        return pd.DataFrame(rows)
