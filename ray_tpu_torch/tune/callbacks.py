"""Tune/Train logger callbacks (port of ray_tpu/tune/callbacks.py).

File-based loggers work offline out of the box (JSON lines, CSV,
TensorBoard via torch's SummaryWriter). Wandb/MLflow run in FILE-BACKED
modes only: WandbLoggerCallback writes wandb's offline run-directory
layout (sync later with `wandb sync`), MLflowLoggerCallback writes the
mlruns/ file-store layout (`mlflow ui --backend-store-uri file://...`);
online modes / remote tracking URIs raise: the deployment has no egress.

    run_config = RunConfig(callbacks=[JsonLoggerCallback(),
                                      CSVLoggerCallback(),
                                      TensorBoardLoggerCallback()])
"""

from __future__ import annotations

import csv
import json
import os


class Callback:
    """Experiment-lifecycle hooks (reference: tune/callback.py)."""

    def setup(self, run_dir: str):
        pass

    def log_trial_result(self, trial, result: dict):
        pass

    def log_trial_end(self, trial):
        pass

    def on_experiment_end(self, trials: list):
        pass


class JsonLoggerCallback(Callback):
    """result.json: one JSON line per reported result per trial
    (reference: tune/logger/json.py)."""

    def setup(self, run_dir: str):
        self.run_dir = run_dir
        self._files: dict[str, object] = {}

    def _file(self, trial):
        f = self._files.get(trial.trial_id)
        if f is None:
            d = os.path.join(self.run_dir, trial.trial_id)
            os.makedirs(d, exist_ok=True)
            f = self._files[trial.trial_id] = open(os.path.join(d, "result.json"), "a", buffering=1)
        return f

    def log_trial_result(self, trial, result: dict):
        self._file(trial).write(json.dumps(result, default=str) + "\n")

    def log_trial_end(self, trial):
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()


class CSVLoggerCallback(Callback):
    """progress.csv per trial (reference: tune/logger/csv.py)."""

    def setup(self, run_dir: str):
        self.run_dir = run_dir
        self._writers: dict[str, tuple] = {}

    def log_trial_result(self, trial, result: dict):
        entry = self._writers.get(trial.trial_id)
        flat = {k: v for k, v in result.items() if not isinstance(v, (dict, list))}
        if entry is None:
            d = os.path.join(self.run_dir, trial.trial_id)
            os.makedirs(d, exist_ok=True)
            f = open(os.path.join(d, "progress.csv"), "a", buffering=1, newline="")
            w = csv.DictWriter(f, fieldnames=sorted(flat))
            w.writeheader()
            entry = self._writers[trial.trial_id] = (f, w)
        f, w = entry
        w.writerow({k: flat.get(k, "") for k in w.fieldnames})

    def log_trial_end(self, trial):
        entry = self._writers.pop(trial.trial_id, None)
        if entry is not None:
            entry[0].close()


class TensorBoardLoggerCallback(Callback):
    """TB event files per trial via torch's SummaryWriter (offline; view
    with tensorboard --logdir <run_dir>). Reference: tune/logger/
    tensorboardx.py."""

    def setup(self, run_dir: str):
        self.run_dir = run_dir
        self._writers: dict[str, object] = {}

    def _writer(self, trial):
        w = self._writers.get(trial.trial_id)
        if w is None:
            from torch.utils.tensorboard import SummaryWriter

            w = self._writers[trial.trial_id] = SummaryWriter(
                log_dir=os.path.join(self.run_dir, trial.trial_id)
            )
        return w

    def log_trial_result(self, trial, result: dict):
        w = self._writer(trial)
        step = int(result.get("training_iteration", 0))
        for k, v in result.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                w.add_scalar(k, v, global_step=step)

    def log_trial_end(self, trial):
        w = self._writers.pop(trial.trial_id, None)
        if w is not None:
            w.close()


class WandbLoggerCallback(Callback):
    """File-backed OFFLINE mode only (reference: air/integrations/wandb.py
    WandbLoggerCallback with WANDB_MODE=offline): per-trial run
    directories in the wandb offline layout — wandb-metadata.json,
    config.json, and an append-only wandb-history.jsonl of results —
    syncable later with `wandb sync <dir>` from a machine with egress.
    Online mode is rejected explicitly: this deployment has none."""

    def __init__(self, project: str = "ray_tpu_torch", group: str | None = None, mode: str = "offline", dir: str | None = None, **kw):
        if mode != "offline":
            raise NotImplementedError(
                "only mode='offline' is supported in this deployment (no egress); "
                "sync the offline run directories later with `wandb sync`"
            )
        self.project = project
        self.group = group
        self.dir = dir
        self._runs: dict[str, str] = {}

    def setup(self, run_dir: str):
        import os

        self.root = self.dir or os.path.join(run_dir, "wandb")
        os.makedirs(self.root, exist_ok=True)

    def _run_dir(self, trial) -> str:
        import json
        import os
        import time

        d = self._runs.get(trial.trial_id)
        if d is None:
            stamp = time.strftime("%Y%m%d_%H%M%S")
            d = self._runs[trial.trial_id] = os.path.join(self.root, f"offline-run-{stamp}-{trial.trial_id}")
            os.makedirs(os.path.join(d, "files"), exist_ok=True)
            with open(os.path.join(d, "files", "wandb-metadata.json"), "w") as f:
                json.dump({"project": self.project, "group": self.group, "run_id": trial.trial_id, "mode": "offline"}, f)
            with open(os.path.join(d, "files", "config.json"), "w") as f:
                json.dump({k: {"value": v} for k, v in (trial.config or {}).items()}, f, default=str)
        return d

    def log_trial_result(self, trial, result: dict):
        import json
        import os

        d = self._run_dir(trial)
        row = {k: v for k, v in result.items() if isinstance(v, (int, float, str, bool))}
        row["_step"] = int(result.get("training_iteration", 0))
        with open(os.path.join(d, "files", "wandb-history.jsonl"), "a") as f:
            f.write(json.dumps(row, default=str) + "\n")

    def log_trial_end(self, trial):
        import json
        import os

        d = self._runs.get(trial.trial_id)
        if d:
            with open(os.path.join(d, "files", "wandb-summary.json"), "w") as f:
                json.dump({"state": "finished"}, f)


class MLflowLoggerCallback(Callback):
    """File-backed local tracking only (reference:
    air/integrations/mlflow.py with a file:// tracking URI): the standard
    mlruns/ directory layout — one run directory per trial with params/,
    metrics/ (timestamped series files), and tags/ — readable by
    `mlflow ui --backend-store-uri file://...`. Remote tracking URIs are
    rejected: this deployment has no egress."""

    def __init__(self, tracking_uri: str | None = None, experiment_name: str = "ray_tpu_torch", **kw):
        if tracking_uri and not tracking_uri.startswith("file:"):
            raise NotImplementedError(
                "only file:// tracking URIs are supported in this deployment (no egress)"
            )
        self.tracking_uri = tracking_uri
        self.experiment_name = experiment_name
        self._runs: dict[str, str] = {}

    def setup(self, run_dir: str):
        import os

        if self.tracking_uri:
            from urllib.parse import urlparse

            # handles both file:///abs and RFC 8089 file:/abs forms
            base = urlparse(self.tracking_uri).path
        else:
            base = os.path.join(run_dir, "mlruns")
        self.root = os.path.join(base, "0")  # experiment id 0
        os.makedirs(self.root, exist_ok=True)
        import json

        with open(os.path.join(self.root, "meta.yaml"), "w") as f:
            f.write(f"experiment_id: '0'\nname: {self.experiment_name}\nlifecycle_stage: active\n")

    def _run_dir(self, trial) -> str:
        import os

        d = self._runs.get(trial.trial_id)
        if d is None:
            d = self._runs[trial.trial_id] = os.path.join(self.root, trial.trial_id)
            for sub in ("params", "metrics", "tags"):
                os.makedirs(os.path.join(d, sub), exist_ok=True)
            for k, v in (trial.config or {}).items():
                with open(os.path.join(d, "params", str(k)), "w") as f:
                    f.write(str(v))
        return d

    def log_trial_result(self, trial, result: dict):
        import os
        import time

        d = self._run_dir(trial)
        ts = int(time.time() * 1000)
        step = int(result.get("training_iteration", 0))
        for k, v in result.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                safe = str(k).replace("/", "_")
                with open(os.path.join(d, "metrics", safe), "a") as f:
                    f.write(f"{ts} {v} {step}\n")

    def log_trial_end(self, trial):
        import os

        d = self._runs.get(trial.trial_id)
        if d:
            with open(os.path.join(d, "tags", "mlflow.runStatus"), "w") as f:
                f.write("FINISHED")
