"""Train error types (port of ray_tpu/train/errors.py)."""

from __future__ import annotations


class TrainingFailedError(RuntimeError):
    """Raised by Trainer.fit() when training fails beyond the failure
    policy's patience. ``.training_error`` holds the worker exception."""

    def __init__(self, msg: str, training_error: BaseException | None = None):
        super().__init__(msg)
        self.training_error = training_error


class WorkerGroupError(RuntimeError):
    """One or more workers in the group failed; maps worker rank -> error."""

    def __init__(self, msg: str, worker_failures: dict):
        super().__init__(f"{msg}: {worker_failures}")
        self.worker_failures = worker_failures
