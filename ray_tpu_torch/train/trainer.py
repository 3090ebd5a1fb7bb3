"""Trainers: DataParallelTrainer, JaxTrainer, TorchTrainer (port of
ray_tpu/train/trainer.py). ``fit()`` runs the controller in the driver's
process.

The loop travels to the workers by reference, as the port's tasks,
actors and Data UDFs do: a function or class defined at the top level of
an importable module (or of a driver script with a file), a
``functools.partial`` of one, or a picklable instance. A lambda or a
closure raises TypeError at ``fit()``, before any worker starts.
"""

from __future__ import annotations

from ray_tpu_torch.data.dataset import check_udf
from ray_tpu_torch.train.backend import BackendConfig, JaxConfig, TorchConfig
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import TrainController
from ray_tpu_torch.train.errors import TrainingFailedError
from ray_tpu_torch.train.result import Result


class DataParallelTrainer:
    _default_backend_config_cls = BackendConfig

    def __init__(
        self,
        train_loop_per_worker,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        backend_config: BackendConfig | None = None,
        datasets: dict | None = None,
        resume_from_checkpoint=None,
        scaling_policy=None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config or self._default_backend_config_cls()
        self.datasets = datasets
        self.resume_from_checkpoint = resume_from_checkpoint
        # elastic training: resize the worker group at restart boundaries
        # as the cluster's capacity changes
        self.scaling_policy = scaling_policy

    def fit(self, raise_on_error: bool = True) -> Result:
        import ray_tpu_torch

        check_udf(self.train_loop_per_worker, "train_loop_per_worker")
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        controller = TrainController(
            self.train_loop_per_worker,
            self.train_loop_config,
            self.scaling_config,
            self.run_config,
            self.backend_config,
            datasets=self.datasets,
            scaling_policy=self.scaling_policy,
        )
        if self.resume_from_checkpoint is not None:
            # a seed only: never registered with the manager, so top-k
            # eviction cannot delete the user's directory
            controller.resume_checkpoint = self.resume_from_checkpoint
        result = controller.run()
        if result.error is not None and raise_on_error:
            raise result.error
        return result


class JaxTrainer(DataParallelTrainer):
    """ray_tpu's name for its SPMD trainer, kept for code written against
    it. Here its backend (``JaxConfig``) bootstraps ``torch.distributed``
    (nccl on card-bound workers), and the loop steps
    ``parallel/train_step.py`` on the worker's card."""

    _default_backend_config_cls = JaxConfig


class TorchTrainer(DataParallelTrainer):
    """A trainer with a torch.distributed gloo process group (``TorchConfig``)."""

    _default_backend_config_cls = TorchConfig


__all__ = ["DataParallelTrainer", "JaxTrainer", "TorchTrainer", "TrainingFailedError"]
