"""ray_tpu_torch.train: distributed training on the port's runtime (port of
ray_tpu/train).

A controller in the driver's process runs a worker group of actors, one
per bundle of a placement group; each worker runs the user's loop in a
thread, reports metrics and checkpoints to the controller, and reads its
dataset shard (``get_dataset_shard``). A worker that asks for
``resources_per_worker={"GPU": 1}`` is bound to the card and trains on
it (``train.torch.get_device()``, ``parallel/train_step.py``).
``JaxTrainer`` and ``JaxConfig`` keep ray_tpu's names with a
``torch.distributed`` bootstrap behind them (``backend.py``);
``jax_checkpoint`` saves torch state.
"""

from ray_tpu_torch.util.usage import record_library_usage as _rlu

_rlu("train")

import sys as _sys  # noqa: E402

from ray_tpu_torch.train import torch_utils as torch  # noqa: E402  (train.torch.prepare_model)
from ray_tpu_torch.train._checkpoint import Checkpoint  # noqa: E402
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig  # noqa: E402
from ray_tpu_torch.train.context import TrainContext, get_context  # noqa: E402
from ray_tpu_torch.train.errors import TrainingFailedError  # noqa: E402
from ray_tpu_torch.train.gbdt import GBDTTrainer, HistGBDT, LightGBMTrainer, XGBoostTrainer  # noqa: E402
from ray_tpu_torch.train.result import Result  # noqa: E402
from ray_tpu_torch.train.scaling_policy import (  # noqa: E402
    ElasticScalingPolicy,
    FixedScalingPolicy,
    NoopDecision,
    ResizeDecision,
    ScalingPolicy,
)
from ray_tpu_torch.train.session import get_checkpoint, get_dataset_shard, report  # noqa: E402
from ray_tpu_torch.train.trainer import DataParallelTrainer, JaxTrainer, TorchTrainer  # noqa: E402

# `import ray_tpu_torch.train.torch` / `from ray_tpu_torch.train.torch import
# prepare_model` work too
_sys.modules[__name__ + ".torch"] = torch

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "GBDTTrainer",
    "HistGBDT",
    "JaxTrainer",
    "LightGBMTrainer",
    "XGBoostTrainer",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchTrainer",
    "TrainContext",
    "TrainingFailedError",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "report",
]
