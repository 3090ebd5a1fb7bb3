"""Train configuration dataclasses (port of ray_tpu/train/config.py):
ScalingConfig, FailureConfig, CheckpointConfig, RunConfig."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

SLICE_ITEM = "Not ported, with no counterpart on one H100"  # ROADMAP.md: util/tpu.py, slice gangs


@dataclass
class ScalingConfig:
    """How many workers and what each one holds.

    A worker asks for the card through ``resources_per_worker={"GPU": 1}``
    (``{"TPU": n}``, ray_tpu's name, folds into ``"GPU"``, as the port's
    ``num_tpus`` does): the runtime then binds its worker process to that
    card (``CUDA_VISIBLE_DEVICES``). ``use_gpu`` is accepted and, as
    ray_tpu's ``use_gpu``, reserves nothing. ``use_tpu`` with a
    ``topology`` gang-reserves a TPU slice in ray_tpu (``util/tpu.py``),
    which has no counterpart on one H100: it raises.
    """

    num_workers: int = 1
    use_tpu: bool = False
    use_gpu: bool = False  # accepted for API parity; reserves nothing
    topology: str | None = None
    accelerator_version: str = "v5e"
    accelerator_type: str | None = None
    resources_per_worker: dict | None = None
    placement_strategy: str = "PACK"

    def __post_init__(self):
        if self.accelerator_type and not self.use_tpu:
            self.use_tpu = self.accelerator_type.upper().startswith("TPU")
        if self.use_tpu and self.topology:
            raise NotImplementedError(
                f"ScalingConfig(use_tpu=True, topology={self.topology!r}) gang-reserves a TPU slice "
                f"(ray_tpu's util/tpu.py), which has no counterpart on one H100 (ROADMAP.md, {SLICE_ITEM}); ask for "
                "the card with resources_per_worker={'GPU': 1}")

    @property
    def _worker_resources(self) -> dict:
        from ray_tpu_torch.accelerators.gpu import fold_card

        res = fold_card(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        return res


@dataclass
class FailureConfig:
    """max_failures: total worker-group restarts allowed (-1 = infinite)."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Top-k retention of the committed checkpoints."""

    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1
    # experiment-lifecycle hooks (the tune.callbacks API)
    callbacks: list = field(default_factory=list)

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = os.environ.get("RT_STORAGE_PATH", os.path.expanduser("~/ray_tpu_results"))
        if self.name is None:
            import time

            self.name = f"train-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
