"""GPU accelerator manager (the counterpart of ray_tpu/accelerators/tpu.py
for NVIDIA cards): detection, the resource's name and valid request
sizes, and each worker's card isolation.

- The resource is ``"GPU"``; a task's ``num_gpus`` and ``num_tpus`` both
  fold into it (``core/runtime.py::_sched_options``), as ray_tpu folds
  both into ``"TPU"``.
- The count comes from ``RT_NUM_GPUS``, else from the visible cards,
  read without creating a CUDA context (NVML where torch can reach it,
  else the CUDA runtime's device count, which makes no context either):
  the driver may fork nothing afterwards, but it must stay able to.
- A request keeps ray_tpu's whole chip counts (1, 2, 4 or 8).
- A worker that holds cards sees only them: ``CUDA_VISIBLE_DEVICES`` is
  set in its environment before anything in it can touch CUDA
  (``core/node.py`` sets it when the worker is forked), mapped through
  the driver's own ``CUDA_VISIBLE_DEVICES`` when that is set.

ray_tpu's pod and topology model (slices, hosts, ``TPU_CHIPS_PER_HOST_BOUNDS``,
the slice gang resources and labels) has no counterpart on one H100.
"""

from __future__ import annotations

import os

RESOURCE_NAME = "GPU"
VALID_CHIP_COUNTS = (1, 2, 4, 8)


def fold_card(res: dict) -> dict:
    """A copy of the resource dict ``res`` with ``"TPU"`` (ray_tpu's name)
    folded into ``"GPU"``, as ``num_tpus`` folds into ``num_gpus``."""
    out = dict(res)
    if "TPU" in out:
        out[RESOURCE_NAME] = out.get(RESOURCE_NAME, 0) + out.pop("TPU")
    return out


def _visible_cards() -> int:
    import torch

    nvml = getattr(torch.cuda, "_device_count_nvml", None)
    if nvml is not None:
        n = nvml()  # NVML honours CUDA_VISIBLE_DEVICES; -1 when NVML is missing
        if n >= 0:
            return n
    return torch.cuda.device_count()


class GPUAcceleratorManager:
    """Per-node card detection and worker isolation."""

    @staticmethod
    def get_resource_name() -> str:
        return RESOURCE_NAME

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        env = os.environ.get("RT_NUM_GPUS")
        if env is not None:
            return int(env)
        return _visible_cards()

    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> tuple[bool, str | None]:
        if quantity not in VALID_CHIP_COUNTS:
            return False, f"GPU request must be one of {VALID_CHIP_COUNTS} (got {quantity}): whole cards only"
        return True, None

    @classmethod
    def set_current_process_visible_accelerators(cls, card_ids: list):
        os.environ.update(cls.worker_env_for_chips(card_ids))

    @staticmethod
    def worker_env_for_chips(card_ids: list[int]) -> dict:
        """The worker's CUDA_VISIBLE_DEVICES: card i is the i-th card this
        process sees (its own CUDA_VISIBLE_DEVICES, when set, lists them)."""
        seen = os.environ.get("CUDA_VISIBLE_DEVICES")
        if seen is not None:
            ids = [c.strip() for c in seen.split(",") if c.strip()]
            return {"CUDA_VISIBLE_DEVICES": ",".join(ids[c] for c in card_ids)}
        return {"CUDA_VISIBLE_DEVICES": ",".join(str(c) for c in card_ids)}

    @staticmethod
    def get_current_node_additional_resources() -> dict:
        return {}

    @staticmethod
    def get_current_node_labels() -> dict:
        return {}
