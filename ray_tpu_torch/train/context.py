"""Per-worker training context (port of ray_tpu/train/context.py): world
size and ranks, the report sink, the latest checkpoint and the dataset
shards. It lives in a module global inside each worker process; the
worker group seeds it before the user loop starts."""

from __future__ import annotations

import threading


class TrainContext:
    def __init__(
        self,
        world_size: int,
        world_rank: int,
        local_rank: int,
        local_world_size: int,
        node_rank: int,
        experiment_name: str,
        trial_name: str | None = None,
        trial_id: str | None = None,
        report_fn=None,
        latest_checkpoint=None,
        dataset_shards: dict | None = None,
        attempt_uid: str = "0",
        num_gpus: float = 0,
    ):
        self._world_size = world_size
        self._world_rank = world_rank
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_rank = node_rank
        self._experiment_name = experiment_name
        self._trial_name = trial_name
        self._trial_id = trial_id
        self._report_fn = report_fn
        self._latest_checkpoint = latest_checkpoint
        self._dataset_shards = dataset_shards or {}
        self._attempt_uid = attempt_uid  # unique per worker-group attempt
        self._num_gpus = num_gpus  # the cards this worker asked for (the runtime bound them)
        self._report_seq = 0
        self._lock = threading.Lock()

    def get_world_size(self) -> int:
        return self._world_size

    def get_world_rank(self) -> int:
        return self._world_rank

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_local_world_size(self) -> int:
        return self._local_world_size

    def get_node_rank(self) -> int:
        return self._node_rank

    def get_experiment_name(self) -> str:
        return self._experiment_name

    def get_trial_name(self):
        return self._trial_name

    def get_trial_id(self):
        return self._trial_id


_context: TrainContext | None = None


def get_context() -> TrainContext | None:
    return _context


def set_context(ctx: TrainContext | None):
    global _context
    _context = ctx
