"""Worker-side session API: report / get_checkpoint / get_dataset_shard
(port of ray_tpu/train/session.py). ``report()`` enqueues to the worker
actor's outbox and returns; persistence happens on the controller."""

from __future__ import annotations

from ray_tpu_torch.train import context as _ctx
from ray_tpu_torch.train._checkpoint import Checkpoint


def report(metrics: dict, checkpoint: Checkpoint | None = None, checkpoint_dir_name: str | None = None):
    """Report metrics (+ optionally a checkpoint) from every worker.

    All workers must call report() the same number of times; the
    controller commits one "round" when every rank has reported.
    """
    ctx = _ctx.get_context()
    if ctx is None:
        # local/debug mode: no-op sink so loops run outside a Trainer
        return
    if ctx._report_fn is not None:
        with ctx._lock:
            ctx._report_seq += 1
            seq = ctx._report_seq
        ctx._report_fn(seq, dict(metrics), checkpoint, checkpoint_dir_name)


def get_checkpoint() -> Checkpoint | None:
    """Latest committed checkpoint (set on restore/restart)."""
    ctx = _ctx.get_context()
    return ctx._latest_checkpoint if ctx is not None else None


def get_dataset_shard(dataset_name: str = "train"):
    ctx = _ctx.get_context()
    if ctx is None:
        return None
    return ctx._dataset_shards.get(dataset_name)
