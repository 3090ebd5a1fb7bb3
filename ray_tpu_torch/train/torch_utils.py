"""Torch train-loop utilities (port of ray_tpu/train/torch_utils.py):
``get_device``, ``prepare_model``, ``prepare_data_loader`` and
``backward``, under a process group that ``TorchConfig`` or
``JaxConfig`` bootstrapped.

``get_device()`` is the worker's card (``cuda:0``: the runtime made it
the only card the worker sees) when the worker asked for one and CUDA
sees it, and the CPU otherwise.

Usage inside a DataParallelTrainer(train_loop, backend_config=TorchConfig()):

    def train_loop(config):
        model = train.torch.prepare_model(Net())
        loader = train.torch.prepare_data_loader(loader)
        for batch in loader: ...
"""

from __future__ import annotations

from ray_tpu_torch.train.backend import TorchConfig, bound_to_card  # noqa: F401  (train.torch.TorchConfig)


def get_device():
    """The device this worker should place tensors on: its card when it
    is bound to one, else the CPU."""
    import torch

    return torch.device("cuda", 0) if bound_to_card() else torch.device("cpu")


def prepare_model(model, *, ddp_kwargs: dict | None = None):
    """Move the model to the worker's device and wrap it in
    DistributedDataParallel when world_size > 1 (no wrap for one worker).
    Requires the process group that the backend's on_start initialized."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train.context import get_context

    model = model.to(get_device())
    if get_context().get_world_size() <= 1:
        return model
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized; run under "
            "DataParallelTrainer(..., backend=TorchConfig()) so the gloo "
            "process group exists before prepare_model"
        )
    kw = dict(ddp_kwargs or {})
    if get_device().type == "cuda":
        kw.setdefault("device_ids", [0])
    return torch.nn.parallel.DistributedDataParallel(model, **kw)


def prepare_data_loader(data_loader, *, add_dist_sampler: bool = True):
    """Shard a DataLoader across the group with a DistributedSampler.
    Non-default samplers are kept when add_dist_sampler=False."""
    import torch
    from torch.utils.data import DataLoader, DistributedSampler

    from ray_tpu_torch.train.context import get_context

    ctx = get_context()
    if ctx.get_world_size() <= 1 or not add_dist_sampler:
        return data_loader
    if data_loader.batch_size is None:
        # a custom batch_sampler owns batching AND sampling; replacing it
        # with a DistributedSampler would silently un-batch the stream
        raise ValueError(
            "prepare_data_loader cannot re-shard a DataLoader built with a "
            "custom batch_sampler; shard inside your batch_sampler and pass "
            "add_dist_sampler=False"
        )
    sampler = getattr(data_loader, "sampler", None)
    if sampler is not None and not isinstance(
        sampler, (torch.utils.data.SequentialSampler, torch.utils.data.RandomSampler)
    ):
        raise ValueError(
            f"prepare_data_loader would replace your custom sampler "
            f"({type(sampler).__name__}); pass add_dist_sampler=False to keep it"
        )
    dist_sampler = DistributedSampler(
        data_loader.dataset,
        num_replicas=ctx.get_world_size(),
        rank=ctx.get_world_rank(),
        shuffle=isinstance(sampler, torch.utils.data.RandomSampler),
    )
    kwargs = dict(
        batch_size=data_loader.batch_size,
        sampler=dist_sampler,
        num_workers=data_loader.num_workers,
        collate_fn=data_loader.collate_fn,
        pin_memory=data_loader.pin_memory,
        drop_last=data_loader.drop_last,
        timeout=data_loader.timeout,
        worker_init_fn=data_loader.worker_init_fn,
        generator=data_loader.generator,
    )
    if data_loader.num_workers > 0:  # only valid with workers
        kwargs["persistent_workers"] = data_loader.persistent_workers
        kwargs["prefetch_factor"] = data_loader.prefetch_factor
    return DataLoader(data_loader.dataset, **kwargs)


def backward(loss):
    """train.torch.backward: a plain backward (no AMP scaler)."""
    loss.backward()
