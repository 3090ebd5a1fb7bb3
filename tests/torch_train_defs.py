"""Train loops, actors and UDFs for the trainer and collective tests
(``tests/test_torch_trainer.py``, ``test_torch_trainer_ddp.py``,
``test_torch_gbdt.py``, ``test_torch_collective.py`` and
``test_torch_data.py``'s train half).

The port sends a loop or an actor class to its workers by reference
(module and qualified name), so they live here at module level, where
both packages' workers import them; ray_tpu's tests define them inline.
A loop takes its package's name from ``config["pkg"]`` and imports that
package's ``train``. No jax at module level: a port worker imports this
module (the ray_tpu-only loop imports jax inside itself)."""

from __future__ import annotations

import importlib
import json
import os
import tempfile
import time

import numpy as np

from ray_tpu_torch.collective import CollectiveActorMixin


def _train(config):
    return importlib.import_module(config["pkg"] + ".train")


# ---------------------------------------------------------------- test_train.py's loops
def single_worker_metrics(config):
    train = _train(config)
    for i in range(3):
        train.report({"loss": 10.0 - i, "i": i})


def multi_worker_context(config):
    train = _train(config)
    ctx = train.get_context()
    assert ctx.get_world_size() == 3
    train.report({"rank": ctx.get_world_rank(), "local_rank": ctx.get_local_rank(),
                  "local_world_size": ctx.get_local_world_size()})


def checkpoint_roundtrip(config):
    train = _train(config)
    ctx = train.get_context()
    for step in range(2):
        d = tempfile.mkdtemp()
        with open(os.path.join(d, f"model_rank{ctx.get_world_rank()}.json"), "w") as f:
            json.dump({"step": step, "rank": ctx.get_world_rank()}, f)
        train.report({"step": step}, checkpoint=train.Checkpoint.from_directory(d))


def _resume_step(train) -> int:
    ckpt = train.get_checkpoint()
    if ckpt is None:
        return 0
    with open(os.path.join(ckpt.path, "state.json")) as f:
        return json.load(f)["step"] + 1


def _report_step(train, step: int, **metrics):
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "state.json"), "w") as f:
        json.dump({"step": step}, f)
    train.report({"step": step, **metrics}, checkpoint=train.Checkpoint.from_directory(d))


def failure_retry(config):
    train = _train(config)
    start = _resume_step(train)
    with open(config["marker"], "a") as f:
        f.write("x")
    attempts = os.path.getsize(config["marker"])
    for step in range(start, 4):
        _report_step(train, step)
        if attempts == 1 and step == 1:
            raise RuntimeError("injected failure after step 1")


def always_fails(config):
    raise ValueError("always fails")


def topk_scores(config):
    train = _train(config)
    for score in [0.1, 0.9, 0.5, 0.3]:
        d = tempfile.mkdtemp()
        open(os.path.join(d, "w"), "w").close()
        train.report({"score": score}, checkpoint=train.Checkpoint.from_directory(d))


def train_collectives(config):
    train = _train(config)
    tcol = importlib.import_module(config["pkg"] + ".train.collective")
    ctx = train.get_context()
    tcol.barrier()
    data = tcol.broadcast_from_rank_zero({"w": 42} if ctx.get_world_rank() == 0 else None)
    summed = tcol.allreduce(np.full(3, float(ctx.get_world_rank() + 1)))
    train.report({"got": data["w"], "sum": [float(x) for x in summed]})


def jax_tiny_llama(config):
    """test_train.py's JaxTrainer loop on ray_tpu (jax imported here, in
    ray_tpu's worker), reporting every step's loss."""
    from functools import partial

    import jax
    import optax

    from ray_tpu import train
    from ray_tpu.models.llama import LlamaConfig, init_params, loss_fn, param_logical_axes
    from ray_tpu.parallel.mesh import create_mesh
    from ray_tpu.parallel.train_step import make_train_step, shard_batch

    cfg = LlamaConfig.tiny(dtype=config["dtype"])
    mesh = create_mesh(dp=-1)
    init_fn, compile_step, _ = make_train_step(partial(loss_fn, config=cfg), optax.adamw(1e-3), mesh,
                                               param_logical_axes(cfg))
    state, shardings = init_fn(jax.random.PRNGKey(0), partial(init_params, cfg))
    step = compile_step(shardings)
    batch = shard_batch(tiny_batch(), mesh)
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    train.report({"first_loss": losses[0], "last_loss": losses[-1], "losses": losses})


def torch_tiny_llama(config):
    """The same loop on the port: ray_tpu's initial weights (numpy, through
    the loop's config) converted in the worker, parallel/train_step.py on
    the worker's device (the CPU here: ``device`` from the config)."""
    from functools import partial

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import LlamaConfig, loss_fn, param_logical_axes
    from ray_tpu_torch.parallel.train_step import adamw, make_train_step, to_device
    from ray_tpu_torch.weights import params_from_jax

    device = config["device"]
    cfg = LlamaConfig.tiny(dtype=config["dtype"])
    init_fn, step_fn = make_train_step(partial(loss_fn, config=cfg), adamw(1e-3), param_axes=param_logical_axes(cfg),
                                       device=device)
    state = init_fn(0, lambda _: params_from_jax(config["params"], device))
    batch = to_device(tiny_batch(), device)
    losses = []
    for _ in range(4):
        state, m = step_fn(state, batch)
        losses.append(m["loss"].item())
    train.report({"first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
                  "device": str(train.torch.get_device())})


def tiny_batch() -> dict:
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 512, (8, 32)).astype(np.int32),
            "targets": rng.integers(0, 512, (8, 32)).astype(np.int32)}


def elastic_steps(config):
    """The elastic cases' loop: resume from the checkpoint, report each
    step with the world size."""
    train = _train(config)
    start = _resume_step(train)
    ws = train.get_context().get_world_size()
    for step in range(start, config["total"]):
        _report_step(train, step, world_size=ws)
        time.sleep(config["sleep"])


def dataset_rows(config):
    train = _train(config)
    shard = train.get_dataset_shard("train")
    tot = 0
    for b in shard.iter_batches(batch_size=64):
        tot += len(b["x"])
    train.report({"n": tot})


def dataset_id_sum(config):
    """test_data.py's train half: each rank sums its shard's ids."""
    train = _train(config)
    it = train.get_dataset_shard("train")
    total = rows = 0
    for batch in it.iter_batches(batch_size=8):
        total += int(batch["id"].sum())
        rows += len(batch["id"])
    rank = train.get_context().get_world_rank()
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"total": total, "rows": rows}, f)
    train.report({"total": total, "rank": rank})


def card_env(config):
    """The card binding a worker sees: its CUDA_VISIBLE_DEVICES, the
    device ``train.torch.get_device()`` names, torch.distributed's backend."""
    train = _train(config)
    import torch.distributed as dist

    train.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "device": str(train.torch.get_device()),
                  "backend": dist.get_backend() if dist.is_initialized() else None})


def jax_checkpoint_loop(config):
    """Save a tree with the port's jax_checkpoint in a worker, report it as
    the checkpoint, restore it on a restart."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import jax_checkpoint

    import torch

    ckpt = train.get_checkpoint()
    if ckpt is not None:
        tree = jax_checkpoint.restore_pytree(ckpt.path, device="cpu")
        train.report({"restored_step": int(tree["step"]), "w": tree["w"].tolist()})
        return
    d = tempfile.mkdtemp()
    jax_checkpoint.save_pytree(d, {"w": torch.arange(4.0), "step": 3})
    train.report({"saved": 1}, checkpoint=train.Checkpoint.from_directory(d))


# ---------------------------------------------------------------- test_train_torch.py's loops
def ddp_syncs_gradients(config):
    import torch as T
    from torch.utils.data import DataLoader, TensorDataset

    train = _train(config)
    T.manual_seed(0)  # same init everywhere; DDP keeps them in sync
    model = train.torch.prepare_model(T.nn.Linear(4, 1))
    is_ddp = isinstance(model, T.nn.parallel.DistributedDataParallel)

    rank = train.get_context().get_world_rank()
    g = T.Generator().manual_seed(42)
    X = T.randn(64, 4, generator=g)
    y = X @ T.tensor([[1.0], [-2.0], [3.0], [0.5]]) + 0.1
    loader = train.torch.prepare_data_loader(DataLoader(TensorDataset(X, y), batch_size=8))
    shard_rows = sum(len(b[0]) for b in loader)

    opt = T.optim.SGD(model.parameters(), lr=0.05)
    losses = []
    for _ in range(40):
        for xb, yb in loader:
            opt.zero_grad()
            loss = T.nn.functional.mse_loss(model(xb), yb)
            train.torch.backward(loss)
            opt.step()
        losses.append(float(loss))
    w = [p.detach().numpy().copy() for p in model.parameters()]
    out = {
        "rank": rank,
        "is_ddp": is_ddp,
        "shard_rows": shard_rows,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "losses": losses,
        "w0": float(np.asarray(w[0]).ravel()[0]),
        "weights": [x.ravel().tolist() for x in w],
    }
    # metrics_history carries rank 0's reports; per-rank facts go through a
    # shared scratch file (same-host test workers)
    with open(f"{config['out']}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    train.report({k: v for k, v in out.items() if k != "weights"})


def prepare_model_single(config):
    import torch as T

    train = _train(config)
    model = train.torch.prepare_model(T.nn.Linear(2, 1))
    train.report({"is_plain": not isinstance(model, T.nn.parallel.DistributedDataParallel)})


# ---------------------------------------------------------------- test_collective.py's actor
class Rank:
    """A rank of a collective group on package ``pkg``."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.rank = None

    def _col(self):
        return importlib.import_module(self.pkg + ".collective")

    def setup(self, world_size, rank, group):
        self._col().init_collective_group(world_size, rank, "object_store", group)
        self.rank = rank
        return rank

    def do_allreduce(self, group):
        return self._col().allreduce(np.full((4,), float(self.rank + 1)), group)

    def do_allgather(self, group):
        return self._col().allgather(np.array([self.rank]), group)

    def do_reducescatter(self, group):
        return self._col().reducescatter(np.arange(8, dtype=np.float64), group)

    def do_broadcast(self, group):
        return self._col().broadcast(np.array([42.0 if self.rank == 0 else 0.0]), src_rank=0, group_name=group)

    def do_sendrecv(self, group, n: int = 1):
        col = self._col()
        if self.rank == 0:
            col.send(np.full(n, 7.0), dst_rank=1, group_name=group)
            return None
        return col.recv(np.zeros(n), src_rank=0, group_name=group)

    def torch_allreduce(self, group, dtype: str):
        """A torch tensor in gives a torch tensor out, of its dtype."""
        import torch

        t = torch.full((3,), float(self.rank + 1), dtype=getattr(torch, dtype))
        out = self._col().allreduce(t, group)
        return type(out).__name__, str(out.dtype), out.float().tolist()


class TRank(Rank, CollectiveActorMixin):
    """A port rank that joins its group through the mixin's hook
    (``declare_collective_group``)."""

    def __rt_init_collective__(self, world_size, rank, backend, group_name):
        self.rank = super().__rt_init_collective__(world_size, rank, backend, group_name)
        return self.rank
