"""Learner and LearnerGroup (port of ray_tpu/rllib/core/learner.py).

A Learner owns an RLModule and its ``torch.optim.Adam`` (optax's adam
defaults: betas (0.9, 0.999), eps 1e-8) and runs minibatch SGD;
``compute_losses(batch)`` is the per-algorithm override point. Gradient
clipping is optax's ``clip_by_global_norm``: every gradient scaled by
``min(1, clip / global_norm)`` (not ``clip_grad_norm_``'s
``clip / (norm + 1e-6)``), on the device with no host sync.

The learner runs on the card unless the config says ``device="cpu"``
(``AlgorithmConfig.learners(device=...)``, the one argument the port
adds; ray_tpu's learner follows JAX's default device). With
``num_learners >= 1`` the learners are the runtime's actors (they ask for
no card and run on it all the same, from workers not bound to it); every
learner takes an equal shard of the batch (padded by wrap-around) and
their gradients are averaged through the port's collective API (the
``"object_store"`` backend) before each step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import collective


def host_state(module) -> dict:
    """The module's state dict as host tensors (weight sync, checkpoints)."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def read_once(scalars: dict, *vectors) -> tuple[dict, list]:
    """Scalar metrics (0-d tensors) and vectors from the learner's device
    in one copy, so an update syncs the card once: ({name: float}, [numpy
    float32 vector, ...])."""
    names = list(scalars)
    parts = [torch.stack([scalars[k].detach().float().reshape(()) for k in names])]
    parts += [v.detach().float().reshape(-1) for v in vectors]
    host = torch.cat(parts).cpu().numpy()
    out, off = [], len(names)
    for v in vectors:
        out.append(host[off : off + v.numel()])
        off += v.numel()
    return {k: float(x) for k, x in zip(names, host)}, out


def _to_device(state, device):
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, dict):
        return {k: _to_device(v, device) for k, v in state.items()}
    if isinstance(state, list):
        return [_to_device(v, device) for v in state]
    return state


class Learner:
    def __init__(self, module_spec, config):
        from ray_tpu_torch.llm.engine import resolve_device

        self.config = config
        self.device = resolve_device(config.device)
        self.module = module_spec.build()
        self.optimizer = None
        self._group_name = None
        self._metrics: dict = {}
        self.sync_ms: list[float] = []  # each allreduce's wall (learner actors)

    # -- construction --
    def build(self, seed: int = 0):
        self.module.init(seed)
        self.module.to(self.device)
        self.optimizer = torch.optim.Adam(self.module.parameters(), lr=self.config.lr)

    # -- per-algorithm override --
    def compute_losses(self, batch) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    # -- gradient sync (learner actors in a collective group) --
    def setup_collective(self, world_size: int, rank: int, group_name: str):
        self._group_name = group_name
        collective.init_collective_group(world_size, rank, group_name=group_name)

    def _sync_grads(self, grads: list[torch.Tensor]):
        if self._group_name is None:
            return
        t0 = time.perf_counter()
        flat = torch.cat([g.reshape(-1) for g in grads])
        out = collective.allreduce(flat, group_name=self._group_name)
        out = out / collective.get_world_size(self._group_name)
        self.sync_ms.append((time.perf_counter() - t0) * 1e3)
        offset = 0
        for g in grads:
            g.copy_(out[offset : offset + g.numel()].view_as(g))
            offset += g.numel()

    def _clip(self, grads: list[torch.Tensor]):
        clip = getattr(self.config, "grad_clip", None)
        if not clip:
            return
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        torch._foreach_mul_(grads, torch.clamp(clip / norm, max=1.0))

    def apply_gradients_step(self, mb: dict) -> dict:
        """One minibatch: loss, gradients, their sync and clip, Adam."""
        self.optimizer.zero_grad(set_to_none=False)
        loss, aux = self.compute_losses(mb)
        loss.backward()
        grads = [p.grad for p in self.module.parameters()]
        self._sync_grads(grads)
        self._clip(grads)
        self.optimizer.step()
        return aux

    def _device_batch(self, batch: dict) -> dict:
        """A sampled batch's columns on the learner's device (the replay
        buffer's ``batch_indices`` stay on the host)."""
        return self._minibatch({k: v for k, v in batch.items() if k != "batch_indices"}, slice(None))

    def _minibatch(self, batch: dict, rows) -> dict:
        return {k: torch.as_tensor(np.ascontiguousarray(v[rows])).to(self.device, non_blocking=True)
                for k, v in batch.items() if hasattr(v, "__getitem__")}

    # -- update loop --
    def update(self, batch: dict, minibatch_size: int | None = None, num_epochs: int = 1, shuffle: bool = True,
               seed: int = 0) -> dict:
        """Minibatch SGD over ``batch`` (a dict of row-major numpy arrays);
        returns the averaged loss metrics (read from the device once)."""
        n = len(batch["obs"])
        minibatch_size = minibatch_size or n
        rng = np.random.default_rng(seed)
        acc: dict[str, list] = {}
        for _ in range(num_epochs):
            idx = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n, minibatch_size):
                rows = idx[start : start + minibatch_size]
                if len(rows) < max(2, minibatch_size // 2) and start > 0:
                    continue  # drop a tiny trailing minibatch
                aux = self.apply_gradients_step(self._minibatch(batch, rows))
                for k, v in aux.items():
                    acc.setdefault(k, []).append(v.detach().float())
        self._metrics = {k: float(np.mean(torch.stack(v).double().cpu().numpy())) for k, v in acc.items()}
        return self._metrics

    # -- state / weights --
    def get_weights(self) -> dict:
        return host_state(self.module)

    def set_weights(self, weights: dict):
        self.module.load_state_dict(weights)

    def get_state(self) -> dict:
        return {"params": host_state(self.module), "opt_state": _to_device(self.optimizer.state_dict(), "cpu")}

    def set_state(self, state: dict):
        self.module.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])


class LearnerActor:
    """A learner in its own worker (``LearnerGroup`` with
    ``num_learners >= 1``): the learner class travels as an argument, so
    one module-level actor class serves every algorithm. One intra-op
    thread, as a remote env runner: learners and runners share a host,
    and several default thread pools spin against each other."""

    def __init__(self, learner_cls, module_spec, config):
        torch.set_num_threads(1)
        self.learner = learner_cls(module_spec, config)

    def build(self, seed: int = 0):
        self.learner.build(seed)
        return str(self.learner.device)

    def setup_collective(self, world_size: int, rank: int, group_name: str):
        self.learner.setup_collective(world_size, rank, group_name)

    def update(self, batch: dict, **kw) -> dict:
        return self.learner.update(batch, **kw)

    def get_weights(self) -> dict:
        return self.learner.get_weights()

    def get_state(self) -> dict:
        return self.learner.get_state()

    def set_state(self, state: dict):
        self.learner.set_state(state)

    def devices(self) -> list[str]:
        return sorted({str(p.device) for p in self.learner.module.parameters()})

    def sync_ms(self) -> list[float]:
        return list(self.learner.sync_ms)


class LearnerGroup:
    """0 remote learners -> one Learner in process; N >= 1 -> N learner
    actors, each update's rows sharded across them, gradients allreduced."""

    def __init__(self, learner_cls, module_spec, config, num_learners: int = 0):
        self.num_learners = num_learners
        self._actors = []
        self._local = None
        if num_learners == 0:
            self._local = learner_cls(module_spec, config)
            self._local.build(seed=config.seed)
            return
        actor_cls = ray_tpu_torch.remote(LearnerActor)
        self._actors = [actor_cls.remote(learner_cls, module_spec, config) for _ in range(num_learners)]
        ray_tpu_torch.get([a.build.remote(seed=config.seed) for a in self._actors])
        group = f"rllib_learners_{id(self)}"
        ray_tpu_torch.get([a.setup_collective.remote(num_learners, i, group) for i, a in enumerate(self._actors)])
        # the same seed on every learner: a synced start

    def update(self, batch: dict, **kw) -> list[dict]:
        if self._local is not None:
            return [self._local.update(batch, **kw)]
        n = len(batch["obs"])
        k = len(self._actors)
        if n < k:
            raise ValueError(f"batch of {n} rows cannot be sharded across {k} learners")
        # every learner MUST take a shard of one size: the per-minibatch
        # allreduce is a blocking collective, so unequal step counts would
        # deadlock the group. Pad with wrap-around rows (a few duplicates,
        # no drops) rather than dropping the n % k remainder.
        shard = -(-n // k)
        if shard * k > n:
            pad = np.arange(shard * k - n) % n
            batch = {key: np.concatenate([v, v[pad]], axis=0) for key, v in batch.items()}
        refs = [a.update.remote({key: v[i * shard : (i + 1) * shard] for key, v in batch.items()}, **kw)
                for i, a in enumerate(self._actors)]
        return ray_tpu_torch.get(refs)

    def get_weights(self) -> dict:
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    def get_state(self) -> dict:
        if self._local is not None:
            return self._local.get_state()
        return ray_tpu_torch.get(self._actors[0].get_state.remote())

    def set_state(self, state: dict):
        if self._local is not None:
            self._local.set_state(state)
        else:
            ray_tpu_torch.get([a.set_state.remote(state) for a in self._actors])

    def stop(self):
        for a in self._actors:
            ray_tpu_torch.kill(a)
        self._actors = []
