"""The training step (port of ray_tpu/parallel/train_step.py, one device).

``make_train_step(loss_fn, tx)`` returns ``(init_fn, step_fn)``:

- ``init_fn(rng, init_params_fn)`` -> ``TrainState`` on the device, with
  the optimizer built over its parameters;
- ``step_fn(state, batch)`` -> ``(state, {"loss", "grad_norm", "step"})``:
  value and gradient of ``loss_fn``, the optimizer update, the global
  gradient norm, step + 1 (``train_step``).

Where the port differs from JAX:

- ``tx`` is a factory, ``list of parameter tensors -> torch.optim.Optimizer``;
  ``adamw`` mirrors ``optax.adamw``'s arguments and defaults.
- The step updates the parameters and the optimizer state in place, where
  the JAX step donates its state and returns new arrays: the state it
  returns is the one it was given, its step advanced. After a step every
  parameter's ``.grad`` holds that step's gradient, until the next step
  clears it before its forward.
- One device: a mesh or sharding rules raise ``NotImplementedError``
  (ROADMAP.md, queue 1, multi-device axes). Logical ``param_axes`` are
  accepted and checked against the parameter tree; on one device they
  shard nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ray_tpu_torch.llm.engine import resolve_device


@dataclass
class TrainState:
    step: int
    params: dict
    opt_state: torch.optim.Optimizer  # holds the moments; updates params in place


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for sub in tree.values() for leaf in tree_leaves(sub)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _structure(tree):
    return {k: _structure(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Callable:
    """``optax.adamw`` as an optimizer factory (decoupled weight decay;
    the moments take the parameters' dtype, as optax's do by default)."""

    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)

    return make


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32 (``optax.global_norm``)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def train_step(state: TrainState, batch, *, loss_fn: Callable):
    """One optimizer step, in place (see the module docstring)."""
    params = tree_leaves(state.params)
    state.opt_state.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, batch)
    loss.backward()
    for p in params:
        if p.grad is None:  # a leaf the loss does not read: JAX's gradient is zeros
            p.grad = torch.zeros_like(p)
    gnorm = global_norm([p.grad for p in params])
    state.opt_state.step()
    state.step += 1
    return state, {"loss": loss.detach(), "grad_norm": gnorm, "step": state.step}


def make_train_step(loss_fn: Callable, tx: Callable, mesh=None, param_axes=None, rules=None, device=None):
    """Returns ``(init_fn, step_fn)`` for ``loss_fn(params, batch)`` and the
    optimizer factory ``tx``. ``device=None`` means the card, and raises
    when there is none; pass ``device="cpu"`` to train on the host."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "meshes and sharding rules are not ported to ray_tpu_torch yet (ROADMAP.md, queue 1, multi-device axes)")
    device = resolve_device(device)

    def init_fn(rng, init_params_fn) -> TrainState:
        """rng: an int seed or a ``torch.Generator`` on the device;
        ``init_params_fn(generator)`` returns the parameter tree, whose
        leaves become the trained tensors (moved to the device, not copied
        when they are there already)."""
        gen = rng if isinstance(rng, torch.Generator) else torch.Generator(device=device).manual_seed(int(rng))
        params = _tree_map(lambda t: t.detach().to(device).requires_grad_(True), init_params_fn(gen))
        if param_axes is not None and _structure(param_axes) != _structure(params):
            raise ValueError("param_axes does not have the parameter tree's structure")
        return TrainState(step=0, params=params, opt_state=tx(tree_leaves(params)))

    def step_fn(state: TrainState, batch):
        return train_step(state, batch, loss_fn=loss_fn)

    return init_fn, step_fn


def to_device(batch: dict, device=None) -> dict:
    """A host batch (numpy arrays or tensors) on the device (``shard_batch``
    on one device). Integer arrays become int64, the index type torch
    gathers with."""
    device = resolve_device(device)

    def one(x):
        t = torch.as_tensor(x)
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        return t.to(device)

    return {k: one(v) for k, v in batch.items()}
