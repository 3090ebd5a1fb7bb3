"""RLModule: the model abstraction (port of
ray_tpu/rllib/core/rl_module.py) as a ``torch.nn.Module``.

ray_tpu's module is stateless (``init(key)`` returns a parameter pytree,
``forward(params, obs)`` is pure); the port's holds its parameters, and
``init(seed)`` redraws them from a seed. The state dict's keys are the
pytree's paths (``pi.0.w``), so ``params_from_jax`` turns ray_tpu's
params into this module's state and both compute the same function.
``forward_inference``/``_exploration``/``_train`` are the three passes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.core.distributions import Categorical, DiagGaussian


def _space_size(space) -> int:
    if hasattr(space, "n"):  # Discrete
        return int(space.n)
    return int(np.prod(space.shape))


@dataclass
class RLModuleSpec:
    """Serializable recipe for building a module on any worker."""

    module_class: type | None = None
    observation_space: Any = None
    action_space: Any = None
    model_config: dict = field(default_factory=dict)

    def build(self) -> "RLModule":
        cls = self.module_class or MLPModule
        return cls(self.observation_space, self.action_space, self.model_config)


class RLModule(nn.Module):
    """Base: subclasses define ``init(seed)`` and ``forward(obs)`` ->
    {"action_dist_inputs", "vf"}; the distribution class follows the
    action space."""

    def __init__(self, observation_space, action_space, model_config: dict | None = None):
        super().__init__()
        self.observation_space = observation_space
        self.action_space = action_space
        self.model_config = dict(model_config or {})
        self.action_dist_cls = Categorical if hasattr(action_space, "n") else DiagGaussian

    def init(self, seed: int = 0) -> "RLModule":
        raise NotImplementedError

    def forward_inference(self, obs) -> dict:
        return self(obs)

    def forward_exploration(self, obs) -> dict:
        return self(obs)

    def forward_train(self, batch) -> dict:
        return self(batch["obs"])

    def spec(self) -> RLModuleSpec:
        return RLModuleSpec(type(self), self.observation_space, self.action_space, self.model_config)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` [in, out], ray_tpu's layout."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x):
        return x @ self.w + self.b


class Tower(nn.ModuleList):
    """An MLP as a list of ``Dense`` layers, tanh between them (its state
    dict keys are the list's, ``0.w``); a module of its own, so
    ``torch.func.functional_call`` can run it on other parameters."""

    @classmethod
    def of(cls, sizes) -> "Tower":
        """Layers of ``sizes[0] -> sizes[1] -> ...``."""
        return cls(Dense(i, o) for i, o in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        return MLPModule._mlp_apply(self, x)


def orthogonal(gen: torch.Generator, n: int) -> torch.Tensor:
    """A random n x n orthogonal matrix (QR of a gaussian, signs fixed by
    R's diagonal), as ``jax.random.orthogonal`` draws it."""
    q, r = torch.linalg.qr(torch.randn(n, n, generator=gen))
    return q * torch.sign(torch.diagonal(r))[None, :]


class MLPModule(RLModule):
    """Separate policy and value MLP towers with tanh activations, the
    reference catalog's fcnet (``fcnet_hiddens`` defaults to (256, 256));
    orthogonal init, the towers' last layers scaled 0.01 (pi) and 1.0
    (vf). Subclasses with other towers override ``_make_towers`` and
    ``init``."""

    def __init__(self, observation_space, action_space, model_config=None):
        super().__init__(observation_space, action_space, model_config)
        self.hiddens = tuple(self.model_config.get("fcnet_hiddens", (256, 256)))
        self.obs_dim = _space_size(observation_space)
        self.out_dim = int(action_space.n) if hasattr(action_space, "n") else 2 * int(np.prod(action_space.shape))
        self._make_towers()
        self.init(0)

    def _make_towers(self):
        self.pi = Tower.of((self.obs_dim, *self.hiddens, self.out_dim))
        self.vf = Tower.of((self.obs_dim, *self.hiddens, 1))

    @staticmethod
    @torch.no_grad()
    def _init_tower(tower, gen, final_scale):
        for i, layer in enumerate(tower):
            fan_in, fan_out = layer.w.shape
            scale = final_scale if i == len(tower) - 1 else 1.0
            layer.w.copy_(orthogonal(gen, max(fan_in, fan_out))[:fan_in, :fan_out] * scale)
            layer.b.zero_()

    def init(self, seed: int = 0) -> "MLPModule":
        gen = torch.Generator().manual_seed(seed)
        self._init_tower(self.pi, gen, 0.01)
        self._init_tower(self.vf, gen, 1.0)
        return self

    @staticmethod
    def _mlp_apply(layers, x):
        for layer in layers[:-1]:
            x = torch.tanh(layer(x))
        return layers[-1](x)

    def forward(self, obs):
        obs = obs.reshape(obs.shape[0], -1).float()
        return {"action_dist_inputs": self._mlp_apply(self.pi, obs), "vf": self._mlp_apply(self.vf, obs)[..., 0]}


def flatten_params(tree, prefix: str = "") -> dict:
    """A nested dict/list parameter tree as {"a.0.w": leaf}: the keys of
    the matching module's state dict."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def params_from_jax(tree, device="cpu") -> dict:
    """A module's state dict from ray_tpu's RLlib params (nested dicts and
    lists of arrays, as numpy): float32 tensors on ``device`` under the
    pytree's paths. ``module.load_state_dict(params_from_jax(p))``. It
    serves every module of the port: ``MLPModule``'s ``{"pi", "vf"}``,
    ``QModule``'s ``{"q"}``, ``SACModule``'s ``{"pi", "q1", "q2",
    "log_alpha"}`` (a scalar leaf: a 0-d tensor) and SAC's ``target_q``
    ``{"q1", "q2"}``, and a gradient tree as well as a parameter tree."""
    return {k: torch.as_tensor(np.array(v, dtype=np.float32), device=device) for k, v in flatten_params(tree).items()}
