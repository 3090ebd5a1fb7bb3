"""Connector pipelines: composable env<->module transforms (port of
ray_tpu/rllib/connectors/connector.py; numpy, as there).

A connector is a picklable callable over numpy batches on the CPU
rollout path: env-to-module pipelines run on the stacked obs batch right
before the module's forward, module-to-env pipelines on the sampled
action batch right before ``env.step``. Stateful connectors
(NormalizeObs) carry their state on the instance; it ships with the
runner (each remote runner keeps its own running statistics).
"""

from __future__ import annotations

import numpy as np


class ConnectorV2:
    """Base: __call__(batch, **ctx) -> batch. ``ctx`` carries optional
    keywords (module, spaces) that concrete connectors may use."""

    def __call__(self, batch, **ctx):
        raise NotImplementedError

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict):
        pass


class ConnectorPipeline(ConnectorV2):
    """Ordered composition (reference: ConnectorPipelineV2 with
    insert/append/prepend editing)."""

    def __init__(self, *connectors: ConnectorV2):
        self.connectors = list(connectors)

    def __call__(self, batch, **ctx):
        for c in self.connectors:
            batch = c(batch, **ctx)
        return batch

    def append(self, connector: ConnectorV2) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def remove(self, connector_cls: type) -> bool:
        for i, c in enumerate(self.connectors):
            if isinstance(c, connector_cls):
                del self.connectors[i]
                return True
        return False

    def get_state(self) -> dict:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict):
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


# ---------------------------------------------------------------- env->module


class FlattenObs(ConnectorV2):
    """[B, *obs_shape] -> [B, prod(obs_shape)]."""

    def __call__(self, batch, **ctx):
        batch = np.asarray(batch)
        return batch.reshape(batch.shape[0], -1)


class CastToFloat32(ConnectorV2):
    def __call__(self, batch, **ctx):
        return np.asarray(batch, dtype=np.float32)


class NormalizeObs(ConnectorV2):
    """Running mean/std normalization (reference: MeanStdFilter connector).
    Welford-updated on every batch seen during exploration."""

    def __init__(self, clip: float = 10.0, update: bool = True):
        self.clip = clip
        self.update = update
        self.count = 0.0
        self.mean = None
        self.m2 = None

    def __call__(self, batch, **ctx):
        x = np.asarray(batch, dtype=np.float64)
        flat = x.reshape(x.shape[0], -1)
        if self.mean is None:
            self.mean = np.zeros(flat.shape[1])
            self.m2 = np.ones(flat.shape[1])
        if self.update:
            for row in flat:
                self.count += 1.0
                delta = row - self.mean
                self.mean += delta / self.count
                self.m2 += delta * (row - self.mean)
        std = np.sqrt(self.m2 / max(self.count, 1.0)) + 1e-8
        out = np.clip((flat - self.mean) / std, -self.clip, self.clip)
        return out.reshape(x.shape).astype(np.float32)

    def get_state(self) -> dict:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    def set_state(self, state: dict):
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]


# ---------------------------------------------------------------- module->env


class ClipActions(ConnectorV2):
    """Clip continuous actions into the env's bounds (reference:
    clip_actions connector piece)."""

    def __init__(self, low=None, high=None):
        self.low = low
        self.high = high

    def __call__(self, batch, **ctx):
        low, high = self.low, self.high
        if low is None and "action_space" in ctx:
            low, high = ctx["action_space"].low, ctx["action_space"].high
        return np.clip(np.asarray(batch), low, high)


class RescaleActions(ConnectorV2):
    """Map module actions in [-1, 1] to the env's [low, high]
    (reference: unsquash_actions)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, dtype=np.float32)
        self.high = np.asarray(high, dtype=np.float32)

    def __call__(self, batch, **ctx):
        a = np.asarray(batch, dtype=np.float32)
        return self.low + (np.clip(a, -1.0, 1.0) + 1.0) * 0.5 * (self.high - self.low)
