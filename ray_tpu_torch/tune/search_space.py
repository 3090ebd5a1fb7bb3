"""Search space primitives (port of ray_tpu/tune/search_space.py): the
domains, ``grid_search``, ``sample_from``, ``expand_grid`` and ``resolve``,
drawing from numpy's ``Generator`` exactly as ray_tpu's do.

A ``sample_from`` function goes into the experiment's snapshot (stdlib
pickle), so it must be a module-level function: ``Tuner.fit()`` raises
TypeError for a lambda or a closure before any trial starts.
"""

from __future__ import annotations

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(0, len(self.categories)))]


class Float(Domain):
    def __init__(self, lower, upper, log=False, q=None):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.lower), np.log(self.upper))))
        else:
            v = float(rng.uniform(self.lower, self.upper))
        if self.q:
            v = round(v / self.q) * self.q
        return v


class Integer(Domain):
    def __init__(self, lower, upper, log=False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            return int(np.exp(rng.uniform(np.log(self.lower), np.log(self.upper))))
        return int(rng.integers(self.lower, self.upper))


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


class Normal(Domain):
    def __init__(self, mean=0.0, sd=1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return float(rng.normal(self.mean, self.sd))


class SampleFrom(Domain):
    """fn(config_so_far) — called with the partially resolved config
    (reference: tune.sample_from receives the spec)."""

    def __init__(self, fn):
        self.fn = fn

    def sample(self, rng, config=None):
        return self.fn(config)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(lower, upper) -> Float:
    return Float(lower, upper)


def quniform(lower, upper, q) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower, upper) -> Float:
    return Float(lower, upper, log=True)


def randint(lower, upper) -> Integer:
    return Integer(lower, upper)


def lograndint(lower, upper) -> Integer:
    return Integer(lower, upper, log=True)


def randn(mean=0.0, sd=1.0) -> Normal:
    return Normal(mean, sd)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def sample_from(fn) -> SampleFrom:
    return SampleFrom(fn)


def expand_grid(space: dict) -> list[dict]:
    """Cartesian product over grid_search entries; other keys pass through."""
    import itertools

    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    if not grid_keys:
        return [dict(space)]
    combos = itertools.product(*[space[k].values for k in grid_keys])
    out = []
    for combo in combos:
        d = dict(space)
        for k, v in zip(grid_keys, combo):
            d[k] = v
        out.append(d)
    return out


def resolve(space: dict, rng: np.random.Generator) -> dict:
    """Sample every Domain leaf; pass literals through. SampleFrom leaves
    see the config resolved so far (declaration order)."""
    out = {}
    for k, v in space.items():
        if isinstance(v, SampleFrom):
            out[k] = v.sample(rng, out)
        elif isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, dict):
            out[k] = resolve(v, rng)
        elif isinstance(v, GridSearch):
            raise ValueError("grid_search must be expanded before resolve()")
        else:
            out[k] = v
    return out
