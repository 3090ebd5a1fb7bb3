"""Threefry-2x32 random numbers on torch tensors: the port's copy of what
ray_tpu takes from ``jax.random`` (``PRNGKey``, ``split``, the 32-bit
``random_bits``, ``uniform``, ``gumbel`` and ``categorical``), bit for bit.

A key is a pair of uint32 words, ``jax.random.key_data``'s layout, held
as an int64 tensor ``[..., 2]`` whose values stay below 2**32: every sum
is masked back to 32 bits, and shifts of values below 2**32 never reach
the sign bit. Leading dimensions are lanes, so one call draws for every
lane of a batch, as ray_tpu's ``vmap`` does. Everything is elementwise
tensor arithmetic with no host read, so the same code runs on the CPU and
inside a captured CUDA graph.

The bit layout follows JAX 0.9 with ``jax_threefry_partitionable`` on
(its default): a draw of shape S hashes the counters of a uint64 iota
over S, split into high and low words (``iota_2x32_shape``); ``split``
keeps both output words as the new keys (``_threefry_split_foldlike``);
32-bit ``random_bits`` are their XOR
(``_threefry_random_bits_partitionable``). ``uniform`` and ``gumbel``
follow ``jax/_src/random.py::_uniform`` and ``_gumbel`` (mode "low").
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000  # 1.0f: uniform randomises the mantissa of a float in [1, 2)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds, the key schedule injected every
    4): key words ``k1, k2`` and counter words ``x1, x2``, int64 tensors
    of uint32 values that broadcast together. Returns the two output
    words ``(y1, y2)``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data as an int64 ``[2]`` tensor.
    With 64-bit mode off (JAX's default) a Python seed is taken modulo
    2**32 and the high word is 0, so a negative seed wraps."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _hash(keys, shape: tuple):
    """Both threefry words over the counters of ``shape`` for every key:
    ``[..., *shape]`` each, where keys is ``[..., 2]``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    lead = keys.shape[:-1] + (1,) * len(shape)
    return threefry2x32(keys[..., 0].reshape(lead), keys[..., 1].reshape(lead), idx >> 32, idx & _M32)


def split(keys, num: int = 2):
    """``jax.random.split`` of every key: ``[..., 2]`` -> ``[..., num, 2]``."""
    y1, y2 = _hash(keys, (num,))
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys, shape: tuple):
    """32-bit ``jax.random.bits`` for every key: ``[..., *shape]`` int64
    values below 2**32."""
    y1, y2 = _hash(keys, tuple(shape))
    return y1 ^ y2


def uniform(keys, shape: tuple, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in f32 for every key: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval) and
    clamped below at minval. The bounds are rounded to f32 first, as JAX
    converts them. XLA contracts the scale and shift into one fused
    multiply-add, rounded once: here the product is exact in f64 and the
    sum is rounded to f32 from there: the same bits unless the f64 sum
    lands exactly halfway between two f32 values. At a span of 1 (JAX's
    default range and gumbel's) the product is exact in f32 as well."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    lo = float(lo)
    bits = (random_bits(keys, shape) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


def gumbel(keys, shape: tuple):
    """``jax.random.gumbel`` in f32, mode "low": ``-log(-log(u))`` with u
    uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, shape, _F32_TINY, 1.0)))


def categorical(keys, logits):
    """``jax.random.categorical`` over the last axis, one key per row:
    ``argmax(gumbel + logits)`` (keys ``[..., 2]``, logits ``[..., V]``
    f32; -inf logits are never drawn). Ties go to the first index, as
    jnp.argmax's."""
    return torch.argmax(gumbel(keys, logits.shape[-1:]) + logits, dim=-1)
