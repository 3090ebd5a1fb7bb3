"""ray_tpu_torch.llm.prng against jax.random (JAX on the CPU, threefry2x32
with ``jax_threefry_partitionable`` on, JAX's default): the threefry hash,
``PRNGKey``'s key data, ``split``, 32-bit ``bits`` and ``uniform``
bit-identical over 16 keys; ``gumbel`` within 2 ulp at the scale of
max(|g|, 1) (each of its two logs is within one ulp of XLA's: an ulp of
the inner log moves the result by at most 2^-23 in absolute terms, the
outer log's by one ulp of the result); ``categorical`` token-identical."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from jax._src import prng as jprng  # noqa: E402  (the threefry primitive itself)

from ray_tpu_torch.llm import prng  # noqa: E402

SEEDS = [0, 7, 2**31 - 1, -1, -123456, 2**32 + 5, 1, 2, 3, 42, 1000, 31337, 65535, 99991, 2**20, 123456789]


def _jkeys():
    return np.stack([np.asarray(jax.random.PRNGKey(s)) for s in SEEDS])


def _tkeys():
    return torch.stack([prng.prng_key(s) for s in SEEDS])


def test_jax_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable and jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    key = prng.prng_key(seed)
    assert key.dtype == torch.int64 and key.tolist() == np.asarray(jax.random.PRNGKey(seed)).astype(np.int64).tolist()


@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_threefry2x32_bit_identical(n):
    rng = np.random.default_rng(n)
    k = rng.integers(0, 2**32, size=(2, len(SEEDS)), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, size=(2, len(SEEDS), n), dtype=np.uint64).astype(np.uint32)
    want = jprng.threefry2x32_p.bind(jnp.asarray(k[0][:, None].repeat(n, 1)), jnp.asarray(k[1][:, None].repeat(n, 1)),
                                     jnp.asarray(x[0]), jnp.asarray(x[1]))
    got = prng.threefry2x32(*(torch.from_numpy(a.astype(np.int64)) for a in (k[0][:, None], k[1][:, None], x[0], x[1])))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("num", [2, 3])
def test_split_bit_identical(num):
    want = np.stack([np.asarray(jax.random.split(jnp.asarray(k), num)) for k in _jkeys()])
    got = prng.split(_tkeys(), num)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # one key alone, and a chain of splits, as the engine advances a lane
    k, kt = jax.random.PRNGKey(5), prng.prng_key(5)
    for _ in range(4):
        k = jax.random.split(k)[1]
        kt = prng.split(kt)[1]
    np.testing.assert_array_equal(kt.numpy(), np.asarray(k).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (513,), (4, 33)])
def test_random_bits_and_uniform_bit_identical(shape):
    keys = _tkeys()
    bits = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), shape, jnp.uint32)) for k in _jkeys()])
    np.testing.assert_array_equal(prng.random_bits(keys, shape).numpy(), bits.astype(np.int64))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-2.5, 3.0)):
        want = np.stack([np.asarray(jax.random.uniform(jnp.asarray(k), shape, minval=lo, maxval=hi))
                         for k in _jkeys()])
        got = prng.uniform(keys, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gumbel_within_two_ulp():
    want = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (5000,))) for k in _jkeys()])
    got = prng.gumbel(_tkeys(), (5000,)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    ulps = np.abs(got - want) / np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert ulps.max() <= 2
    # the two logs, stage by stage on the same inputs: one ulp each
    u = prng.uniform(_tkeys(), (5000,), float(np.finfo(np.float32).tiny), 1.0)
    for x in (u, -torch.log(u)):
        d = torch.log(x).numpy().view(np.int32).astype(np.int64) - np.asarray(jnp.log(x.numpy())).view(np.int32)
        assert np.abs(d).max() <= 1


@pytest.mark.parametrize("V", [17, 512])
def test_categorical_token_identical(V):
    lg = np.random.default_rng(V).standard_normal((len(SEEDS), V)).astype(np.float32) * 2
    lg[::3, : V // 2] = -np.inf  # filtered tokens are never drawn
    want = np.array([int(jax.random.categorical(jnp.asarray(k), jnp.asarray(row))) for k, row in zip(_jkeys(), lg)])
    got = prng.categorical(_tkeys(), torch.from_numpy(lg)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[::3] >= V // 2).all()
