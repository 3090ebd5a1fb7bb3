"""The slot KV cache (``ray_tpu_torch/llm/kv_cache.py``) against
ray_tpu/llm/kv_cache.py on the same numpy-seeded inputs, f32 and bf16 on
the CPU: ``alloc``'s tensors; ``insert_sequence`` in its four dtype
directions (fp into fp, fp into int8, int8 with its wire scales into
int8, int8 into fp); ``append_token_layer``/``append_scale_layer`` at
every slot, an empty one and one past the row's end (clamped) included;
``extract_sequence``; ``free_slot``. Every comparison is exact: the same
inputs through the same arithmetic, so int8 values and scales are
byte-identical and fp values identical (the port writes in place, JAX
returns new arrays)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import kv_cache as jkvc  # noqa: E402
from ray_tpu.llm import kv_quant as jkvq  # noqa: E402
from ray_tpu_torch.llm import kv_cache as tkvc  # noqa: E402

L, B, S, KV, HD, T = 2, 3, 48, 2, 16, 32
DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfg(dtype):
    return dict(num_layers=L, num_slots=B, max_seq_len=S, num_kv_heads=KV, head_dim=HD, dtype=dtype)


def _same(t, j):
    """Exact equality, dtype included (bf16 compared as its bits)."""
    j = np.asarray(j)
    if t.dtype == torch.bfloat16:
        assert j.dtype == jnp.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
    else:
        assert t.numpy().dtype == j.dtype, (t.dtype, j.dtype)
        np.testing.assert_array_equal(t.numpy(), j)


def _same_cache(tc, jc):
    assert set(tc) == set(jc)
    for name in tc:
        _same(tc[name], jc[name])


def _block(rng, dtype="float32"):
    """A prefilled sequence's K/V [L, T, kv, hd] on both sides (the same values)."""
    jdt, tdt = DTYPES[dtype]
    k, v = (rng.standard_normal((L, T, KV, HD)).astype(np.float32) * 3 for _ in range(2))
    return (jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt)), (torch.from_numpy(k).to(tdt),
                                                                          torch.from_numpy(v).to(tdt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_alloc_matches_jax(dtype):
    jc = jkvc.alloc(jkvc.CacheConfig(**_cfg(dtype)))
    tc = tkvc.alloc(tkvc.CacheConfig(**_cfg(dtype)), "cpu")
    _same_cache(tc, jc)
    if dtype == "int8":
        assert tuple(tc["k_scale"].shape) == (L, B, KV, S)  # the position axis last


@pytest.mark.parametrize("block,cache", [("float32", "float32"), ("bfloat16", "int8"), ("int8", "int8"),
                                         ("int8", "float32")],
                         ids=["fp_into_fp", "fp_into_int8", "int8_into_int8", "int8_into_fp"])
def test_insert_sequence_matches_jax_in_every_dtype_direction(block, cache):
    """Two slots filled, one of them twice (a recycled slot): the whole
    cache equal after each insert. An int8 block is ray_tpu's quantized
    prefill with its scales in the wire layout [L, kv, T]."""
    rng = np.random.default_rng(0)
    jc = jkvc.alloc(jkvc.CacheConfig(**_cfg(cache)))
    tc = tkvc.alloc(tkvc.CacheConfig(**_cfg(cache)), "cpu")
    for slot, n in ((2, 20), (0, 32), (2, 7)):
        (jk, jv), (tk, tv) = _block(rng, "float32" if block == "int8" else block)
        jsc = tsc = ()
        if block == "int8":
            (jk, sk), (jv, sv) = jkvq.quantize_heads(jk), jkvq.quantize_heads(jv)
            jsc = (sk.transpose(0, 2, 1), sv.transpose(0, 2, 1))
            tk, tv = torch.from_numpy(np.asarray(jk)), torch.from_numpy(np.asarray(jv))
            tsc = tuple(torch.from_numpy(np.asarray(s)) for s in jsc)
        jc = jkvc.insert_sequence(jc, slot, jk, jv, n, *jsc)
        assert tkvc.insert_sequence(tc, slot, tk, tv, n, *tsc) is tc
        _same_cache(tc, jc)
    assert tc["length"].tolist() == [32, 0, 7]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_append_token_and_scale_layer_match_jax(dtype):
    """One token per slot at its length: a slot mid-row, an empty slot
    (written at position 0, as ray_tpu does) and one past the row's end
    (clamped to S - 1), twice in a row."""
    rng = np.random.default_rng(1)
    jc = jkvc.alloc(jkvc.CacheConfig(**_cfg(dtype)))
    tc = tkvc.alloc(tkvc.CacheConfig(**_cfg(dtype)), "cpu")
    lengths = np.array([5, 0, S + 3], np.int32)
    for _ in range(2):
        k_t, v_t = (rng.standard_normal((B, KV, HD)).astype(np.float32) for _ in range(2))
        if dtype == "int8":
            (k_t, sk), (v_t, sv) = jkvq.quantize_heads(jnp.asarray(k_t)), jkvq.quantize_heads(jnp.asarray(v_t))
            for name, s in (("k_scale", sk), ("v_scale", sv)):
                j = jkvc.append_scale_layer(jc[name][1], s, jnp.asarray(lengths))
                jc[name] = jc[name].at[1].set(j)
                out = tkvc.append_scale_layer(tc[name][1], torch.from_numpy(np.asarray(s)), torch.from_numpy(lengths))
                assert out.data_ptr() == tc[name][1].data_ptr()  # in place
        jk, jv = jkvc.append_token_layer(jc["k"][1], jc["v"][1], jnp.asarray(k_t), jnp.asarray(v_t),
                                         jnp.asarray(lengths))
        jc["k"], jc["v"] = jc["k"].at[1].set(jk), jc["v"].at[1].set(jv)
        tkvc.append_token_layer(tc["k"][1], tc["v"][1], torch.from_numpy(np.asarray(k_t)),
                                torch.from_numpy(np.asarray(v_t)), torch.from_numpy(lengths))
        _same_cache(tc, jc)
        lengths += 1
    assert (tc["k"][1, 1, 2:] == 0).all() and (tc["k"][1, 2, S - 1] != 0).any()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_extract_sequence_and_free_slot_match_jax(dtype):
    """extract_sequence is insert_sequence's inverse (values and the wire
    scales), returns copies, and free_slot empties only its slot."""
    rng = np.random.default_rng(2)
    jc = jkvc.alloc(jkvc.CacheConfig(**_cfg(dtype)))
    tc = tkvc.alloc(tkvc.CacheConfig(**_cfg(dtype)), "cpu")
    for slot, n in ((1, 30), (2, 9)):
        (jk, jv), (tk, tv) = _block(rng)
        jc = jkvc.insert_sequence(jc, slot, jk, jv, n)
        tkvc.insert_sequence(tc, slot, tk, tv, n)
    for Tx in (16, T):
        jout = jkvc.extract_sequence(jc, 1, Tx)
        tout = tkvc.extract_sequence(tc, 1, Tx)
        assert len(tout) == len(jout) == (4 if dtype == "int8" else 2)
        for t, j in zip(tout, jout):
            _same(t, j)
        tout[0].zero_()  # a copy, not a view of the cache
        _same(tc["k"], jc["k"])
    jc = jkvc.free_slot(jc, 1)
    assert tkvc.free_slot(tc, 1) is tc
    _same_cache(tc, jc)
    assert tc["length"].tolist() == [0, 0, 9]
