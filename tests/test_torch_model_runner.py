"""The serving forward passes against ray_tpu's on the same weights
(converted with ``params_from_jax``) and the same numpy-seeded inputs,
f32 on the CPU, atol 1e-4 (the same f32 arithmetic through a few layers,
in another summation order): batched prefill logits and K/V, the paged
decode step's and the prefix-cache extend's logits and pool (fp and int8
pools), and the training forward under every ``attention_impl``. Plus
the card's refusal of an ``attention_impl`` it has no kernel for, and the
bf16 weight round trip."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import model_runner as jmr  # noqa: E402
from ray_tpu.llm import paged_kv as jpkv  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.llm import model_runner as tmr  # noqa: E402
from ray_tpu_torch.llm import paged_kv as tpkv  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

ATOL = 1e-4
KW = dict(dtype="float32", remat=False, max_seq_len=256)
JCFG = jllama.LlamaConfig.tiny(**KW)
TCFG = tllama.LlamaConfig.tiny(**KW)
PAGE = 16


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_prefill_logits_and_kv_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(0)
    toks = rng.integers(1, JCFG.vocab_size, size=(4, 32)).astype(np.int32)
    lens = np.array([32, 1, 17, 5], np.int32)
    lj, kj, vj = jmr.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), JCFG)
    lt, kt, vt = tmr.prefill(tp, torch.from_numpy(toks.astype(np.int64)), torch.from_numpy(lens), TCFG)
    assert lt.dtype == torch.float32 and tuple(kt.shape) == tuple(kj.shape)
    _close(lt, lj)
    _close(kt, kj)
    _close(vt, vj)


def test_llama_forward_matches_jax(params):
    jp, tp = params
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size, size=(2, 40)).astype(np.int32)
    _close(tllama.forward(tp, torch.from_numpy(toks.astype(np.int64)), TCFG),
           jllama.forward(jp, jnp.asarray(toks), JCFG))


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla", "other"])
def test_llama_forward_matches_jax_under_every_attention_impl(params, impl):
    """On the host every ``attention_impl`` runs the plain attention: ray_tpu's
    "xla" numbers (its "pallas" has only an interpret mode off the TPU, and
    an unknown value takes its "auto" path, XLA off the TPU)."""
    jp, tp = params
    toks = np.random.default_rng(1).integers(0, JCFG.vocab_size, size=(2, 40)).astype(np.int32)
    cfg = dataclasses.replace(TCFG, attention_impl=impl)
    _close(tllama.forward(tp, torch.from_numpy(toks.astype(np.int64)), cfg),
           jllama.forward(jp, jnp.asarray(toks), dataclasses.replace(JCFG, attention_impl="xla")))
    lt, _, _ = tmr.prefill(tp, torch.from_numpy(toks.astype(np.int64)), torch.tensor([40, 7]), cfg)
    lj, _, _ = jmr.prefill(jp, jnp.asarray(toks), jnp.asarray([40, 7], jnp.int32), JCFG)
    _close(lt, lj)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla", "other"])
def test_card_refuses_an_attention_impl_without_a_kernel(impl):
    """The field is honoured or refused, never dropped: on the card only
    "auto"/"pallas" (K1-K3) run; anything else raises naming the field,
    K1's head dims and ROADMAP.md. The host never refuses."""
    cfg = dataclasses.replace(TCFG, attention_impl=impl)
    tllama.check_attention_impl(cfg, "cpu")
    if impl in ("auto", "pallas"):
        tllama.check_attention_impl(cfg, torch.device("cuda"))
        return
    with pytest.raises(ValueError, match=r"attention_impl=.*head_dim 64 or 128.*ROADMAP"):
        tllama.check_attention_impl(cfg, torch.device("cuda"))


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_decode_step_paged_matches_jax(params, cache_dtype):
    """Prefill three prompts into their pages on both sides, then three
    paged decode steps fed the same tokens: logits and the whole pool
    (the appended K/V included) agree after every step."""
    jp, tp = params
    rng = np.random.default_rng(2)
    B, T, max_pg, P = 3, 32, 4, 13
    pcfg = dict(num_layers=JCFG.num_layers, num_pages=P, page_size=PAGE, max_pages_per_seq=max_pg,
                num_slots=B, num_kv_heads=JCFG.num_kv_heads, head_dim=JCFG.hd, dtype=cache_dtype)
    jpool = jpkv.alloc(jpkv.PagedCacheConfig(**pcfg))
    tpool = tpkv.alloc(tpkv.PagedCacheConfig(**pcfg), "cpu")
    tables = rng.permutation(np.arange(1, P))[: B * max_pg].reshape(B, max_pg).astype(np.int32)
    lens = np.array([5, PAGE, 2 * PAGE - 1], np.int32)
    toks = rng.integers(1, JCFG.vocab_size, size=(B, T)).astype(np.int32)
    _, kj, vj = jmr.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), JCFG)
    _, kt, vt = tmr.prefill(tp, torch.from_numpy(toks.astype(np.int64)), torch.from_numpy(lens), TCFG)
    for b in range(B):
        row = tables[b, : T // PAGE]
        jpool = jpkv.insert_pages(jpool, jnp.asarray(row), kj[:, b], vj[:, b])
        tpkv.insert_pages(tpool, torch.from_numpy(row), kt[:, b], vt[:, b])
    lengths = lens.copy()
    for step in range(3):
        nxt = rng.integers(1, JCFG.vocab_size, size=B).astype(np.int32)
        lj, jpool, _ = jmr.decode_step_paged(jp, jpool, jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(nxt), JCFG)
        lt, tpool, _ = tmr.decode_step_paged(tp, tpool, torch.from_numpy(tables), torch.from_numpy(lengths),
                                             torch.from_numpy(nxt.astype(np.int64)), TCFG)
        _close(lt, lj)
        for name in tpool:
            if cache_dtype == "int8" and name in ("k", "v"):
                # an int8 code may round one step apart where the f32 K/V
                # differ by ~1e-6 at an exact half; the dequantized value
                # then moves by one scale step, never more
                diff = np.abs(tpool[name].numpy().astype(np.int32) - np.asarray(jpool[name]).astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                _close(tpool[name], jpool[name])
        lengths += 1


def _extend_setup(jp, tp, cache_dtype, rng, n_p, max_pg=8, P=12):
    """Both pools with a prompt's first n_p positions inserted in its pages."""
    pcfg = dict(num_layers=JCFG.num_layers, num_pages=P, page_size=PAGE, max_pages_per_seq=max_pg,
                num_slots=1, num_kv_heads=JCFG.num_kv_heads, head_dim=JCFG.hd, dtype=cache_dtype)
    jpool = jpkv.alloc(jpkv.PagedCacheConfig(**pcfg))
    tpool = tpkv.alloc(tpkv.PagedCacheConfig(**pcfg), "cpu")
    row = rng.permutation(np.arange(1, P))[:max_pg].astype(np.int32)
    if n_p:
        toks = rng.integers(1, JCFG.vocab_size, size=(1, n_p)).astype(np.int32)
        _, kj, vj = jmr.prefill(jp, jnp.asarray(toks), jnp.asarray([n_p], jnp.int32), JCFG)
        _, kt, vt = tmr.prefill(tp, torch.from_numpy(toks.astype(np.int64)), torch.tensor([n_p]), TCFG)
        jpool = jpkv.insert_pages(jpool, jnp.asarray(row[: n_p // PAGE]), kj[:, 0], vj[:, 0])
        tpkv.insert_pages(tpool, torch.from_numpy(row[: n_p // PAGE]), kt[:, 0], vt[:, 0])
    return jpool, tpool, row


def _close_pool(tpool, jpool, cache_dtype):
    for name in tpool:
        if cache_dtype == "int8" and name in ("k", "v"):
            # an int8 code may round one step apart where the f32 K/V differ
            # by ~1e-6 at an exact half (as in the decode test)
            diff = np.abs(tpool[name].numpy().astype(np.int32) - np.asarray(jpool[name]).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            _close(tpool[name], jpool[name])


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_p,T,length", [(32, 16, 11), (16, 32, 32), (0, 16, 5)])
def test_extend_paged_matches_jax(params, cache_dtype, n_p, T, length):
    """A prefix of n_p positions in the pool, then the suffix (a T-token
    bucket, ``length`` real) extended over it: the logits at the last real
    token and the whole pool after the chunk's append agree with
    ``jmr.extend_paged``; then a decode step over the extended sequence
    agrees too, so the appended chunk is where decode reads it."""
    jp, tp = params
    rng = np.random.default_rng(n_p + T)
    jpool, tpool, row = _extend_setup(jp, tp, cache_dtype, rng, n_p)
    toks = np.zeros(T, np.int32)
    toks[:length] = rng.integers(1, JCFG.vocab_size, size=length)
    lj, jpool = jmr.extend_paged(jp, jpool, jnp.asarray(row), n_p, jnp.asarray(toks), length, JCFG)
    lt, tpool = tmr.extend_paged(tp, tpool, torch.from_numpy(row), n_p, torch.from_numpy(toks.astype(np.int64)),
                                 length, TCFG)
    assert tuple(lt.shape) == (JCFG.vocab_size,) and lt.dtype == torch.float32
    _close(lt, lj)
    _close_pool(tpool, jpool, cache_dtype)
    n, nxt = n_p + length, np.array([7], np.int32)
    lj, _, _ = jmr.decode_step_paged(jp, jpool, jnp.asarray(row[None]), jnp.asarray([n], jnp.int32), jnp.asarray(nxt),
                                     JCFG)
    lt, _, _ = tmr.decode_step_paged(tp, tpool, torch.from_numpy(row[None]), torch.tensor([n], dtype=torch.int32),
                                     torch.from_numpy(nxt.astype(np.int64)), TCFG)
    _close(lt, lj)


def test_extend_write_targets_match_jax():
    row = np.array([3, 4, 5, 0], np.int32)
    for start, T in ((0, 16), (17, 32), (40, 32)):
        wj = jmr.extend_write_targets(jnp.asarray(row), start, T, PAGE)
        wt = tmr.extend_write_targets(torch.from_numpy(row), start, T, PAGE)
        for a, b in zip(wt, wj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_decode_write_targets_match_jax():
    tables = np.array([[3, 4, 5], [6, 0, 0], [0, 0, 0]], np.int32)
    lengths = np.array([17, 15, 100], np.int32)
    wj = jmr.decode_write_targets(jnp.asarray(tables), jnp.asarray(lengths), PAGE)
    wt = tmr.decode_write_targets(torch.from_numpy(tables), torch.from_numpy(lengths), PAGE)
    for a, b in zip(wt, wj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bf16_weights_round_trip_bit_exact():
    cfg = jllama.LlamaConfig.tiny(dtype="bfloat16")
    jp = jllama.init_params(cfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(leaf).view(np.int16))
    assert set(tp["layers"]) == set(tllama.PARAM_AXES["layers"])
