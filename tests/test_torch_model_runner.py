"""The serving forward passes against ray_tpu's on the same weights
(converted with ``params_from_jax``) and the same numpy-seeded inputs,
f32 on the CPU, atol 1e-4 (the same f32 arithmetic through a few layers,
in another summation order): batched prefill logits and K/V, the paged
decode step's and the prefix-cache extend's logits and pool (fp and int8
pools), the device-resident step (``paged_fused_step`` + ``append_paged``:
tokens equal, keys bit-equal, logprobs and pool within ATOL) chained over
steps with the lane deltas between them (``make_delta_fns``: the same
arrays as ray_tpu's scatters), and the training forward under every
``attention_impl``. The slot layout's forwards against ray_tpu's on f32
and int8 caches holding the same bytes: ``decode_step`` chained over
steps (an empty slot included), ``extend`` over a slot's prefix (a
clamped chunk included) then a decode step, and the device-resident
``fused_step`` with a lane delta between steps: logits within 1e-4 of
the largest logit, sampled tokens and new keys equal, the cache within
ATOL (int8 codes at most one step apart, see ``_close_pool``). Plus
the card's refusal of an ``attention_impl`` it has no kernel for, and the
bf16 weight round trip."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import kv_cache as jkvc  # noqa: E402
from ray_tpu.llm import model_runner as jmr  # noqa: E402
from ray_tpu.llm import paged_kv as jpkv  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.llm import kv_cache as tkvc  # noqa: E402
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


def _fused_setup(jp, tp, rng, B=3, max_pg=4, P=13):
    """Both pools with three prompts prefilled into their pages, and the
    device-resident lanes on both sides (ray_tpu's dtypes: int32 tables,
    lengths and tokens, uint32 keys)."""
    pcfg = dict(num_layers=JCFG.num_layers, num_pages=P, page_size=PAGE, max_pages_per_seq=max_pg, num_slots=B,
                num_kv_heads=JCFG.num_kv_heads, head_dim=JCFG.hd, dtype="float32")
    jpool = jpkv.alloc(jpkv.PagedCacheConfig(**pcfg))
    tpool = tpkv.alloc(tpkv.PagedCacheConfig(**pcfg), "cpu")
    tables = rng.permutation(np.arange(1, P))[: B * max_pg].reshape(B, max_pg).astype(np.int32)
    lens = np.array([5, PAGE, 2 * PAGE - 1], np.int32)[:B]
    toks = rng.integers(1, JCFG.vocab_size, size=(B, 2 * PAGE)).astype(np.int32)
    _, kj, vj = jmr.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), JCFG)
    _, kt, vt = tmr.prefill(tp, torch.from_numpy(toks.astype(np.int64)), torch.from_numpy(lens), TCFG)
    for b in range(B):
        row = tables[b, :2]
        jpool = jpkv.insert_pages(jpool, jnp.asarray(row), kj[:, b], vj[:, b])
        tpkv.insert_pages(tpool, torch.from_numpy(row), kt[:, b], vt[:, b])
    keys = np.stack([np.asarray(jax.random.PRNGKey(100 + b)) for b in range(B)])
    lanes = dict(tables=tables, lengths=lens, tokens=rng.integers(1, JCFG.vocab_size, size=B).astype(np.int32),
                 keys=keys, temps=np.array([0.0, 0.8, 1.3], np.float32)[:B], top_k=np.array([0, 5, 0], np.int32)[:B],
                 top_p=np.array([1.0, 1.0, 0.8], np.float32)[:B])
    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    wide = ("tokens", "keys", "top_k")  # int64 in the port
    tl = {k: torch.from_numpy(v.astype(np.int64) if k in wide else v.copy()) for k, v in lanes.items()}
    return jpool, tpool, jl, tl


ORDER = ("tables", "lengths", "tokens", "keys", "temps", "top_k", "top_p")


def test_fused_step_and_deltas_match_jax(params):
    """Three device-resident steps on both sides, with a lane delta (a
    seeded admission into slot 1), a table delta (slot 2's row and length
    moved) and a table-cell delta (a grown page) between them: the 11
    outputs of ``paged_fused_step``, the pool after ``append_paged`` and
    the delta functions' arrays agree with ray_tpu's, every key advancing
    every step."""
    jp, tp = params
    rng = np.random.default_rng(7)
    jpool, tpool, jl, tl = _fused_setup(jp, tp, rng)
    attn_fn, append_fn = tmr.make_fused_paged_fns(TCFG, "torch")
    j_attn, j_append = jmr.make_fused_paged_fns(JCFG)
    j_lane, j_table, j_cell = jmr.make_delta_fns()
    t_lane, t_table, t_cell = tmr.make_delta_fns()
    for step in range(3):
        jo = j_attn(jp, jpool, *(jl[k] for k in ORDER))
        to = attn_fn(tp, tpool, *(tl[k] for k in ORDER))
        assert len(to) == len(jo) == 11
        np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))  # tokens
        _close(to[1], jo[1])  # logprobs
        np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]).astype(np.int64))  # keys
        for t, j in zip(to[3:5], jo[3:5]):  # k_new, v_new
            _close(t, j)
        for t, j in zip(to[5:], jo[5:]):  # write targets, lengths + 1, the passed-through sampling lanes
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert not (to[2] == tl["keys"]).all(dim=-1).any()
        jpool = j_append(jpool, *jo[5:7], *jo[3:5])
        append_fn(tpool, *to[5:7], *to[3:5])
        _close_pool(tpool, jpool, "float32")
        jl.update(tokens=jo[0], keys=jo[2], lengths=jo[7], temps=jo[8], top_k=jo[9], top_p=jo[10])  # donated lanes
        tl["tokens"].copy_(to[0])
        tl["keys"].copy_(to[2])
        tl["lengths"].copy_(to[7])
        if step == 0:  # a seeded stochastic request bound into slot 1
            key = np.asarray(jax.random.PRNGKey(77))
            names = ("tokens", "keys", "temps", "top_k", "top_p")
            jout = j_lane(*(jl[k] for k in names), np.int32(1), np.int32(9), key, np.float32(0.7), np.int32(0),
                          np.float32(0.9))
            tout = t_lane(*(tl[k] for k in names), 1, 9, key.tolist(), 0.7, 0, 0.9)
            jl.update(zip(names, jout))
            assert all(t is tl[k] for t, k in zip(tout, names))  # in place
        elif step == 1:  # slot 2 moved to other pages at another length, then a grown page
            row = np.array([11, 12, 0, 0], np.int32)
            jl["tables"], jl["lengths"] = j_table(jl["tables"], jl["lengths"], np.int32(2), jnp.asarray(row),
                                                  np.int32(20))
            t_table(tl["tables"], tl["lengths"], 2, torch.from_numpy(row), 20)
            jl["tables"] = j_cell(jl["tables"], np.int32(2), np.int32(2), np.int32(10))
            t_cell(tl["tables"], 2, 2, 10)
        for k in ORDER:
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]).astype(tl[k].numpy().dtype))


def test_fused_fns_refuse_the_other_device(params):
    _, tp = params
    with pytest.raises(ValueError, match="attn_impl"):
        tmr.make_fused_paged_fns(TCFG, "xla")
    attn_fn, _ = tmr.make_fused_paged_fns(TCFG, "cuda")
    with pytest.raises(ValueError, match="cpu"):
        attn_fn(tp, {}, torch.zeros(1, 1, dtype=torch.int32), *([None] * 6))


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


SLOT_S = 96  # the slot caches' rows
LOGIT_RTOL = 1e-4  # relative to the largest |logit|: the same f32 arithmetic in another summation order


def _close_logits(t, j):
    j = np.asarray(j)
    assert np.abs(t.numpy() - j).max() <= LOGIT_RTOL * np.abs(j).max()


def _slot_caches(jp, cache_dtype, rng, lens, T=32):
    """Both slot caches with one prompt per slot prefilled by ray_tpu and
    inserted on both sides (the same bytes, so an int8 cache starts
    byte-identical); a length-0 slot stays empty."""
    ccfg = dict(num_layers=JCFG.num_layers, num_slots=len(lens), max_seq_len=SLOT_S,
                num_kv_heads=JCFG.num_kv_heads, head_dim=JCFG.hd, dtype=cache_dtype)
    jc = jkvc.alloc(jkvc.CacheConfig(**ccfg))
    tc = tkvc.alloc(tkvc.CacheConfig(**ccfg), "cpu")
    toks = rng.integers(1, JCFG.vocab_size, size=(len(lens), T)).astype(np.int32)
    _, kj, vj = jmr.prefill(jp, jnp.asarray(toks), jnp.asarray(np.maximum(lens, 1), jnp.int32), JCFG)
    for b, n in enumerate(lens):
        if n:
            jc = jkvc.insert_sequence(jc, b, kj[:, b], vj[:, b], int(n))
            tkvc.insert_sequence(tc, b, torch.from_numpy(np.asarray(kj[:, b])), torch.from_numpy(np.asarray(vj[:, b])),
                                 int(n))
    return jc, tc


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_decode_step_matches_jax(params, cache_dtype):
    """Three slot decode steps fed the same tokens, over three prompts and
    an empty slot: logits, the whole cache (each step's appended token
    included) and the length lane agree after every step."""
    jp, tp = params
    rng = np.random.default_rng(12)
    lens = np.array([5, 16, 0, 31], np.int32)
    jc, tc = _slot_caches(jp, cache_dtype, rng, lens)
    for _ in range(3):
        nxt = rng.integers(1, JCFG.vocab_size, size=len(lens)).astype(np.int32)
        lj, jc = jmr.decode_step(jp, jc, jnp.asarray(nxt), JCFG)
        lt, out = tmr.decode_step(tp, tc, torch.from_numpy(nxt.astype(np.int64)), TCFG)
        assert out is tc and lt.dtype == torch.float32
        _close_logits(lt, lj)
        _close_pool(tc, jc, cache_dtype)
        lens += 1
        assert tc["length"].tolist() == lens.tolist()


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("n_p,T,length", [(32, 16, 11), (16, 32, 32), (0, 16, 5), (80, 32, 10)],
                         ids=["prefix32_T16", "prefix16_T32", "no_prefix", "clamped"])
def test_extend_matches_jax(params, cache_dtype, n_p, T, length):
    """A prefix of n_p positions in slot 1, then the suffix (a T-token
    bucket, ``length`` real) extended over it: the logits at the last real
    token, the whole cache and the slot's new length agree with
    ``jmr.extend`` (the last case's chunk passes the row's end, so ray_tpu
    clamps its write: the port clamps the same way); then a decode step over
    both slots agrees too."""
    jp, tp = params
    rng = np.random.default_rng(n_p + T)
    jc, tc = _slot_caches(jp, cache_dtype, rng, np.array([9, n_p], np.int32), T=max(n_p, 16))
    toks = np.zeros(T, np.int32)
    toks[:length] = rng.integers(1, JCFG.vocab_size, size=length)
    lj, jc = jmr.extend(jp, jc, 1, jnp.asarray(toks), jnp.asarray(length, jnp.int32), JCFG)
    lt, out = tmr.extend(tp, tc, 1, torch.from_numpy(toks.astype(np.int64)), length, TCFG)
    assert out is tc and tuple(lt.shape) == (JCFG.vocab_size,)
    _close_logits(lt, lj)
    _close_pool(tc, jc, cache_dtype)
    assert tc["length"].tolist() == [9, n_p + length]
    nxt = np.array([3, 7], np.int32)
    lj, jc = jmr.decode_step(jp, jc, jnp.asarray(nxt), JCFG)
    lt, _ = tmr.decode_step(tp, tc, torch.from_numpy(nxt.astype(np.int64)), TCFG)
    _close_logits(lt, lj)


SLOT_LANES = ("tokens", "keys", "temps", "top_k", "top_p")


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_slot_fused_step_and_lane_delta_match_jax(params, cache_dtype):
    """Three device-resident slot steps (``make_fused_fns``) on both sides,
    mixed greedy and stochastic lanes, with a seeded admission's lane delta
    after the first: ray_tpu's 7 outputs agree (tokens and keys equal,
    every key advancing; logprobs within ATOL; the sampling lanes passed
    through), and so do the cache and its length lane."""
    jp, tp = params
    rng = np.random.default_rng(8)
    lens = np.array([5, 16, 31], np.int32)
    jc, tc = _slot_caches(jp, cache_dtype, rng, lens)
    keys = np.stack([np.asarray(jax.random.PRNGKey(100 + b)) for b in range(3)])
    lanes = dict(tokens=rng.integers(1, JCFG.vocab_size, size=3).astype(np.int32), keys=keys,
                 temps=np.array([0.0, 0.8, 1.3], np.float32), top_k=np.array([0, 5, 0], np.int32),
                 top_p=np.array([1.0, 1.0, 0.8], np.float32))
    jl = {k: jnp.asarray(v) for k, v in lanes.items()}
    tl = {k: torch.from_numpy(v.astype(np.int64) if k in ("tokens", "keys", "top_k") else v.copy())
          for k, v in lanes.items()}
    step = tmr.make_fused_fns(TCFG)
    for i in range(3):
        jo = jmr.fused_step(jp, jc, *(jl[k] for k in SLOT_LANES), JCFG)
        to = step(tp, tc, *(tl[k] for k in SLOT_LANES))
        assert len(to) == len(jo) == 7 and to[0] is tc
        jc = jo[0]
        np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1]))  # tokens
        _close(to[2], jo[2])  # logprobs
        np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]).astype(np.int64))  # keys
        assert not (to[3] == tl["keys"]).all(dim=-1).any()
        for t, j in zip(to[4:], jo[4:]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        _close_pool(tc, jc, cache_dtype)
        lens += 1
        assert tc["length"].tolist() == lens.tolist()
        jl.update(tokens=jo[1], keys=jo[3])
        tl["tokens"].copy_(to[1])
        tl["keys"].copy_(to[3])
        if i == 0:  # a seeded stochastic request bound into slot 1
            key = np.asarray(jax.random.PRNGKey(77))
            jout = jmr.set_lane(*(jl[k] for k in SLOT_LANES), np.int32(1), np.int32(9), key, np.float32(0.7),
                                np.int32(0), np.float32(0.9))
            jl.update(zip(SLOT_LANES, jout))
            tmr.set_lane(*(tl[k] for k in SLOT_LANES), 1, 9, key.tolist(), 0.7, 0, 0.9)
        for k in SLOT_LANES:
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]).astype(tl[k].numpy().dtype))


def test_make_fused_fns_refuses_a_mesh():
    """A mesh with axes besides tp is not ported; a pure tp mesh needs the
    rank's group (tests/test_torch_engine_tp.py runs it)."""
    from ray_tpu_torch.parallel.mesh import create_mesh

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmr.make_fused_fns(TCFG, mesh=create_mesh(dp=2, tp=2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="group"):
        tmr.make_fused_fns(TCFG, mesh=create_mesh(tp=2, devices=["cpu"] * 2))


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
