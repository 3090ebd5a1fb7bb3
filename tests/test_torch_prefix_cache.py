"""Prefix caching on the port's paged engine against ray_tpu's: the
content-stable keys byte for byte, the cache's byte accounting, and greedy
streams token-identical to ray_tpu's engine with
``enable_prefix_caching=True`` (``kv_layout="paged"``,
``telemetry=False``), each decode mode against the same mode
(``device_resident`` True, the default, and False), with equal
``prefix_cache_stats()`` and preemption counts, in five schedules: hits
after a leader, a hit on a shorter prefix than the stored pad width,
same-wave followers (they miss; a blocked one re-resolves when the store
generation moves), eviction under a small byte budget, and preemption."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm.kvplane import index as jindex  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.llm.engine import PrefixCache  # noqa: E402
from ray_tpu_torch.llm.kvplane import index as tindex  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side of these tiny models runs on one intra-op thread:
    beside other test workers, torch's thread pool spins against the XLA
    runtime's and a schedule takes ~10x longer; the arithmetic is the same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 300])
def test_prefix_keys_are_byte_identical_to_ray_tpu(n):
    ids = [int(t) for t in np.random.default_rng(n).integers(0, 128256, size=n)]
    buf = tindex.token_bytes(ids)
    assert buf == jindex.token_bytes(ids) and len(buf) == 4 * n
    assert tindex.stable_hash(ids) == jindex.stable_hash(ids) == tindex.stable_hash(buf)
    for k in sorted({0, n // 2, n}):
        assert tindex.prefix_key(buf, k) == jindex.prefix_key(buf, k)
    assert (tindex._SALT, tindex._TOKEN_BYTES) == (jindex._SALT, jindex._TOKEN_BYTES)


def test_store_holds_contiguous_copies_and_counts_their_bytes():
    """A stored group is a contiguous copy of the first ``pad`` positions,
    not a view that keeps the whole batched prefill output alive: the
    cache's bytes equal its tensors' storage bytes, and LRU eviction under
    the budget frees them."""
    L, Bp, T, kv, hd = 2, 4, 128, 2, 8
    ks, vs = torch.randn(L, Bp, T, kv, hd), torch.randn(L, Bp, T, kv, hd)
    one = 2 * L * 64 * kv * hd * 4  # k + v of a group padded to the 64 bucket
    cache = PrefixCache(block=32, max_bytes=2 * one)
    prompts = [list(range(100 * i + 1, 100 * i + 71)) for i in range(3)]  # 70 tokens: boundaries 32, 64
    for i, prompt in enumerate(prompts):
        assert cache.store(prompt, ks[:, i], vs[:, i], (64, 128)) == 64
        held = [t for g in cache._groups.values() for t in g[:2]]
        assert all(t.is_contiguous() and t.untyped_storage().nbytes() == t.numel() * 4 for t in held)
        assert all(t.untyped_storage().data_ptr() != ks.untyped_storage().data_ptr() for t in held)
        assert cache.stats()["bytes"] == sum(t.untyped_storage().nbytes() for t in held) == min(i + 1, 2) * one
    assert cache.store(prompts[2], ks[:, 3], vs[:, 3], (64, 128)) is None  # every boundary cached already
    assert cache.stats() == dict(hits=0, misses=0, tokens_saved=0, evictions=1, entries=2, bytes=2 * one)
    assert cache.lookup(prompts[0]) is None  # evicted
    k, v, n = cache.lookup(prompts[1][:64] + [7])
    assert n == 64 and torch.equal(k, ks[:, 1, :64]) and torch.equal(v, vs[:, 1, :64])
    assert cache.lookup(prompts[2][:40])[2] == 32  # the longest boundary strictly inside the prompt
    assert (cache.hits, cache.misses, cache.tokens_saved) == (2, 1, 64 + 32)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _synced(fn):
    """One ray_tpu program with its inputs and outputs settled (ray_tpu's
    paged engine is nondeterministic on the XLA CPU runtime otherwise:
    ROADMAP.md, queue 3)."""

    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


def _toks(rng, n):
    return [int(t) for t in rng.integers(1, 500, size=n)]


def _scenario(name):
    """(engine arguments, waves of prompts run by successive generate()
    calls, max_tokens, expected prefix_cache_stats() counters)."""
    rng = np.random.default_rng(11)
    if name == "hits":  # a leader, then three followers on its 64-token prefix
        pre = _toks(rng, 64)
        sched = dict(max_num_seqs=4, max_seq_len=256, page_size=16, prefix_block=32)
        return sched, [[pre + _toks(rng, 36)], [pre + _toks(rng, n) for n in (5, 40, 70)]], 8, (3, 1, 0)
    if name == "shorter_prefix":  # stored at pad 256 (a 200-token prompt), hit at its first 64 tokens
        long = _toks(rng, 200)
        sched = dict(max_num_seqs=2, max_seq_len=256, page_size=64, prefix_block=64)
        return sched, [[long], [long[:64] + [3, 2, 1]]], 6, (1, 1, 0)
    if name == "same_wave":
        # one wave: the leader and the second miss (looked up before any
        # prefill ran); the third misses, blocks on pages, re-resolves once
        # the leader's store moves the generation and hits; the fourth hits
        pre = _toks(rng, 64)
        sched = dict(max_num_seqs=4, max_seq_len=256, page_size=16, prefix_block=32, num_pages=24)
        return sched, [[pre + _toks(rng, n) for n in (60, 10, 30, 3)]], 8, (2, 3, 0)
    if name == "eviction":  # a budget of one group: b evicts a, b's follower hits, a's misses and evicts b
        a, b = _toks(rng, 70), _toks(rng, 70)
        sched = dict(max_num_seqs=2, max_seq_len=256, page_size=16, prefix_block=32, prefix_cache_bytes=70000)
        return sched, [[a], [b], [b[:64] + [7]], [a[:64] + [5, 6]]], 6, (1, 3, 2)
    # preemption: 7 pages; hits admit with 3 pages each and grow to 4; preempted
    # requests re-admit through a plain prefill (their prompt holds generated tokens)
    pre = _toks(rng, 16)
    sched = dict(max_num_seqs=3, max_seq_len=128, page_size=16, prefill_buckets=(16, 32, 64, 128), num_pages=8,
                 prefix_block=16)
    return sched, [[pre + _toks(rng, 4)], [pre + _toks(rng, n) for n in (8, 2, 12, 1, 6)]], 40, (5, 1, 0)


@pytest.mark.parametrize("device_resident", [True, False], ids=["device_resident", "sync"])
@pytest.mark.parametrize("name", ["hits", "shorter_prefix", "same_wave", "eviction", "preemption"])
def test_prefix_cached_generation_token_identical_to_ray_tpu(params, name, device_resident):
    jp, tp = params
    sched, waves, max_tokens, (hits, misses, evictions) = _scenario(name)
    je = JaxEngine(jllama.LlamaConfig.tiny(**KW), jp, kv_layout="paged", enable_prefix_caching=True,
                   device_resident=device_resident, telemetry=False, seed=5, **sched)
    for fn in ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_attn", "_fused_append", "_set_lane",
               "_set_table", "_set_table_cell"):
        if hasattr(je, fn):
            setattr(je, fn, _synced(getattr(je, fn)))
    # caching on by default
    te = LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", kv_layout="paged", seed=5,
                   device_resident=device_resident, **sched)
    ref = [je.generate(w, JaxParams(max_tokens=max_tokens)) for w in waves]
    out = [te.generate(w, SamplingParams(max_tokens=max_tokens)) for w in waves]
    assert [[o.token_ids for o in w] for w in out] == [[o.token_ids for o in w] for w in ref]
    assert all(len(o.token_ids) == max_tokens for w in out for o in w)
    stats = te.prefix_cache_stats()
    assert stats == je.prefix_cache_stats()
    assert (stats["hits"], stats["misses"], stats["evictions"]) == (hits, misses, evictions)
    assert te.extend_forwards == hits and te.preemption_count == je.preemption_count
    assert (te.preemption_count > 0) == (name == "preemption")
    assert te.kv_cache_stats()["pages_free"] == te.kv_cache_stats()["pages_total"]


def test_prefix_caching_defaults_and_validation(params):
    _, tp = params
    cfg = tllama.LlamaConfig.tiny(**KW)
    te = LLMEngine(cfg, tp, device="cpu", max_num_seqs=1, max_seq_len=128)
    assert te._prefix_cache is not None and (te._prefix_cache.block, te._prefix_cache.max_bytes) == (64, 256 << 20)
    assert te.prefix_cache_stats()["local"] == {"hits": 0, "tokens_saved": 0}
    assert LLMEngine(cfg, tp, device="cpu", max_num_seqs=1, enable_prefix_caching=False).prefix_cache_stats() == {}
    with pytest.raises(ValueError, match="prefix_block"):
        LLMEngine(cfg, tp, device="cpu", kv_layout="paged", max_num_seqs=1, page_size=64, prefix_block=96)


def test_hit_streams_equal_the_uncached_engine(params):
    """A hit computes the same function as a full prefill: in f32 on the
    host, the cached engine's greedy streams equal a caching-off engine's
    on the same prompts (a leader, then followers of 1-100 suffix tokens
    over its 128-token prefix, hit at the longest 64-block boundary)."""
    _, tp = params
    rng = np.random.default_rng(4)
    pre = _toks(rng, 128)
    prompts = [pre + _toks(rng, n) for n in (1, 30, 64, 100)]
    sched = dict(max_num_seqs=4, max_seq_len=256, kv_layout="paged", page_size=16, seed=5)
    cfg = tllama.LlamaConfig.tiny(**KW)
    cached = LLMEngine(cfg, tp, device="cpu", **sched)
    leader = cached.generate(pre + _toks(rng, 20), SamplingParams(max_tokens=6))
    hits = cached.generate(prompts, SamplingParams(max_tokens=8))
    plain = LLMEngine(cfg, tp, device="cpu", enable_prefix_caching=False, **sched).generate(
        prompts, SamplingParams(max_tokens=8))
    assert len(leader.token_ids) == 6 and cached.extend_forwards == 4
    assert cached.prefix_cache_stats()["tokens_saved"] == 4 * 128
    assert [o.token_ids for o in hits] == [o.token_ids for o in plain]
