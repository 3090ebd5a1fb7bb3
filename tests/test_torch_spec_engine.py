"""The port's speculative engine (``speculative=SpecConfig(...)``) against
ray_tpu's speculative engine and against the port's own plain engine, the
oracles of ray_tpu's tests/test_llm_spec.py on port vs ray_tpu: greedy
streams token-identical for both drafters (prompt-lookup n-grams; a model
drafter sharing the target's weights; a smaller model drafter of its own)
on both KV layouts under staggered admissions with an abort, paged
recompute-preemption (8 pages), stop tokens and prefix hits, the int8
cache, seeded streams, ``spec_stats`` (rounds, lane rounds, proposed,
accepted, emitted) equal to ray_tpu's, adaptive k walking down as
ray_tpu's does, the capped trailing round and the configuration errors.

ray_tpu's engines run with every program settled (``_synced``): its paged
engine is nondeterministic on the XLA CPU runtime otherwise (ROADMAP.md,
queue 3), and the spec programs and the drafter's are settled too."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import SpecConfig as JaxSpec  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams, SpecConfig  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
JCFG, TCFG = jllama.LlamaConfig.tiny(**KW), tllama.LlamaConfig.tiny(**KW)
SMALL = dict(num_layers=1, hidden_size=64, intermediate_size=128, num_heads=2, num_kv_heads=1)  # a drafter of its own
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell", "_verify_step", "_verify_attn", "_verify_append", "_set_hist",
           "_set_slot_scalar")
DRAFTER_SETTLED = ("_propose", "_prefill", "_insert", "_draft")
STATS = ("rounds", "lane_rounds", "proposed", "accepted", "emitted")
LAYOUTS = pytest.mark.parametrize("layout", ["slots", "paged"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's tiny models (beside other test
    workers, torch's pool spins against the XLA runtime's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    jd = jllama.init_params(jllama.LlamaConfig.tiny(**KW, **SMALL), jax.random.PRNGKey(1))
    to_t = lambda p: params_from_jax(jax.tree.map(np.asarray, p), "cpu")  # noqa: E731
    return jp, to_t(jp), jd, to_t(jd)


def _synced(fn):
    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


def _specs(params, drafter, k=3, **kw):
    """(ray_tpu's SpecConfig, the port's) for one drafter choice."""
    jp, tp, jd, td = params
    if drafter == "ngram":
        return JaxSpec(drafter="ngram", k=k, **kw), SpecConfig(drafter="ngram", k=k, **kw)
    if drafter == "model":  # weight sharing: the target accepts nearly every proposal
        return (JaxSpec(drafter="model", k=k, draft_config=JCFG, draft_params=jp, **kw),
                SpecConfig(drafter="model", k=k, draft_config=TCFG, draft_params=tp, **kw))
    return (JaxSpec(drafter="model", k=k, draft_config=jllama.LlamaConfig.tiny(**KW, **SMALL), draft_params=jd, **kw),
            SpecConfig(drafter="model", k=k, draft_config=tllama.LlamaConfig.tiny(**KW, **SMALL), draft_params=td, **kw))


def _engines(params, spec_pair, **kw):
    """ray_tpu's engine (programs settled, telemetry off) and the port's,
    same arguments; ``spec_pair`` None for plain engines."""
    jp, tp = params[:2]
    je = JaxEngine(JCFG, jp, telemetry=False, speculative=spec_pair and spec_pair[0], **kw)
    for name in SETTLED:
        if hasattr(je, name):
            setattr(je, name, _synced(getattr(je, name)))
    drafter = getattr(je, "_drafter", None)
    for name in DRAFTER_SETTLED:
        if drafter is not None and hasattr(drafter, name):
            setattr(drafter, name, _synced(getattr(drafter, name)))
    te = LLMEngine(TCFG, tp, device="cpu", speculative=spec_pair and spec_pair[1], **kw)
    return je, te


def _drive(eng, params_cls, sched, aborts=None, max_steps=900, on_step=None):
    """Step an engine over a step-indexed admission (and abort) schedule:
    ({request_id: token_ids}, {request_id: finish_reason})."""
    finals, reasons, ids = {}, {}, []
    t = 0
    while t <= max(sched) or eng.has_unfinished():
        for prompt, sp in sched.get(t, []):
            ids.append(eng.add_request(prompt, params_cls(**sp)))
        if aborts and t in aborts:
            eng.abort_request(ids[aborts[t]])
        for o in eng.step():
            if o.finished:
                finals[o.request_id] = o.token_ids
                reasons[o.request_id] = o.finish_reason
        if on_step is not None:
            on_step(eng)
        t += 1
        assert t < max_steps, "schedule never converged"
    return finals, reasons


def _mixed_schedule(n=6, seed=0, seeded=False):
    """ray_tpu's test_llm_spec mixed schedule: prompts of 4-60 tokens,
    3-12 new tokens, arriving over 8 steps; ``seeded`` makes every other
    request stochastic (seeded, one seedless, top-k / top-p < 1)."""
    rng = np.random.default_rng(seed)
    sched = {}
    for i in range(n):
        prompt = [int(t) for t in rng.integers(1, 500, size=int(rng.integers(4, 60)))]
        sp = dict(max_tokens=int(rng.integers(3, 13)), temperature=0.0)
        if seeded and i % 2:
            sp.update(temperature=(0.8, 1.2)[i // 2 % 2], top_p=0.9, top_k=8 if i % 3 == 0 else 0,
                      seed=None if i == 5 else 40 + i)
        sched.setdefault(int(rng.integers(0, 8)), []).append((prompt, sp))
    return sched


def _stats(eng):
    s = eng.spec_stats()
    return {k: s[k] for k in STATS}


def _drained(te):
    st = te.kv_cache_stats()
    return te.num_running == 0 and te.num_waiting == 0 and st.get("pages_free") == st.get("pages_total")


@LAYOUTS
@pytest.mark.parametrize("drafter", ["ngram", "model", "model_small"])
def test_spec_greedy_token_identical_to_ray_tpu_and_plain(params, layout, drafter):
    """Staggered admissions through 3 recycling slots with an abort at step
    6: the port's spec engine emits ray_tpu's spec engine's streams with
    the same finish reasons and spec counters, and its own plain engine's
    streams (an abort, timed by the host, may cut elsewhere in the same
    stream)."""
    kw = dict(max_num_seqs=3, max_seq_len=128, kv_layout=layout, page_size=16)
    sched, aborts = _mixed_schedule(), {6: 0}
    je, te = _engines(params, _specs(params, drafter), **kw)
    ref, ref_r = _drive(je, JaxParams, sched, aborts)
    got, got_r = _drive(te, SamplingParams, sched, aborts)
    assert got == ref and got_r == ref_r
    assert _stats(te) == _stats(je)
    plain, plain_r = _drive(LLMEngine(TCFG, params[1], device="cpu", **kw), SamplingParams, sched, aborts)
    assert set(plain) == set(got) and "aborted" in plain_r.values()
    for rid in plain:
        if plain_r[rid] == "aborted":
            n = min(len(plain[rid]), len(got[rid]))
            assert got[rid][:n] == plain[rid][:n]
        else:
            assert got[rid] == plain[rid] and got_r[rid] == plain_r[rid], rid
    s = te.spec_stats()
    assert s["rounds"] > 0 and s["emitted"] > 0
    if drafter == "model":
        assert s["acceptance_rate"] > 0.8 and s["mean_tokens_per_round"] > 1.5, s
    if layout == "paged":
        assert _drained(te)


def test_spec_paged_preemption_token_identical(params):
    """A pool too small for the load (num_pages=8) forces recompute
    preemption (spec growth books a k+1-token lookahead); the streams, the
    preemption count and the spec counters equal ray_tpu's, the streams
    equal the port's plain engine's, and the pool drains."""
    rng = np.random.default_rng(1)
    sched = {}
    for _ in range(5):
        prompt = [int(t) for t in rng.integers(1, 500, size=int(rng.integers(50, 60)))]
        sched.setdefault(int(rng.integers(0, 6)), []).append((prompt, dict(max_tokens=int(rng.integers(50, 64)))))
    kw = dict(max_num_seqs=3, max_seq_len=256, kv_layout="paged", page_size=32, num_pages=8,
              enable_prefix_caching=False)
    je, te = _engines(params, _specs(params, "ngram"), **kw)
    ref, ref_r = _drive(je, JaxParams, sched)
    got, got_r = _drive(te, SamplingParams, sched)
    assert got == ref and got_r == ref_r
    assert te.preemption_count == je.preemption_count > 0
    assert _stats(te) == _stats(je)
    plain = LLMEngine(TCFG, params[1], device="cpu", **kw)
    assert _drive(plain, SamplingParams, sched)[0] == got and plain.preemption_count > 0
    assert _drained(te)


@LAYOUTS
def test_spec_stop_tokens_and_prefix_hits(params, layout):
    """A stop id hit mid-round cuts the stream where the plain engine
    does; a prefix-cache hit (insert + suffix extend, then the drafter's
    own prefill) decodes as ray_tpu's spec engine and the plain engine do."""
    kw = dict(max_num_seqs=2, max_seq_len=128, prefix_block=16, kv_layout=layout, page_size=16)
    je, te = _engines(params, _specs(params, "model"), **kw)
    plain = LLMEngine(TCFG, params[1], device="cpu", **kw)
    base = plain.generate([4, 4], SamplingParams(max_tokens=8)).token_ids
    stop = dict(max_tokens=8, stop_token_ids=(base[4],))
    want = plain.generate([4, 4], SamplingParams(**stop))
    out = te.generate([4, 4], SamplingParams(**stop))
    assert out.token_ids == want.token_ids == je.generate([4, 4], JaxParams(**stop)).token_ids
    assert out.finish_reason == "stop"
    base40 = [(i % 50) + 1 for i in range(40)]
    for prompt in (base40 + [7, 8, 9], base40 + [30, 31]):
        o = te.generate(prompt, SamplingParams(max_tokens=6))
        assert o.token_ids == plain.generate(prompt, SamplingParams(max_tokens=6)).token_ids
        assert o.token_ids == je.generate(prompt, JaxParams(max_tokens=6)).token_ids
    assert te.prefix_cache_stats() == je.prefix_cache_stats() and te.prefix_cache_stats()["hits"] == 1
    assert _stats(te) == _stats(je)


@LAYOUTS
def test_spec_int8_cache_token_identical(params, layout):
    """The int8 cache (quantized on the verify's block append, on both
    layouts): ray_tpu's int8 spec engine's streams and counters."""
    kw = dict(max_num_seqs=3, max_seq_len=128, kv_layout=layout, page_size=16, cache_dtype="int8")
    sched = _mixed_schedule(seed=4)
    je, te = _engines(params, _specs(params, "ngram"), **kw)
    ref, ref_r = _drive(je, JaxParams, sched)
    got, got_r = _drive(te, SamplingParams, sched)
    assert got == ref and got_r == ref_r and _stats(te) == _stats(je)
    assert te.kv_cache_stats()["quantized"]


@pytest.mark.parametrize("layout, drafter", [("slots", "ngram"), ("paged", "model_small")])
def test_spec_seeded_streams_equal_ray_tpu(params, layout, drafter):
    """Stochastic lanes (seeded and seedless, top-p 0.9, some top-k 8)
    beside greedy ones: the one-hot rejection sampling draws from the same
    threefry subkeys as ray_tpu's, so the streams, the counters and the
    lane keys after the run are bit-equal."""
    kw = dict(max_num_seqs=3, max_seq_len=128, kv_layout=layout, page_size=16, seed=3)
    sched = _mixed_schedule(n=7, seed=2, seeded=True)
    je, te = _engines(params, _specs(params, drafter), **kw)
    ref, ref_r = _drive(je, JaxParams, sched)
    got, got_r = _drive(te, SamplingParams, sched)
    assert got == ref and got_r == ref_r and _stats(te) == _stats(je)
    np.testing.assert_array_equal(te._dkeys.numpy(), np.asarray(je._dkeys).astype(np.int64))


def test_spec_adaptive_k_decays_as_ray_tpu(params):
    """Random prompts give the n-gram drafter ~zero acceptance: the EMA
    controller walks the request's effective k down to k_min, step for step
    as ray_tpu's does, and the per-request k surfaces in spec_stats."""
    kw = dict(max_num_seqs=1, max_seq_len=128)
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 500, size=24)]
    je, te = _engines(params, _specs(params, "ngram", k=4, k_min=1, ema_alpha=0.6), **kw)
    seen = []
    for eng, cls in ((je, JaxParams), (te, SamplingParams)):
        ks = []
        _drive(eng, cls, {0: [(prompt, dict(max_tokens=24))]},
               on_step=lambda e: ks.append(sorted(e.spec_stats()["k_per_request"].values())))
        seen.append(ks)
    assert seen[0] == seen[1]
    assert {k for ks in seen[1] for k in ks} >= {1, 4}
    assert _stats(te) == _stats(je) and te.spec_stats()["accepted"] <= te.spec_stats()["proposed"]


def test_spec_trailing_round_capped(params):
    """The discarded trailing round costs a whole drafter round, so it is
    capped: a solo request the pending round finishes dispatches no further
    round (max_tokens=2: exactly one), an idle engine none."""
    te = LLMEngine(TCFG, params[1], device="cpu", max_num_seqs=2, max_seq_len=64,
                   speculative=SpecConfig(drafter="ngram", k=3))
    te.generate([5, 6], SamplingParams(max_tokens=2))
    assert te.spec_stats()["rounds"] == 1
    for _ in range(3):
        te.step()
    assert te.spec_stats()["rounds"] == 1


def test_spec_configuration_errors(params):
    tp = params[1]
    kw = dict(device="cpu", max_num_seqs=1, max_seq_len=64)
    with pytest.raises(ValueError, match="device-resident"):
        LLMEngine(TCFG, tp, device_resident=False, speculative=SpecConfig(), **kw)
    with pytest.raises(ValueError, match="draft_config"):
        LLMEngine(TCFG, tp, speculative=SpecConfig(drafter="model"), **kw)
    with pytest.raises(ValueError, match="vocab"):
        LLMEngine(TCFG, tp, speculative=SpecConfig(drafter="model", draft_config=tllama.LlamaConfig.tiny(vocab_size=64)),
                  **kw)
    with pytest.raises(TypeError, match="SpecConfig"):
        LLMEngine(TCFG, tp, speculative=object(), **kw)
    assert LLMEngine(TCFG, tp, **kw).spec_stats() == {}
