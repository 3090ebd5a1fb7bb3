"""The device-resident decode step as a CUDA graph, on the card (``cuda``
marker; skips elsewhere; imports no jax, so it runs on the chip machine:
``python -m pytest tests/test_torch_graph_cuda.py``).

A small f32 model with head_dim 64 (K4 takes 64 and 128), 3 lanes of
mixed sampling. The replayed graph runs the same kernels as the eager step
on the same inputs, so the comparisons are bit-equal: tokens, logprobs,
keys, lengths and the pool (f32, and int8 with its scales) or the slot
cache. Plus the deltas between replays (on the slot layout an admission's
``insert_sequence``, whose length write lands in the cache's own lane),
K4's replay-aware launch count, the refusal of a moved pool, cache or
weight, the threefry bits on the card against the CPU, and the graph
engine's greedy and seeded streams against the synchronous engine's on
each layout and on an int8 cache. The speculative round as one graph
(``SpecPagedStep``, ``SpecSlotStep``) with either drafter: replays
bit-equal to the eager round (emit, logprobs, acc, lanes, the pool or
cache, the draft cache), a moved draft cache refused, the capture's
warm-up leaving the draft cache's rows untouched, and the spec engine's
greedy streams equal to the plain engine's on the card with K4 counted
num_layers times a round on the paged layout; a re-capture counted by the
telemetry's recompile sentinel. KV entering a graph engine from outside
its prefill (handoffs scattered in, a restored checkpoint, a resumed
suspension) on both layouts and cache dtypes: every captured address
kept, ``captures`` 1, the restored device key equal to the checkpoint's."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.llm import LLMEngine, SamplingParams, SpecConfig
from ray_tpu_torch.llm import kv_cache as kvc
from ray_tpu_torch.llm import model_runner as mr
from ray_tpu_torch.llm import paged_kv as pkv
from ray_tpu_torch.llm import prng
from ray_tpu_torch.llm.cuda.graph import FusedDecode, PagedStep, SlotStep, SpecPagedStep, SpecSlotStep
from ray_tpu_torch.llm.cuda.paged_attn import paged_attn_partials
from ray_tpu_torch.llm.spec import drafter as sdr
from ray_tpu_torch.llm.spec import verify as sver
from ray_tpu_torch.models.llama import LlamaConfig, init_params

pytestmark = pytest.mark.cuda

CFG = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
                  max_seq_len=256, dtype="float32", remat=False)
PAGE, MAX_PG, P, B = 16, 4, 17, 3  # pages 13-16 stay free for the table deltas
LANES = PagedStep.LANES
S = 96  # the slot cache's rows


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the decode graph and K4 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sampling_lanes(dev, rng):
    return dict(tokens=torch.from_numpy(rng.integers(1, CFG.vocab_size, size=B)).to(dev),
                keys=torch.stack([prng.prng_key(s) for s in (3, 4, 5)]).to(dev),
                temps=torch.tensor([0.0, 0.8, 1.3], device=dev), top_k=torch.tensor([0, 5, 0], device=dev),
                top_p=torch.tensor([1.0, 1.0, 0.8], device=dev))


def _fill(tree, g, dtype):
    """Random values for the K/V (int8: random codes and positive scales)."""
    for name, t in tree.items():
        if name == "length":
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=t.device, dtype=torch.int8))
        elif dtype == "int8":
            t.copy_(torch.rand(t.shape, generator=g, device=t.device) * 0.05)
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=t.device))


def _setup(dev, seed=0, dtype="float32"):
    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(CFG, g)
    pcfg = pkv.PagedCacheConfig(num_layers=CFG.num_layers, num_pages=P, page_size=PAGE, max_pages_per_seq=MAX_PG,
                                num_slots=B, num_kv_heads=CFG.num_kv_heads, head_dim=CFG.hd, dtype=dtype)
    pool = pkv.alloc(pcfg, dev)
    _fill(pool, g, dtype)
    rng = np.random.default_rng(seed)
    lanes = dict(
        tables=torch.from_numpy(rng.permutation(np.arange(1, 13)).reshape(B, MAX_PG).astype(np.int32)).to(dev),
        lengths=torch.tensor([5, PAGE, 2 * PAGE - 1], dtype=torch.int32, device=dev), **_sampling_lanes(dev, rng))
    attn_fn, append_fn = mr.make_fused_paged_fns(CFG, "cuda")
    return params, pool, lanes, attn_fn, append_fn


def _eager_step(attn_fn, append_fn, params, pool, lanes):
    """The same step without a graph, on the given (cloned) state."""
    return PagedStep(attn_fn, append_fn).run(params, pool, lanes)


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def _deltas(lanes, step):
    """The scheduler's deltas between steps: a lane bound, a row moved, a page grown."""
    set_lane, set_table, set_table_cell = mr.make_delta_fns()
    if step == 0:
        set_lane(lanes["tokens"], lanes["keys"], lanes["temps"], lanes["top_k"], lanes["top_p"], 1, 7,
                 prng.prng_key(77).tolist(), 0.7, 0, 0.9)
    elif step == 1:
        set_table(lanes["tables"], lanes["lengths"], 2, torch.tensor([13, 14, 0, 0], dtype=torch.int32).pin_memory(),
                  20)
        set_table_cell(lanes["tables"], 2, 2, 15)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_replay_bit_equal_to_the_eager_step_with_deltas(dev, dtype):
    """The paged step, on an f32 pool and on an int8 pool captured with
    its scale tensors (K4's int8 branch, quantize-on-append)."""
    params, pool, lanes, attn_fn, append_fn = _setup(dev, dtype=dtype)
    fused = FusedDecode(PagedStep(attn_fn, append_fn), params, pool, lanes)
    assert fused.capture_s > 0 and fused.k4_per_replay == CFG.num_layers
    ref_pool, ref_lanes = _clone(pool), _clone(lanes)  # after the warm-up, which writes the trash page only
    for step in range(3):
        toks, logps = FusedDecode.read(fused.step(params, pool))
        ref_toks, ref_logps = _eager_step(attn_fn, append_fn, params, ref_pool, ref_lanes)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(toks, ref_toks.cpu().numpy())
        np.testing.assert_array_equal(logps, ref_logps.cpu().numpy())
        for k in LANES:
            assert torch.equal(lanes[k], ref_lanes[k]), (step, k)
        for k in pool:
            assert torch.equal(pool[k], ref_pool[k]), (step, k)
        _deltas(lanes, step)
        _deltas(ref_lanes, step)
    assert lanes["lengths"].tolist() == [5 + 3, PAGE + 3, 20 + 1]  # lane 2 was set to 20 before the third step


def test_replay_counts_k4_and_alternates_the_host_buffers(dev):
    """Two replays before the first is read (the engine reads step N after
    dispatching N + 1): each lands in its own pinned buffer, and K4's
    counter grows by num_layers a replay (the warm-up's launches count,
    the capture's do not)."""
    params, pool, lanes, attn_fn, append_fn = _setup(dev, seed=1)
    ref_params, ref_pool, ref_lanes, _, _ = _setup(dev, seed=1)
    before = paged_attn_partials.launches
    fused = FusedDecode(PagedStep(attn_fn, append_fn), params, pool, lanes)
    assert paged_attn_partials.launches == before + CFG.num_layers
    paged_attn_partials.launches = 0
    h1 = fused.step(params, pool)
    h2 = fused.step(params, pool)
    assert h1[0][0].data_ptr() != h2[0][0].data_ptr()
    t1, _ = FusedDecode.read(h1)
    t2, _ = FusedDecode.read(h2)
    assert paged_attn_partials.launches == 2 * CFG.num_layers and fused.replays == 2
    for t in (t1, t2):
        e, _ = _eager_step(attn_fn, append_fn, ref_params, ref_pool, ref_lanes)
        np.testing.assert_array_equal(t, e.cpu().numpy())


def test_moved_pool_or_weight_raises(dev):
    params, pool, lanes, attn_fn, append_fn = _setup(dev)
    fused = FusedDecode(PagedStep(attn_fn, append_fn), params, pool, lanes)
    moved = dict(pool, k=pool["k"].clone())
    with pytest.raises(RuntimeError, match="pool/k"):
        fused.step(params, moved)
    layers = dict(params["layers"], wq=params["layers"]["wq"].clone())
    with pytest.raises(RuntimeError, match="layers/wq"):
        fused.step(dict(params, layers=layers), pool)
    fused.step(params, pool)  # the tensors it was built on still replay


def _slot_setup(dev, seed=0, dtype="float32"):
    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(CFG, g)
    cache = kvc.alloc(kvc.CacheConfig(num_layers=CFG.num_layers, num_slots=B, max_seq_len=S,
                                      num_kv_heads=CFG.num_kv_heads, head_dim=CFG.hd, dtype=dtype), dev)
    _fill(cache, g, dtype)
    cache["length"].copy_(torch.tensor([5, 40, S - 2], dtype=torch.int32))  # the last one reaches the row's end
    return params, cache, _sampling_lanes(dev, np.random.default_rng(seed))


def _slot_deltas(cache, lanes, step, g):
    """Between steps: a seeded lane bound, then an admission into slot 0
    (insert_sequence: K/V copied in, the length lane written in place)."""
    set_lane, _, _ = mr.make_delta_fns()
    if step == 0:
        set_lane(lanes["tokens"], lanes["keys"], lanes["temps"], lanes["top_k"], lanes["top_p"], 1, 7,
                 prng.prng_key(77).tolist(), 0.7, 0, 0.9)
    elif step == 1:
        k = torch.randn((CFG.num_layers, 32, CFG.num_kv_heads, CFG.hd), generator=g, device=cache["k"].device)
        kvc.insert_sequence(cache, 0, k, -k, 20)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_slot_replay_bit_equal_to_the_eager_step_with_deltas(dev, dtype):
    """The slot step (``fused_step``: append, attention over the whole
    row, sampling) replayed three times against the eager step on cloned
    state, a lane delta and an admission's insert between replays: tokens,
    logprobs, lanes and the whole cache (its length lane included) equal.
    The capture's warm-up leaves the length lane as it was."""
    params, cache, lanes = _slot_setup(dev, dtype=dtype)
    lengths0 = cache["length"].clone()
    fused = FusedDecode(SlotStep(mr.make_fused_fns(CFG)), params, cache, lanes)
    assert fused.capture_s > 0 and fused.k4_per_replay == 0 and torch.equal(cache["length"], lengths0)
    ref_cache, ref_lanes = _clone(cache), _clone(lanes)
    step = SlotStep(mr.make_fused_fns(CFG))
    for i in range(3):
        toks, logps = FusedDecode.read(fused.step(params, cache))
        with torch.no_grad():
            ref_toks, ref_logps = step.run(params, ref_cache, ref_lanes)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(toks, ref_toks.cpu().numpy())
        np.testing.assert_array_equal(logps, ref_logps.cpu().numpy())
        for k in SlotStep.LANES:
            assert torch.equal(lanes[k], ref_lanes[k]), (i, k)
        for k in cache:
            assert torch.equal(cache[k], ref_cache[k]), (i, k)
        _slot_deltas(cache, lanes, i, torch.Generator(device=dev).manual_seed(i))
        _slot_deltas(ref_cache, ref_lanes, i, torch.Generator(device=dev).manual_seed(i))
    assert cache["length"].tolist() == [20 + 1, 40 + 3, S + 1]


def test_moved_slot_cache_raises(dev):
    params, cache, lanes = _slot_setup(dev)
    fused = FusedDecode(SlotStep(mr.make_fused_fns(CFG)), params, cache, lanes)
    for name in ("k", "length"):
        with pytest.raises(RuntimeError, match=f"cache/{name}"):
            fused.step(params, dict(cache, **{name: cache[name].clone()}))
    fused.step(params, cache)  # the tensors it was built on still replay


def test_threefry_on_the_card_bit_equal_to_the_cpu(dev):
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.integers(0, 2**32, size=(16, 2), dtype=np.uint64).astype(np.int64))
    x = torch.from_numpy(rng.integers(0, 2**32, size=(2, 16, 4096), dtype=np.uint64).astype(np.int64))
    on_card = prng.threefry2x32(k[:, :1].to(dev), k[:, 1:].to(dev), x[0].to(dev), x[1].to(dev))
    on_host = prng.threefry2x32(k[:, :1], k[:, 1:], x[0], x[1])
    for a, b in zip(on_card, on_host):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(prng.split(k.to(dev)).cpu(), prng.split(k))
    u_card, u_host = prng.uniform(k.to(dev), (128256,)).cpu(), prng.uniform(k, (128256,))
    assert torch.equal(u_card, u_host)
    g_card, g_host = prng.gumbel(k.to(dev), (128256,)).cpu(), prng.gumbel(k, (128256,))
    assert ((g_card - g_host).abs() <= 2 * torch.finfo(torch.float32).eps * g_host.abs().clamp(min=1)).all()


@pytest.mark.parametrize("layout,dtype", [("paged", None), ("paged", "int8"), ("slots", None), ("slots", "int8")])
def test_graph_engine_streams_equal_the_sync_engine(dev, layout, dtype):
    """The graph engine (the default) against ``device_resident=False`` on
    the card, on each layout and cache dtype: greedy and seeded streams
    equal; on the paged layout K4 launched num_layers times per decode step,
    counted through the replays, and never on the slot layout."""
    params = init_params(CFG, torch.Generator(device=dev).manual_seed(3))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, CFG.vocab_size, size=int(n)).tolist() for n in (9, 30, 17, 50)]
    sps = [SamplingParams(max_tokens=12), SamplingParams(max_tokens=12, temperature=0.8, top_p=0.9, seed=1),
           SamplingParams(max_tokens=7, temperature=1.2, top_k=20, seed=2), SamplingParams(max_tokens=12)]
    outs = {}
    for resident in (True, False):
        eng = LLMEngine(CFG, params, max_num_seqs=3, kv_layout=layout, cache_dtype=dtype, page_size=PAGE,
                        prefill_buckets=(64, 128, 256), device_resident=resident)
        assert (eng.graph_capture_s > 0) == resident
        paged_attn_partials.launches = 0
        outs[resident] = [o.token_ids for o in eng.generate(prompts, sps)]
        per_step = CFG.num_layers if layout == "paged" else 0
        assert paged_attn_partials.launches == per_step * eng.decode_steps and eng.decode_steps > 0
        stats = eng.kv_cache_stats()
        assert stats.get("pages_free") == stats.get("pages_total") and stats["occupied_tokens"] == 0
    assert outs[True] == outs[False]


# ------------------------------------------------------------ the spec round
K = 4  # proposals a round
H = 80  # history columns
DCFG = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=1, num_heads=2, num_kv_heads=1,
                   head_dim=64, max_seq_len=256, dtype="float32", remat=False)


def _spec_setup(dev, layout, drafter_kind, seed=0):
    """A paged pool (or slot cache) with its lanes, the spec lanes (a
    repeating history so the n-gram drafter proposes real matches) and a
    drafter (a model drafter's cache filled at random)."""
    if layout == "paged":
        params, kv, lanes, attn_fn, append_fn = _setup(dev, seed)
    else:
        params, kv, lanes = _slot_setup(dev, seed)
        kv["length"].copy_(torch.tensor([5, 40, S - 3], dtype=torch.int32))  # the last block runs past the row
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    hist = sver.spec_hist_buffer(B, H, dev)
    hist.copy_(torch.randint(1, 40, (B, H), generator=g, device=dev))
    hist[:, 20:40] = hist[:, :20]
    lanes.update(hist=hist, hist_len=torch.tensor([30, 45, H - 2], device=dev), spec_k=torch.tensor([K, K, 1], device=dev))
    if drafter_kind == "ngram":
        drafter = sdr.NGramDrafter(k=K, n=2)
    else:
        drafter = sdr.ModelDrafter(DCFG, k=K, seed=seed, device=dev)
        drafter.init_slots(B, S, (64,), dev)
        _fill(drafter.cache, g, "float32")
    if layout == "paged":
        step = SpecPagedStep(drafter, *sver.make_spec_verify_paged(CFG, "cuda"))
    else:
        step = SpecSlotStep(drafter, sver.make_spec_verify_slots(CFG))
    return params, kv, lanes, drafter, step


def _clone_lanes(lanes):
    out = _clone(lanes)
    out["hist"] = sver.clone_hist(lanes["hist"])
    return out


@pytest.mark.parametrize("drafter_kind", ["ngram", "model"])
@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_spec_replay_bit_equal_to_the_eager_round(dev, layout, drafter_kind):
    """Three replays of the captured round against the eager round on
    cloned state (the draft cache too), a lane's effective k moved between
    them: emit, logprobs, acc, every lane, the pool or cache and the draft
    cache equal. The capture's warm-up (lanes at length 0) leaves the draft
    cache's rows and the target's lengths as they were; K4 runs once a
    layer a round on the paged layout."""
    params, kv, lanes, drafter, step = _spec_setup(dev, layout, drafter_kind)
    cache = drafter.state().get("cache")  # a model drafter's; the n-gram drafter has none
    draft0 = _clone(cache) if cache is not None else None
    kv0 = _clone(kv)
    fused = FusedDecode(step, params, kv, lanes)
    assert fused.captures == 1 and fused.k4_per_replay == (CFG.num_layers if layout == "paged" else 0)
    if draft0 is not None:
        for name in draft0:
            assert torch.equal(drafter.cache[name], draft0[name]), name
    if layout == "slots":
        assert torch.equal(kv["length"], kv0["length"])
    ref_kv, ref_lanes = _clone(kv), _clone_lanes(lanes)
    ref_draft = _clone(cache) if cache is not None else None
    for i in range(3):
        out = FusedDecode.read(fused.step(params, kv))
        ref = step.run(params, ref_kv, ref_lanes, ref_draft)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b.cpu().numpy())
        for k in step.LANES:
            assert torch.equal(lanes[k], ref_lanes[k]), (i, k)
        for k in kv:
            assert torch.equal(kv[k], ref_kv[k]), (i, k)
        if ref_draft is not None:
            for k in ref_draft:
                assert torch.equal(drafter.cache[k], ref_draft[k]), (i, k)
        sver.set_slot_scalar(lanes["spec_k"], i % B, 2)
        sver.set_slot_scalar(ref_lanes["spec_k"], i % B, 2)
    assert fused.captures == 1 and fused.replays == 3


def test_spec_moved_draft_cache_raises(dev):
    params, pool, lanes, drafter, step = _spec_setup(dev, "paged", "model")
    fused = FusedDecode(step, params, pool, lanes)
    cache = drafter.cache
    drafter.cache = dict(cache, k=cache["k"].clone())
    with pytest.raises(RuntimeError, match="draft/cache/k"):
        fused.step(params, pool)
    drafter.cache = cache
    fused.step(params, pool)  # the tensors it was built on still replay


@pytest.mark.parametrize("drafter_kind", ["ngram", "model"])
@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_spec_engine_streams_equal_the_plain_engine(dev, layout, drafter_kind):
    """The spec graph engine's greedy streams equal the plain engine's on
    the card; K4 is launched num_layers times per dispatched round on the
    paged layout (counted through the replays) and never on slots; the
    pool drains."""
    params = init_params(CFG, torch.Generator(device=dev).manual_seed(3))
    rng = np.random.default_rng(3)
    prompts = [(rng.integers(1, 40, size=int(n)).tolist() * 3)[:n] for n in (9, 30, 17, 50)]
    sp = SamplingParams(max_tokens=16)
    kw = dict(max_num_seqs=3, kv_layout=layout, page_size=PAGE, prefill_buckets=(64, 128, 256))
    plain = [o.token_ids for o in LLMEngine(CFG, params, **kw).generate(prompts, sp)]
    spec = (SpecConfig(drafter="ngram", k=K, ngram=2) if drafter_kind == "ngram"
            else SpecConfig(drafter="model", k=K, draft_config=CFG, draft_params=params))
    eng = LLMEngine(CFG, params, speculative=spec, **kw)
    paged_attn_partials.launches = 0
    assert [o.token_ids for o in eng.generate(prompts, sp)] == plain
    stats = eng.spec_stats()
    assert paged_attn_partials.launches == (CFG.num_layers if layout == "paged" else 0) * stats["rounds"]
    if drafter_kind == "model":
        assert stats["acceptance_rate"] > 0.8
    kv = eng.kv_cache_stats()
    assert kv.get("pages_free") == kv.get("pages_total") and eng.telemetry()["recompiles"] == {}


def test_recapture_counts_in_the_recompile_sentinel(dev):
    """The telemetry's sentinel over a real graph: the capture in the
    constructor is the warm baseline, a second capture is one recompile,
    and the re-captured graph still replays."""
    from ray_tpu_torch.llm.telemetry import FlightRecorder

    params, pool, lanes, attn_fn, append_fn = _setup(dev)
    fused = FusedDecode(PagedStep(attn_fn, append_fn), params, pool, lanes)
    rec = FlightRecorder()
    rec.register_entry("fused_attn", fused)
    assert rec.check_recompiles() == [] and fused.captures == 1
    fused._capture()
    assert fused.captures == 2 and rec.check_recompiles() == ["fused_attn"] and rec.recompiles == {"fused_attn": 1}
    FusedDecode.read(fused.step(params, pool))


# ------------------------------------------ KV entering the graph engine
def _addresses(eng):
    """Every address the engine's captured graph reads: the weights, the
    pool or cache, the draft state (``FusedDecode._addresses``) and the
    lanes."""
    fd = eng._decode
    return fd._addresses(eng.params, eng.kv), {name: t.data_ptr() for name, t in fd.lanes.items()}


def _finish_all(eng, ids):
    finals = {}
    while eng.has_unfinished():
        finals.update((o.request_id, o.token_ids) for o in eng.step()
                      if o.finished and o.finish_reason not in ("suspended", "migrated"))
    return [finals[i] for i in ids]


@pytest.mark.parametrize("layout,dtype", [("paged", None), ("paged", "int8"), ("slots", None), ("slots", "int8")])
def test_scatter_restore_resume_keep_the_captured_graph(dev, layout, dtype):
    """Handoffs scattered into a graph engine, a checkpoint restored into
    another and a conversation suspended and resumed there: every captured
    address unchanged and ``captures`` 1 on each engine; the restored
    lane's device key, read right after the bind (before its first step),
    equal to the checkpoint's bit for bit; the disaggregated streams equal
    the sync engine's on the same handoffs, the spliced and the resumed
    streams the uninterrupted ones, greedy and seeded."""
    from ray_tpu_torch.llm import migrate

    params = init_params(CFG, torch.Generator(device=dev).manual_seed(3))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, CFG.vocab_size, size=int(n)).tolist() for n in (9, 30, 50)]
    sps = [SamplingParams(max_tokens=12), SamplingParams(max_tokens=12, temperature=0.8, top_p=0.9, seed=1),
           SamplingParams(max_tokens=12, temperature=1.2, top_k=20, seed=2)]
    kw = dict(max_num_seqs=3, kv_layout=layout, cache_dtype=dtype, page_size=PAGE, prefill_buckets=(64, 128, 256))
    pre = LLMEngine(CFG, params, **kw)
    pays = [pre.prefill_handoff(p) for p in prompts]  # B = 1 forwards, as each request's own prefill below
    sync = LLMEngine(CFG, params, device_resident=False, **kw)
    want = _finish_all(sync, [sync.add_prefilled(pay, sp) for pay, sp in zip(pays, sps)])
    dec = LLMEngine(CFG, params, **kw)
    before = _addresses(dec)
    got = _finish_all(dec, [dec.add_prefilled(pay, sp) for pay, sp in zip(pays, sps)])
    assert got == want
    # migration: the seeded request checkpointed mid-decode on dec, restored on dst
    rid = dec.add_request(prompts[1], sps[1])
    while len(dec._requests[rid].token_ids) < 5:
        dec.step()
    state = migrate.decode(migrate.encode(dec.checkpoint_request(rid)))
    assert dec.finish_migrated(rid)
    dst = LLMEngine(CFG, params, **kw)
    dst_before = _addresses(dst)
    seen = {}
    bind = dst._bind_resume

    def spy(st, slot):
        bind(st, slot)
        seen[st.request_id] = migrate.key_to_wire(dst._dkeys[slot].cpu().numpy())

    dst._bind_resume = spy
    rid2 = dst.restore_request(state)
    spliced = _finish_all(dst, [rid2])[0]
    np.testing.assert_array_equal(seen[rid2], state["rng_key"])
    assert spliced == want[1] and spliced[: len(state["emitted_token_ids"])] == state["emitted_token_ids"]
    # suspend and resume on dst
    rid3 = dst.add_request(prompts[2], sps[2])
    while len(dst._requests[rid3].token_ids) < 4:
        dst.step()
    info = dst.suspend_request(rid3)
    assert info["published"] is False and info["nbytes"] == migrate.state_nbytes(dst._suspended[rid3]["state"])
    if layout == "paged":
        assert dst.kv_cache_stats()["pages_free"] == dst._pcfg.num_pages - 1
    dst.resume_suspended(rid3)
    assert _finish_all(dst, [rid3])[0] == want[2]
    assert dst.suspend_stats()["resumed"] == 1
    for eng, ptrs in ((dec, before), (dst, dst_before)):
        assert _addresses(eng) == ptrs and eng._decode.captures == 1
