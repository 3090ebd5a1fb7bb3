"""The port's LLMEngine on the slot layout (``kv_layout="slots"``, the
default, as in ray_tpu) and with the int8 cache on both layouts, against
ray_tpu's engine of the same layout, cache dtype and decode mode, on the
same weights.

The slot engine runs three step-indexed schedules, greedy and seeded
(seeded and seedless stochastic lanes mixed with greedy ones):
ray_tpu's staggered admissions with an abort mid-flight
(tests/test_llm_device_resident.py::test_slots_fused_equals_sync), a
prefix-hit schedule (a leader, then followers on its prefix: the hit's
``insert_sequence`` + ``extend``), and a schedule that recycles two slots
through nine requests (one finished by its first token, one a repeat of an
earlier prompt that hits the prefix cache in a recycled slot). Tokens,
finish reasons, prefix-cache stats and the device lane keys equal
ray_tpu's. The int8 engine (``cache_dtype="int8"``: quantized on insert
and append, dequantized in attention; on the paged layout through K4's
int8 branch) runs seeded schedules on each layout: slots over the abort
and prefix-hit schedules, paged over the prefix-hit schedule and
ray_tpu's paged preemption schedule (re-admission re-quantizes). Then the
port's two decode modes against each other on slots, the default layout
and its stats, the attention-kernel rule, and the refusal of a moved
cache tensor."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
# every program of ray_tpu's engines, both layouts and decode modes; the ones an engine lacks are skipped
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell")
MODES = pytest.mark.parametrize("device_resident", [True, False], ids=["device_resident", "sync"])
SEEDED = pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
SCHEDULES = pytest.mark.parametrize("name", ["staggered_abort", "prefix_hits", "recycle"])


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
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _synced(fn):
    """One ray_tpu program with its inputs and outputs settled (ROADMAP.md,
    queue 3: ray_tpu's engines are nondeterministic on the XLA CPU runtime
    when their programs overlap)."""

    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


def jax_engine(jp, **kw):
    je = JaxEngine(jllama.LlamaConfig.tiny(**KW), jp, telemetry=False, **kw)
    for name in SETTLED:
        if hasattr(je, name):
            setattr(je, name, _synced(getattr(je, name)))
    return je


def torch_engine(tp, **kw):
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", **kw)


def schedule(name, seeded):
    """(engine arguments, {step: [(prompt, sampling kwargs)]}, {step:
    ordinal of the request to abort}) of one named schedule. ``seeded``
    turns every other request stochastic: seeded ones and, every fourth,
    a seedless one (drawn from its slot's key)."""
    rng = np.random.default_rng({"staggered_abort": 0, "prefix_hits": 2, "recycle": 4, "preemption": 1}[name])
    sched, aborts = {}, {}
    if name == "preemption":
        # ray_tpu's test_paged_fused_equals_sync_under_preemption (paged only): 64-token
        # buckets (2 pages of 32), generations long enough to need growth pages that a
        # 7-page pool cannot give every sequence
        kw = dict(max_num_seqs=3, max_seq_len=256, page_size=32, num_pages=8, enable_prefix_caching=False)
        for _ in range(5):
            prompt = [int(t) for t in rng.integers(1, 500, size=int(rng.integers(50, 60)))]
            sched.setdefault(int(rng.integers(0, 6)), []).append((prompt, int(rng.integers(50, 64))))
    elif name == "staggered_abort":
        # ray_tpu's test_slots_fused_equals_sync: staggered admissions of varying lengths so
        # slots recycle mid-decode, a stochastic request, and an abort at step 6
        kw = dict(max_num_seqs=3, max_seq_len=128, enable_prefix_caching=False)
        for _ in range(8):
            prompt = [int(t) for t in rng.integers(1, 500, size=int(rng.integers(4, 90)))]
            sched.setdefault(int(rng.integers(0, 10)), []).append((prompt, int(rng.integers(3, 14))))
        sched.setdefault(1, []).append(([7, 7, 7], 30))  # aborted at step 6
    elif name == "prefix_hits":
        # a leader, then followers on its 64-token prefix arriving over a few steps
        kw = dict(max_num_seqs=3, max_seq_len=256, prefix_block=32)
        pre = [int(t) for t in rng.integers(1, 500, size=64)]
        sched[0] = [(pre + [int(t) for t in rng.integers(1, 500, size=20)], 10)]
        for step, n in ((3, 5), (3, 40), (5, 70), (9, 12)):
            sched.setdefault(step, []).append((pre + [int(t) for t in rng.integers(1, 500, size=n)], 12))
    else:
        # two slots through nine requests; one ends with its first token, and the
        # last repeats the second's prompt: a prefix hit admitted into a recycled slot
        kw = dict(max_num_seqs=2, max_seq_len=128, prefix_block=16)
        prompts = [[int(t) for t in rng.integers(1, 500, size=int(n))] for n in (9, 40, 23, 5, 61, 17, 33, 12)]
        steps = (0, 0, 0, 1, 2, 6, 7, 7)
        for step, prompt, max_tokens in zip(steps, prompts, (6, 4, 1, 9, 3, 7, 5, 2)):
            sched.setdefault(step, []).append((prompt, max_tokens))
        sched.setdefault(9, []).append((prompts[1] + [3, 4], 6))
    out, i = {}, 0
    for step in sorted(sched):
        for prompt, max_tokens in sched[step]:
            if name == "staggered_abort" and prompt == [7, 7, 7]:
                aborts = {6: i}
            stochastic = seeded and i % 2 == 1
            sp = dict(max_tokens=max_tokens, temperature=(0.7, 1.3)[i // 2 % 2] if stochastic else 0.0,
                      top_k=5 if stochastic and i % 3 == 0 else 0, top_p=0.8 if stochastic and i % 3 == 1 else 1.0,
                      seed=None if not stochastic or i % 4 == 3 else 100 + i)
            out.setdefault(step, []).append((prompt, sp))
            i += 1
    return kw, out, aborts


def drive(eng, params_cls, sched, aborts, max_steps=400):
    """Step an engine over a step-indexed admission (and abort) schedule
    until nothing is left; returns ({request_id: token_ids},
    {request_id: finish_reason})."""
    finals, reasons, ids = {}, {}, []
    t = 0
    while t <= max(sched) or eng.has_unfinished():
        for prompt, sp in sched.get(t, []):
            ids.append(eng.add_request(prompt, params_cls(**sp)))
        if t in aborts:
            eng.abort_request(ids[aborts[t]])
        for o in eng.step():
            if o.finished:
                finals[o.request_id] = o.token_ids
                reasons[o.request_id] = o.finish_reason
        t += 1
        assert t < max_steps, "schedule never converged"
    return finals, reasons


def assert_same_run(te, je, out, ref, name, device_resident):
    """The port's run equals ray_tpu's: streams, finish reasons, the
    prefix cache's counters and, device-resident, the lane keys."""
    (tokens, reasons), (ref_tokens, ref_reasons) = out, ref
    assert tokens == ref_tokens and reasons == ref_reasons
    assert ("aborted" in reasons.values()) == (name == "staggered_abort")
    assert te.prefix_cache_stats() == je.prefix_cache_stats()
    assert (te.prefix_cache_stats().get("hits", 0) > 0) == (name in ("prefix_hits", "recycle"))
    assert te.preemption_count == je.preemption_count and (te.preemption_count > 0) == (name == "preemption")
    assert te.extend_forwards == te.prefix_cache_stats().get("hits", 0)
    if device_resident:
        np.testing.assert_array_equal(te._dkeys.numpy(), np.asarray(je._dkeys).astype(np.int64))
    assert te.num_running == te.num_waiting == 0 and te.kv_cache_stats()["occupied_tokens"] == 0


@SCHEDULES
@SEEDED
@MODES
def test_slot_engine_token_identical_to_ray_tpu(params, name, seeded, device_resident):
    jp, tp = params
    kw, sched, aborts = schedule(name, seeded)
    je = jax_engine(jp, device_resident=device_resident, seed=5, **kw)
    ref = drive(je, JaxParams, sched, aborts)
    te = torch_engine(tp, device_resident=device_resident, seed=5, **kw)
    assert te.kv_layout == je.kv_layout == "slots"
    assert_same_run(te, je, drive(te, SamplingParams, sched, aborts), ref, name, device_resident)


@pytest.mark.parametrize("layout,name", [("slots", "staggered_abort"), ("slots", "prefix_hits"),
                                         ("paged", "prefix_hits"), ("paged", "preemption")])
@MODES
def test_int8_engine_token_identical_to_ray_tpu(params, layout, name, device_resident):
    """Seeded schedules (greedy, seeded and seedless lanes) on an int8
    cache: the same streams as ray_tpu's int8 engine of the same layout
    and mode; a paged engine also drains its pages."""
    jp, tp = params
    kw, sched, aborts = schedule(name, seeded=True)
    kw = dict(kw, kv_layout=layout, cache_dtype="int8", seed=5, device_resident=device_resident)
    if layout == "paged":
        kw.setdefault("page_size", 16)
    je = jax_engine(jp, **kw)
    ref = drive(je, JaxParams, sched, aborts)
    te = torch_engine(tp, **kw)
    assert te.kv_quant and je.kv_quant and te.kv_cache_stats()["dtype"] == "int8"
    assert_same_run(te, je, drive(te, SamplingParams, sched, aborts), ref, name, device_resident)
    if layout == "paged":
        stats = te.kv_cache_stats()
        assert stats["pages_free"] == stats["pages_total"] == je._page_alloc.free_pages


@SCHEDULES
@SEEDED
def test_slot_device_resident_equals_the_sync_loop(params, name, seeded):
    """The port's two decode modes on the slot layout: equal streams and
    finish reasons, except that a host-timed abort may cut the
    device-resident stream up to one token earlier. Seedless stochastic
    lanes draw from their slot's key, whose history depends on the
    schedule, so they get a seed here."""
    _, tp = params
    kw, sched, aborts = schedule(name, seeded)
    sched = {t: [(p, {**sp, "seed": 7} if sp["temperature"] and sp["seed"] is None else sp) for p, sp in reqs]
             for t, reqs in sched.items()}
    (fused, fused_r), (sync, sync_r) = (drive(torch_engine(tp, seed=5, device_resident=dr, **kw), SamplingParams,
                                              sched, aborts) for dr in (True, False))
    assert set(fused) == set(sync) and fused_r == sync_r
    for rid in sync:
        if sync_r[rid] == "aborted":
            n = min(len(sync[rid]), len(fused[rid]))
            assert fused[rid][:n] == sync[rid][:n] and abs(len(sync[rid]) - len(fused[rid])) <= 1
        else:
            assert fused[rid] == sync[rid], rid


def test_slots_is_the_default_and_its_stats(params):
    """The default layout, its accounting (no page fields; occupied tokens
    from prompt + generated tokens; the length lane not counted in the
    allocation) and its attention implementation."""
    _, tp = params
    cfg = tllama.LlamaConfig.tiny(**KW)
    te = torch_engine(tp, max_num_seqs=2, max_seq_len=64, prefill_buckets=(32, 64))
    stats = te.kv_cache_stats()
    per_tok = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.hd * 4
    assert stats == dict(layout="slots", dtype="float32", quantized=False, attn_kernel="torch",
                         bytes_per_token=per_tok, allocated_bytes=2 * 64 * per_tok, slots_total=2,
                         slots_in_use=0, occupied_tokens=0, occupied_bytes=0)
    te.add_request(list(range(1, 11)), SamplingParams(max_tokens=5))
    te.step()
    te.step()
    stats = te.kv_cache_stats()
    assert stats["slots_in_use"] == 1 and stats["occupied_tokens"] == 12 and stats["occupied_bytes"] == 12 * per_tok
    q = torch_engine(tp, max_num_seqs=2, max_seq_len=64, prefill_buckets=(32, 64), cache_dtype="int8").kv_cache_stats()
    assert q["quantized"] and q["bytes_per_token"] == 2 * cfg.num_layers * cfg.num_kv_heads * (cfg.hd + 4)
    assert q["allocated_bytes"] == 2 * 64 * q["bytes_per_token"]


def test_slot_attention_kernel_rule(params):
    """The slot layout has no page gather: its attention is plain PyTorch
    on either device, and asking for K4 raises, as ray_tpu raises on
    attn_kernel="pallas" with slots."""
    _, tp = params
    assert torch_engine(tp, max_num_seqs=1, attn_kernel="torch").attn_kernel == "torch"
    with pytest.raises(ValueError, match="attn_kernel"):
        torch_engine(tp, max_num_seqs=1, attn_kernel="cuda")
    with pytest.raises(ValueError, match="kv_layout"):
        torch_engine(tp, max_num_seqs=1, kv_layout="blocks")


def test_moved_cache_raises_instead_of_decoding(params):
    """The decode step reads the cache, its length lane included, where it
    was built: a tensor replaced behind its back raises."""
    _, tp = params
    for name in ("k", "length"):
        te = torch_engine(tp, max_num_seqs=2)
        te.add_request(list(range(1, 20)), SamplingParams(max_tokens=8))
        te.step()
        te.cache[name] = te.cache[name].clone()
        with pytest.raises(RuntimeError, match=f"cache/{name}"):
            te.step()


def test_slot_hit_streams_equal_the_uncached_engine(params):
    """A hit computes the same function as a full prefill: on the slot
    layout, in f32 on the host, the cached engine's greedy streams equal a
    caching-off engine's on the same prompts (followers of 1-100 suffix
    tokens over a 128-token prefix)."""
    _, tp = params
    rng = np.random.default_rng(4)
    pre = [int(t) for t in rng.integers(1, 500, size=128)]
    prompts = [pre + [int(t) for t in rng.integers(1, 500, size=n)] for n in (1, 30, 64, 100)]
    cached = torch_engine(tp, max_num_seqs=4, seed=5)
    cached.generate(pre + [5, 6, 7], SamplingParams(max_tokens=4))
    hits = cached.generate(prompts, SamplingParams(max_tokens=8))
    plain = torch_engine(tp, max_num_seqs=4, seed=5, enable_prefix_caching=False).generate(
        prompts, SamplingParams(max_tokens=8))
    assert cached.extend_forwards == 4 and cached.prefix_cache_stats()["tokens_saved"] == 4 * 128
    assert [o.token_ids for o in hits] == [o.token_ids for o in plain]
