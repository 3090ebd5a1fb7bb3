"""The port's paged LLMEngine (``kv_layout="paged"``, pinned: the default
is the slot layout, tests/test_torch_engine_slots.py) against ray_tpu's
paged engine on the same weights, each
decode mode against the same mode: greedy generation token-identical
under the paged schedule that preempts (3 slots, 8 pages of 16, 6 prompts
of 8-40 tokens, 40 new tokens each), with equal preemption counts and
prefix caching off on both sides (tests/test_torch_prefix_cache.py holds
it on). Then the device-resident loop (the default) over the schedules of
ray_tpu's tests/test_llm_device_resident.py (preemption with 8 pages,
staggered admissions with an abort while a step is in flight) and a
prefix-hit schedule, greedy and seeded (seeded and seedless stochastic
lanes mixed with greedy ones): token-identical to ray_tpu's
device-resident engine with equal finish reasons, preemption counts,
prefix-cache stats and a drained pool, and to the port's own synchronous
loop. Plus the one-step-delayed emission, abort, the device rule and the
features the port does not have yet."""

import queue

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.parallel.mesh import create_mesh  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
SCHED = dict(max_num_seqs=3, max_seq_len=128, page_size=16, prefill_buckets=(32, 64, 128), num_pages=8, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side of these tiny models runs on one intra-op thread:
    beside other test workers, torch's thread pool spins against the XLA
    runtime's and a schedule takes ~10x longer; the arithmetic is the same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _prompts():
    rng = np.random.default_rng(3)
    return [list(rng.integers(1, 500, size=int(rng.integers(8, 40)))) for _ in range(6)]


def _synced(fn):
    """Run one ray_tpu program with its inputs and outputs settled.

    ray_tpu's paged engine on the XLA CPU runtime emits different tokens
    from run to run of this very schedule when its prefill/insert/decode
    programs overlap (ROADMAP.md, queue 3). Settling each call restores
    the deterministic result, which is the oracle compared here."""

    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


# every program of ray_tpu's paged engine, both decode modes; the ones a mode lacks are skipped
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_attn", "_fused_append", "_set_lane",
           "_set_table", "_set_table_cell")
MODES = pytest.mark.parametrize("device_resident", [True, False], ids=["device_resident", "sync"])


def _jax_engine(jp, **kw):
    je = JaxEngine(jllama.LlamaConfig.tiny(**KW), jp, kv_layout="paged", telemetry=False, **kw)
    for name in SETTLED:
        if hasattr(je, name):
            setattr(je, name, _synced(getattr(je, name)))
    return je


def _torch_engine(tp, **kw):
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", **{"kv_layout": "paged", **SCHED, **kw})


@MODES
@pytest.mark.parametrize("batch_prefill", [True, False], ids=["batched_prefill", "one_prefill_each"])
def test_generate_token_identical_to_ray_tpu_under_preemption(params, batch_prefill, device_resident):
    jp, tp = params
    je = _jax_engine(jp, enable_prefix_caching=False, device_resident=device_resident, batch_prefill=batch_prefill,
                     **SCHED)
    ref = je.generate(_prompts(), JaxParams(max_tokens=40))
    te = _torch_engine(tp, batch_prefill=batch_prefill, enable_prefix_caching=False, device_resident=device_resident)
    out = te.generate(_prompts(), SamplingParams(max_tokens=40))
    assert [o.token_ids for o in out] == [o.token_ids for o in ref]
    assert all(len(o.token_ids) == 40 and o.finish_reason == "length" for o in out)
    assert te.preemption_count == je.preemption_count > 0
    stats = te.kv_cache_stats()
    assert stats["attn_kernel"] == "torch" and stats["pages_free"] == stats["pages_total"] == 7
    assert te.prefill_forwards > 0 and te.decode_steps > 0


def test_abort_mid_run_frees_slot_and_pages(params):
    _, tp = params
    te = _torch_engine(tp, num_pages=32)  # three running, the fourth waits for a slot
    prompts = _prompts()[:4]
    ids = [te.add_request(p, SamplingParams(max_tokens=30)) for p in prompts]
    finals = {}
    for _ in range(3):
        for o in te.step():
            finals[o.request_id] = o
    assert te.abort_request(ids[1]) and not te.abort_request(ids[1])
    assert te.abort_request(ids[3])  # still waiting: aborted before admission
    while te.has_unfinished():
        for o in te.step():
            if o.finished:
                finals[o.request_id] = o
    assert finals[ids[1]].finish_reason == "aborted" and 0 < len(finals[ids[1]].token_ids) < 30
    assert finals[ids[3]].finish_reason == "aborted"
    assert [len(finals[i].token_ids) for i in (ids[0], ids[2])] == [30, 30]
    # the survivors decode exactly as they would alone
    alone = _torch_engine(tp).generate([prompts[0], prompts[2]], SamplingParams(max_tokens=30))
    assert [finals[ids[0]].token_ids, finals[ids[2]].token_ids] == [o.token_ids for o in alone]
    assert te.kv_cache_stats()["pages_free"] == 31 and te.num_running == 0 and te.num_waiting == 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device does not raise here")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(tllama.LlamaConfig.tiny(**KW), max_num_seqs=1, max_seq_len=64, prefill_buckets=(64,))


@pytest.mark.parametrize(
    "kw, exc, match",
    [
        # a mesh with axes besides tp (ray_tpu runs it through GSPMD); a pure tp
        # mesh is tests/test_torch_engine_tp.py's
        (dict(mesh=create_mesh(dp=2, tp=2, devices=["cpu"] * 4)), NotImplementedError, "ROADMAP"),
        # the KV plane is ported: ray_tpu's refusal of a plane without the
        # prefix cache it is the cluster tier of (ray_tpu/llm/engine.py:587)
        (dict(kv_plane=object(), enable_prefix_caching=False), ValueError, "enable_prefix_caching"),
    ],
    ids=["mesh", "kv_plane"],
)
def test_unported_features_raise_naming_roadmap(params, kw, exc, match):
    with pytest.raises(exc, match=match):
        _torch_engine(params[1], **kw)


def test_attn_kernel_and_request_validation(params):
    _, tp = params
    with pytest.raises(ValueError, match="attn_kernel"):
        _torch_engine(tp, attn_kernel="cuda")
    te = _torch_engine(tp)
    with pytest.raises(ValueError, match="max_seq_len"):
        te.add_request(list(range(100)), SamplingParams(max_tokens=40))
    with pytest.raises(ValueError, match="empty"):
        te.add_request([], SamplingParams(max_tokens=4))


def test_streamed_tokens_and_logprobs(params):
    _, tp = params
    te = _torch_engine(tp)
    prompt = _prompts()[0]
    q = queue.SimpleQueue()
    rid = te.add_request(prompt, SamplingParams(max_tokens=6, logprobs=True), out_queue=q)
    final = None
    while te.has_unfinished():
        for o in te.step():
            if o.request_id == rid and o.finished:
                final = o
    streamed = []
    while (tok := q.get(timeout=1)) is not None:
        streamed.append(tok)
    assert final.streamed and streamed == final.token_ids
    assert len(final.logprobs) == 6 and all(lp <= 0.0 for lp in final.logprobs)
    # the same request unstreamed generates the same tokens
    assert _torch_engine(tp).generate(prompt, SamplingParams(max_tokens=6)).token_ids == final.token_ids


def _schedule(name, seeded):
    """(engine arguments, {step: [(prompt, max_tokens, sampling)]}, {step:
    ordinal of the request to abort}) of one named schedule. ``seeded``
    turns every other request stochastic: seeded ones and, every fourth,
    a seedless one (drawn from its slot's key)."""
    rng = np.random.default_rng({"preemption": 1, "staggered_abort": 0, "prefix_hits": 2}[name])
    sched, aborts = {}, {}
    if name == "preemption":
        # ray_tpu's test_paged_fused_equals_sync_under_preemption: 64-token buckets
        # (2 pages of 32), generations long enough to need growth pages that a 7-page
        # pool cannot give every sequence
        kw = dict(max_num_seqs=3, max_seq_len=256, page_size=32, num_pages=8, enable_prefix_caching=False)
        for _ in range(5):
            prompt = [int(t) for t in rng.integers(1, 500, size=int(rng.integers(50, 60)))]
            sched.setdefault(int(rng.integers(0, 6)), []).append((prompt, int(rng.integers(50, 64))))
    elif name == "staggered_abort":
        # ray_tpu's test_slots_fused_equals_sync on the paged layout: staggered admissions of
        # varying lengths so slots recycle mid-decode, and an abort at step 6
        kw = dict(max_num_seqs=3, max_seq_len=128, page_size=16, enable_prefix_caching=False)
        for _ in range(8):
            prompt = [int(t) for t in rng.integers(1, 500, size=int(rng.integers(4, 90)))]
            sched.setdefault(int(rng.integers(0, 10)), []).append((prompt, int(rng.integers(3, 14))))
        sched.setdefault(1, []).append(([7, 7, 7], 30))  # aborted at step 6
    else:
        # a leader, then followers on its 64-token prefix arriving over a few steps
        kw = dict(max_num_seqs=3, max_seq_len=256, page_size=16, prefix_block=32)
        pre = [int(t) for t in rng.integers(1, 500, size=64)]
        sched[0] = [(pre + [int(t) for t in rng.integers(1, 500, size=20)], 10)]
        for step, n in ((3, 5), (3, 40), (5, 70), (9, 12)):
            sched.setdefault(step, []).append((pre + [int(t) for t in rng.integers(1, 500, size=n)], 12))
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


def _drive(eng, params_cls, sched, aborts, max_steps=400):
    """ray_tpu's tests/test_llm_device_resident.py::_drive: step an engine
    over a step-indexed admission (and abort) schedule until nothing is
    left; returns ({request_id: token_ids}, {request_id: finish_reason})."""
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


def _drained(eng):
    stats = eng.kv_cache_stats()
    return stats["pages_free"] == stats["pages_total"] and eng.num_running == 0 and eng.num_waiting == 0


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("name", ["preemption", "staggered_abort", "prefix_hits"])
def test_device_resident_token_identical_to_ray_tpu(params, name, seeded):
    """The default (device-resident) engine against ray_tpu's
    device-resident engine: the same tokens, finish reasons, preemption
    count and prefix-cache stats, and both pools drained; the lane keys
    after the run are bit-equal too."""
    jp, tp = params
    kw, sched, aborts = _schedule(name, seeded)
    je = _jax_engine(jp, device_resident=True, seed=5, **kw)
    ref, ref_r = _drive(je, JaxParams, sched, aborts)
    te = LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", kv_layout="paged", seed=5, **kw)
    out, out_r = _drive(te, SamplingParams, sched, aborts)
    assert out == ref and out_r == ref_r
    assert te.preemption_count == je.preemption_count
    assert (te.preemption_count > 0) == (name == "preemption")
    assert ("aborted" in out_r.values()) == (name == "staggered_abort")
    assert te.prefix_cache_stats() == je.prefix_cache_stats()
    assert (te.prefix_cache_stats().get("hits", 0) > 0) == (name == "prefix_hits")
    np.testing.assert_array_equal(te._dkeys.numpy(), np.asarray(je._dkeys).astype(np.int64))
    assert _drained(te) and je._page_alloc.free_pages == je._pcfg.num_pages - 1


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("name", ["preemption", "staggered_abort", "prefix_hits"])
def test_device_resident_equals_the_sync_loop(params, name, seeded):
    """The port's two decode modes on one schedule: equal streams and
    finish reasons (the one-step-delayed emission changes when tokens
    surface, not which), except that an abort, timed by the host, may cut
    the device-resident stream up to one token earlier. Seedless
    stochastic lanes draw from their slot's key, whose history depends on
    the schedule, so they are held only in the greedy and seeded-only
    cases."""
    _, tp = params
    kw, sched, aborts = _schedule(name, seeded)
    sched = {t: [(p, {**sp, "seed": 7} if sp["temperature"] and sp["seed"] is None else sp) for p, sp in reqs]
             for t, reqs in sched.items()}
    runs = []
    for device_resident in (True, False):
        te = LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", kv_layout="paged", seed=5,
                       device_resident=device_resident, **kw)
        runs.append((*_drive(te, SamplingParams, sched, aborts), te))
    (fused, fused_r, ef), (sync, sync_r, es) = runs
    assert set(fused) == set(sync) and fused_r == sync_r
    for rid in sync:
        if sync_r[rid] == "aborted":
            n = min(len(sync[rid]), len(fused[rid]))
            assert fused[rid][:n] == sync[rid][:n] and abs(len(sync[rid]) - len(fused[rid])) <= 1
        else:
            assert fused[rid] == sync[rid], rid
    assert ef.preemption_count == es.preemption_count
    assert _drained(ef) and _drained(es)


def test_emission_trails_device_by_one_step(params):
    """ray_tpu's documented async semantics: the step that admits a request
    emits its first token (from the prefill) and dispatches its first
    decode step, whose token surfaces on the NEXT step() call; a step is
    in flight until the trailing one drains."""
    _, tp = params
    te = _torch_engine(tp, max_num_seqs=1)
    te.add_request([5, 6], SamplingParams(max_tokens=3))
    out1 = te.step()
    assert len(out1) == 1 and len(out1[0].token_ids) == 1 and te.decode_steps == 1
    out2 = te.step()
    assert len(out2[0].token_ids) == 2 and te.decode_steps == 2
    out3 = te.step()  # the third token drains; the step dispatched with it is the discarded trailing one
    assert out3[0].finished and len(out3[0].token_ids) == 3 and te.decode_steps == 3
    assert te.has_unfinished()  # the trailing step is still pending
    assert te.step() == [] and not te.has_unfinished()
    sync = _torch_engine(tp, max_num_seqs=1, device_resident=False)
    assert sync.generate([5, 6], SamplingParams(max_tokens=3)).token_ids == out3[0].token_ids
    assert sync.decode_steps == 2


def test_abort_with_a_step_in_flight(params):
    """An abort between a dispatch and its drain: the in-flight token is
    never emitted, the lane points at the trash page at once, and the
    freed pages go to the next admission while the sequence still running
    decodes as it would alone."""
    _, tp = params
    te = _torch_engine(tp, num_pages=32)
    prompts = _prompts()[:3]
    ids = [te.add_request(p, SamplingParams(max_tokens=12)) for p in prompts[:2]]
    for _ in range(3):
        te.step()
    assert te._pending is not None
    n_before = len(te._requests[ids[0]].token_ids)
    assert te.abort_request(ids[0])
    assert te._dtables[0].tolist() == [0] * te._pcfg.max_pages_per_seq and int(te._dlengths[0]) == 0
    late = te.add_request(prompts[2], SamplingParams(max_tokens=12))
    finals = {}
    while te.has_unfinished():
        for o in te.step():
            if o.finished:
                finals[o.request_id] = o
    assert finals[ids[0]].finish_reason == "aborted" and len(finals[ids[0]].token_ids) == n_before
    alone = _torch_engine(tp, num_pages=32).generate([prompts[1], prompts[2]], SamplingParams(max_tokens=12))
    assert [finals[ids[1]].token_ids, finals[late].token_ids] == [o.token_ids for o in alone]
    assert _drained(te)


def test_moved_pool_raises_instead_of_decoding(params):
    """The decode step reads the pool and the weights where it was built
    (on the card, where its graph recorded them): a pool tensor replaced
    behind its back makes the next step raise, on the host as on the card."""
    _, tp = params
    te = _torch_engine(tp)
    te.add_request(_prompts()[0], SamplingParams(max_tokens=8))
    te.step()
    te.pool["k"] = te.pool["k"].clone()
    with pytest.raises(RuntimeError, match="pool/k"):
        te.step()
