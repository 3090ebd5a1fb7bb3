"""The port's LLMEngine against ray_tpu's on the same weights: greedy
generation token-identical under the paged schedule that preempts (3
slots, 8 pages of 16, 6 prompts of 8-40 tokens, 40 new tokens each),
with equal preemption counts and prefix caching off on both sides
(tests/test_torch_prefix_cache.py holds it on). Plus abort, the device rule and the
features this slice does not port."""

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
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
SCHED = dict(max_num_seqs=3, max_seq_len=128, page_size=16, prefill_buckets=(32, 64, 128), num_pages=8, seed=5)


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


def _torch_engine(tp, **kw):
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", **{**SCHED, **kw})


@pytest.mark.parametrize("batch_prefill", [True, False], ids=["batched_prefill", "one_prefill_each"])
def test_generate_token_identical_to_ray_tpu_under_preemption(params, batch_prefill):
    jp, tp = params
    je = JaxEngine(jllama.LlamaConfig.tiny(**KW), jp, kv_layout="paged", enable_prefix_caching=False,
                   device_resident=False, telemetry=False, batch_prefill=batch_prefill, **SCHED)
    for name in ("_prefill", "_insert", "_decode", "_extend"):
        setattr(je, name, _synced(getattr(je, name)))
    ref = je.generate(_prompts(), JaxParams(max_tokens=40))
    te = _torch_engine(tp, batch_prefill=batch_prefill, enable_prefix_caching=False)
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
    "kw",
    [
        dict(kv_layout="slots"),
        dict(device_resident=True),
        dict(cache_dtype="int8"),
        dict(telemetry=True),
        dict(speculative=object()),
        dict(mesh=object()),
    ],
    ids=["slots", "device_resident", "int8", "telemetry", "speculative", "mesh"],
)
def test_unported_features_raise_naming_roadmap(params, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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
