"""Suspend and resume in the port (the engine's ``suspend_request``,
``resume_suspended``, ``suspended_requests``, ``drop_suspended`` and
``suspend_stats``), on the CPU: the conversation tier of
tests/test_llm_kv_tiering.py without its object-plane tier.

- The suspend/resume matrix: an idle conversation spilled to host memory
  and scattered back in under its ORIGINAL request id emits the stream of
  the never-suspended run with no token recomputed or emitted again,
  across layout x cache dtype x greedy/seeded; the spilled bytes are the
  checkpoint's; its pages return at suspend.
- A resume racing a concurrent admission into the freed slot.
- Refusals (typed MigrationError, the conversation untouched) and drop.
- The object-plane tier: ``"published": False`` with no plane attached
  (the host copy kept, the failed publish counted); with a plane, the
  state published, restored from its reference on another engine, and
  fetched back by ``resume_suspended`` when the host copy is gone.
- ``on_kv_spill``'s byte counter.

The port's streams are held against ray_tpu's engine on the same weights
(the never-suspended run), and its suspend/resume against that run."""

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.llm import migrate as tmig  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
ENG = dict(max_num_seqs=2, max_seq_len=128)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell")
RNG = np.random.default_rng(23)
PROMPT = [int(x) for x in RNG.integers(1, 511, size=24)]
PROMPT_B = [int(x) for x in RNG.integers(1, 511, size=24)]
GREEDY = dict(max_tokens=14)
SEEDED = dict(max_tokens=14, temperature=0.8, seed=7, top_k=20)
_REPLICAS = itertools.count()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's tiny models."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _synced(fn):
    """One ray_tpu program with its inputs and outputs settled."""

    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


@pytest.fixture(scope="module")
def oracle(params):
    """ray_tpu's never-suspended streams of PROMPT and PROMPT_B, per layout
    and cache dtype, greedy and seeded (computed once, on demand)."""
    engines, streams = {}, {}

    def get(layout, dtype, sp, prompt=PROMPT):
        key = (layout, dtype, tuple(sorted(sp.items())), tuple(prompt))
        if key not in streams:
            je = engines.get((layout, dtype))
            if je is None:  # one engine per layout and dtype: the seeded lane's key comes from its seed
                je = engines[layout, dtype] = JaxEngine(jllama.LlamaConfig.tiny(**KW), params[0], telemetry=False,
                                                        kv_layout=layout, cache_dtype=dtype, **ENG)
                for name in SETTLED:
                    if hasattr(je, name):
                        setattr(je, name, _synced(getattr(je, name)))
            streams[key] = list(je.generate(list(prompt), JaxParams(**sp)).token_ids)
        return streams[key]

    return get


def mk(tp, layout="slots", dtype=None, **kw):
    kw.setdefault("telemetry_tags", {"replica": f"t{next(_REPLICAS)}"})
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", kv_layout=layout, cache_dtype=dtype,
                     **{**ENG, **kw})


def run_until(eng, rid, n_tokens, budget=500):
    for _ in range(budget):
        with eng._lock:
            st = eng._requests.get(rid)
            done = st is None or st.finished or len(st.token_ids) >= n_tokens
        if done:
            return
        eng.step()
    raise AssertionError(f"request never reached {n_tokens} tokens")


def drain(eng, rid):
    """The request's FINAL stream (a suspend's transient finished report
    skipped)."""
    out = None
    while eng.has_unfinished():
        for o in eng.step():
            if o.request_id == rid and o.finished and o.finish_reason != "suspended":
                out = o
    assert out is not None, "request drained without finishing"
    return list(out.token_ids)


@pytest.mark.parametrize("dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_suspend_resume_matrix(params, oracle, layout, dtype):
    eng = mk(params[1], layout, dtype)
    for sp in (GREEDY, SEEDED):
        want = oracle(layout, dtype, sp)
        rid = eng.add_request(list(PROMPT), SamplingParams(**sp))
        run_until(eng, rid, 6)
        pre = list(eng._requests[rid].token_ids)
        info = eng.suspend_request(rid)  # publish=True, ray_tpu's default
        assert info == {"request_id": rid, "nbytes": tmig.state_nbytes(eng._suspended[rid]["state"]),
                        "published": False}
        assert info["nbytes"] > 0 and eng._requests[rid].finish_reason == "suspended"
        assert eng.suspended_requests() == [rid] and not eng.has_unfinished()
        if layout == "paged":  # its pages returned at suspend
            assert eng.kv_cache_stats()["pages_free"] == eng._pcfg.num_pages - 1
        assert eng.resume_suspended(rid) == rid
        toks = drain(eng, rid)
        assert toks == want, f"{layout}/{dtype}/{sp}"
        assert toks[: len(pre)] == pre and len(pre) < len(toks)
    stats = eng.suspend_stats()
    assert (stats["suspended"], stats["resumed"], stats["held"], stats["dropped"]) == (2, 2, 0, 0)
    assert stats["spilled_bytes"] > 0
    m = eng._tel.m["rt_llm_kv_spilled_bytes_total"]
    assert m._series[m._key(eng._tel.tags)] == stats["spilled_bytes"]


def test_resume_races_concurrent_admission(params, oracle):
    """Resume while a fresh request takes the freed slot: both finish, the
    resumed stream equal to its never-suspended run."""
    eng = mk(params[1], max_num_seqs=1)
    rid1 = eng.add_request(list(PROMPT), SamplingParams(**GREEDY))
    run_until(eng, rid1, 5)
    pre = list(eng._requests[rid1].token_ids)
    eng.suspend_request(rid1, publish=False)
    rid2 = eng.add_request(list(PROMPT_B), SamplingParams(**GREEDY))
    eng.step()  # the admission wave claims the freed slot while rid1 is spilled
    assert eng.resume_suspended(rid1) == rid1
    outs = {}
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished and o.finish_reason != "suspended":
                outs[o.request_id] = list(o.token_ids)
    assert outs[rid1] == oracle("slots", None, GREEDY) and outs[rid1][: len(pre)] == pre
    assert outs[rid2] == oracle("slots", None, GREEDY, PROMPT_B)


def test_suspend_refusals_and_drop(params):
    eng = mk(params[1])
    with pytest.raises(tmig.MigrationError) as e:
        eng.suspend_request("nope")
    assert (e.value.status_code, e.value.retryable) == (500, False)
    with pytest.raises(tmig.MigrationError):
        eng.resume_suspended("nope")
    out = eng.generate(list(PROMPT), SamplingParams(**GREEDY))
    with pytest.raises(tmig.MigrationError):  # finished
        eng.suspend_request(out.request_id)
    s_rid = eng.add_request(list(PROMPT_B), SamplingParams(max_tokens=4), stream=True)
    with pytest.raises(tmig.MigrationError):  # streaming: refused, still running
        eng.suspend_request(s_rid)
    assert not eng._requests[s_rid].finished and eng.suspend_stats()["suspended"] == 0
    while eng.has_unfinished():
        eng.step()
    rid = eng.add_request(list(PROMPT_B), SamplingParams(**GREEDY))
    run_until(eng, rid, 3)
    eng.suspend_request(rid, publish=False)
    assert eng.drop_suspended(rid) is True and eng.drop_suspended(rid) is False
    assert eng.suspend_stats()["dropped"] == 1 and eng.suspended_requests() == []
    with pytest.raises(tmig.MigrationError):  # the record is gone
        eng.resume_suspended(rid)


def test_refused_resume_keeps_the_record(params):
    """A resume into an engine that refuses the state leaves the record
    claimable."""
    eng = mk(params[1])
    rid = eng.add_request(list(PROMPT), SamplingParams(**GREEDY))
    run_until(eng, rid, 4)
    eng.suspend_request(rid)
    rec = eng._suspended[rid]
    rec["state"]["sampling"]["max_tokens"] = 10_000  # no longer fits max_seq_len
    with pytest.raises(tmig.MigrationError):
        eng.resume_suspended(rid)
    assert eng.suspended_requests() == [rid] and eng.suspend_stats()["resumed"] == 0


def test_object_plane_leg(params, oracle):
    """The object-plane tier: without a plane attached, a publish=True
    suspend keeps only the host copy ("published": False, counted in
    suspend_publish_errors); with one, the state is also published, a
    second engine restores the conversation from the reference and
    continues ray_tpu's never-suspended stream, and with the host copy
    gone resume_suspended fetches the plane copy."""
    from ray_tpu_torch.core import direct

    want = oracle("slots", None, SEEDED)
    eng = mk(params[1])
    rid = eng.add_request(list(PROMPT), SamplingParams(**SEEDED))
    run_until(eng, rid, 3)
    assert eng.suspend_request(rid, publish=True)["published"] is False
    assert eng._suspended[rid]["ref"] is None and eng.suspend_publish_errors == 1
    eng.resume_suspended(rid)
    assert drain(eng, rid) == want
    st = direct.attach(b"tiering-test-key")
    try:
        for source in ("reference", "plane fallback"):
            eng = mk(params[1])
            rid = eng.add_request(list(PROMPT), SamplingParams(**SEEDED))
            run_until(eng, rid, 5)
            info = eng.suspend_request(rid)
            rec = eng._suspended[rid]
            assert info["published"] is True and rec["meta"] == tmig.meta_of(rec["state"])
            assert st.owned.size() == 1 and eng.suspend_publish_errors == 0
            if source == "reference":
                peer = mk(params[1])
                new_rid = peer.restore_request(rec["ref"])
                assert drain(peer, new_rid) == want
                assert eng.drop_suspended(rid)
            else:
                rec["state"] = None  # the host copy gone: the plane copy serves
                assert eng.resume_suspended(rid) == rid
                assert drain(eng, rid) == want
            del rec
            direct.free_owned([k for k in list(st.owned._objects)])
    finally:
        direct.detach()
