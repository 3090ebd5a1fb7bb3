"""Live request migration in the port (``ray_tpu_torch/llm/migrate.py``
and the engine's ``checkpoint_request``/``finish_migrated``/
``restore_request``), on the CPU.

- The oracle matrix of tests/test_llm_migrate.py: a request checkpointed
  mid-decode on one engine and restored on a second emits the stream of
  the never-migrated run, with no token repeated or dropped at the
  splice: layout x cache dtype x greedy/seeded (the seeded lane's
  ADVANCED key rides the checkpoint), spec n-gram on both layouts (its
  controller state migrating), paged int8 with spec, cross-layout, and
  the synchronous engine.
- Across packages: a ray_tpu checkpoint restored on the port, and a port
  checkpoint restored on ray_tpu, continue ray_tpu's uninterrupted
  stream, greedy and seeded, on both layouts: the keys and the wire.
- The cold checkpoint of a waiting request, the refusals, the wire
  validation and the geometry guard, with ray_tpu's error classes,
  status codes and retryable flags; the codec against ray_tpu's on the
  same state; the migration counters.

Engines are LlamaConfig.tiny in f32, 2 slots, max_seq_len 128, on weights
converted from ray_tpu's; ray_tpu's engines have every program settled."""

import copy
import itertools
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import migrate as jmig  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch.core import direct  # noqa: E402
from ray_tpu_torch.core.ids import ObjectID  # noqa: E402
from ray_tpu_torch.core.object_ref import ObjectRef  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams, SpecConfig  # noqa: E402
from ray_tpu_torch.llm import migrate as tmig  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
ENG = dict(max_num_seqs=2, max_seq_len=128)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell", "_extract_slots", "_extract_paged", "_scatter_slots",
           "_scatter_paged")
RNG = np.random.default_rng(17)
PROMPT = [int(x) for x in RNG.integers(1, 511, size=24)]
GREEDY = dict(max_tokens=14)
SEEDED = dict(max_tokens=14, temperature=0.8, seed=7, top_k=20)
SAMPLING = pytest.mark.parametrize("sp", [GREEDY, SEEDED], ids=["greedy", "seeded"])
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


def jax_engine(jp, **kw):
    je = JaxEngine(jllama.LlamaConfig.tiny(**KW), jp, telemetry=False, **{**ENG, **kw})
    for name in SETTLED:
        if hasattr(je, name):
            setattr(je, name, _synced(getattr(je, name)))
    return je


def mk(tp, layout="slots", dtype=None, spec=False, **kw):
    """A port engine on the host with a replica tag of its own."""
    if spec:
        kw.setdefault("speculative", SpecConfig(k=3))
    kw.setdefault("telemetry_tags", {"replica": f"m{next(_REPLICAS)}"})
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", kv_layout=layout, cache_dtype=dtype,
                     **{**ENG, **kw})


def run_until(eng, rid, n_tokens, budget=500):
    """Step until the request has emitted >= n_tokens (host view)."""
    for _ in range(budget):
        with eng._lock:
            st = eng._requests.get(rid)
            done = st is None or st.finished or len(st.token_ids) >= n_tokens
        if done:
            return
        eng.step()
    raise AssertionError(f"request never reached {n_tokens} tokens")


def finish(eng, rid):
    toks = None
    while eng.has_unfinished():
        for o in eng.step():
            if o.request_id == rid and o.finished:
                toks = list(o.token_ids)
    assert toks is not None, "request drained without finishing"
    return toks


def migrate_mid_decode(tp, sp, layout, dtype, spec, cut=6, wire=True, dst_layout=None, **kw):
    """Checkpoint at ``cut`` emitted tokens, restore on a fresh engine:
    (the never-migrated stream, the tokens before the splice, the
    restored stream, the source engine)."""
    want = mk(tp, dst_layout or layout, dtype, spec, **kw).generate(list(PROMPT), SamplingParams(**sp)).token_ids
    src = mk(tp, layout, dtype, spec, **kw)
    rid = src.add_request(list(PROMPT), SamplingParams(**sp))
    run_until(src, rid, cut)
    state = src.checkpoint_request(rid)
    pre = list(src._requests[rid].token_ids)
    assert state["emitted_token_ids"] == pre
    assert src.finish_migrated(rid) and src._requests[rid].finish_reason == "migrated"
    if wire:
        state = tmig.decode(tmig.encode(state))
    dst = mk(tp, dst_layout or layout, dtype, spec, **kw)
    return list(want), pre, finish(dst, dst.restore_request(state)), src


def check_splice(want, pre, toks):
    assert toks == want
    assert toks[: len(pre)] == pre  # nothing re-emitted or dropped
    assert len(pre) < len(toks)  # the splice continued


# -------------------------------------------------------------- the oracle
@SAMPLING
@pytest.mark.parametrize("dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_migration_oracle(params, layout, dtype, sp):
    want, pre, toks, src = migrate_mid_decode(params[1], sp, layout, dtype, spec=False)
    check_splice(want, pre, toks)
    if layout == "paged":  # the source's pages went back to its pool
        assert src._page_alloc.free_pages == src._pcfg.num_pages - 1


@pytest.mark.parametrize("layout,dtype", [("slots", None), ("paged", None), ("paged", "int8")])
def test_migration_oracle_spec_ngram(params, layout, dtype):
    """Greedy (spec's lossless regime) with the n-gram drafter: the history
    lane rebuilds from prompt + emitted and the controller state rides."""
    want, pre, toks, _ = migrate_mid_decode(params[1], GREEDY, layout, dtype, spec=True)
    check_splice(want, pre, toks)


@pytest.mark.parametrize("src_layout,dst_layout", [("slots", "paged"), ("paged", "slots")])
def test_cross_layout_migration(params, src_layout, dst_layout):
    want, pre, toks, _ = migrate_mid_decode(params[1], GREEDY, src_layout, None, spec=False, dst_layout=dst_layout)
    check_splice(want, pre, toks)


@SAMPLING
def test_sync_engine_migration(params, sp):
    """The synchronous loop checkpoints its host key and restores into the
    same stream as the device-resident loop."""
    want, pre, toks, _ = migrate_mid_decode(params[1], sp, "paged", None, spec=False, wire=False,
                                            device_resident=False)
    check_splice(want, pre, toks)


def test_spec_controller_state_migrates(params):
    src = mk(params[1], spec=True)
    rid = src.add_request(list(PROMPT), SamplingParams(**GREEDY))
    run_until(src, rid, 6)
    src._controller._state[rid] = [0.625, 2]
    state = tmig.decode(tmig.encode(src.checkpoint_request(rid)))
    exp = src._controller.export(rid)
    assert state["spec"] == {"ema": exp[0], "k": exp[1]} and state["spec"]["k"] == 2
    dst = mk(params[1], spec=True)
    rid2 = dst.restore_request(state)
    run_until(dst, rid2, len(state["emitted_token_ids"]) + 1)
    exp = dst._controller.export(rid2)
    assert exp is not None and 1 <= exp[1] <= 3


# --------------------------------------------------------- across packages
def to_numpy_state(state: dict) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_checkpoints_cross_packages_continue_ray_tpus_stream(params, layout):
    """ray_tpu's checkpoint restored on the port, and the port's on
    ray_tpu, each through the other's codec, continue ray_tpu's
    uninterrupted stream token for token, greedy and seeded: the uint32
    wire key converts into the port's int64 lane words and back."""
    jp, tp = params
    je = jax_engine(jp, kv_layout=layout)
    for sp in (GREEDY, SEEDED):
        want = list(je.generate(list(PROMPT), JaxParams(**sp)).token_ids)
        # ray_tpu -> port
        rid = je.add_request(list(PROMPT), JaxParams(**sp))
        run_until(je, rid, 6)
        jstate = je.checkpoint_request(rid)
        je.finish_migrated(rid)
        while je.has_unfinished():
            je.step()
        assert jstate["rng_key"].dtype == np.uint32
        tstate = tmig.decode(tmig.encode(jmig.decode(jmig.encode(jstate))))
        dst = mk(tp, layout)
        got = finish(dst, dst.restore_request(tstate))
        check_splice(want, jstate["emitted_token_ids"], got)
        # port -> ray_tpu
        src = mk(tp, layout)
        rid = src.add_request(list(PROMPT), SamplingParams(**sp))
        run_until(src, rid, 6)
        tstate = src.checkpoint_request(rid)
        assert tstate["rng_key"].dtype == np.uint32
        jstate = jmig.decode(jmig.encode(to_numpy_state(tmig.decode(tmig.encode(tstate)))))
        rev = finish(je, je.restore_request(jstate))
        check_splice(want, tstate["emitted_token_ids"], rev)


def test_codec_matches_ray_tpu(params):
    """The same checkpoint through both codecs: the same wire keys and
    live block, the same decoded state and meta."""
    src = mk(params[1], "paged", "int8")
    rid = src.add_request(list(PROMPT), SamplingParams(**SEEDED))
    run_until(src, rid, 5)
    tstate = src.checkpoint_request(rid)
    jstate = to_numpy_state(tstate)
    tw, jw = tmig.encode(tstate), jmig.encode(jstate)
    assert set(tw) == set(jw) and tw["live"].keys() == jw["live"].keys()
    assert {k: v for k, v in tw["live"].items() if k != "rng_key"} == \
           {k: v for k, v in jw["live"].items() if k != "rng_key"}
    np.testing.assert_array_equal(tw["live"]["rng_key"], jw["live"]["rng_key"])
    assert tmig.meta_of(tstate) == jmig.meta_of(jstate)
    assert tmig.state_nbytes(tstate) == jmig.state_nbytes(jstate) > 0
    td, jd = tmig.decode(tw), jmig.decode(jw)
    assert set(td) == set(jd)
    for name in jd:
        if isinstance(jd[name], np.ndarray) and name != "rng_key":
            np.testing.assert_array_equal(td[name].numpy(), jd[name])
        elif name != "rng_key":
            assert td[name] == jd[name], name


# -------------------------------------------------------- cold checkpoints
def test_cold_checkpoint_waiting_request(params):
    tp = params[1]
    want = list(mk(tp).generate(list(PROMPT), SamplingParams(**GREEDY)).token_ids)
    src = mk(tp, max_num_seqs=1)
    src.add_request([int(x) for x in RNG.integers(1, 511, size=16)], SamplingParams(max_tokens=32))
    src.step()  # the blocker holds the one slot
    rid = src.add_request(list(PROMPT), SamplingParams(**GREEDY))
    state = src.checkpoint_request(rid)
    assert state.get("k") is None and state["emitted_token_ids"] == []
    assert tmig.meta_of(state)["hot"] is False and tmig.state_nbytes(state) == 0
    state = tmig.decode(tmig.encode(state))
    dst = mk(tp)
    assert finish(dst, dst.restore_request(state)) == want


def test_cold_checkpoint_sampled_with_tokens_refuses(params):
    src = mk(params[1], "paged", max_num_seqs=2, num_pages=11, page_size=16)
    r0 = src.add_request(list(PROMPT), SamplingParams(max_tokens=100, temperature=0.7, seed=3))
    r1 = src.add_request(list(PROMPT[:16]), SamplingParams(max_tokens=100, temperature=0.7, seed=4))
    preempted = []
    for _ in range(200):
        src.step()
        with src._lock:
            preempted = [rid for rid in (r0, r1) if (st := src._requests.get(rid)) is not None
                         and not st.finished and st.slot < 0 and st.token_ids]
        if preempted:
            break
    assert preempted, "pool pressure never preempted a sampled request"
    with pytest.raises(tmig.MigrationError):
        src.checkpoint_request(preempted[0])


# --------------------------------------------------------------- refusals
def _status(exc):
    return exc.status_code, exc.retryable


def test_error_classes_match_ray_tpu():
    for name in ("MigrationError", "MigrationLostError", "RequestMigratedError"):
        assert _status(getattr(tmig, name)) == _status(getattr(jmig, name)), name
    assert _status(tmig.MigrationError) == (500, False) and _status(tmig.MigrationLostError) == (503, True)
    err = tmig.RequestMigratedError("r1", {"nbytes": 4, "emitted": 2}, ref="ref")
    assert tmig.migration_of(err) == ("r1", {"nbytes": 4, "emitted": 2}, "ref")
    assert tmig.migration_lost(tmig.MigrationLostError("gone")) and not tmig.migration_lost(ValueError("x"))


def test_checkpoint_refuses_untransferable_state(params):
    src = mk(params[1])
    with pytest.raises(tmig.MigrationError) as e:
        src.checkpoint_request("nope")
    assert _status(e.value) == (500, False)
    rid = src.add_request(list(PROMPT), SamplingParams(**GREEDY))
    run_until(src, rid, 2)
    out_rid = src.add_prefill_request(list(PROMPT[:8]))
    with pytest.raises(tmig.MigrationError):  # prefill-only
        src.checkpoint_request(out_rid)
    s_rid = src.add_request(list(PROMPT[:8]), SamplingParams(max_tokens=4), stream=True)
    with pytest.raises(tmig.MigrationError):  # streaming consumer
        src.checkpoint_request(s_rid)
    src.abort_request(rid)
    with pytest.raises(tmig.MigrationError):  # finished
        src.checkpoint_request(rid)
    assert src.finish_migrated(rid) is False
    # a reference this process neither owns nor has an owner hint for goes
    # to the head: with no runtime that raises, naming init(); with one up,
    # the head answers that the object was freed, which the bounded retry
    # turns into MigrationLostError
    with pytest.raises(RuntimeError, match=r"call ray_tpu_torch.init\(\) first"):
        src.restore_request(ObjectRef(ObjectID.from_put()))
    import ray_tpu_torch as rtt

    rt = rtt.init(num_cpus=1, _system_config={"prestart_workers": False})
    try:
        gone = rtt.put({"k": torch.ones(50000)}).id  # the head's store; its last reference dies here
        deadline = time.monotonic() + 10
        while gone not in rt._freed_set and time.monotonic() < deadline:
            time.sleep(0.02)
        with pytest.raises(tmig.MigrationLostError):
            src.restore_request(ObjectRef(gone))
    finally:
        rtt.shutdown()


CORRUPTIONS = {
    "kind": lambda w: w.update(kind="kv_handoff"),
    "version": lambda w: w["live"].update(version=99),
    "truncated_block": lambda w: w.update(k=w["k"][:, :-1]),
    "dtype": lambda w: w.update(dtype="int8"),
    "emitted_dropped": lambda w: w["live"].update(emitted_token_ids=w["live"]["emitted_token_ids"][:-2]),
    "no_key": lambda w: w["live"].pop("rng_key"),
    "f32_key": lambda w: w["live"].update(rng_key=np.zeros(2, np.float32)),
    "sampling": lambda w: w["live"].update(sampling={}),
    "coverage": lambda w: w["live"].update(n_prompt=5),
}


@pytest.fixture(scope="module")
def good_wires(params):
    """One checkpoint's wire dict from each package (the same request)."""
    jp, tp = params
    src = mk(tp)
    rid = src.add_request(list(PROMPT), SamplingParams(**GREEDY))
    run_until(src, rid, 5)
    state = src.checkpoint_request(rid)
    return tmig.encode(state), jmig.encode(to_numpy_state(state))


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_wire_validation_refuses_what_ray_tpu_refuses(good_wires, name):
    tw, jw = good_wires
    tmig.decode(tw)
    jmig.decode(jw)
    tbad, jbad = copy.deepcopy(tw), copy.deepcopy(jw)
    CORRUPTIONS[name](tbad)
    CORRUPTIONS[name](jbad)
    with pytest.raises(jmig.MigrationError) as je:
        jmig.decode(jbad)
    with pytest.raises(tmig.MigrationError) as te:
        tmig.decode(tbad)
    assert _status(te.value) == _status(je.value) == (500, False)


def test_int8_wire_scale_validation_and_geometry_guard(params):
    src = mk(params[1], dtype="int8")
    rid = src.add_request(list(PROMPT), SamplingParams(**GREEDY))
    run_until(src, rid, 5)
    wire = tmig.encode(src.checkpoint_request(rid))
    bad = copy.deepcopy(wire)
    del bad["k_scale"]
    with pytest.raises(tmig.MigrationError):
        tmig.decode(bad)
    bad = copy.deepcopy(wire)
    bad["k_scale"] = bad["k_scale"].double()
    with pytest.raises(tmig.MigrationError):
        tmig.decode(bad)
    # a block wider than the consumer's row, and a pool too small for it
    with pytest.raises(tmig.MigrationError):
        mk(params[1], max_seq_len=32, prefill_buckets=(32,)).restore_request(tmig.decode(wire))
    with pytest.raises(tmig.MigrationError):
        mk(params[1], "paged", page_size=16, num_pages=3).restore_request(tmig.decode(wire))


def test_publish_and_fetch_over_the_object_plane(params):
    """migrate.publish stores the checkpoint as an owned object of this
    process; fetch returns the state field for field (ray_tpu's meta), and
    restore_request of the reference continues the stream; a freed
    checkpoint is MigrationLostError (503, retryable) after the retries."""
    src = mk(params[1])
    want = list(src.generate(list(PROMPT), SamplingParams(**SEEDED)).token_ids)
    rid = src.add_request(list(PROMPT), SamplingParams(**SEEDED))
    run_until(src, rid, 5)
    state = src.checkpoint_request(rid)
    src.finish_migrated(rid)
    st = direct.attach(b"migrate-test-key")
    try:
        meta, ref = tmig.publish(state)
        assert meta == jmig.meta_of(to_numpy_state(state)) and st.owned.size() == 1
        got = tmig.fetch(ref, meta)
        assert set(got) == set(state)
        for k, v in state.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), k
            else:
                assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k
        dst = mk(params[1])
        new_rid = dst.restore_request(ref)
        assert finish(dst, new_rid) == want
        direct.free_owned([ref.id])
        with pytest.raises(tmig.MigrationLostError) as e:
            tmig.fetch(ref, retries=1, retry_wait_s=0.01)
        assert (type(e.value).status_code, type(e.value).retryable) == (503, True)
    finally:
        direct.detach()


# --------------------------------------------------------------- telemetry
def _count(eng, name, **tags):
    m = eng._tel.m[name]
    return m._series.get(m._key({**eng._tel.tags, **tags}), 0.0)


def test_migration_counters_and_splice(params):
    """on_migration counts "checkpointed" on the source and "restored" on
    the peer with the block's bytes; the source records reason
    "migrated"; the peer's first post-splice token lands in the splice
    histogram."""
    tp = params[1]
    src = mk(tp)
    rid = src.add_request(list(PROMPT), SamplingParams(**GREEDY))
    run_until(src, rid, 5)
    state = src.checkpoint_request(rid)
    src.finish_migrated(rid)
    nbytes = tmig.state_nbytes(state)
    assert nbytes == 2 * 2 * 64 * 2 * 32 * 4  # k + v, [2, 64, 2, 32] f32 at the 64 bucket
    assert _count(src, "rt_llm_migrations_total", outcome="checkpointed") == 1
    assert _count(src, "rt_llm_migration_bytes_total") == nbytes
    assert "migrated" in [r["reason"] for r in src.telemetry()["requests"]]
    dst = mk(tp)
    finish(dst, dst.restore_request(state))
    assert _count(dst, "rt_llm_migrations_total", outcome="restored") == 1
    assert _count(dst, "rt_llm_migration_bytes_total") == nbytes
    splice = dst._tel.m["rt_llm_migration_splice_s"]
    assert splice._series[splice._key(dst._tel.tags)][0] == 1  # [count, sum, buckets...]: one observation
