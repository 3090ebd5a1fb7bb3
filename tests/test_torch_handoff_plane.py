"""The publish and fetch legs of handoff, migration and suspend over the
port's object plane (``handoff.publish``/``fetch``, ``migrate.publish``/
``fetch``, ``LLMEngine.restore_request`` of a reference, the plane tier
of ``suspend_request``/``resume_suspended``), on the CPU.

- ``handoff.publish`` -> ``fetch`` of a numpy-made KV dict equals
  ray_tpu's ``handoff.decode(encode(kv))`` field for field, f32 and int8
  (with scales), for all three kinds (kv_handoff, kv_prefix, live_state).
  ray_tpu's ``publish`` needs its runtime (``ray_tpu.init``), so its codec
  is the oracle.
- The bounded retry: HandoffLostError after the budget, with one chaos hit
  per attempt at ``handoff.fetch``; a dropped ``handoff.put``; a fetch
  that loses its first attempt and lands on the retry.
- ``migrate.publish``/``fetch`` of a port checkpoint equal ray_tpu's codec
  on the same state.
- ``restore_request(ref)`` and a suspend that publishes, resumed from the
  plane on another engine or in place with the host copy gone: the
  streams equal the uninterrupted run's and ray_tpu's on the same prompt
  and weights, both layouts, greedy and seeded.
- A borrower in a fresh process (``subprocess``, bounded) attaches the
  plane with the owner's authkey, fetches a published handoff, admits it
  into its own engine and generates the in-process stream token for
  token; the owner frees the handoff after the borrower releases it.

Engines are LlamaConfig.tiny in f32, 2 slots, max_seq_len 128, on weights
converted from ray_tpu's; ray_tpu's engines have every program settled.
Every test that attaches a plane detaches it in a ``finally``."""

import itertools
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import migrate as jmig  # noqa: E402
from ray_tpu.llm.disagg import handoff as jhandoff  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch import _config as tconfig  # noqa: E402
from ray_tpu_torch import chaos as tchaos  # noqa: E402
from ray_tpu_torch.core import direct  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.llm import migrate as tmig  # noqa: E402
from ray_tpu_torch.llm.disagg import handoff as thandoff  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
KW = dict(dtype="float32", remat=False, max_seq_len=256)
ENG = dict(max_num_seqs=2, max_seq_len=128)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell", "_extract_slots", "_extract_paged", "_scatter_slots",
           "_scatter_paged")
RNG = np.random.default_rng(29)
PROMPT = [int(x) for x in RNG.integers(1, 511, size=40)]
GREEDY = dict(max_tokens=12)
SEEDED = dict(max_tokens=12, temperature=0.8, seed=3, top_k=20)
KEY = b"handoff-plane-test-key"
CHILD_S = 120  # the borrower process's bound
_REPLICAS = itertools.count()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segments() -> set:
    return {n for n in os.listdir("/dev/shm") if n.startswith(f"rt{os.getpid()}_")}


@pytest.fixture(autouse=True)
def _clean():
    """A cleared port chaos plane; no plane left attached and no segment
    the test made left behind."""
    tchaos.clear()
    tchaos.seed(0)
    before = _segments()
    yield
    tchaos.clear()
    direct.detach()
    assert _segments() <= before


@pytest.fixture
def plane(monkeypatch):
    monkeypatch.setenv("RT_OWNED_OBJECT_GRACE_S", "0.05")
    monkeypatch.setenv("RT_REF_COUNTING_INTERVAL_S", "0.02")
    tconfig.reset_config()
    st = direct.attach(KEY)
    try:
        yield st
    finally:
        direct.detach()
        tconfig.reset_config()


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _synced(fn):
    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


@pytest.fixture(scope="module")
def oracle(params):
    """ray_tpu's uninterrupted stream of PROMPT per layout and sampling."""
    streams = {}

    def get(layout, sp):
        key = (layout, tuple(sorted(sp.items())))
        if key not in streams:
            je = JaxEngine(jllama.LlamaConfig.tiny(**KW), params[0], telemetry=False, kv_layout=layout, **ENG)
            for name in SETTLED:
                if hasattr(je, name):
                    setattr(je, name, _synced(getattr(je, name)))
            streams[key] = list(je.generate(list(PROMPT), JaxParams(**sp)).token_ids)
        return streams[key]

    return get


def mk(tp, layout="slots", **kw):
    kw.setdefault("telemetry_tags", {"replica": f"h{next(_REPLICAS)}"})
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", kv_layout=layout, **{**ENG, **kw})


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
    out = None
    while eng.has_unfinished():
        for o in eng.step():
            if o.request_id == rid and o.finished and o.finish_reason not in ("suspended", "migrated"):
                out = o
    assert out is not None, "request drained without finishing"
    return list(out.token_ids)


def _wait(cond, timeout=10.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end and not cond():
        time.sleep(0.01)
    return cond()


# ----------------------------------------------------------------- the codec over the plane
def _kv(dtype: str, kind: str) -> dict:
    """A numpy-made KV payload [L=2, T=512, kv=2, hd=32] (+ int8 scales):
    above the inline threshold, so it travels through a segment."""
    rng = np.random.default_rng(5)
    shape, n = (2, 512, 2, 32), 400
    kv = {"n": n, "prompt_token_ids": [int(t) for t in rng.integers(1, 500, size=n)]}
    if dtype == "int8":
        kv.update(k=rng.integers(-127, 128, size=shape).astype(np.int8),
                  v=rng.integers(-127, 128, size=shape).astype(np.int8),
                  k_scale=(rng.random((2, 2, 512)) * 0.1 + 0.01).astype(np.float32),
                  v_scale=(rng.random((2, 2, 512)) * 0.1 + 0.01).astype(np.float32))
    else:
        kv.update(k=rng.standard_normal(shape).astype(np.float32), v=rng.standard_normal(shape).astype(np.float32))
    if kind == "kv_handoff":
        kv["logits"] = rng.standard_normal(512).astype(np.float32)
    return kv


@pytest.mark.parametrize("kind", ["kv_handoff", "kv_prefix", "live_state"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_publish_fetch_equals_ray_tpus_codec(plane, dtype, kind):
    kv = _kv(dtype, kind)
    wire = thandoff.encode(kv, kind=kind)
    t0 = time.perf_counter()
    ref = direct.put_owned(wire) if kind != "kv_handoff" else None
    meta = thandoff.meta_of(wire)
    if ref is None:
        meta_p, ref = thandoff.publish(kv)
        assert meta_p == meta
    assert meta == jhandoff.meta_of(jhandoff.encode(kv, kind=kind))
    assert plane.owned.entry(ref.id.binary()).payload.shm is not None
    got = thandoff.fetch(ref, meta, kind=kind)
    want = jhandoff.decode(jhandoff.encode(kv, kind=kind), kind=kind)
    assert set(got) == set(want) and time.perf_counter() - t0 < 30
    for name, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[name].dtype == torch.from_numpy(w).dtype and np.array_equal(got[name].numpy(), w), name
        else:
            assert got[name] == w, name
    # a fetched tensor is the reader's to write: the owner's copy stays
    got["k"].zero_()
    assert np.array_equal(thandoff.fetch(ref, kind=kind)["k"].numpy(), want["k"])
    with pytest.raises(thandoff.HandoffError, match="does not match"):
        thandoff.fetch(ref, dict(meta, shape=(1, 2, 3, 4)), kind=kind)


def test_bounded_retry_and_chaos_legs(plane):
    kv = _kv("float32", "kv_handoff")
    meta, ref = thandoff.publish(kv)
    # one chaos hit per ATTEMPT: the first lost, the retry lands
    rule = tchaos.inject("handoff.fetch", drop_prob=1.0, max_hits=1)
    assert thandoff.fetch(ref, meta, retries=1, retry_wait_s=0.01)["n"] == 400 and rule.hits == 1
    # every attempt lost: HandoffLostError after retries + 1 attempts, never a hang
    rule = tchaos.inject("handoff.fetch", drop_prob=1.0)
    with pytest.raises(thandoff.HandoffLostError, match="3 attempts"):
        thandoff.fetch(ref, meta, retries=2, retry_wait_s=0.01)
    assert rule.hits == 3
    tchaos.clear()
    # the object gone at its owner: the same typed loss (503, retryable)
    direct.free_owned([ref.id])
    with pytest.raises(thandoff.HandoffLostError) as e:
        thandoff.fetch(ref, meta, retries=1, retry_wait_s=0.01)
    assert (type(e.value).status_code, type(e.value).retryable) == (503, True)
    # a dropped publish is the owner-side loss the router absorbs; nothing is stored
    tchaos.inject("handoff.put", drop_prob=1.0)
    with pytest.raises(thandoff.HandoffLostError, match="chaos"):
        thandoff.publish(kv)
    assert plane.owned.size() == 0


def test_migrate_publish_fetch_equals_ray_tpus_codec(plane, params):
    src = mk(params[1], "paged", page_size=16)
    rid = src.add_request(list(PROMPT), SamplingParams(**SEEDED))
    run_until(src, rid, 4)
    state = src.checkpoint_request(rid)
    meta, ref = tmig.publish(state)
    np_state = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    assert meta == jmig.meta_of(np_state)
    got = tmig.fetch(ref, meta)
    want = jmig.decode(jmig.encode(np_state))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, np.ndarray):
            assert np.array_equal(g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g), w), name
        else:
            assert g == w, name
    with pytest.raises(tmig.MigrationError, match="emitted count"):
        tmig.fetch(ref, dict(meta, emitted=99))


# ----------------------------------------------------------------- engines over the plane
@pytest.mark.parametrize("sp", [GREEDY, SEEDED], ids=["greedy", "seeded"])
@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_restore_from_ref_and_resume_from_plane(plane, params, oracle, layout, sp):
    """A checkpoint restored from its reference on a peer, and a suspended
    conversation resumed from the plane copy (its host copy gone), each
    continue ray_tpu's uninterrupted stream."""
    want = oracle(layout, sp)
    kw = dict(page_size=16) if layout == "paged" else {}
    src = mk(params[1], layout, **kw)
    rid = src.add_request(list(PROMPT), SamplingParams(**sp))
    run_until(src, rid, 4)
    meta, ref = tmig.publish(src.checkpoint_request(rid))
    assert src.finish_migrated(rid)
    peer = mk(params[1], layout, **kw)
    assert drain(peer, peer.restore_request(ref)) == want
    rid = src.add_request(list(PROMPT), SamplingParams(**sp))
    run_until(src, rid, 6)
    info = src.suspend_request(rid)
    assert info["published"] is True and src.suspend_publish_errors == 0
    src._suspended[rid]["state"] = None  # only the plane copy is left
    assert src.resume_suspended(rid) == rid
    assert drain(src, rid) == want
    assert src.suspend_stats()["resumed"] == 1
    del ref
    assert _wait(lambda: plane.owned.size() == 0), "the plane copies were never freed"


def test_resume_with_both_tiers_gone_is_migration_lost(plane, params):
    src = mk(params[1])
    rid = src.add_request(list(PROMPT), SamplingParams(**GREEDY))
    run_until(src, rid, 3)
    assert src.suspend_request(rid)["published"] is True
    rec = src._suspended[rid]
    rec["state"] = None
    direct.free_owned([rec["ref"].id])
    with pytest.raises(tmig.MigrationLostError):
        src.resume_suspended(rid)
    assert src.suspend_stats()["dropped"] == 1 and src.suspended_requests() == []


_BORROWER = r"""
import json, pickle, sys, torch
from ray_tpu_torch.core import direct
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm.disagg import handoff
from ray_tpu_torch.models import llama
torch.set_num_threads(1)
key, weights = bytes.fromhex(sys.argv[1]), sys.argv[2]
direct.attach(key)
meta, ref = pickle.loads(sys.stdin.buffer.read())
tp = torch.load(weights, weights_only=True)
eng = LLMEngine(llama.LlamaConfig.tiny(dtype="float32", remat=False, max_seq_len=256), tp, device="cpu",
                max_num_seqs=2, max_seq_len=128, kv_layout="paged", page_size=16)
payload = handoff.fetch(ref, meta)
rid = eng.add_prefilled(payload, SamplingParams(max_tokens=12))
del payload, ref
toks = None
while eng.has_unfinished():
    for o in eng.step():
        if o.request_id == rid and o.finished:
            toks = list(o.token_ids)
direct.detach()
print(json.dumps(toks))
"""


def test_borrower_process_admits_a_published_handoff(plane, params, tmp_path):
    pre = mk(params[1], "paged", page_size=16)
    kv = pre.prefill_handoff(list(PROMPT))
    meta, ref = thandoff.publish(kv)
    k = ref.id.binary()
    want = drain(dec := mk(params[1], "paged", page_size=16),
                 dec.add_prefilled(thandoff.fetch(ref, meta), SamplingParams(max_tokens=12)))
    weights = tmp_path / "tiny.pt"
    torch.save(params[1], weights)
    blob = pickle.dumps((meta, ref))  # the ref leaves the owner: it now waits for the release
    del ref
    out = subprocess.run([sys.executable, "-c", _BORROWER, KEY.hex(), str(weights)], input=blob, cwd=REPO,
                         capture_output=True, timeout=CHILD_S)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    import json

    assert json.loads(out.stdout.decode().strip().splitlines()[-1]) == want
    # the borrower registered and released its borrow: the owner frees the handoff
    assert _wait(lambda: plane.owned.size() == 0), f"entry left: {plane.owned.entry(k)}"
