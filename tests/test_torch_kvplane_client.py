"""The cluster KV plane in the port (``llm/kvplane/client.py::KVPlaneClient``,
``llm/kvplane/quant.py`` and the engine's remote-prefix tier), over the
port's object plane, on the CPU.

- Prefix reuse across replicas: a prefix prefilled on replica A serves a
  completion on replica B as a REMOTE hit (B fetches the block over the
  plane, inserts it and extends the suffix), token-identical to ray_tpu's
  caching-off engine on the same prompt and weights, on both layouts and
  both cache dtypes (an int8 wire for int8 caches); B's next request on
  the same prefix hits its LOCAL tier (the fetched block re-stored and
  republished: both replicas hold it in the index). ray_tpu holds its own
  plane against the same oracle (test_llm_kvplane.py).
- ``publish_min_hits``: a once-seen prefix is not published, the second
  sighting publishes it, a remote fetch republishes at once.
- An evicted remote block: the bounded retry, then a local prefill with
  the same tokens, the loss counted and the dead route dropped.
- A local eviction unregisters the route, then frees the owned block.
- ``CacheAwareRouter`` over two port engines sends a shared-prefix request
  to the holder.
- The publish runs with the engine lock released; the prefetch worker
  adopts the fleet's hot block (and a ``kvplane.prefetch`` drop skips the
  round); the fetch spans reach the flight recorder.
- ``wire_quantize``/``wire_dequantize`` against ray_tpu's op-by-op
  ``kv_quant`` functions (its jitted programs round some scales an ulp
  otherwise, ROADMAP.md queue 3).

Engines are LlamaConfig.tiny in f32 on weights converted from ray_tpu's,
2 slots, max_seq_len 128, 64-token prefix blocks (page 32 on the paged
layout); ray_tpu's engines have every program settled."""

import itertools
import os
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import kv_quant as jkvq  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch import _config as tconfig  # noqa: E402
from ray_tpu_torch import chaos as tchaos  # noqa: E402
from ray_tpu_torch.core import direct  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.llm.disagg import handoff as thandoff  # noqa: E402
from ray_tpu_torch.llm.kvplane import CacheAwareRouter, KVPlaneClient, PrefixIndex, boundary_keys  # noqa: E402
from ray_tpu_torch.llm.kvplane import quant as tquant  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
ENG = dict(max_num_seqs=2, max_seq_len=128)
CFG = tllama.LlamaConfig.tiny(**KW)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell")
RNG = np.random.default_rng(7)
SHARED = [int(x) for x in RNG.integers(1, 500, size=70)]  # >= one 64-token block
SP = dict(max_tokens=6)
_REPLICAS = itertools.count()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def plane(monkeypatch):
    """The real object plane, as ray_tpu's rt fixture gives its tests:
    publish and fetch ride put_owned and get_owned_view."""
    monkeypatch.setenv("RT_OWNED_OBJECT_GRACE_S", "0.05")
    monkeypatch.setenv("RT_REF_COUNTING_INTERVAL_S", "0.02")
    tconfig.reset_config()
    tchaos.clear()
    tchaos.seed(0)
    before = {n for n in os.listdir("/dev/shm") if n.startswith(f"rt{os.getpid()}_")}
    st = direct.attach(b"kvplane-test-key")
    try:
        yield st
    finally:
        tchaos.clear()
        direct.detach()
        tconfig.reset_config()
        assert {n for n in os.listdir("/dev/shm") if n.startswith(f"rt{os.getpid()}_")} <= before


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
    """ray_tpu's caching-off engine's greedy stream of a prompt, per layout
    and cache dtype."""
    engines, streams = {}, {}

    def get(prompt, layout="slots", dtype=None):
        key = (tuple(prompt), layout, dtype)
        if key not in streams:
            je = engines.get((layout, dtype))
            if je is None:
                kw = dict(page_size=32) if layout == "paged" else {}
                je = engines[layout, dtype] = JaxEngine(jllama.LlamaConfig.tiny(**KW), params[0], telemetry=False,
                                                        kv_layout=layout, cache_dtype=dtype,
                                                        enable_prefix_caching=False, **ENG, **kw)
                for name in SETTLED:
                    if hasattr(je, name):
                        setattr(je, name, _synced(getattr(je, name)))
            streams[key] = list(je.generate(list(prompt), JaxParams(**SP)).token_ids)
        return streams[key]

    return get


def mk(tp, plane_client=None, layout="slots", dtype=None, **kw):
    if layout == "paged":
        kw.setdefault("page_size", 32)
    kw.setdefault("telemetry_tags", {"replica": f"k{next(_REPLICAS)}"})
    # a generous fetch deadline: a loaded test host must not turn a remote hit into a local prefill
    kw.setdefault("prefix_fetch_deadline_s", 30.0)
    return LLMEngine(CFG, tp, device="cpu", kv_plane=plane_client, kv_layout=layout, cache_dtype=dtype,
                     **{**ENG, **kw})


def client(idx, rid, **kw):
    """Publish on the first store (publish_min_hits=1), as ray_tpu's tests'
    _client: the policy has its own test."""
    kw.setdefault("publish_min_hits", 1)
    return KVPlaneClient(idx, rid, **kw)


def gen(eng, prompt) -> list:
    return list(eng.generate(list(prompt), SamplingParams(**SP)).token_ids)


def _wait(cond, timeout=10.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end and not cond():
        time.sleep(0.01)
    return cond()


# ----------------------------------------------------------------- reuse across replicas
@pytest.mark.parametrize("dtype", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_cross_replica_prefix_reuse_token_identical(params, oracle, plane, layout, dtype):
    idx = PrefixIndex()
    a = mk(params[1], client(idx, "A"), layout, dtype)
    assert gen(a, SHARED + [5, 6, 7]) == oracle(SHARED + [5, 6, 7], layout, dtype)
    assert a.prefix_cache_stats()["remote"]["published_blocks"] == 1 and idx.stats()["keys"] == 1
    assert plane.owned.size() == 1  # the one published block, owned by this process

    prompt_b = SHARED + [9, 10, 11, 12]
    b = mk(params[1], client(idx, "B"), layout, dtype)
    assert gen(b, prompt_b) == oracle(prompt_b, layout, dtype), f"{layout}/{dtype}: the remote hit's stream"
    s = b.prefix_cache_stats()
    assert s["remote"]["hits"] == 1 and s["remote"]["tokens_saved"] == 64 and s["local"]["hits"] == 0
    assert s["remote"]["fetched_bytes"] > 0 and s["plane"]["fetches"] == 1 and b.extend_forwards == 1
    fp_bytes = 64 * CFG.num_layers * CFG.num_kv_heads * CFG.hd * 2 * 4
    if dtype == "int8":  # the int8 wire: values and scales, about a quarter of the f32 bytes
        assert s["plane"]["wire_dtype"] == "int8" and s["remote"]["fetched_bytes"] < 0.75 * fp_bytes
    # the fetched block was re-stored and republished: the next hit is LOCAL
    prompt_b2 = SHARED + [42, 43]
    assert gen(b, prompt_b2) == oracle(prompt_b2, layout, dtype)
    s2 = b.prefix_cache_stats()
    assert s2["local"]["hits"] == 1 and s2["remote"]["hits"] == 1
    assert idx.stats()["keys"] == 1 and idx.match_replicas(boundary_keys(prompt_b2, 64)).keys() == {"A", "B"}
    # the remote tier's counters have ray_tpu's keys
    assert set(s2["remote"]) == {"hits", "tokens_saved", "fetched_bytes", "lost", "published_blocks",
                                 "published_bytes", "errors", "abandoned", "prefetched_blocks", "prefetched_bytes",
                                 "prefetch_hits", "inflight_fetches"}
    # the fetch span reached the flight recorder (on_prefix_fetch)
    fetches = b._tel.recorder.snapshot()["fetches"]
    assert [(f["tokens"], f["hit"]) for f in fetches] == [(64, True)] and fetches[0]["t1"] >= fetches[0]["t0"]
    for c in (a._kv_plane, b._kv_plane):
        c.shutdown()
    assert _wait(lambda: plane.owned.size() == 0)


def test_publish_min_hits_policy(params, plane):
    idx = PrefixIndex()
    a = mk(params[1], KVPlaneClient(idx, "A"))  # the default policy: min_hits=2
    gen(a, SHARED + [5, 6])  # the store mints the 64 boundary: seen once
    s = a.prefix_cache_stats()
    assert idx.stats()["keys"] == 0 and s["plane"]["published_skipped"] == 1 and s["plane"]["published_blocks"] == 0
    assert plane.owned.size() == 0
    gen(a, SHARED + [7, 8])  # a local hit re-offers it: seen twice, published
    s = a.prefix_cache_stats()
    assert s["local"]["hits"] == 1 and idx.stats()["keys"] == 1
    assert s["plane"]["published_blocks"] == 1 and s["remote"]["published_blocks"] == 1
    # a remote fetch is reuse evidence: B's republish skips the policy
    b = mk(params[1], KVPlaneClient(idx, "B"))
    gen(b, SHARED + [9, 10])
    sb = b.prefix_cache_stats()
    assert sb["remote"]["hits"] == 1 and sb["plane"]["published_blocks"] == 1 and sb["plane"]["published_skipped"] == 0
    assert idx.match_replicas(boundary_keys(SHARED + [0], 64)).keys() == {"A", "B"}


def test_publish_runs_with_the_engine_lock_released(params, plane):
    idx = PrefixIndex()
    c = client(idx, "A")
    eng = mk(params[1], c)
    real, held = c.publish, []

    def guarded(*a, **kw):
        held.append(eng._lock.locked())
        return real(*a, **kw)

    c.publish = guarded
    gen(eng, SHARED + [5, 6])
    assert held and not any(held)
    assert eng.prefix_cache_stats()["remote"]["published_blocks"] == 1 and idx.stats()["keys"] == 1


def test_evicted_remote_block_bounded_retry_then_local_prefill(params, oracle, plane):
    idx = PrefixIndex()
    a = mk(params[1], client(idx, "A"))
    gen(a, SHARED + [5, 6, 7])
    key = boundary_keys(SHARED + [1], 64)[0][1]
    ref = idx._entries[key]["A"]["ref"]
    direct.free_owned([ref.id])  # the bytes gone, the route still registered: the eviction race
    prompt = SHARED + [9, 10, 11]
    b = mk(params[1], client(idx, "B", fetch_timeout_s=1.0, fetch_retries=1, retry_wait_s=0.05))
    t0 = time.monotonic()
    assert gen(b, prompt) == oracle(prompt), "the fallback prefill diverged"
    assert time.monotonic() - t0 < 30, "the lost-block fallback must be bounded"
    s = b.prefix_cache_stats()
    assert s["remote"]["hits"] == 0 and s["remote"]["lost"] == 1 and s["plane"]["fetch_lost"] == 1
    assert b.prefill_forwards == 1 and b.extend_forwards == 0
    # report_lost dropped the dead route; B's own publish is the only holder
    assert idx.match_replicas(boundary_keys(prompt, 64)) == {"B": 64}


def test_local_eviction_unregisters_then_frees(params, plane):
    idx = PrefixIndex()
    c = client(idx, "A")
    a = mk(params[1], c)
    gen(a, SHARED + [5, 6])
    key = boundary_keys(SHARED + [1], 64)[0][1]
    ref = idx._entries[key]["A"]["ref"]
    assert plane.owned.size() == 1
    with a._lock:
        a._prefix_cache._evict_one()
    assert _wait(lambda: idx.stats()["keys"] == 0 and c.stats()["unpublished_blocks"] == 1)
    assert plane.owned.size() == 0
    with pytest.raises(thandoff.HandoffLostError):
        thandoff.fetch(ref, kind=thandoff.PREFIX_KIND, timeout_s=0.5, retries=0)


def test_cache_aware_router_sends_shared_prefixes_to_the_holder(params, oracle, plane):
    idx = PrefixIndex()
    engines = {"r0": mk(params[1], client(idx, "r0")), "r1": mk(params[1], client(idx, "r1"))}

    def submit(rid, prompt, sp):
        out = engines[rid].generate(prompt, SamplingParams(**sp))
        return {"token_ids": list(out.token_ids), "finish_reason": out.finish_reason, "replica": rid}

    router = CacheAwareRouter(idx, submit, list(engines), block=64, telemetry_tags={"model": "kvplane-router-test"})
    first = router.generate(SHARED + [5, 6, 7], SP)
    assert first["replica"] == "r0" and router.stats()["cold"] == 1
    outs = [router.generate(SHARED + [40 + i], SP) for i in range(3)]
    assert [o["replica"] for o in outs] == ["r0"] * 3 and router.stats()["routed_to_holder"] == 3
    assert engines["r0"].prefix_cache_stats()["local"]["hits"] == 3
    assert engines["r1"].prefix_cache_stats()["remote"]["hits"] == 0  # never fetched: the affinity held
    assert outs[0]["token_ids"] == oracle(SHARED + [40])


def test_prefetch_adopts_the_fleets_hot_block(params, oracle, plane):
    idx = PrefixIndex()
    a = mk(params[1], client(idx, "A"))
    gen(a, SHARED + [5, 6])
    idx.lookup(boundary_keys(SHARED + [1], 64), None, "someone")  # demand on the prefix
    c = client(idx, "B", prefetch_k=2, heartbeat_every_s=0.0)
    b = mk(params[1], c)
    tchaos.inject("kvplane.prefetch", drop_prob=1.0, max_hits=1)
    c.maybe_heartbeat()
    assert _wait(lambda: c.stats()["prefetch_skipped"] == 1)
    c._prefetch_thread.join(10)
    c.maybe_heartbeat()  # this round runs
    assert _wait(lambda: c.stats()["prefetch_blocks"] == 1)
    c._prefetch_thread.join(10)
    prompt = SHARED + [9, 10]
    assert gen(b, prompt) == oracle(prompt)
    s = b.prefix_cache_stats()
    assert s["local"]["hits"] == 1 and s["remote"]["hits"] == 0
    assert s["remote"]["prefetched_blocks"] == 1 and s["remote"]["prefetch_hits"] == 1


# ----------------------------------------------------------------- wire quantizers
def test_wire_quantizers_match_ray_tpus_op_by_op_functions():
    rng = np.random.default_rng(3)
    k = (rng.standard_normal((2, 64, 2, 16)) * 3).astype(np.float32)
    v = (rng.standard_normal((2, 64, 2, 16)) * 3).astype(np.float32)
    k[0, 5] = 0.0  # an all-zero vector quantizes to q = 0, scale = 0
    kq, vq, ks, vs = tquant.wire_quantize(torch.from_numpy(k), torch.from_numpy(v))
    for t, x, sc in ((kq, k, ks), (vq, v, vs)):
        jq, js = jkvq.quantize_heads(jnp.asarray(x))
        assert t.dtype == torch.int8 and np.array_equal(t.numpy(), np.asarray(jq))
        assert sc.shape == (2, 2, 64) and np.array_equal(sc.numpy(), np.asarray(js).transpose(0, 2, 1))
    for dtype in ("float32", "bfloat16"):
        kd, vd = tquant.wire_dequantize(kq, vq, ks, vs, dtype)
        jd = jkvq.dequantize(jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()).transpose(0, 2, 1))
        want = torch.from_numpy(np.asarray(jd)).to(kd.dtype)
        assert kd.dtype == tllama.torch_dtype(dtype) and torch.equal(kd, want)
        # requantizing the dequantized block gives the wire bytes back (the re-store's premise)
        if dtype == "float32":
            assert torch.equal(tquant.wire_quantize(kd, vd)[0], kq)
    assert tquant.make_wire_fns() == (tquant.wire_quantize, tquant.wire_dequantize)
