"""The cluster prefix index in the port (``ray_tpu_torch/llm/kvplane/``:
``index.py``, ``routing.py``'s scoring, ``client.py::index_call``)
against ray_tpu's, on the CPU.

- Keys: ``stable_hash`` content-derived and independent of the process
  hash seed; ``boundary_keys`` equal to ray_tpu's, strict and publish
  side, over many lengths and blocks; the port engine's prefix cache
  keyed in the same space.
- ``PrefixIndex``: tests/test_llm_kvplane.py's longest-live-match,
  staleness and lost-route scenario and tests/test_llm_kv_tiering.py's
  demand-decay scenario, each run on both packages' indexes under one
  fake clock with every answer compared; then a seeded sequence of 400
  mixed operations (register, unregister, heartbeat, lookup, match,
  report_lost, expire, drop_replica, top_hot, clock steps) whose answers
  and stats must be equal call for call.
- ``score_replica``/``rank_replicas`` equal to ray_tpu's on seeded inputs,
  and tests/test_llm_kvplane.py's scoring scenario.
- ``index_call`` against an in-process index and a ``.remote`` handle,
  and under the port's chaos plane (drop, method filter, injected fault),
  beside ray_tpu's under its own.
- The index and the cache-aware router's counters under 16 threads with a
  shortened switch interval: no update lost.
"""

import hashlib
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu import chaos as jchaos  # noqa: E402
from ray_tpu.llm.kvplane import client as jclient  # noqa: E402
from ray_tpu.llm.kvplane import index as jindex  # noqa: E402
from ray_tpu.llm.kvplane import routing as jrouting  # noqa: E402
from ray_tpu_torch import chaos as tchaos  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.llm.kvplane import client as tclient  # noqa: E402
from ray_tpu_torch.llm.kvplane import index as tindex  # noqa: E402
from ray_tpu_torch.llm.kvplane import routing as trouting  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402

PKGS = {"ray_tpu": (jindex, jrouting, jclient, jchaos), "port": (tindex, trouting, tclient, tchaos)}


@pytest.fixture(autouse=True)
def _port_chaos_hygiene():
    """The port's chaos plane, cleared and seeded around every test (the
    conftest fixture clears ray_tpu's only)."""
    tchaos.clear()
    tchaos.seed(0)
    yield
    tchaos.clear()


def both(scenario):
    """Run ``scenario(index, routing, client, chaos)`` on each package and
    return the two results (ray_tpu's, the port's)."""
    return [scenario(*mods) for mods in PKGS.values()]


# ------------------------------------------------------------------ keys
def test_stable_hash_is_content_derived_and_hashseed_independent():
    """blake2b over the salt and int32 token bytes, locked against the
    derivation, against ray_tpu's, and against PYTHONHASHSEED in
    subprocesses that load the port's index.py alone."""
    ids = [3, 1, 4, 1, 5, 9, 2, 6]
    expect = hashlib.blake2b(b"rt-kvplane-v1:" + np.asarray(ids, np.int32).tobytes(), digest_size=16).digest()
    assert tindex.stable_hash(ids) == tindex.stable_hash(tindex.token_bytes(ids)) == expect == jindex.stable_hash(ids)
    prog = ("import importlib.util, sys;"
            "spec = importlib.util.spec_from_file_location('idx', sys.argv[1]);"
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m);"
            "print(m.stable_hash([3, 1, 4, 1, 5, 9, 2, 6]).hex())")
    digests = set()
    for seed in ("0", "1"):
        r = subprocess.run([sys.executable, "-c", prog, tindex.__file__], env={**os.environ, "PYTHONHASHSEED": seed},
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        digests.add(r.stdout.strip())
    assert digests == {expect.hex()}


@pytest.mark.parametrize("block", [1, 16, 64])
def test_boundary_keys_equal_ray_tpus(block):
    rng = np.random.default_rng(block)
    for n in [0, 1, block - 1, block, block + 1, 2 * block, 200, 333]:
        ids = [int(t) for t in rng.integers(0, 128256, size=n)]
        for strict in (True, False):
            assert tindex.boundary_keys(ids, block, strict=strict) == jindex.boundary_keys(ids, block, strict=strict)
    ids = list(range(200))
    assert [n for n, _ in tindex.boundary_keys(ids, 64)] == [64, 128, 192]
    assert [n for n, _ in tindex.boundary_keys(ids[:192], 64)] == [64, 128]
    assert [n for n, _ in tindex.boundary_keys(ids[:128], 64, strict=False)] == [64, 128]
    assert tindex.boundary_keys(ids, 64)[0][1] == tindex.prefix_key(tindex.token_bytes(ids), 64)


def test_prefix_cache_keys_are_stable_hashes():
    """The port engine's local cache and the index share one key space:
    after a store, the cache's map holds the key boundary_keys derives."""
    torch.manual_seed(0)
    cfg = tllama.LlamaConfig.tiny(dtype="float32", remat=False, max_seq_len=128)
    eng = LLMEngine(cfg, max_num_seqs=2, max_seq_len=128, device="cpu", telemetry=False)
    prompt = [int(t) for t in np.random.default_rng(7).integers(1, cfg.vocab_size - 1, size=72)]
    eng.generate(prompt, SamplingParams(max_tokens=2))
    cache = eng._prefix_cache
    (n, key), = tindex.boundary_keys(prompt, cache.block)
    assert n == 64 and key in cache._keys and cache._keys[key][1] == 64


# ----------------------------------------------------------------- index
def _staleness(index, routing, client, chaos):
    """tests/test_llm_kvplane.py's scenario: every answer, in order."""
    clock = {"t": 1000.0}
    idx = index.PrefixIndex(ttl_s=5.0, time_fn=lambda: clock["t"])
    keys = index.boundary_keys(list(range(140)), 64)
    out = [idx.register("A", [(key, n, {"nbytes": 1}, f"ref-{n}") for n, key in keys]), idx.lookup(keys),
           idx.lookup(keys, exclude="A"), idx.match_replicas(keys), idx.register("B", [(keys[0][1], 64, {}, "b-ref")]),
           idx.lookup(keys), idx.match_replicas(keys)]
    clock["t"] += 4.0
    out.append(idx.heartbeat("B"))
    clock["t"] += 2.0
    out += [idx.match_replicas(keys), idx.lookup(keys), idx.expire(), idx.stats(), idx.heartbeat("B"),
            idx.match_replicas(keys), idx.report_lost("B", keys[0][1]), idx.lookup(keys), idx.match_replicas(keys),
            idx.stats()]
    return out


def test_index_longest_live_match_staleness_and_lost_routes():
    want, got = both(_staleness)
    assert got == want
    assert got[1]["n"] == 128 and got[1]["ref"] == "ref-128" and got[2] is None
    assert got[3] == {"A": 128} and got[6] == {"A": 128, "B": 64}
    assert got[8] == {"B": 64} and got[10] == 2 and got[11]["replicas_known"] == 1
    assert got[15] is None and got[16] == {}


def _top_hot(index, routing, client, chaos, ref):
    """tests/test_llm_kv_tiering.py's demand-decay scenario."""
    t = [0.0]
    idx = index.PrefixIndex(ttl_s=1e6, time_fn=lambda: t[0], demand_halflife_s=10.0)
    (k64, k128) = [key for _, key in index.boundary_keys(list(range(130)), 64)]
    idx.register("A", [(k64, 64, {"nbytes": 1}, ref), (k128, 128, {"nbytes": 1}, ref)])
    for _ in range(3):
        idx.lookup([(64, k64), (128, k128)], None, "router")
    out = [idx.top_hot(4), idx.top_hot(4, exclude="A")]
    t[0] = 15.0
    idx.match_replicas([])  # any demand touch runs the lazy decay: one halving
    out.append(idx.top_hot(4))
    t[0] = 200.0
    idx.match_replicas([])  # 18 more halvings: dust, dropped
    out += [idx.top_hot(4), idx.stats()]
    return out


def test_top_hot_demand_decay_and_alias_dedup():
    ref = object()  # top_hot compares refs by identity: one shared object
    want, got = [_top_hot(*mods, ref) for mods in PKGS.values()]
    assert got == want
    assert len(got[0]) == 1 and got[0][0]["n"] == 128 and got[0][0]["demand"] == pytest.approx(3.0)
    assert set(got[0][0]) == {"key", "n", "replica", "meta", "ref", "demand"}
    assert got[1] == [] and got[2][0]["demand"] == pytest.approx(1.5) and got[3] == []


def _random_ops(index, routing, client, chaos, plan):
    clock = {"t": 0.0}
    idx = index.PrefixIndex(ttl_s=7.0, time_fn=lambda: clock["t"], demand_halflife_s=5.0)
    out = []
    for op, arg in plan:
        if op == "tick":
            clock["t"] += arg
            out.append(None)
        else:
            out.append(getattr(idx, op)(*arg))
    out.append(idx.stats())
    return out


def test_index_random_operations_equal_ray_tpus():
    """A seeded mix of every index operation, the same calls on both
    packages' indexes: every answer and the final stats equal."""
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 50, size=int(n))] for n in rng.integers(20, 200, size=12)]
    keys = [tindex.boundary_keys(p, 16) for p in prompts]
    pub = [tindex.boundary_keys(p, 16, strict=False) for p in prompts]
    refs = [object() for _ in prompts]  # shared objects: top_hot dedups aliases by identity
    reps = ["r0", "r1", "r2"]
    plan = []
    for _ in range(400):
        i, r = int(rng.integers(len(prompts))), reps[int(rng.integers(3))]
        op = rng.choice(["register", "register", "unregister", "heartbeat", "lookup", "lookup", "match_replicas",
                         "report_lost", "expire", "drop_replica", "top_hot", "tick"])
        if op == "register" and pub[i]:
            cut = int(rng.integers(1, len(pub[i]) + 1))
            plan.append(("register", (r, [(k, n, {"nbytes": n}, refs[i]) for n, k in pub[i][:cut]])))
        elif op == "unregister" and pub[i]:
            plan.append(("unregister", (r, [k for _, k in pub[i][::2]])))
        elif op == "heartbeat":
            plan.append(("heartbeat", (r,)))
        elif op == "lookup":
            plan.append(("lookup", (keys[i], r if rng.random() < 0.3 else None, r if rng.random() < 0.5 else None)))
        elif op == "match_replicas":
            plan.append(("match_replicas", (keys[i],)))
        elif op == "report_lost" and pub[i]:
            plan.append(("report_lost", (r, pub[i][-1][1])))
        elif op == "expire":
            plan.append(("expire", ()))
        elif op == "drop_replica":
            plan.append(("drop_replica", (r,)))
        elif op == "top_hot":
            plan.append(("top_hot", (int(rng.integers(1, 5)), r if rng.random() < 0.5 else None)))
        elif op == "tick":
            plan.append(("tick", float(rng.integers(1, 6))))
    want, got = [_random_ops(*mods, plan) for mods in PKGS.values()]
    assert got == want
    assert sum(1 for x in got if isinstance(x, dict) and "ref" in x) > 10  # lookups hit
    assert got[-1]["registered"] > 0 and got[-1]["expired"] > 0


# --------------------------------------------------------------- scoring
def test_score_and_rank_equal_ray_tpus():
    rng = np.random.default_rng(5)
    reps = [f"r{i}" for i in range(5)]
    for _ in range(200):
        plen = int(rng.integers(1, 400))
        matches = {r: int(rng.integers(0, plen + 1)) for r in reps if rng.random() < 0.5}
        loads = {r: int(rng.integers(0, 6)) for r in reps if rng.random() < 0.7}
        kw = dict(cache_weight=float(rng.choice([1.0, 2.0])), load_weight=float(rng.choice([0.1, 0.5, 0.0])))
        assert (trouting.rank_replicas(reps, matches, loads, plen, **kw)
                == jrouting.rank_replicas(reps, matches, loads, plen, **kw))
        for r in reps:
            assert (trouting.score_replica(matches.get(r, 0), plen, loads.get(r, 0), **kw)
                    == jrouting.score_replica(matches.get(r, 0), plen, loads.get(r, 0), **kw))


def test_router_scoring_prefers_holder_then_sheds_on_load():
    replicas = ["r0", "r1", "r2"]
    assert trouting.rank_replicas(replicas, {"r1": 128}, {}, 140)[0] == "r1"
    assert trouting.rank_replicas(replicas, {"r1": 128}, {"r1": 20}, 140, load_weight=0.1)[0] != "r1"
    assert trouting.rank_replicas(replicas, {}, {"r0": 2, "r1": 0, "r2": 0}, 100)[0] == "r1"
    assert trouting.rank_replicas(replicas, {}, {}, 100) == replicas


# ------------------------------------------------------------ index_call
class _Handle:
    """A deployment-handle stand-in: ``method.remote(*args).result(timeout_s)``."""

    def __init__(self, idx):
        self.idx, self.calls = idx, []

    def __getattr__(self, name):
        handle = self

        class _Method:
            @staticmethod
            def remote(*args):
                handle.calls.append(name)

                class _Resp:
                    @staticmethod
                    def result(timeout_s):
                        return getattr(handle.idx, name)(*args)

                return _Resp()

        return _Method()


def _index_calls(index, routing, client, chaos):
    idx = index.PrefixIndex()
    keys = index.boundary_keys(list(range(100)), 16)
    idx.register("A", [(k, n, {}, f"ref-{n}") for n, k in keys])
    handle = _Handle(idx)
    out = [client.index_call(idx, "match_replicas", keys), client.index_call(handle, "lookup", keys, None, None),
           list(handle.calls)]

    def outcome(fn):
        try:
            return ("ok", fn())
        except Exception as e:  # noqa: BLE001 — the class and message are the outcome
            return (type(e).__name__, str(e))

    rule = chaos.inject("kvplane.index", drop_prob=1.0, methods=("match_replicas",))
    out += [outcome(lambda: client.index_call(idx, "match_replicas", keys)),
            outcome(lambda: client.index_call(idx, "top_hot", 2, None)), (rule.hits, rule.seen)]
    chaos.inject("kvplane.index", raises=TimeoutError, max_hits=1)
    out += [outcome(lambda: client.index_call(handle, "stats")), outcome(lambda: client.index_call(handle, "stats"))]
    chaos.clear()
    out.append(outcome(lambda: client.index_call(idx, "heartbeat", "A")))
    return out


def test_index_call_transports_and_chaos_equal_ray_tpus():
    want, got = both(_index_calls)
    assert got == want
    assert got[0] == {"A": 96} and got[1]["n"] == 96 and got[2] == ["lookup"]
    assert got[3] == ("ConnectionError", "chaos: dropped index rpc match_replicas")
    assert got[4][0] == "ok" and got[5] == (1, 1)
    assert got[6][0] == "TimeoutError" and got[7][0] == "ok" and got[8] == ("ok", 6)


def test_index_and_router_counters_hold_under_threads():
    """16 daemon threads (more than this host's cores) register, look up
    and route against one index and one router with the interpreter's
    switch interval shortened: every counter adds up and no in-flight
    count leaks."""
    idx = tindex.PrefixIndex()
    router = trouting.CacheAwareRouter(idx, lambda rid, prompt, sp: {"replica": rid}, ["r0", "r1", "r2"],
                                       telemetry_tags={"replica": "stress"})
    n_threads, rounds = 16, 40
    errors = []

    def work(t):
        try:
            for r in range(rounds):
                prompt = [t + 1] * 80 + [r]
                keys = tindex.boundary_keys(prompt, 16, strict=False)
                idx.register(f"r{t % 3}", [(k, n, {}, None) for n, k in keys])
                idx.lookup(tindex.boundary_keys(prompt, 16))
                router.generate(prompt)
        except BaseException as e:  # noqa: BLE001 — surfaced by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,), daemon=True) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and errors == []
    per = len(tindex.boundary_keys([1] * 81, 16, strict=False))
    st, rst = idx.stats(), router.stats()
    assert st["registered"] == n_threads * rounds * per and st["lookups"] == n_threads * rounds
    assert rst["requests"] == n_threads * rounds and set(rst["inflight"].values()) == {0}
    assert rst["routed_to_holder"] + rst["routed_off_holder"] + rst["cold"] == rst["requests"]
