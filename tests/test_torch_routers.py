"""The serving routers in the port (``ray_tpu_torch/llm/disagg/router.py``
``DisaggRouter`` and ``ray_tpu_torch/llm/kvplane/routing.py``
``CacheAwareRouter``) against ray_tpu's, on the CPU.

- The in-process scenarios of tests/test_llm_chaos.py (the shared retry
  budget, overload surfacing as a 429), tests/test_llm_kvplane.py (next-
  ranked retry, bounded failure) and tests/test_llm_migrate.py (the
  migration probes, the resume legs, the lost checkpoint's fallback),
  each run on both packages with fake refs: the same calls, outcomes,
  ``stats()`` and RouterTelemetry series. Plus the cache-aware router's
  holder / off-holder / cold accounting and ``hot_prefixes`` over an
  index with entries, and its index-down degrade.
- Over engines, the routers driven as ray_tpu's tests drive them, with
  closures: prefill is ``prefill_handoff`` on a prefill engine, its
  payload encoded by the handoff codec and passed as the "ref"; decode
  runs the replica's ``AdmissionController.check`` on a paged decode
  engine, then ``add_prefilled`` of the decoded payload, and steps to
  the end; resume is ``restore_request`` of a live-state wire on the peer.
  Each leg on port engines is token-identical to the same leg on ray_tpu
  engines, greedy and seeded, with equal counters: the plain leg, a
  draining replica's 429 answered by failover with the same handoff, a
  lost handoff's re-prefill, the resume leg (a lane checkpointed mid-
  decode and spliced on the peer), and the fleet-wide shed (429, budget
  exhausted); and the cache-aware router's load order, its failover off
  a draining replica, its index-down degrade under a ``kvplane.index``
  chaos drop and its resume leg. Within a package every leg's stream
  equals the plain leg's.

Engines are LlamaConfig.tiny in f32 on weights converted from ray_tpu's:
a slot prefill engine and two paged decode engines a package, shared by
the module; ray_tpu's have every program settled (ROADMAP.md queue 3).
The port's chaos plane is cleared and seeded around every test by this
file's own fixture.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu import chaos as jchaos  # noqa: E402
from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import migrate as jmig  # noqa: E402
from ray_tpu.llm.disagg import handoff as jhandoff  # noqa: E402
from ray_tpu.llm.disagg import router as jrouter  # noqa: E402
from ray_tpu.llm.kvplane import index as jindex  # noqa: E402
from ray_tpu.llm.kvplane import routing as jrouting  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.serve import overload as jov  # noqa: E402
from ray_tpu_torch import chaos as tchaos  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.llm import migrate as tmig  # noqa: E402
from ray_tpu_torch.llm.disagg import handoff as thandoff  # noqa: E402
from ray_tpu_torch.llm.disagg import router as trouter  # noqa: E402
from ray_tpu_torch.llm.kvplane import index as tindex  # noqa: E402
from ray_tpu_torch.llm.kvplane import routing as trouting  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.serve import overload as tov  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell", "_extract_slots", "_extract_paged", "_scatter_slots",
           "_scatter_paged")
RNG = np.random.default_rng(23)
PROMPTS = [[int(t) for t in RNG.integers(1, 500, size=n)] for n in (30, 77, 45)]
GREEDY = dict(max_tokens=10)
SEEDED = dict(max_tokens=10, temperature=0.8, seed=5, top_k=20)
SAMPLING = pytest.mark.parametrize("sp", [GREEDY, SEEDED], ids=["greedy", "seeded"])
CUT = 4  # the resume legs checkpoint a lane once it has this many tokens
_TAGS = itertools.count()

J = SimpleNamespace(name="ray_tpu", DisaggRouter=jrouter.DisaggRouter, DisaggRequestError=jrouter.DisaggRequestError,
                    handoff_lost=jrouter._handoff_lost, CacheAwareRouter=jrouting.CacheAwareRouter,
                    KVRouteError=jrouting.KVRouteError, PrefixIndex=jindex.PrefixIndex, index=jindex,
                    handoff=jhandoff, migrate=jmig, ov=jov, chaos=jchaos, Params=JaxParams)
T = SimpleNamespace(name="port", DisaggRouter=trouter.DisaggRouter, DisaggRequestError=trouter.DisaggRequestError,
                    handoff_lost=trouter._handoff_lost, CacheAwareRouter=trouting.CacheAwareRouter,
                    KVRouteError=trouting.KVRouteError, PrefixIndex=tindex.PrefixIndex, index=tindex,
                    handoff=thandoff, migrate=tmig, ov=tov, chaos=tchaos, Params=SamplingParams)
PKGS = (J, T)


@pytest.fixture(autouse=True)
def _port_chaos_hygiene():
    """The port's chaos plane, cleared and seeded around every test (the
    conftest fixture clears ray_tpu's only)."""
    tchaos.clear()
    tchaos.seed(0)
    yield
    tchaos.clear()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's tiny models."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jitter_from_seed():
    """Both retry-jitter RNGs restarted from their seed, so hints compare
    draw for draw; their states restored afterwards."""
    saved = jov._retry_jitter.getstate(), tov._retry_jitter.getstate()
    jov._retry_jitter.seed(0x52455452)
    tov._retry_jitter.seed(0x52455452)
    yield
    jov._retry_jitter.setstate(saved[0])
    tov._retry_jitter.setstate(saved[1])


def _tags(pkg):
    return {"replica": f"{'j' if pkg is J else 't'}router{next(_TAGS)}"}


def _count(router, name, **extra):
    tel = router._tel
    m = tel.m[name]
    return m._series.get(m._key({**tel.tags, **extra}), 0.0)


def _series(router):
    """A router's RouterTelemetry series, by event."""
    out = {f"handoffs {e}": _count(router, "rt_llm_handoffs_total", event=e) for e in ("published", "lost", "reused")}
    out.update({f"migrations {o}": _count(router, "rt_llm_migrations_total", outcome=o) for o in ("resumed", "lost")})
    out.update({f"shed {c}": _count(router, "rt_llm_requests_shed_total", **{"class": c}) for c in "012"})
    out["failed"] = _count(router, "rt_llm_requests_finished_total", reason="error")
    out["budget"] = _count(router, "rt_llm_retry_budget_exhausted_total")
    out["handoff bytes"] = _count(router, "rt_llm_handoff_bytes_total")
    return out


def _err(e):
    return (type(e).__name__, str(e), getattr(e, "status_code", None), getattr(e, "retry_after_s", None),
            getattr(e, "shed_class", None))


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — the error's fields are the outcome
        return _err(e)
    return ("ok", {k: v for k, v in out.items() if k != "request_id"})


def both(scenario):
    """Run ``scenario(pkg)`` on ray_tpu and on the port; return both."""
    return [scenario(pkg) for pkg in PKGS]


# ------------------------------------------------------ fake-ref scenarios
class _Ref:
    class id:  # noqa: N801 — mimics ObjectRef.id
        @staticmethod
        def binary():
            return b"ref"

        @staticmethod
        def hex():
            return "ref"


def _shared_budget(pkg):
    calls = {"prefill": 0, "decode": 0}

    def prefill(prompt):
        calls["prefill"] += 1
        return {"nbytes": 16}, _Ref()

    def decode(meta, ref, prompt, sp):
        calls["decode"] += 1
        raise RuntimeError("decode lane dead")

    router = pkg.DisaggRouter(prefill, decode, max_attempts=3, telemetry_tags=_tags(pkg))
    out = _outcome(lambda: router.generate([1, 2, 3]))
    return out, dict(calls), router.stats(), _series(router)


def test_retry_budget_is_shared_across_attempt_kinds():
    """ONE budget covers the attempts; the handoff is reused across decode
    deaths (no re-prefill); exhaustion is the typed terminal error."""
    want, got = both(_shared_budget)
    assert got == want
    assert got[0][0] == "DisaggRequestError" and got[0][2] == 500 and got[1] == {"prefill": 1, "decode": 3}
    assert got[2]["budget_exhausted"] == 1 and got[2]["failed"] == 1 and got[2]["decode_retries"] == 3
    assert got[3]["handoffs reused"] == 3 and got[3]["failed"] == 1 and got[3]["budget"] == 1


def _overload_429(pkg):
    def prefill(prompt):
        return {"nbytes": 0}, _Ref()

    def decode(meta, ref, prompt, sp):
        w = RuntimeError("TaskError wrapper")  # the hint lives on the CAUSE
        w.cause = pkg.ov.OverloadedError("replica busy", retry_after_s=3.0, shed_class=1)
        raise w

    def submit(rid, prompt, sp):
        raise pkg.ov.OverloadedError("replica draining", retry_after_s=1.5)

    out = []
    router = pkg.DisaggRouter(prefill, decode, max_attempts=2, telemetry_tags=_tags(pkg))
    out += [_outcome(lambda: router.generate([1, 2, 3], {"priority": 1})), router.stats(), _series(router)]
    kvr = pkg.CacheAwareRouter(pkg.PrefixIndex(), submit, ["r0", "r1"], max_attempts=2, telemetry_tags=_tags(pkg))
    out += [_outcome(lambda: kvr.generate([1, 2, 3])), kvr.stats(), _series(kvr)]
    kvr2 = pkg.CacheAwareRouter(pkg.PrefixIndex(), submit, ["r0"], max_attempts=3, telemetry_tags=_tags(pkg))
    out += [_outcome(lambda: kvr2.generate([1, 2, 3])), kvr2.stats()]
    return out


def test_routers_surface_overload_as_429():
    """A fleet whose every lane sheds is saturated, not broken: both
    routers re-raise OverloadedError with the replica's hint; a fleet
    smaller than the budget is not a budget exhaustion."""
    want, got = both(_overload_429)
    assert got == want
    assert got[0] == ("OverloadedError", got[0][1], 429, 3.0, 1) and got[1]["shed"] == 1
    assert got[2]["shed 1"] == 1.0 and got[3][2:4] == (429, 1.5)
    assert got[4]["shed"] == 1 and got[4]["budget_exhausted"] == 1 and got[7]["budget_exhausted"] == 0


def _next_ranked(pkg):
    calls = []

    def submit(rid, prompt, sp):
        calls.append(rid)
        if len(calls) == 1:
            raise ConnectionError("replica died")
        return {"token_ids": [1], "finish_reason": "length", "replica": rid}

    def always_dead(rid, prompt, sp):
        raise ConnectionError("no replica alive")

    router = pkg.CacheAwareRouter(pkg.PrefixIndex(), submit, ["r0", "r1"], max_attempts=2, telemetry_tags=_tags(pkg))
    out = [_outcome(lambda: router.generate(list(range(70)), {})), list(calls), router.stats()]
    router2 = pkg.CacheAwareRouter(pkg.PrefixIndex(), always_dead, ["r0", "r1"], max_attempts=2,
                                   telemetry_tags=_tags(pkg))
    return out + [_outcome(lambda: router2.generate(list(range(70)), {})), router2.stats(), _series(router2)]


def test_router_retries_next_ranked_then_bounded_failure():
    want, got = both(_next_ranked)
    assert got == want
    assert got[0][1]["replica"] == "r1" and got[1] == ["r0", "r1"] and got[2]["retries"] == 1
    assert got[3][0] == "KVRouteError" and got[3][2] == 500
    assert got[4]["failed"] == 1 and set(got[4]["inflight"].values()) == {0} and got[5]["failed"] == 1.0


def _probes(pkg):
    mig, handoff = pkg.migrate, pkg.handoff
    err = mig.RequestMigratedError("req-1", {"nbytes": 4, "emitted": 3}, _Ref)
    wrapped = RuntimeError("TaskError wrapper")
    wrapped.cause = err
    lost = RuntimeError("wire")
    lost.cause = mig.MigrationLostError("gone")
    tb_only = RuntimeError("remote")
    tb_only.tb_str = "... x.MigrationLostError: gone ..."
    h_tb = RuntimeError("remote")
    h_tb.tb_str = "... x.HandoffLostError: evicted ..."
    h_wrapped = RuntimeError("wrapper")
    h_wrapped.cause = handoff.HandoffLostError("evicted")
    cases = [err, wrapped, lost, tb_only, RuntimeError("plain"), None, h_tb, h_wrapped, handoff.HandoffError("bad")]
    return [(mig.migration_of(e), mig.migration_lost(e), pkg.handoff_lost(e)) for e in cases]


def test_migration_and_handoff_probes():
    want, got = both(_probes)
    assert got == want
    assert got[0][0] == ("req-1", {"nbytes": 4, "emitted": 3}, _Ref) and got[1][0][2] is _Ref
    assert [g[1] for g in got] == [False, False, True, True, False, False, False, False, False]
    assert [g[2] for g in got] == [False] * 6 + [True, True, False]


def _resume_scenarios(pkg):
    out = []
    calls = {"prefill": 0, "decode": 0, "resume": 0}
    mig_err = pkg.migrate.RequestMigratedError("d-1", {"nbytes": 8, "emitted": 5}, _Ref())

    def prefill(prompt):
        calls["prefill"] += 1
        return {"nbytes": 0}, _Ref()

    def decode(meta, ref, prompt, sp):
        calls["decode"] += 1
        w = RuntimeError("TaskError wrapper")
        w.cause = mig_err
        raise w

    def resume(meta, ref, sp):
        calls["resume"] += 1
        assert meta["emitted"] == 5 and ref is mig_err.migration_ref
        return {"request_id": "d-1", "token_ids": list(range(9)), "finish_reason": "length"}

    router = pkg.DisaggRouter(prefill, decode, resume=resume, max_attempts=3, telemetry_tags=_tags(pkg))
    out += [_outcome(lambda: router.generate([1, 2, 3])), dict(calls), router.stats(), _series(router)]

    calls = {"prefill": 0, "decode": 0, "resume": 0}

    def decode2(meta, ref, prompt, sp):
        calls["decode"] += 1
        if calls["decode"] == 1:
            raise pkg.migrate.RequestMigratedError("d-2", {"nbytes": 8, "emitted": 5}, _Ref())
        return {"request_id": "d-2", "token_ids": [1, 2], "finish_reason": "length"}

    def lost(meta, ref, sp):
        calls["resume"] += 1
        raise pkg.migrate.MigrationLostError("owner exited")

    router = pkg.DisaggRouter(prefill, decode2, resume=lost, max_attempts=3, telemetry_tags=_tags(pkg))
    out += [_outcome(lambda: router.generate([1, 2, 3])), dict(calls), router.stats(), _series(router)]

    seen = []

    def submit(rid, prompt, sp):
        seen.append(("submit", rid))
        raise pkg.migrate.RequestMigratedError("k-1", {"nbytes": 8, "emitted": 4}, _Ref())

    def resume_submit(rid, meta, ref, sp):
        seen.append(("resume", rid))
        assert meta["emitted"] == 4
        return {"request_id": "k-1", "token_ids": [5, 6, 7], "finish_reason": "stop"}

    kvr = pkg.CacheAwareRouter(pkg.PrefixIndex(), submit, ["r0", "r1"], max_attempts=3, resume_submit=resume_submit,
                               telemetry_tags=_tags(pkg))
    out += [_outcome(lambda: kvr.generate([1, 2, 3])), list(seen), kvr.stats(), _series(kvr)]
    return out


def test_resume_legs_and_lost_checkpoint_fallback():
    """tests/test_llm_migrate.py's three router scenarios: the disagg
    resume leg beats re-prefill, a lost checkpoint falls back to
    re-decoding the surviving handoff, and the cache-aware router resumes
    on the next-ranked replica."""
    want, got = both(_resume_scenarios)
    assert got == want
    assert got[0][1]["token_ids"] == list(range(9)) and got[1] == {"prefill": 1, "decode": 1, "resume": 1}
    assert got[2]["migrations"] == 1 and got[2]["resumed"] == 1 and got[3]["migrations resumed"] == 1
    assert got[4][1]["token_ids"] == [1, 2] and got[5] == {"prefill": 1, "decode": 2, "resume": 1}
    assert got[6]["resumed"] == 0 and got[7]["migrations lost"] == 1
    assert got[9] == [("submit", "r0"), ("resume", "r1")] and got[10]["resumed"] == 1


def _cache_aware_accounting(pkg):
    clock = {"t": 0.0}
    idx = pkg.PrefixIndex(ttl_s=10.0, time_fn=lambda: clock["t"])
    shared = list(range(1, 140))
    keys = pkg.index.boundary_keys(shared, 64, strict=False)
    idx.register("r1", [(k, n, {"nbytes": n}, f"ref-{n}") for n, k in keys])
    landed = []

    def submit(rid, prompt, sp):
        landed.append(rid)
        return {"token_ids": [len(prompt)], "finish_reason": "length"}

    router = pkg.CacheAwareRouter(idx, submit, ["r0", "r1", "r2"], telemetry_tags=_tags(pkg))
    out = [router.route(shared + [5]), _outcome(lambda: router.generate(shared + [5])),
           _outcome(lambda: router.generate([9] * 30))]
    router._inflight["r1"] = 30  # a swamped holder sheds to an idle peer
    out += [_outcome(lambda: router.generate(shared + [6])), router.hot_prefixes(2)]
    router._inflight["r1"] = 0
    clock["t"] = 20.0  # r1's lease lapsed: its entries stop matching
    out += [router.route(shared + [7]), list(landed)]
    pkg.chaos.inject("kvplane.index", drop_prob=1.0)
    out += [_outcome(lambda: router.generate(shared + [8])), router.hot_prefixes(2)]
    pkg.chaos.clear()
    return out + [router.stats(), idx.stats()]


def test_cache_aware_routing_accounting_equal_ray_tpus():
    """Over an index with entries: the holder wins, a swamped holder sheds
    to a peer, cold prompts balance, a lapsed lease stops matching, the
    hot feed, and an index down (chaos drop) degrades to load order with
    index_errors counted, never a failure."""
    want, got = both(_cache_aware_accounting)
    assert got == want
    assert got[0] == (["r1", "r0", "r2"], {"r1": 128}) and got[6] == ["r1", "r0", "r0"]
    assert got[5] == (["r0", "r1", "r2"], {}) and got[8] == []
    st = got[9]
    assert (st["routed_to_holder"], st["routed_off_holder"], st["cold"], st["index_errors"]) == (1, 1, 2, 2)
    assert st["matched_tokens"] == 256 and got[4][0]["n"] == 128


# ------------------------------------------------------- legs over engines
@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _engine(pkg, params, **kw):
    kw = dict(max_num_seqs=2, max_seq_len=128, enable_prefix_caching=False, **kw)
    if pkg is J:
        je = JaxEngine(jllama.LlamaConfig.tiny(**KW), params[0], telemetry_tags=_tags(pkg), **kw)
        for name in SETTLED:
            if hasattr(je, name):
                setattr(je, name, _synced(getattr(je, name)))
        return je
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), params[1], device="cpu", telemetry_tags=_tags(pkg), **kw)


def _synced(fn):
    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


@pytest.fixture(scope="module")
def fleets(params):
    """Per package: a slot prefill engine and two paged decode engines."""
    return {pkg.name: (_engine(pkg, params), [_engine(pkg, params, kv_layout="paged", page_size=16) for _ in range(2)])
            for pkg in PKGS}


def _run_until(eng, rid, n_tokens):
    for _ in range(200):
        eng.step()
        if len(eng._requests[rid].token_ids) >= n_tokens:
            return
    raise AssertionError("request never reached the cut")


def _finish(eng, rid):
    for _ in range(200):
        for o in eng.step():
            if o.request_id == rid and o.finished:
                return {"request_id": rid, "token_ids": list(o.token_ids), "finish_reason": o.finish_reason}
    raise AssertionError("request never finished")


class Split:
    """Closures over one package's engines, as the routers take them: the
    prefill engine's handoff payload, encoded, is the "ref"; decode tries
    D0 on a handoff's first attempt and D1 on its second; resume restores
    a live-state wire on D1. ``lose`` makes the next decode attempts raise
    HandoffLostError; ``cut`` checkpoints the decoding lane at that many
    tokens and raises RequestMigratedError with its wire."""

    def __init__(self, pkg, fleet, lose=0, cut=None):
        self.pkg, (self.pre, self.decs) = pkg, fleet
        self.acs = [pkg.ov.AdmissionController(d) for d in self.decs]
        self.lose, self.cut, self.log, self._tries = lose, cut, [], {}

    def prefill(self, prompt):
        self.log.append("prefill")
        wire = self.pkg.handoff.encode(self.pre.prefill_handoff(prompt))
        return self.pkg.handoff.meta_of(wire), wire

    def decode(self, meta, ref, prompt, sp):
        n = self._tries[id(ref)] = self._tries.get(id(ref), 0) + 1
        i = (n - 1) % len(self.decs)
        self.log.append(f"decode D{i}")
        if self.lose:
            self.lose -= 1
            raise self.pkg.handoff.HandoffLostError("handoff evicted before scatter-in")
        self.acs[i].check(int(sp.get("priority", 0)))
        eng = self.decs[i]
        rid = eng.add_prefilled(self.pkg.handoff.decode(ref), self.pkg.Params(**sp))
        if self.cut is None:
            return _finish(eng, rid)
        self.cut, cut = None, self.cut
        return self._migrate(eng, rid, cut)

    def _migrate(self, eng, rid, cut):
        _run_until(eng, rid, cut)
        state = eng.checkpoint_request(rid)
        assert eng.finish_migrated(rid)
        mig = self.pkg.migrate
        raise mig.RequestMigratedError(rid, mig.meta_of(state), mig.encode(state))

    def resume(self, meta, ref, sp):
        self.log.append("resume D1")
        eng = self.decs[1]
        return _finish(eng, eng.restore_request(self.pkg.migrate.decode(ref)))

    def submit(self, rid, prompt, sp):
        """The cache-aware router's replica call: r0 is D0, r1 is D1."""
        i = int(rid[1])
        self.log.append(f"submit {rid}")
        self.acs[i].check(int(sp.get("priority", 0)))
        eng = self.decs[i]
        req = eng.add_request(list(prompt), self.pkg.Params(**sp))
        if self.cut is None:
            return _finish(eng, req)
        self.cut, cut = None, self.cut
        return self._migrate(eng, req, cut)

    def resume_submit(self, rid, meta, ref, sp):
        self.log.append(f"resume {rid}")
        eng = self.decs[int(rid[1])]
        return _finish(eng, eng.restore_request(self.pkg.migrate.decode(ref)))

    def disagg(self, max_attempts=3):
        return self.pkg.DisaggRouter(self.prefill, self.decode, resume=self.resume, max_attempts=max_attempts,
                                     telemetry_tags=_tags(self.pkg))

    def generate(self, router, prompt, sp):
        self._tries.clear()
        out = _outcome(lambda: router.generate(list(prompt), dict(sp)))
        return out, list(self.log), router.stats(), _series(router)


def _disagg_legs(pkg, fleet, sp):
    legs = {}
    split = Split(pkg, fleet)
    router = split.disagg()
    legs["plain"] = [split.generate(router, p, sp) for p in PROMPTS[:2]]
    split = Split(pkg, fleet)
    split.acs[0].drain()
    legs["draining D0"] = split.generate(split.disagg(), PROMPTS[0], sp)
    split = Split(pkg, fleet, lose=1)
    legs["handoff lost"] = split.generate(split.disagg(), PROMPTS[0], sp)
    split = Split(pkg, fleet, cut=CUT)
    legs["resume"] = split.generate(split.disagg(), PROMPTS[0], sp)
    split = Split(pkg, fleet)
    for ac in split.acs:
        ac.drain()
    router = split.disagg()
    legs["shed"] = split.generate(router, PROMPTS[0], {**sp, "priority": 1})
    legs["shed http"] = pkg.ov.http_error_of(_raised(lambda: router.generate(list(PROMPTS[0]), dict(sp)), pkg))
    return legs


def _raised(fn, pkg):
    try:
        fn()
    except pkg.ov.OverloadedError as e:
        return e
    raise AssertionError("no shed")


@SAMPLING
def test_disagg_router_over_engines_equals_ray_tpus(fleets, sp):
    want, got = [_disagg_legs(pkg, fleets[pkg.name], sp) for pkg in PKGS]
    assert got == want
    plain = got["plain"][0]
    toks = plain[0][1]["token_ids"]
    assert len(toks) == sp["max_tokens"] and plain[1] == ["prefill", "decode D0"]
    assert plain[2]["prefills"] == 1 and plain[2]["decode_retries"] == 0 and plain[3]["handoffs published"] == 1
    assert plain[3]["handoff bytes"] == plain[2]["handoff_bytes"] > 0
    drain = got["draining D0"]
    assert drain[0][1]["token_ids"] == toks and drain[1] == ["prefill", "decode D0", "decode D1"]
    assert drain[2]["prefills"] == 1 and drain[2]["decode_retries"] == 1 and drain[3]["handoffs reused"] == 1
    lost = got["handoff lost"]
    assert lost[0][1]["token_ids"] == toks and lost[1] == ["prefill", "decode D0", "prefill", "decode D0"]
    assert lost[2]["prefills"] == 2 and lost[2]["handoffs_lost"] == 1 and lost[3]["handoffs lost"] == 1
    res = got["resume"]
    assert res[0][1]["token_ids"] == toks and res[1] == ["prefill", "decode D0", "resume D1"]
    assert (res[2]["prefills"], res[2]["migrations"], res[2]["resumed"]) == (1, 1, 1)
    assert res[3]["migrations resumed"] == 1
    shed = got["shed"]
    assert shed[0][0] == "OverloadedError" and shed[0][2] == 429 and shed[0][4] == 1
    assert shed[1] == ["prefill", "decode D0", "decode D1", "decode D0"]
    assert shed[2]["shed"] == 1 and shed[2]["budget_exhausted"] == 1 and shed[3]["shed 1"] == 1
    assert got["shed http"][0] == 429 and got["shed http"][1]["retry_after_s"] > 0


def _cache_aware_legs(pkg, fleet, sp):
    legs = {}
    split = Split(pkg, fleet)
    router = pkg.CacheAwareRouter(pkg.PrefixIndex(), split.submit, ["r0", "r1"], telemetry_tags=_tags(pkg))
    legs["load order"] = [split.generate(router, p, sp) for p in PROMPTS]
    split = Split(pkg, fleet)
    split.acs[0].drain()
    router = pkg.CacheAwareRouter(pkg.PrefixIndex(), split.submit, ["r0", "r1"], telemetry_tags=_tags(pkg))
    legs["draining r0"] = [split.generate(router, p, sp) for p in PROMPTS]
    split = Split(pkg, fleet)
    router = pkg.CacheAwareRouter(pkg.PrefixIndex(), split.submit, ["r0", "r1"], telemetry_tags=_tags(pkg))
    pkg.chaos.inject("kvplane.index", drop_prob=1.0)
    legs["index down"] = [split.generate(router, p, sp) for p in PROMPTS]
    pkg.chaos.clear()
    split = Split(pkg, fleet, cut=CUT)
    router = pkg.CacheAwareRouter(pkg.PrefixIndex(), split.submit, ["r0", "r1"], max_attempts=3,
                                  resume_submit=split.resume_submit, telemetry_tags=_tags(pkg))
    legs["resume"] = split.generate(router, PROMPTS[1], sp)
    return legs


@SAMPLING
def test_cache_aware_router_over_engines_equals_ray_tpus(fleets, sp):
    want, got = [_cache_aware_legs(pkg, fleets[pkg.name], sp) for pkg in PKGS]
    assert got == want
    streams = [leg[0][1]["token_ids"] for leg in got["load order"]]
    assert all(len(t) == sp["max_tokens"] for t in streams)
    assert [leg[1][-1] for leg in got["load order"]] == ["submit r0"] * 3  # idle fleet: declaration order
    assert got["load order"][-1][2]["cold"] == 3 and got["load order"][-1][2]["index_errors"] == 0
    drain = got["draining r0"]
    assert [leg[0][1]["token_ids"] for leg in drain] == streams and drain[-1][1] == ["submit r0", "submit r1"] * 3
    assert drain[-1][2]["retries"] == 3
    down = got["index down"]
    assert [leg[0][1]["token_ids"] for leg in down] == streams
    n_keyed = sum(len(p) > 64 for p in PROMPTS)
    assert down[-1][2]["index_errors"] == n_keyed == 1 and down[-1][2]["cold"] == 3
    res = got["resume"]
    assert res[0][1]["token_ids"] == streams[1] and res[1] == ["submit r0", "resume r1"]
    assert res[2]["migrations"] == 1 and res[2]["resumed"] == 1
