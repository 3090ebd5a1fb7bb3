"""The overload plane in the port (``ray_tpu_torch/serve/overload.py``,
``LLMEngine.host_load``) against ray_tpu's, on the CPU.

- The typed errors (``OverloadedError``, ``ReplicaDrainingError``,
  ``StepperDiedError``) with ray_tpu's status codes, flags and bases; the
  probes ``is_overloaded``, ``retry_hint_of``, ``shed_class_of`` and
  ``http_error_of``'s ``(code, body)`` equal to ray_tpu's over direct,
  wire-wrapped and traceback-only errors of every registered class.
- ``RetryBudget`` and ``router_terminal``: the same counters, raised
  class, hint and shed class, and telemetry series as ray_tpu's.
- ``AdmissionController`` on a port engine beside one on a ray_tpu engine
  with the same queue and the same EMAs: tests/test_llm_chaos.py's
  scenarios (shed-lowest-class-first, the estimated queue wait, the cost
  of a check, the stats lock, the jitter bounds) plus the drain
  lifecycle, every cap and the sample-hook gauge; stats dicts, error
  classes, status codes, retry hints (draw for draw: both jitter RNGs
  restarted from their seed) and shed classes equal.
- ``host_load()``: a ray_tpu engine and a port engine in the same mode
  (sync, and device-resident: the port's graph engine's step run eagerly
  on the host) and layout (paged, slots) over the same schedule, with
  waiting, running and (paged) preempted requests: equal dicts before and
  after every step, with ``has_unfinished``/``num_waiting``/``num_running``.
- ``wait_for_drain`` over an object with ``.engine``.

Engines are LlamaConfig.tiny in f32 on weights converted from ray_tpu's;
ray_tpu's engines have every program settled (ROADMAP.md queue 3). Each
engine's telemetry carries a replica tag of its own (the metric series
are per process, keyed by tags).
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu import exceptions as jexc  # noqa: E402
from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import migrate as jmig  # noqa: E402
from ray_tpu.llm.disagg import handoff as jhandoff  # noqa: E402
from ray_tpu.llm.telemetry import RouterTelemetry as JaxRouterTelemetry  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.serve import overload as jov  # noqa: E402
from ray_tpu_torch import chaos as tchaos  # noqa: E402
from ray_tpu_torch import exceptions as texc  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.llm import migrate as tmig  # noqa: E402
from ray_tpu_torch.llm.disagg import handoff as thandoff  # noqa: E402
from ray_tpu_torch.llm.telemetry import RouterTelemetry  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.serve import overload as tov  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell")
PROMPT = [int(x) for x in np.random.default_rng(11).integers(1, 511, size=24)]
_REPLICAS = itertools.count()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's tiny models."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jitter_from_seed():
    """Both packages' retry-jitter RNGs restarted from their seed, so hints
    compare draw for draw; their states restored afterwards."""
    saved = jov._retry_jitter.getstate(), tov._retry_jitter.getstate()
    jov._retry_jitter.seed(0x52455452)
    tov._retry_jitter.seed(0x52455452)
    yield
    jov._retry_jitter.setstate(saved[0])
    tov._retry_jitter.setstate(saved[1])


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _synced(fn):
    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


def engines(params, **kw):
    """(ray_tpu engine, port engine) of one configuration, telemetry on."""
    jp, tp = params
    kw.setdefault("max_num_seqs", 2)
    kw.setdefault("max_seq_len", 128)
    je = JaxEngine(jllama.LlamaConfig.tiny(**KW), jp, telemetry_tags={"replica": f"j{next(_REPLICAS)}"}, **kw)
    for name in SETTLED:
        if hasattr(je, name):
            setattr(je, name, _synced(getattr(je, name)))
    te = LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", telemetry_tags={"replica": f"t{next(_REPLICAS)}"},
                   **kw)
    return je, te


PAIRS = ((jov, JaxParams, jexc), (tov, SamplingParams, texc))


def _err(e):
    """A raised error as comparable fields."""
    return (type(e).__name__, str(e), getattr(e, "status_code", None), getattr(e, "retryable", None),
            getattr(e, "retry_after_s", None), getattr(e, "shed_class", None))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error's fields are the outcome
        return _err(e)


# ---------------------------------------------------------------- errors
@pytest.mark.parametrize("name", ["OverloadedError", "ReplicaDrainingError", "StepperDiedError"])
def test_error_classes_match_ray_tpu(name):
    t, j = getattr(tov, name), getattr(jov, name)
    assert (t.status_code, t.retryable) == (j.status_code, j.retryable)
    assert [b.__name__ for b in t.__mro__] == [b.__name__ for b in j.__mro__]
    assert texc.serving_error_spec(t("x")) is texc.SERVING_ERRORS[name]
    assert (texc.SERVING_ERRORS[name].status_code, texc.SERVING_ERRORS[name].retryable) == (
        jexc.SERVING_ERRORS[name].status_code, jexc.SERVING_ERRORS[name].retryable)


def test_serving_table_rows_equal_ray_tpus():
    """Every row the port has is ray_tpu's, and since the object plane
    (its runtime errors included) it has every one of them."""
    for name, spec in texc.SERVING_ERRORS.items():
        assert (spec.status_code, spec.retryable) == (jexc.SERVING_ERRORS[name].status_code,
                                                      jexc.SERVING_ERRORS[name].retryable), name
    assert set(jexc.SERVING_ERRORS) == set(texc.SERVING_ERRORS)


def _probe_cases(ov, handoff, mig, chaos_error):
    """Errors a probe meets: direct, wire-wrapped (``.cause``), a chain
    deeper than the walk, and traceback-only, of every registered class."""

    def wrap(inner, depth=1):
        for _ in range(depth):
            w = RuntimeError("TaskError wrapper")
            w.cause, inner = inner, w
        return inner

    def tb(text):
        e = RuntimeError("remote")
        e.tb_str = f"... {text}: busy ..."
        return e

    cases = [ov.OverloadedError("busy", retry_after_s=2.0), ov.OverloadedError("busy", retry_after_s=2.25, shed_class=2),
             ov.ReplicaDrainingError("draining", retry_after_s=0.4, shed_class=1), ov.StepperDiedError("died"),
             wrap(ov.OverloadedError("busy", retry_after_s=3.0, shed_class=1)),
             wrap(ov.OverloadedError("deep", retry_after_s=5.0), depth=7),
             wrap(ov.OverloadedError("too deep", retry_after_s=5.0), depth=8),
             handoff.HandoffLostError("gone"), handoff.HandoffError("bad"), mig.MigrationError("bad"),
             mig.MigrationLostError("gone"), wrap(handoff.HandoffLostError("gone")), chaos_error("boom"),
             RuntimeError("plain"), None]
    cases += [tb(f"x.{name}") for name in texc.SERVING_ERRORS]
    w = wrap(ov.OverloadedError("busy", retry_after_s=4.0))
    w.tb_str = "ReplicaDrainingError"  # a surviving cause's real hint beats the wrapper's traceback
    return cases + [w]


def test_probes_and_http_mapping_equal_ray_tpus():
    from ray_tpu import chaos as jchaos

    rows = []
    for (ov, _, _), handoff, mig, ce in zip(PAIRS, (jhandoff, thandoff), (jmig, tmig),
                                              (jchaos.ChaosError, tchaos.ChaosError)):
        rows.append([(ov.is_overloaded(e), ov.retry_hint_of(e), ov.retry_hint_of(e, 7.0), ov.shed_class_of(e),
                      ov.shed_class_of(e, 3), ov.http_error_of(e)) for e in _probe_cases(ov, handoff, mig, ce)])
    assert rows[1] == rows[0]
    got = rows[1]
    assert got[0][5] == (429, {"error": "busy", "retry_after_s": 2.0}) and got[4][:2] == (True, 3.0)
    assert got[5][0] and not got[6][0]  # the walk is bounded at 8 links
    assert got[3][5][0] == 503 and got[13][5] is None and got[14] == (False, 1.0, 7.0, 0, 3, None)
    assert got[-1][5] == (429, {"error": "busy", "retry_after_s": 4.0})
    # the request class rides SamplingParams.priority in both packages
    assert SamplingParams(priority=2).priority == JaxParams(priority=2).priority == 2
    for P in (JaxParams, SamplingParams):
        with pytest.raises(ValueError):
            P(priority=-1)


# ---------------------------------------------------- budget and terminal
def _budget(ov, tel):
    b = ov.RetryBudget(3, tel)
    out = [(b.try_spend(), b.remaining) for _ in range(4)]
    b.exhaust()
    b0 = ov.RetryBudget(0)
    return out + [b0.attempts, b0.try_spend(), b0.try_spend(), b0.remaining]


def _count(tel, name, **extra):
    m = tel.m[name]
    return m._series.get(m._key({**tel.tags, **extra}), 0.0)


def test_retry_budget_equal_ray_tpus():
    tels = [JaxRouterTelemetry({"replica": f"jb{next(_REPLICAS)}"}), RouterTelemetry({"replica": f"tb{next(_REPLICAS)}"})]
    want, got = [_budget(ov, tel) for (ov, _, _), tel in zip(PAIRS, tels)]
    assert got == want == [(True, 2), (True, 1), (True, 0), (False, 0), 1, True, False, 0]
    assert [_count(t, "rt_llm_retry_budget_exhausted_total") for t in tels] == [1.0, 1.0]


def _terminals(ov, tel):
    out = []
    for spent, last, priority in [(3, ov.OverloadedError("busy", retry_after_s=3.0, shed_class=1), 1),
                                  (1, ov.ReplicaDrainingError("draining", retry_after_s=0.5), 0),
                                  (3, RuntimeError("dead"), 0), (2, None, 0)]:
        tb_only = RuntimeError("remote")
        tb_only.tb_str = "... OverloadedError: busy"
        for err, prio in ((last, priority), (tb_only, 7)):
            budget = ov.RetryBudget(3, tel)
            for _ in range(spent):
                budget.try_spend()
            counters = {"budget_exhausted": 0, "shed": 0, "failed": 0}
            res = _outcome(lambda: ov.router_terminal(err, budget=budget, priority=prio, counters=counters,
                                                      lock=threading.Lock(), telemetry=tel, shed_msg="shed!"))
            out.append((res, dict(counters)))
    series = [_count(tel, "rt_llm_requests_shed_total", **{"class": c}) for c in "0123"]
    return out + [series, _count(tel, "rt_llm_requests_finished_total", reason="error"),
                  _count(tel, "rt_llm_retry_budget_exhausted_total")]


def test_router_terminal_equal_ray_tpus():
    """Saturation re-raises the 429 with the replica's dug-out hint and
    class (counted as shed, never failed); a real failure counts failed
    and returns; budget exhaustion is told from a short ranked list."""
    tels = [JaxRouterTelemetry({"replica": f"jt{next(_REPLICAS)}"}), RouterTelemetry({"replica": f"tt{next(_REPLICAS)}"})]
    want, got = [_terminals(ov, tel) for (ov, _, _), tel in zip(PAIRS, tels)]
    assert got == want
    assert got[0] == (("OverloadedError", "shed!", 429, True, 3.0, 1), {"budget_exhausted": 1, "shed": 1, "failed": 0})
    assert got[1][0][5] == 2  # traceback-only: the priority clamped with the default classes
    assert got[4] == (("ok", None), {"budget_exhausted": 1, "shed": 0, "failed": 1})


# ------------------------------------------------------------- admission
def _set_emas(eng, service=0.0, itl=0.0):
    eng._tel.service_ema_s = service
    eng._tel.itl_ema_s = itl


def test_admission_sheds_lowest_class_first(params):
    """Queue past the cap: class 0 sheds with a typed 429 while class 1
    still admits, on both packages, with equal stats, errors and hints."""
    res = []
    for eng, (ov, P, _) in zip(engines(params, max_num_seqs=1), PAIRS):
        for _ in range(3):
            eng.add_request(list(PROMPT), P(max_tokens=2))
        ac = ov.AdmissionController(eng, ov.AdmissionConfig(max_queue_depth=4, class_fracs=(0.25, 1.0)))
        out = [_outcome(lambda: ac.check(0)), _outcome(lambda: ac.check(1)), _outcome(lambda: ac.check(5)),
               _outcome(ac.check_capacity)]
        eng.add_request(list(PROMPT), P(max_tokens=2))
        out += [_outcome(lambda: ac.check(1)), ac.stats(), eng.host_load()]
        res.append(out)
    assert res[1] == res[0]
    got = res[1]
    assert got[0][0] == "OverloadedError" and got[0][2] == 429 and got[0][5] == 0 and got[0][4] > 0
    assert got[1] == got[2] == got[3] == ("ok", None) and got[4][0] == "OverloadedError" and got[4][5] == 1
    assert got[5]["shed_depth"] == 2 and got[5]["shed_by_class"] == {0: 1, 1: 1} and got[5]["admitted"] == 3


def test_estimated_queue_wait_feeds_admission(params):
    """queue depth x service-time EMA / slots, and the ITL path over the
    queued max_tokens; the flight recorder really feeds both EMAs."""
    res = []
    for eng, (ov, P, _) in zip(engines(params, max_num_seqs=1), PAIRS):
        _set_emas(eng, service=10.0)
        for _ in range(2):
            eng.add_request(list(PROMPT), P(max_tokens=2))
        ac = ov.AdmissionController(eng, ov.AdmissionConfig(max_queue_depth=100, max_queue_wait_s=5.0))
        out = [ac.estimate_queue_wait_s(), _outcome(lambda: ac.check(0)), ac.stats()]
        _set_emas(eng, itl=0.1)
        out.append(ac.estimate_queue_wait_s())
        _set_emas(eng)
        while eng.has_unfinished():
            eng.step()
        assert eng._tel.service_ema_s > 0.0 and eng._tel.itl_ema_s > 0.0
        out.append(_outcome(lambda: ac.check(0)))
        res.append(out)
    assert res[1] == res[0]
    got = res[1]
    assert got[0] == pytest.approx(20.0) and got[1][0] == "OverloadedError" and got[2]["shed_wait"] == 1
    assert 0 < got[1][4] <= 30.0 and got[3] == pytest.approx(0.4) and got[4] == ("ok", None)


def test_admission_check_is_cheap(params):
    """Host-only dict work: 1000 checks well under a second."""
    _, te = engines(params)
    ac = tov.AdmissionController(te)
    ac.check(0)
    t0 = time.perf_counter()
    for _ in range(1000):
        ac.check(0)
    assert time.perf_counter() - t0 < 1.0


def test_stats_estimates_queue_wait_outside_admission_lock(params):
    """stats() reads engine.host_load() (the engine lock) BEFORE it takes
    the admission lock, so no ingress check stalls behind a step."""
    _, te = engines(params, max_num_seqs=1)
    _set_emas(te, service=10.0)
    te.add_request(list(PROMPT), SamplingParams(max_tokens=2))
    ac = tov.AdmissionController(te)
    real, held = te.host_load, []

    def guarded():
        held.append(ac._lock.locked())
        return real()

    te.host_load = guarded
    assert ac.stats()["queue_wait_est_s"] == pytest.approx(10.0)
    assert held and not any(held)


def test_retry_after_jitter_bounds_and_draws(params):
    """Hints are jittered ±25% around the clamped estimate, the spread is
    live, and the port draws ray_tpu's hints exactly."""
    hints = []
    for eng, (ov, P, _) in zip(engines(params, max_num_seqs=1), PAIRS):
        _set_emas(eng, service=10.0)
        for _ in range(2):
            eng.add_request(list(PROMPT), P(max_tokens=2))
        ac = ov.AdmissionController(eng, ov.AdmissionConfig(max_queue_depth=100, max_queue_wait_s=5.0))
        base = min(max(ac.estimate_queue_wait_s(), 0.25), 30.0)
        hs = []
        for _ in range(40):
            with pytest.raises(ov.OverloadedError) as ei:
                ac.check(0)
            hs.append(ei.value.retry_after_s)
        assert all(0.75 * base - 1e-9 <= h <= 1.25 * base + 1e-9 for h in hs)
        assert len(set(round(h, 6) for h in hs)) > 1 and max(hs) - min(hs) > 0.01 * base
        hints.append(hs)
    assert hints[1] == hints[0]


def _gauge(eng, name):
    m = eng._tel.m[name]
    return m._series.get(m._key(eng._tel.tags))


def test_drain_lifecycle_caps_and_gauges(params):
    """Drain (every request sheds with ReplicaDrainingError, the gauge 0
    -> 1 -> 2), the backlog and slot caps, the disabled controller, and
    the wait-estimate gauge refreshed by the telemetry's sample hook, on
    both packages: equal outcomes, stats and gauge values."""
    res = []
    for eng, (ov, P, _) in zip(engines(params, max_num_seqs=2, kv_layout="paged", page_size=16), PAIRS):
        out = []
        ac = ov.AdmissionController(eng)
        assert eng._tel.sample_hook == ac._refresh_wait_gauge
        out.append(_gauge(eng, "rt_llm_drain_state"))
        ac.drain()
        out += [ac.draining, _outcome(lambda: ac.check(2)), _gauge(eng, "rt_llm_drain_state")]
        ac.drained()
        out += [_gauge(eng, "rt_llm_drain_state"), ov.http_error_of(_outcome_exc(lambda: ac.check(0), ov)), ac.stats()]
        for _ in range(3):
            eng.add_request(list(PROMPT), P(max_tokens=8))
        backlog = ov.AdmissionController(eng, ov.AdmissionConfig(max_kv_backlog=0.05))
        out += [_outcome(lambda: backlog.check(0)), _outcome(lambda: backlog.check(2)), backlog.stats()]
        eng.step()
        _set_emas(eng)  # the step's real timings fed the EMAs: zero them, so the hints compare
        slots = ov.AdmissionController(eng, ov.AdmissionConfig(max_slot_occupancy=0.9, class_fracs=(0.5, 1.0)))
        out += [eng.host_load(), _outcome(lambda: slots.check(0)), _outcome(lambda: slots.check(1)), slots.stats()]
        off = ov.AdmissionController(eng, ov.AdmissionConfig(enabled=False, max_queue_depth=0))
        out += [_outcome(lambda: off.check(0)), off.stats()]
        _set_emas(eng, service=0.25)
        assert eng._tel.sample_hook == off._refresh_wait_gauge  # the latest controller's refresh
        eng._tel.sample_hook(6)  # what the telemetry's sample tick calls with the live queue depth
        out.append(_gauge(eng, "rt_llm_admission_queue_wait_est_ms"))
        res.append(out)
    assert res[1] == res[0]
    got = res[1]
    assert got[0] == 0.0 and got[1] is True and got[2][0] == "ReplicaDrainingError" and got[2][2] == 429
    assert (got[3], got[4]) == (1.0, 2.0) and got[5][0] == 429 and got[6]["shed_draining"] == 2
    assert got[7][0] == "OverloadedError" and got[9]["shed_backlog"] == 2
    assert got[10]["slots_in_use"] == 2 and got[11][0] == "OverloadedError" and got[12][0] == "OverloadedError"
    assert got[13]["shed_slots"] == 2 and got[14] == ("ok", None) and got[15]["admitted"] == 1
    assert got[16] == 750.0  # 6 waiting x 0.25 s / 2 slots


def _outcome_exc(fn, ov):
    try:
        fn()
    except ov.OverloadedError as e:
        return e
    raise AssertionError("no shed")


# ------------------------------------------------------------- host_load
def _host_schedule(eng, P, trace):
    """Three requests at step 0 and two more at step 2 on a 2-slot engine;
    ``trace`` gets host_load and the queue counters before every step."""
    rng = np.random.default_rng(5)
    reqs = [([int(t) for t in rng.integers(1, 500, size=int(n))], int(m)) for n, m in
            ((20, 60), (24, 70), (12, 20), (50, 12), (9, 28))]
    for prompt, m in reqs[:3]:
        eng.add_request(prompt, P(max_tokens=m))
    for t in range(400):
        if t == 2:
            for prompt, m in reqs[3:]:
                eng.add_request(prompt, P(max_tokens=m))
        trace.append((eng.host_load(), eng.has_unfinished(), eng.num_waiting, eng.num_running))
        if t > 2 and not eng.has_unfinished():
            return
        eng.step()
    raise AssertionError("schedule never converged")


@pytest.mark.parametrize("layout", ["paged", "slots"])
@pytest.mark.parametrize("resident", [False, True], ids=["sync", "resident"])
def test_host_load_equals_ray_tpus_at_every_step(params, layout, resident):
    kw = dict(kv_layout=layout, device_resident=resident, enable_prefix_caching=False)
    if layout == "paged":
        kw.update(page_size=16, num_pages=11)  # 10 pages of 16: the two long lanes outgrow it and preempt
    traces = [], []
    pair = engines(params, **kw)
    for eng, (_, P, _), trace in zip(pair, PAIRS, traces):
        _host_schedule(eng, P, trace)
    assert traces[1] == traces[0]
    loads = [t[0] for t in traces[1]]
    assert max(x["queue_depth"] for x in loads) >= 3 and max(x["slots_in_use"] for x in loads) == 2
    if layout == "paged":
        assert pair[0].preemption_count == pair[1].preemption_count > 0
        assert max(x["occupied_tokens"] for x in loads) > 0 and loads[0]["capacity_tokens"] == 160


def test_wait_for_drain_equal_ray_tpus(params):
    class _Server:
        def __init__(self, engine):
            self.engine = engine

    out = []
    for eng, (ov, P, _) in zip(engines(params), PAIRS):
        eng.add_request(list(PROMPT), P(max_tokens=3))
        t0 = time.perf_counter()
        waited = ov.wait_for_drain(_Server(eng), timeout_s=0.05, poll_s=0.01)
        assert time.perf_counter() - t0 < 1.0
        while eng.has_unfinished():
            eng.step()
        out.append((waited, ov.wait_for_drain(_Server(eng), timeout_s=0.05)))
    assert out[1] == out[0] == (False, True)
