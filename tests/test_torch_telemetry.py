"""The port's serving telemetry (ray_tpu_torch/llm/telemetry.py,
util/metrics.py, util/tracing.py) against ray_tpu's: the metric catalog,
the flight recorder's ring bounds and request lifecycle, the Prometheus
exposition of the same observations (golden histogram, escaping), the
off switch, the JSONL dump on an engine error under the port's session
dir, the recompile sentinel counting re-captures, and the same schedules
through both packages' engines (both layouts, both decode modes, and
speculative rounds): every step record equal field by field but the
clocks (``t``, ``wall_ms``), the request records' tokens, prompt tokens,
preemptions and reasons, and the histogram counts and counters."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import SpecConfig as JaxSpec  # noqa: E402
from ray_tpu.llm import telemetry as jtel  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.util import metrics as jmetrics  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams, SpecConfig  # noqa: E402
from ray_tpu_torch.llm import telemetry as ttel  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.util import metrics as tmetrics  # noqa: E402
from ray_tpu_torch.util import tracing as ttracing  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
JCFG, TCFG = jllama.LlamaConfig.tiny(**KW), tllama.LlamaConfig.tiny(**KW)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell", "_verify_step", "_verify_attn", "_verify_append", "_set_hist",
           "_set_slot_scalar")
CLOCKS = ("t", "wall_ms")
REQUEST_FIELDS = ("request_id", "tokens", "prompt_tokens", "preemptions", "reason")
HISTOGRAMS = ("rt_llm_ttft_s", "rt_llm_itl_s", "rt_llm_queue_wait_s")
COUNTERS = ("rt_llm_tokens_total", "rt_llm_prefill_tokens_total", "rt_llm_preemptions_total", "rt_llm_recompiles_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _engine(tp, **kw):
    kw = {"max_num_seqs": 2, "max_seq_len": 128, "enable_prefix_caching": False, **kw}
    return LLMEngine(TCFG, tp, device="cpu", **kw)


# ------------------------------------------------------------------ catalog
def test_metric_catalog_equals_ray_tpu():
    assert ttel.METRICS == jtel.METRICS
    assert ttel._LATENCY_BOUNDARIES == jtel._LATENCY_BOUNDARIES and ttel._SERVE_TAGS == jtel._SERVE_TAGS
    assert ttel.FlightRecorder.STEP_FIELDS == jtel.FlightRecorder.STEP_FIELDS
    inst = ttel.instruments()
    assert {n: m.kind for n, m in inst.items()} == {n: s["kind"] for n, s in jtel.METRICS.items()}
    assert ttel.default_tags("engine", model="m", replica="r") == jtel.default_tags("engine", model="m", replica="r")


# ---------------------------------------------------------- flight recorder
def test_flight_recorder_ring_is_bounded():
    recs = []
    for mod in (ttel, jtel):
        rec = mod.FlightRecorder(max_steps=8, max_requests=4)
        pad = (None,) * (len(mod.FlightRecorder.STEP_FIELDS) - 3)
        for i in range(50):
            rec.record_step((float(i), "decode") + pad)
            rec.record_request({"request_id": f"r{i}"})
        recs.append(rec.snapshot())
    snap = recs[0]
    assert snap == recs[1]
    assert snap["step_count"] == 50
    assert len(snap["steps"]) == 8 and snap["steps"][-1]["step"] == 50 and snap["steps"][-1]["phase"] == "decode"
    assert len(snap["requests"]) == 4 and snap["requests"][-1]["request_id"] == "r49"


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_flight_recorder_steps_and_request_lifecycle(params, layout):
    eng = _engine(params[1], kv_layout=layout, page_size=16, telemetry_tags={"model": "fr-test"})
    outs = eng.generate([[1, 2, 3, 4], [5, 6, 7]], SamplingParams(max_tokens=6))
    snap = eng.telemetry()
    assert snap["tags"]["model"] == "fr-test" and snap["tags"]["stage"] == "engine"
    steps = snap["steps"]
    assert steps and steps[-1]["step"] == snap["step_count"]
    phases = {r["phase"] for r in steps}
    assert "decode" in phases and ("prefill" in phases or "mixed" in phases)
    for r in steps:
        assert r["wall_ms"] >= 0 and r["capacity_tokens"] > 0
        assert 0 <= r["batch"] <= 2 and r["occupied_tokens"] >= 0
        assert ("pages_free" in r) == (layout == "paged")
    reqs = {r["request_id"]: r for r in snap["requests"]}
    assert len(reqs) == 2
    for out in outs:
        rec = reqs[out.request_id]
        assert rec["tokens"] == len(out.token_ids) == 6 and rec["reason"] == "length"
        assert rec["ttft_s"] is not None and rec["ttft_s"] >= 0
        assert len(rec["itl_s"]) == rec["tokens"] - 1
        assert rec["submit_t"] <= rec["admit_t"] <= rec["first_token_t"] <= rec["finish_t"]
        assert rec["queue_wait_s"] >= 0
    assert snap["recompiles"] == {} and snap["wire_bytes_per_step"] == 0.0


def test_a_dropped_engine_is_freed_at_once(params):
    """The telemetry holds its engine weakly: dropping the last reference
    frees the engine (its cache, on the card its graph) without waiting
    for the cycle collector."""
    import gc
    import weakref

    gc.disable()
    try:
        eng = _engine(params[1], kv_layout="paged", page_size=16, speculative=SpecConfig(k=2))
        eng.generate([1, 2, 3], SamplingParams(max_tokens=3))
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_submitted_at_backdates_the_clock(params):
    import time

    eng = _engine(params[1])
    rid = eng.add_request([1, 2, 3], SamplingParams(max_tokens=2), submitted_at=time.time() - 5.0)
    while eng.has_unfinished():
        eng.step()
    rec = next(r for r in eng.telemetry()["requests"] if r["request_id"] == rid)
    assert rec["ttft_s"] >= 5.0 and rec["queue_wait_s"] >= 5.0


def test_recompile_sentinel_counts_recaptures():
    """The sentinel's contract in the port: the first observed capture of
    a registered graph is the warm baseline; any capture after it is a
    recompile, counted per entry. An object without a capture count is not
    registered; a host engine's graph (captures 0) never warms."""

    class FakeGraph:
        captures = 0

    rec = ttel.FlightRecorder()
    g = FakeGraph()
    rec.register_entry("fused_attn", g)
    rec.register_entry("plain", lambda: None)
    assert rec.check_recompiles() == []  # never captured: no baseline yet
    g.captures = 1
    assert rec.check_recompiles() == []  # first capture = warm
    assert rec.check_recompiles() == []
    g.captures = 3
    assert rec.check_recompiles() == ["fused_attn"]
    assert rec.recompiles == {"fused_attn": 2}
    g.captures = 4
    assert rec.check_recompiles() == ["fused_attn"] and rec.recompiles == {"fused_attn": 3}


@pytest.mark.parametrize("layout, spec, name", [("slots", False, "fused_step"), ("paged", False, "fused_attn"),
                                                ("slots", True, "verify_step"), ("paged", True, "verify_attn")])
def test_engine_registers_its_graph_under_ray_tpu_names(params, layout, spec, name):
    eng = _engine(params[1], kv_layout=layout, page_size=16, speculative=SpecConfig() if spec else None)
    entries = eng._tel.recorder._entries
    assert list(entries) == [name] and entries[name][0] is eng._decode
    assert _engine(params[1], kv_layout=layout, page_size=16, device_resident=False)._tel.recorder._entries == {}


# -------------------------------------------------------------- exposition
def test_prometheus_exposition_golden_histogram_equals_ray_tpu():
    """The same observations through both packages' histograms: the
    exposition lines of that metric are equal (cumulative ``le`` buckets,
    +Inf, _count, _sum, label escaping), and HELP escapes newlines."""
    tag_val = 'a"b\\c'
    texts = []
    for m in (tmetrics, jmetrics):
        h = m.Histogram("golden_torch_hist_s", description="golden histogram", boundaries=[0.1, 1.0],
                        tag_keys=("route",))
        for v in (0.05, 0.5, 5.0):
            h.observe(v, tags={"route": tag_val})
        m.Counter("golden_torch_desc_total", description="line1\nline2").inc(1)
        text = m.export_prometheus()
        texts.append([ln for ln in text.splitlines() if "golden_torch_" in ln])
    assert texts[0] == texts[1]
    esc = 'route="a\\"b\\\\c"'
    assert f'golden_torch_hist_s_bucket{{{esc},le="0.1"}} 1' in texts[0]
    assert f'golden_torch_hist_s_bucket{{{esc},le="+Inf"}} 3' in texts[0]
    assert f"golden_torch_hist_s_sum{{{esc}}} 5.55" in texts[0]
    assert "# HELP golden_torch_desc_total line1\\nline2" in texts[0]
    with pytest.raises(ValueError, match="already registered"):
        tmetrics.Gauge("golden_torch_hist_s")


def test_slo_metrics_flow_into_exposition(params):
    eng = _engine(params[1], telemetry_tags={"model": "slo-test", "replica": "r0"})
    eng.generate([[1, 2, 3, 4, 5]], SamplingParams(max_tokens=8))
    text = tmetrics.export_prometheus()

    def series(name):
        return [ln for ln in text.splitlines() if ln.startswith(name) and 'model="slo-test"' in ln]

    assert float(series("rt_llm_ttft_s_count")[0].split()[-1]) == 1
    assert float(series("rt_llm_itl_s_count")[0].split()[-1]) == 7
    assert series("rt_llm_tokens_total") and series("rt_llm_kv_occupancy") and series("rt_llm_queue_wait_s_count")
    assert float(series("rt_llm_recompiles_total")[0].split()[-1]) == 0
    fin = [ln for ln in series("rt_llm_requests_finished_total") if 'reason="length"' in ln]
    assert fin and float(fin[0].split()[-1]) == 1


def test_telemetry_off_is_really_off(params):
    before = tmetrics.get_metrics_snapshot().get("rt_llm_ttft_s", {}).get("series", {})
    eng = _engine(params[1], telemetry=False, telemetry_tags={"model": "off-test"})
    out = eng.generate([[1, 2, 3]], SamplingParams(max_tokens=4))[0]
    assert len(out.token_ids) == 4 and eng.telemetry() == {} and eng._tel is None
    after = tmetrics.get_metrics_snapshot().get("rt_llm_ttft_s", {}).get("series", {})
    assert after == before and not any("off-test" in key for key in after)


# -------------------------------------------------------------- postmortem
def test_engine_error_dumps_flight_jsonl(params, monkeypatch, tmp_path):
    """A dying engine writes its step history as JSONL under the port's
    session dir before the error surfaces, once per engine."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("RT_SESSION_PID", raising=False)
    eng = _engine(params[1], telemetry_tags={"model": "crash-test"})
    eng.generate([[1, 2, 3]], SamplingParams(max_tokens=2))

    def boom(*a, **kw):
        raise RuntimeError("injected decode failure")

    eng._decode.step = boom
    eng.add_request([4, 5, 6], SamplingParams(max_tokens=4))
    with pytest.raises(RuntimeError, match="injected decode failure"):
        while eng.has_unfinished():
            eng.step()
    d = os.path.join(ttracing.session_dir(), "llm_flight")
    assert d.startswith(str(tmp_path)) and "ray_tpu_torch" in d
    dumps = sorted(os.listdir(d))
    assert dumps
    lines = [json.loads(ln) for ln in open(os.path.join(d, dumps[-1])) if ln.strip()]
    assert lines[0]["kind"] == "flight_header" and "injected decode failure" in lines[0]["error"]
    assert lines[0]["tags"]["model"] == "crash-test" and lines[0]["kv_layout"] == "slots"
    assert {ln["kind"] for ln in lines[1:]} == {"step", "request"}
    assert eng._tel.dump_on_error(RuntimeError("again")) is None


def test_tracing_spans_under_the_session_dir(params, monkeypatch, tmp_path):
    """RT_TRACING on: one request's admission, prefill, first-token, decode
    and request spans, one trace id, in the port's span file."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("RT_SESSION_PID", raising=False)
    ttracing.shutdown()
    monkeypatch.setattr(ttracing, "_enabled", True)
    try:
        _engine(params[1]).generate([1, 2, 3], SamplingParams(max_tokens=3))
        ttracing.shutdown()
        spans = ttracing.load_spans()
    finally:
        ttracing.shutdown()
    names = [s["name"] for s in spans]
    assert set(names) == {"llm.admission", "llm.prefill", "llm.first_token", "llm.decode", "llm.request"}
    assert len({s["trace_id"] for s in spans}) == 1
    with ttracing.span("outer") as sp:
        assert ttracing.child_context() == (sp.trace_id, sp.span_id)


# ------------------------------------------------- parity with ray_tpu's engine
def _synced(fn):
    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


def _schedule():
    """Staggered admissions of 6 prompts of 52-62 tokens (3 slots, the rest
    waiting), 24-30 new tokens each, one aborted at step 8."""
    rng = np.random.default_rng(11)
    sched = {}
    for i in range(6):
        prompt = [int(t) for t in rng.integers(1, 500, size=int(rng.integers(52, 63)))]
        sched.setdefault(int(rng.integers(0, 6)), []).append((prompt, dict(max_tokens=int(rng.integers(24, 31)))))
    return sched


def _drive(eng, cls, sched, aborts):
    ids, t = [], 0
    while t <= max(sched) or eng.has_unfinished():
        for prompt, sp in sched.get(t, []):
            ids.append(eng.add_request(prompt, cls(**sp)))
        if t in aborts:
            eng.abort_request(ids[aborts[t]])
        eng.step()
        t += 1
        assert t < 400


def _series(tel, name, **extra):
    key = tuple(str({**tel.tags, **extra}.get(k, "")) for k in tel.m[name].tag_keys)
    return tel.m[name]._series.get(key)


@pytest.mark.parametrize("layout, device_resident, spec", [
    ("slots", True, False), ("slots", False, False), ("paged", True, False), ("paged", False, False),
    ("slots", True, True), ("paged", True, True)],
    ids=["slots-resident", "slots-sync", "paged-resident", "paged-sync", "slots-spec", "paged-spec"])
def test_records_equal_ray_tpu_engine(params, layout, device_resident, spec):
    """The same schedule through ray_tpu's engine and the port's (paged: 12
    pages of 16, so growth past 80 positions preempts): equal step records but the clocks,
    equal request records' tokens / prompt tokens / preemptions / reasons,
    equal histogram counts and counters."""
    jp, tp = params
    kw = dict(max_num_seqs=3, max_seq_len=128, kv_layout=layout, page_size=16, device_resident=device_resident,
              enable_prefix_caching=False)
    if layout == "paged":
        kw["num_pages"] = 12
    tag = f"parity-{layout}-{device_resident}-{spec}"
    je = JaxEngine(JCFG, jp, telemetry_tags={"model": tag}, speculative=JaxSpec(k=3) if spec else None, **kw)
    for name in SETTLED:
        if hasattr(je, name):
            setattr(je, name, _synced(getattr(je, name)))
    te = LLMEngine(TCFG, tp, device="cpu", telemetry_tags={"model": tag}, speculative=SpecConfig(k=3) if spec else None,
                   **kw)
    sched, aborts = _schedule(), {8: 2}
    for eng, cls in ((je, JaxParams), (te, SamplingParams)):
        _drive(eng, cls, sched, aborts)
    js, ts = je.telemetry(), te.telemetry()
    strip = lambda rows: [{k: v for k, v in r.items() if k not in CLOCKS} for r in rows]  # noqa: E731
    assert ts["step_count"] == js["step_count"]
    assert strip(ts["steps"]) == strip(js["steps"])
    pick = lambda rows: [{k: r[k] for k in REQUEST_FIELDS} for r in rows]  # noqa: E731
    assert pick(ts["requests"]) == pick(js["requests"])
    assert {r["reason"] for r in ts["requests"]} >= {"length", "aborted"}
    assert ts["recompiles"] == js["recompiles"] == {}
    for name in HISTOGRAMS:
        assert _series(te._tel, name)[0] == _series(je._tel, name)[0], name
    for name in COUNTERS:
        assert _series(te._tel, name) == _series(je._tel, name), name
    for reason in ("length", "aborted"):
        assert (_series(te._tel, "rt_llm_requests_finished_total", reason=reason)
                == _series(je._tel, "rt_llm_requests_finished_total", reason=reason))
    if spec:
        assert any("spec_k" in r for r in ts["steps"])
        assert _series(te._tel, "rt_llm_spec_acceptance") == _series(je._tel, "rt_llm_spec_acceptance")
    if layout == "paged":
        assert te.preemption_count == je.preemption_count > 0
        assert sum(r["preemptions"] for r in ts["requests"]) == te.preemption_count
