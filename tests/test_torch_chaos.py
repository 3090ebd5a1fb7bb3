"""The port's chaos plane (``ray_tpu_torch/chaos.py``) and its gate at
``llm.suspend`` against ray_tpu's, on the CPU.

- The plane: the site table and fault modes equal to ray_tpu's, inject's
  refusals, and the same rule schedules (probabilistic drops under one
  seed, ``after``, ``max_hits``, ``methods``, delays and injected
  faults) giving the same outcomes call for call; inert when empty.
- The fault taxonomy: every mode a site declares is registered with
  ray_tpu's status code, and ``ChaosError`` is stamped from its row.
- ``llm.suspend``: tests/test_llm_chaos.py's and
  tests/test_llm_kv_tiering.py's scenarios on a port engine beside a
  ray_tpu engine: an injected fault or a drop refuses with a typed
  MigrationError (500, not retryable, the injected error on
  ``__cause__``), the conversation untouched and RUNNING, and its stream
  then equal to ray_tpu's and to the uninterrupted run's; a delay rule
  only delays.

The port's plane is cleared and seeded around every test by this file's
own fixture (the conftest fixture clears ray_tpu's only). Engines are
LlamaConfig.tiny in f32, 2 slots, on weights converted from ray_tpu's;
ray_tpu's engines have every program settled (ROADMAP.md queue 3).
"""

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu import chaos as jchaos  # noqa: E402
from ray_tpu import exceptions as jexc  # noqa: E402
from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import migrate as jmig  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch import chaos as tchaos  # noqa: E402
from ray_tpu_torch import exceptions as texc  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: E402
from ray_tpu_torch.llm import migrate as tmig  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(dtype="float32", remat=False, max_seq_len=256)
ENG = dict(max_num_seqs=2, max_seq_len=128)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell", "_extract_slots", "_extract_paged")
PROMPT = [int(x) for x in np.random.default_rng(11).integers(1, 511, size=24)]
GREEDY = dict(max_tokens=10)
SEEDED = dict(max_tokens=10, temperature=0.8, seed=5, top_k=20)


@pytest.fixture(autouse=True)
def _port_chaos_hygiene():
    """The port's chaos plane, cleared and seeded around every test."""
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


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _synced(fn):
    def run(*args):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args))

    return run


def jax_engine(jp):
    je = JaxEngine(jllama.LlamaConfig.tiny(**KW), jp, telemetry=False, **ENG)
    for name in SETTLED:
        if hasattr(je, name):
            setattr(je, name, _synced(getattr(je, name)))
    return je


def torch_engine(tp):
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", telemetry=False, **ENG)


# ----------------------------------------------------------------- plane
def test_site_table_and_fault_modes_equal_ray_tpus():
    assert tchaos.SITES == jchaos.SITES
    assert tchaos.FAULT_MODES == jchaos.FAULT_MODES
    assert set(tchaos.FAULT_MODES) == set(tchaos.SITES)
    # every declared mode has ray_tpu's row (the object plane's
    # ObjectLostError included)
    missing = {n for names in tchaos.FAULT_MODES.values() for n in names} - set(texc.SERVING_ERRORS)
    assert missing == set()
    for names in tchaos.FAULT_MODES.values():
        for name in names:
            spec = texc.SERVING_ERRORS[name]
            assert (spec.status_code, spec.retryable) == (jexc.SERVING_ERRORS[name].status_code,
                                                          jexc.SERVING_ERRORS[name].retryable), name


def test_fault_taxonomy_registry_agreement():
    """tests/test_llm_chaos.py's three-way contract on the port's side."""
    spec = texc.serving_error_spec(tchaos.ChaosError("x"))
    assert spec is texc.SERVING_ERRORS["ChaosError"]
    assert (tchaos.ChaosError.status_code, tchaos.ChaosError.retryable) == (jchaos.ChaosError.status_code,
                                                                            jchaos.ChaosError.retryable) == (500, False)
    for spec in texc.SERVING_ERRORS.values():
        assert 400 <= spec.status_code < 600


def test_marker_registered_and_fixture_reseeds():
    """The fixture hands every test a cleared, seeded plane; the rpc
    namespace is accepted as ray_tpu accepts it."""
    assert not tchaos.active()
    r = tchaos.inject("serve.step", drop_prob=0.5, max_hits=0)
    assert tchaos.active() and r.hits == 0
    assert tchaos.apply("serve.step") is True and r.seen == 1 and r.hits == 0
    tchaos.inject("rpc.x", delay_s=0.0)
    tchaos.clear("rpc.")
    assert set(tchaos.rules()) == {"serve.step"}
    tchaos.clear()
    assert not tchaos.active() and tchaos.apply("serve.step") is True


@pytest.mark.parametrize("site,kw", [("nope.site", {}), ("llm.suspend", {"raises": "boom"}),
                                     ("llm.suspend", {"raises": int})])
def test_inject_refusals_equal_ray_tpus(site, kw):
    errs = []
    for chaos in (jchaos, tchaos):
        with pytest.raises((ValueError, TypeError)) as ei:
            chaos.inject(site, **kw)
        errs.append(type(ei.value))
    assert errs[0] is errs[1]


def _schedule(chaos):
    """Every rule kind over one seeded plane: the outcome of each apply."""

    def outcome(site, method=None):
        try:
            return chaos.apply(site, method)
        except Exception as e:  # noqa: BLE001 — the class and message are the outcome
            return (type(e).__name__, str(e))

    chaos.seed(123)
    out = []
    r1 = chaos.inject("handoff.fetch", drop_prob=0.5)
    out += [outcome("handoff.fetch") for _ in range(40)]
    r2 = chaos.inject("kvplane.index", fail_prob=0.3, methods=("lookup",), after=3, max_hits=12)
    out += [outcome("kvplane.index", m) for m in ["lookup", "register"] * 20]
    r3 = chaos.inject("llm.suspend", raises=KeyError, max_hits=2)
    out += [outcome("llm.suspend") for _ in range(4)]
    out += [outcome("serve.preempt"), (r1.hits, r1.seen, r2.hits, r2.seen, r3.hits, r3.seen), sorted(chaos.rules())]
    chaos.clear()
    return out


def test_rule_schedules_equal_ray_tpus():
    want, got = _schedule(jchaos), _schedule(tchaos)
    assert got == want
    assert 5 < sum(x is False for x in got[:40]) < 35  # drops are live
    assert got[-2] == (40, 40, 12, 20, 2, 4)


def test_delay_rule_sleeps_inline():
    tchaos.inject("kvplane.prefetch", delay_s=0.05, max_hits=1)
    t0 = time.perf_counter()
    assert tchaos.apply("kvplane.prefetch") is True
    assert time.perf_counter() - t0 >= 0.05
    t0 = time.perf_counter()
    assert tchaos.apply("kvplane.prefetch") is True  # max_hits spent: passthrough
    assert time.perf_counter() - t0 < 0.05


# ------------------------------------------------------------ llm.suspend
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
                return list(o.token_ids)
    raise AssertionError("request never finished")


@pytest.mark.parametrize("sp", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_suspend_fault_is_migration_error_with_cause(params, sp):
    """tests/test_llm_chaos.py's scenario on both packages: an injected
    ChaosError at llm.suspend surfaces as MigrationError (500, not
    retryable) with the ChaosError on __cause__; the refusal mutates
    nothing, a later suspend spills the same bytes as ray_tpu's, and the
    resumed stream equals ray_tpu's."""
    jp, tp = params
    outs = []
    for eng, chaos, mig, P in ((jax_engine(jp), jchaos, jmig, JaxParams), (torch_engine(tp), tchaos, tmig,
                                                                           SamplingParams)):
        rid = eng.add_request(list(PROMPT), P(**sp))
        _run_until(eng, rid, 3)
        chaos.inject("llm.suspend", raises=chaos.ChaosError)
        with pytest.raises(mig.MigrationError) as ei:
            eng.suspend_request(rid, publish=False)
        assert isinstance(ei.value.__cause__, chaos.ChaosError)
        spec = type(ei.value).status_code, type(ei.value).retryable
        chaos.clear()
        assert not eng._requests[rid].finished and eng.suspended_requests() == []
        info = eng.suspend_request(rid, publish=False)
        eng.resume_suspended(rid)
        outs.append((spec, info["nbytes"], eng.suspend_stats(), _finish(eng, rid)))
    assert outs[1] == outs[0]
    assert outs[1][0] == (500, False) and outs[1][1] > 0 and len(outs[1][3]) == sp["max_tokens"]


def test_suspend_chaos_typed_and_conversation_untouched(params):
    """tests/test_llm_kv_tiering.py's scenario: a DROP and an injected
    RuntimeError at llm.suspend both refuse with MigrationError before any
    state mutates; the conversation finishes equal to the uninterrupted
    run's, on both packages; a delay rule only delays the spill."""
    jp, tp = params
    streams = []
    for eng, chaos, mig, P in ((jax_engine(jp), jchaos, jmig, JaxParams), (torch_engine(tp), tchaos, tmig,
                                                                           SamplingParams)):
        want = list(eng.generate(list(PROMPT), P(**GREEDY)).token_ids)
        rid = eng.add_request(list(PROMPT), P(**GREEDY))
        _run_until(eng, rid, 4)
        chaos.inject("llm.suspend", drop_prob=1.0)
        with pytest.raises(mig.MigrationError, match="dropped"):
            eng.suspend_request(rid)
        chaos.inject("llm.suspend", raises=RuntimeError)
        with pytest.raises(mig.MigrationError, match="faulted"):
            eng.suspend_request(rid)
        chaos.clear()
        assert not eng._requests[rid].finished and eng.suspended_requests() == []
        assert eng.suspend_stats()["suspended"] == 0
        got = _finish(eng, rid)
        assert got == want
        streams.append(got)
    assert streams[1] == streams[0]
    # the port alone: a delay rule is a slow spill, not a refusal
    eng = torch_engine(tp)
    rid = eng.add_request(list(PROMPT), SamplingParams(**GREEDY))
    _run_until(eng, rid, 4)
    rule = tchaos.inject("llm.suspend", delay_s=0.05)
    t0 = time.perf_counter()
    assert eng.suspend_request(rid)["nbytes"] > 0
    assert time.perf_counter() - t0 >= 0.05 and rule.hits == 1
    eng.resume_suspended(rid)
    assert _finish(eng, rid) == streams[1]
