"""The port's tensor-parallel engine (``mesh=create_mesh(tp=n, devices=["cpu"] * n)``:
rank 0 in the test process, n-1 rank processes over gloo) against the
port's tp=1 engine and against ray_tpu's tp engine on the same weights:
twins of every case of ``tests/test_llm_tp.py`` and of
``tests/test_llm.py``'s ``test_tp_sharded_engine_matches_single_device``
and ``test_tp_engine_rejects_indivisible_kv_heads``.

ray_tpu's tp engine runs through a test-side shim: its
``model_runner._tp_shard_map`` passes no ``check_vma`` and jax 0.9's
``shard_map`` then refuses the fused step's replicated outputs, so the
``ray_tpu_tp`` fixture rebinds it, with ``monkeypatch``, to
``jax.shard_map(..., check_vma=False)`` (no ray_tpu file changes). Its
programs are settled (inputs and outputs ready around each call) as
``tests/test_torch_engine.py`` settles its paged engine. Tokens compare
exactly; the int8 collective's logit drift is bounded by 0.2 as in
ray_tpu. Each port engine here starts its rank processes (~2 s each)."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ray_tpu.llm.model_runner as jmr  # noqa: E402
import ray_tpu.llm.spec.verify as jverify  # noqa: E402
from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm.spec import SpecConfig as JaxSpec  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.parallel.mesh import create_mesh as jax_mesh  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams, SpecConfig  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.parallel.mesh import create_mesh  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

KW = dict(num_heads=4, num_kv_heads=4, dtype="float32", max_seq_len=256)
CFG_J = jllama.LlamaConfig.tiny(attention_impl="xla", **KW)
CFG_T = tllama.LlamaConfig.tiny(**KW)
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell", "_verify_step", "_verify_attn", "_verify_append", "_set_hist",
           "_set_slot_scalar")
LAYOUTS = pytest.mark.parametrize("layout", ["slots", "paged"])


def _shard_map_unchecked(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, axis_names={"tp"}, check_vma=False)


@pytest.fixture
def ray_tpu_tp(monkeypatch):
    """The shim, where ray_tpu binds the name: its model runner and its
    spec verify (which imports it at module load)."""
    monkeypatch.setattr(jmr, "_tp_shard_map", _shard_map_unchecked)
    monkeypatch.setattr(jverify, "_tp_shard_map", _shard_map_unchecked)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for rank 0 here and (they copy it) each rank
    process: several processes' thread pools spin against each other. The
    ranks' PYTHONPATH gets this directory, for tests/torch_tp_defs.py's
    probes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.dirname(os.path.abspath(__file__)), old) if p)
    yield
    torch.set_num_threads(n)
    if old is None:
        os.environ.pop("PYTHONPATH")
    else:
        os.environ["PYTHONPATH"] = old


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(CFG_J, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _synced(fn):
    def run(*args, **kw):
        jax.block_until_ready(args)
        return jax.block_until_ready(fn(*args, **kw))

    return run


def _jax_engine(cfg, jp, **kw):
    je = JaxEngine(cfg, jp, telemetry=False, **kw)
    for name in SETTLED:
        if hasattr(je, name):
            setattr(je, name, _synced(getattr(je, name)))
    return je


def _mesh(n=2):
    return create_mesh(tp=n, devices=["cpu"] * n)


def _jmesh(n=2):
    return jax_mesh(tp=n, devices=jax.devices()[:n])


def _drive(eng, schedule, sp_cls, max_steps=500):
    """Step an engine over a step-indexed admission schedule; returns
    ({index: tokens}, {index: reason})."""
    finals, reasons, ids = {}, {}, {}
    last_t = max(schedule)
    t = 0
    while t <= last_t or eng.has_unfinished():
        for prompt, sp in schedule.get(t, []):
            ids[eng.add_request(prompt, sp_cls(**sp))] = len(ids)
        for o in eng.step():
            if o.finished:
                finals[ids[o.request_id]] = list(o.token_ids)
                reasons[ids[o.request_id]] = o.finish_reason
        t += 1
        assert t < max_steps, "schedule never converged"
    return finals, reasons


def _mixed_schedule(seed=0, n=6):
    """test_llm_tp.py's: staggered admissions, varying lengths and budgets,
    one seeded stochastic lane."""
    rng = np.random.default_rng(seed)
    sched = {}
    for _ in range(n):
        prompt = [int(t) for t in rng.integers(1, CFG_T.vocab_size - 1, size=int(rng.integers(4, 60)))]
        sp = dict(max_tokens=int(rng.integers(3, 12)), temperature=0.0)
        sched.setdefault(int(rng.integers(0, 8)), []).append((prompt, sp))
    sched.setdefault(1, []).append(([7, 7, 7], dict(max_tokens=8, temperature=1.0, seed=123)))
    return sched


@LAYOUTS
def test_tp2_fused_token_identical(params, ray_tpu_tp, layout):
    """tp=2 over two gloo ranks == the port's tp=1 == ray_tpu's tp=2 under
    the mixed schedule (greedy and seeded, slot recycling), both layouts;
    the rank holds half the heads and kv heads."""
    jp, tp = params
    sched = _mixed_schedule()
    kw = dict(max_num_seqs=3, max_seq_len=128, kv_layout=layout)
    if layout == "paged":
        kw["page_size"] = 32
    base = _drive(LLMEngine(CFG_T, tp, device="cpu", **kw), sched, SamplingParams)
    eng = LLMEngine(CFG_T, tp, mesh=_mesh(2), **kw)
    try:
        got = _drive(eng, sched, SamplingParams)
        assert eng.params["layers"]["wq"].shape[-1] == CFG_T.num_heads * CFG_T.hd // 2
        assert eng.kv["k"].shape[3] == CFG_T.num_kv_heads // 2
        assert len(eng.tp_pids) == 1
    finally:
        eng.shutdown()
    ref = _drive(_jax_engine(CFG_J, jp, mesh=_jmesh(2), **kw), sched, JaxParams)
    assert got == base
    assert got == ref


@LAYOUTS
def test_tp2_int8_kv_cache_composes(params, ray_tpu_tp, layout):
    """cache_dtype='int8' at tp=2: each rank's scale lanes hold its kv heads;
    streams equal the port's tp=1 int8 engine's and ray_tpu's tp=2's."""
    jp, tp = params
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6], [4, 4, 4, 4, 4, 4]]
    kw = dict(max_num_seqs=4, max_seq_len=64, kv_layout=layout, cache_dtype="int8")
    if layout == "paged":
        kw["page_size"] = 16
    base = [o.token_ids for o in LLMEngine(CFG_T, tp, device="cpu", **kw).generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=10))]
    eng = LLMEngine(CFG_T, tp, mesh=_mesh(2), **kw)
    try:
        got = [o.token_ids for o in eng.generate(prompts, SamplingParams(temperature=0.0, max_tokens=10))]
        assert eng.kv["k_scale"].shape[2] == CFG_T.num_kv_heads // 2
        assert eng.kv_cache_stats()["allocated_bytes"] == 2 * sum(
            t.numel() * t.element_size() for n, t in eng.kv.items() if n != "length")
    finally:
        eng.shutdown()
    ref = [o.token_ids for o in _jax_engine(CFG_J, jp, mesh=_jmesh(2), **kw).generate(
        prompts, JaxParams(temperature=0.0, max_tokens=10))]
    assert got == base == ref


@LAYOUTS
def test_tp2_spec_ngram_composes(params, ray_tpu_tp, layout):
    """n-gram speculation at tp=2: the verify forward runs per rank; streams
    equal the port's plain tp=1 engine's and ray_tpu's tp=2 spec engine's,
    with real acceptances."""
    jp, tp = params
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5, 6, 5]]
    kw = dict(max_num_seqs=4, max_seq_len=64, kv_layout=layout)
    if layout == "paged":
        kw["page_size"] = 16
    base = [o.token_ids for o in LLMEngine(CFG_T, tp, device="cpu", **kw).generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=14))]
    eng = LLMEngine(CFG_T, tp, mesh=_mesh(2), speculative=SpecConfig(k=3), **kw)
    try:
        got = [o.token_ids for o in eng.generate(prompts, SamplingParams(temperature=0.0, max_tokens=14))]
        stats = eng.spec_stats()
    finally:
        eng.shutdown()
    je = _jax_engine(CFG_J, jp, mesh=_jmesh(2), speculative=JaxSpec(k=3), **kw)
    ref = [o.token_ids for o in je.generate(prompts, JaxParams(temperature=0.0, max_tokens=14))]
    assert got == base == ref
    assert stats["rounds"] > 0 and stats["accepted"] > 0
    assert stats["accepted"] == je.spec_stats()["accepted"]


@LAYOUTS
def test_tp2_prefix_hits_compose(params, ray_tpu_tp, layout):
    """Prefix caching at tp=2: a leader's prompt is stored (each rank keeps
    its kv heads of the group), followers hit it and extend their suffix
    on every rank; streams and hit counts equal the port's tp=1 engine's
    and ray_tpu's tp=2 engine's, and rank 1 drops a group's shards once
    rank 0's copy is gone."""
    jp, tp = params
    rng = np.random.default_rng(4)
    prefix = [int(t) for t in rng.integers(1, 500, size=40)]
    leader = prefix + [5, 6, 7]
    followers = [prefix + [int(t) for t in rng.integers(1, 500, size=n)] for n in (3, 9, 17)]
    kw = dict(max_num_seqs=2, max_seq_len=128, kv_layout=layout, prefix_block=16,
              prefill_buckets=(16, 32, 64, 128))
    if layout == "paged":
        kw["page_size"] = 16

    def run(eng, sp_cls):
        first = eng.generate(leader, sp_cls(temperature=0.0, max_tokens=6)).token_ids
        rest = [o.token_ids for o in eng.generate(followers, sp_cls(temperature=0.0, max_tokens=6))]
        return [first] + rest, {k: eng.prefix_cache_stats()[k] for k in ("hits", "misses", "tokens_saved")}

    base = run(LLMEngine(CFG_T, tp, device="cpu", **kw), SamplingParams)
    eng = LLMEngine(CFG_T, tp, mesh=_mesh(2), **kw)
    try:
        got = run(eng, SamplingParams)
        held = eng.tp_call("torch_tp_defs", "prefix_groups")
        eng._prefix_cache.max_bytes = 0  # the next store evicts every group
        while eng._prefix_cache._order:
            eng._prefix_cache._evict_one()
        eng.generate([1, 2, 3], SamplingParams(max_tokens=2))  # an operation carries the drops
        after = eng.tp_call("torch_tp_defs", "prefix_groups")
    finally:
        eng.shutdown()
    ref = run(_jax_engine(CFG_J, jp, mesh=_jmesh(2), **kw), JaxParams)
    assert got == base == ref
    assert got[1]["hits"] == 3
    assert held[0] == 0 and held[1] == len(eng._prefix_cache._groups) + eng._prefix_cache.evictions > 0
    assert after == [0, 0]


def test_model_drafter_mesh_is_named_gap(params):
    """A draft model at tp raises NotImplementedError naming what is
    missing, before any rank starts; ray_tpu raises the same."""
    _, tp = params
    dcfg = tllama.LlamaConfig.tiny(num_heads=4, num_kv_heads=4, dtype="float32")
    with pytest.raises(NotImplementedError, match="draft model"):
        LLMEngine(CFG_T, tp, mesh=_mesh(2), max_num_seqs=2, max_seq_len=64,
                  speculative=SpecConfig(k=3, drafter="model", draft_config=dcfg))


def test_tp_divisibility_validation():
    """Every tp-sharded dimension is checked at construction with ray_tpu's
    messages, before any rank starts."""
    mesh4 = _mesh(4)
    tiny = tllama.LlamaConfig.tiny
    with pytest.raises(ValueError, match="num_kv_heads"):
        LLMEngine(tiny(dtype="float32"), max_seq_len=64, mesh=mesh4)  # 2 kv heads
    with pytest.raises(ValueError, match="num_heads"):
        LLMEngine(tiny(num_heads=6, num_kv_heads=4, head_dim=16, dtype="float32"), max_seq_len=64, mesh=mesh4)
    with pytest.raises(ValueError, match="intermediate_size"):
        LLMEngine(tiny(num_heads=4, num_kv_heads=4, intermediate_size=250, dtype="float32"), max_seq_len=64,
                  mesh=mesh4)
    with pytest.raises(ValueError, match="vocab_size"):
        LLMEngine(tiny(num_heads=4, num_kv_heads=4, vocab_size=514, dtype="float32"), max_seq_len=64, mesh=mesh4)
    with pytest.raises(ValueError, match="tp_collective"):
        LLMEngine(tiny(num_heads=4, num_kv_heads=4, dtype="float32"), max_seq_len=64, tp_collective="int8",
                  device="cpu")
    with pytest.raises(ValueError, match="hidden_size"):
        LLMEngine(tiny(num_heads=4, num_kv_heads=4, hidden_size=126, head_dim=32, vocab_size=512, dtype="float32"),
                  max_seq_len=64, mesh=mesh4, tp_collective="int8")
    with pytest.raises(ValueError, match="'fp' or 'int8'"):
        LLMEngine(tiny(dtype="float32"), max_seq_len=64, tp_collective="bf8", device="cpu")


def _successor_params(cfg, period=16):
    """test_llm_tp.py's decisive-logits copy model: attention and MLP
    zeroed, the unembedding wired so greedy decode follows t -> (t+1) % period."""
    p = jllama.init_params(cfg, jax.random.PRNGKey(0))
    z = jax.tree.map(jnp.zeros_like, p["layers"])
    layers = dict(p["layers"])
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        layers[k] = z[k]
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(1), p["embed"].shape, jnp.float32)) * 0.1
    un = np.zeros(p["unembed"].shape, np.float32)
    for t in range(period):
        un += np.outer(emb[t], np.eye(cfg.vocab_size, dtype=np.float32)[(t + 1) % period]) * 4.0
    return {**p, "layers": layers, "embed": jnp.asarray(emb), "unembed": jnp.asarray(un)}


def test_tp_collective_int8_exact_top1_on_decisive_workload(ray_tpu_tp):
    """int8 vs fp collectives vs tp=1 on the successor workload: identical
    greedy streams on both packages; per-step wire bytes of the int8
    step's per-layer sums under 0.55x the fp step's."""
    jp = _successor_params(CFG_J)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompts = [[0, 1, 2, 3], [8, 9, 10]]
    kw = dict(max_num_seqs=2, max_seq_len=64)
    base = [o.token_ids for o in LLMEngine(CFG_T, tp, device="cpu", **kw).generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=12))]
    out, wire = {}, {}
    for coll in ("fp", "int8"):
        eng = LLMEngine(CFG_T, tp, mesh=_mesh(2), tp_collective=coll, **kw)
        try:
            out[coll] = [o.token_ids for o in eng.generate(prompts, SamplingParams(temperature=0.0, max_tokens=12))]
            wire[coll] = eng.tp_wire_step_bytes
            assert eng.telemetry()["wire_bytes_per_step"] == wire[coll]
        finally:
            eng.shutdown()
    jq = [o.token_ids for o in _jax_engine(CFG_J, jp, mesh=_jmesh(2), tp_collective="int8", **kw).generate(
        prompts, JaxParams(temperature=0.0, max_tokens=12))]
    assert out["fp"] == base and out["int8"] == base and jq == base
    assert base[0][:4] == [4, 5, 6, 7]
    # once-a-step terms at B = 2 lanes: the embed sum (f32 [2, 1, H]) and the logits gather
    once = 2 * 1 * CFG_T.hidden_size * 4 + 2 * (CFG_T.vocab_size // 2) * 4
    assert wire["int8"] - once < 0.55 * (wire["fp"] - once), wire


def test_tp_mixed_mesh_falls_back_and_rejects_int8(params):
    """A mesh with axes besides tp cannot carry the int8 collective
    (ValueError, as ray_tpu), and is not ported (NotImplementedError naming
    the item)."""
    _, tp = params
    mixed = create_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="tp_collective"):
        LLMEngine(CFG_T, tp, mesh=mixed, max_seq_len=64, tp_collective="int8")
    with pytest.raises(NotImplementedError, match="queue 1, multi-device axes"):
        LLMEngine(CFG_T, tp, mesh=mixed, max_seq_len=64)


def test_tp_sharded_engine_matches_single_device(ray_tpu_tp):
    """test_llm.py's done-criterion at tp=4 (three rank processes): greedy
    decode equals the port's single-device engine and ray_tpu's tp=4."""
    cfg_j = jllama.LlamaConfig.tiny(num_heads=4, num_kv_heads=4, dtype="float32", attention_impl="xla",
                                    max_seq_len=128)
    cfg_t = tllama.LlamaConfig.tiny(num_heads=4, num_kv_heads=4, dtype="float32", max_seq_len=128)
    jp = jllama.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 1, 4, 1, 5, 9, 2, 6]]
    base = [o.token_ids for o in LLMEngine(cfg_t, tp, device="cpu", max_num_seqs=4, max_seq_len=64).generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=12))]
    eng = LLMEngine(cfg_t, tp, max_num_seqs=4, max_seq_len=64, mesh=_mesh(4))
    try:
        assert eng.kv["k"].shape[3] == 1 and len(eng.tp_pids) == 3
        got = [o.token_ids for o in eng.generate(prompts, SamplingParams(temperature=0.0, max_tokens=12))]
    finally:
        eng.shutdown()
    ref = [o.token_ids for o in _jax_engine(cfg_j, jp, max_num_seqs=4, max_seq_len=64, mesh=_jmesh(4)).generate(
        prompts, JaxParams(temperature=0.0, max_tokens=12))]
    assert got == base == ref


def test_tp_engine_rejects_indivisible_kv_heads():
    with pytest.raises(ValueError, match="num_kv_heads"):
        LLMEngine(tllama.LlamaConfig.tiny(dtype="float32"), max_seq_len=64, mesh=_mesh(4))


def test_ranks_die_with_the_engine(params):
    """shutdown() stops the rank processes; an engine dropped without it is
    collected and its ranks stop too. The sync loop runs at tp as well."""
    import gc
    import os
    import time

    _, tp = params

    def gone(pid, within=30.0):
        end = time.time() + within
        while time.time() < end:
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                return True
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split(")")[-1].split()[0] == "Z":
                    return True
            time.sleep(0.05)
        return False

    prompts = [[1, 2, 3, 4], [5, 6, 7]]
    base = [o.token_ids for o in LLMEngine(CFG_T, tp, device="cpu", max_num_seqs=2, max_seq_len=64,
                                           device_resident=False).generate(prompts, SamplingParams(max_tokens=6))]
    eng = LLMEngine(CFG_T, tp, mesh=_mesh(2), max_num_seqs=2, max_seq_len=64, device_resident=False)
    assert [o.token_ids for o in eng.generate(prompts, SamplingParams(max_tokens=6))] == base
    (pid,) = eng.tp_pids
    eng.shutdown()
    eng.shutdown()
    assert gone(pid)
    eng = LLMEngine(CFG_T, tp, mesh=_mesh(2), max_num_seqs=2, max_seq_len=64)
    (pid,) = eng.tp_pids
    del eng
    gc.collect()
    assert gone(pid)


def test_a_failing_rank_raises_its_traceback(params):
    """An operation that raises in a rank process reaches rank 0 as a
    RankError carrying the rank's traceback; the rank exits, and the
    engine's next operation raises instead of waiting on it."""
    from ray_tpu_torch.parallel.ranks import RankError

    _, tp = params
    eng = LLMEngine(CFG_T, tp, mesh=_mesh(2), max_num_seqs=2, max_seq_len=64)
    try:
        with pytest.raises(RankError, match="probe failure in rank 1"):
            eng.tp_call("torch_tp_defs", "fail_on_rank", 1)
        with pytest.raises(RankError, match="rank 1"):
            eng.generate([1, 2, 3], SamplingParams(max_tokens=2))
    finally:
        eng.shutdown()
