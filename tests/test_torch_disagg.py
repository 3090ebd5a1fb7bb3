"""Disaggregated prefill/decode in the port (``ray_tpu_torch/llm/disagg/``
and the engine's handoff admission) against ray_tpu's, on the CPU.

- The extract and scatter-in functions against ray_tpu's, called op by
  op, on the same seeded slot cache and page pool, in every dtype
  direction (fp into fp, fp into int8, int8 with its wire scales into
  int8, int8 into fp, bf16 into bf16 and into int8): exact, the paged
  scatter's table row and length lane included; and extract -> scatter
  -> extract round trips. (ray_tpu's engine jits them; under jit XLA
  divides the quantizer's amax by 127 as a product with its reciprocal,
  one ulp off on some scales, so the op-by-op functions are the exact
  oracle, as in tests/test_torch_kv_cache.py.)
- The handoff codec against ray_tpu's: the same wire keys and meta on the
  same payload, and the same refusals (HandoffError, status 500, not
  retryable) over the malformed payloads of tests/test_llm_disagg.py.
- Across packages: a ray_tpu prefill engine's payloads admitted by the
  port's decode engine give ray_tpu's decode stream, and the port's
  payloads admitted by ray_tpu's decode engine give it too, on both
  layouts, greedy and seeded.
- The port alone: a disaggregated run equals the single-engine sync
  oracle with an abort (slots) and under decode-side preemption (paged),
  spec on the decode side, int8 handoffs and cross-dtype requantization,
  telemetry's handoff counters, and a prefill-only request's stash.
- The port imports neither jax nor ray_tpu (an ``ast`` scan).

Engines are LlamaConfig.tiny in f32, 2 slots, max_seq_len 128, the
weights converted from ray_tpu's (``params_from_jax``). ray_tpu's engines
have every program settled (``_synced``, ROADMAP.md queue 3)."""

import ast
import itertools
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm.disagg import handoff as jhandoff  # noqa: E402
from ray_tpu.llm.disagg import scatter as jscatter  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch import exceptions as texc  # noqa: E402
from ray_tpu_torch.llm import LLMEngine, SamplingParams, SpecConfig  # noqa: E402
from ray_tpu_torch.llm.disagg import handoff as thandoff  # noqa: E402
from ray_tpu_torch.llm.disagg import scatter as tscatter  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
KW = dict(dtype="float32", remat=False, max_seq_len=256)
ENG = dict(max_num_seqs=2, max_seq_len=128)
# every program of ray_tpu's engines, the handoff programs included; the ones an engine lacks are skipped
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_step", "_fused_attn", "_fused_append",
           "_set_lane", "_set_table", "_set_table_cell", "_extract_slots", "_extract_paged", "_scatter_slots",
           "_scatter_paged")
RNG = np.random.default_rng(11)
PROMPTS = [[int(t) for t in RNG.integers(1, 500, size=n)] for n in (30, 77)]
GREEDY = dict(max_tokens=10)
SEEDED = dict(max_tokens=10, temperature=0.8, seed=5, top_k=20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's tiny models (beside other test
    workers, torch's pool spins against the XLA runtime's)."""
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


_REPLICAS = itertools.count()


def torch_engine(tp, **kw):
    """A port engine on the host, tagged with a replica name of its own
    (the telemetry's series are per process, keyed by tags)."""
    kw.setdefault("telemetry_tags", {"replica": f"r{next(_REPLICAS)}"})
    return LLMEngine(tllama.LlamaConfig.tiny(**KW), tp, device="cpu", **{**ENG, **kw})


def to_numpy(payload: dict) -> dict:
    """A port payload (host tensors) as ray_tpu's (numpy arrays; bf16 as
    ml_dtypes bfloat16 through its bits)."""
    out = {}
    for name, x in payload.items():
        if isinstance(x, torch.Tensor):
            x = (x.view(torch.int16).numpy().view(jnp.bfloat16) if x.dtype == torch.bfloat16 else x.numpy())
        out[name] = x
    return out


def to_torch(x):
    """A ray_tpu array as a host tensor (a bf16 block through its bits)."""
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def same(t, j):
    """Exact equality, dtype included (bf16 compared as its bits)."""
    j = np.asarray(j)
    want = to_torch(j)
    assert t.dtype == want.dtype, (t.dtype, want.dtype)
    if t.dtype == torch.bfloat16:
        t, want = t.view(torch.int16), want.view(torch.int16)
    np.testing.assert_array_equal(t.numpy(), want.numpy())


def drive(eng, admits, aborts=None, max_steps=600):
    """Step an engine over admissions {step: [(admit_fn, key)]}; returns
    ({key: tokens}, {key: reason})."""
    finals, reasons, ids = {}, {}, {}
    t = 0
    last = max(admits) if admits else 0
    while t <= last or eng.has_unfinished():
        for admit, key in admits.get(t, []):
            ids[admit()] = key
        if aborts and t in aborts:
            eng.abort_request(next(r for r, k in ids.items() if k == aborts[t]))
        for o in eng.step():
            if o.finished and o.request_id in ids:
                finals[ids[o.request_id]] = list(o.token_ids)
                reasons[ids[o.request_id]] = o.finish_reason
        t += 1
        assert t < max_steps, "schedule never converged"
    return finals, reasons


# ------------------------------------------------------------------ imports
def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_ray_tpu():
    """Every module of ray_tpu_torch/ and chip_smoke.py, parsed: no import
    of jax (or jaxlib), none of ray_tpu (ray_tpu_torch is the port) and
    none of cloudpickle (the card's machine has none). Importing
    ray_tpu_torch.data and ray_tpu_torch.llm.batch in a fresh interpreter
    loads none of jax, ray_tpu, pyarrow, pandas or PIL (the data library
    imports those three only in the conversions and readers that need
    them)."""
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    # the serving control plane's modules and the object plane's are among them
    control = ["chaos.py", "exceptions.py", "serve/__init__.py", "serve/overload.py", "llm/kvplane/__init__.py",
               "llm/kvplane/index.py", "llm/kvplane/routing.py", "llm/kvplane/client.py", "llm/disagg/router.py",
               "_config.py", "core/ids.py", "core/task_spec.py", "core/serialization.py", "core/object_ref.py",
               "core/object_store.py", "core/payloads.py", "core/direct.py", "llm/kvplane/quant.py",
               # the runtime's modules
               "api.py", "accelerators/gpu.py", "core/context.py", "core/gcs.py", "core/table_store.py",
               "core/scheduler.py", "core/task_manager.py", "core/node.py", "core/worker_main.py", "core/runtime.py",
               "core/rpc_chaos.py", "util/placement_group.py", "util/scheduling_strategies.py",
               # the data library and batch inference
               "_native/__init__.py", "data/__init__.py", "data/block.py", "data/datasource.py", "data/executor.py",
               "data/iterator.py", "data/dataset.py", "llm/batch.py",
               # compiled graphs, device objects and RLlib's on-policy half
               "dag.py", "experimental/__init__.py", "experimental/channels.py", "experimental/compiled_dag.py",
               "experimental/device_objects.py", "rllib/__init__.py", "rllib/core/distributions.py",
               "rllib/core/rl_module.py", "rllib/core/learner.py", "rllib/env/env_runner.py", "rllib/env/episode.py",
               "rllib/env/multi_agent.py", "rllib/connectors/connector.py", "rllib/offline/json_io.py",
               "rllib/algorithms/algorithm.py", "rllib/algorithms/algorithm_config.py", "rllib/algorithms/ppo/ppo.py",
               "rllib/algorithms/impala/impala.py", "rllib/algorithms/appo/appo.py",
               # RLlib's off-policy and offline half
               "rllib/utils/replay_buffers.py", "rllib/algorithms/dqn/dqn.py", "rllib/algorithms/cql/cql.py",
               "rllib/algorithms/sac/sac.py", "rllib/algorithms/bc/bc.py", "rllib/algorithms/marwil/marwil.py",
               # cross-language and the cluster tooling
               "core/xlang.py", "core/lock_sanitizer.py", "autoscaler/__init__.py", "autoscaler/autoscaler.py",
               "autoscaler/launcher.py", "cluster_utils.py", "dashboard/__init__.py", "dashboard/dashboard.py",
               "dashboard/grafana.py", "util/profiling.py", "cpp/__init__.py",
               # tensor-parallel serving
               "parallel/mesh.py", "parallel/ranks.py", "collective/ici.py"]
    assert {REPO / "ray_tpu_torch" / name for name in control} <= set(files)
    bad = []
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "ray_tpu", "cloudpickle"):
                bad.append((str(path.relative_to(REPO)), mod))
    assert bad == []
    probe = ("import sys, ray_tpu_torch.data, ray_tpu_torch.llm.batch, ray_tpu_torch.dag, ray_tpu_torch.experimental, "
             "ray_tpu_torch.experimental.compiled_dag, ray_tpu_torch.rllib, ray_tpu_torch.autoscaler, "
             "ray_tpu_torch.dashboard, ray_tpu_torch.core.xlang, ray_tpu_torch.util.profiling, "
             "ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.ranks, ray_tpu_torch.collective.ici; "
             "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'ray_tpu', 'pyarrow', 'pandas', "
             "'PIL'}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


# ------------------------------------------------- extract and scatter-in
L, KVH, HD, T = 2, 2, 16, 32
B, S = 3, 64  # slots
P, PAGE, MAX_PG = 9, 8, 8  # pages
DIRECTIONS = [("float32", "float32"), ("float32", "int8"), ("int8", "int8"), ("int8", "float32"),
              ("bfloat16", "bfloat16"), ("bfloat16", "int8")]


def _arrays(rng, dtype, shape, scale_shape):
    """Seeded contents in ``dtype`` (int8 with positive f32 scales) as
    numpy: {"k", "v"[, "k_scale", "v_scale"]}."""
    if dtype == "int8":
        out = {n: rng.integers(-127, 128, size=shape).astype(np.int8) for n in ("k", "v")}
        out.update({n: (rng.random(scale_shape) * 0.1 + 0.01).astype(np.float32) for n in ("k_scale", "v_scale")})
        return out
    return {n: (rng.standard_normal(shape) * 2).astype(np.float32) for n in ("k", "v")}


def _both(arrays: dict, dtype: str):
    """The same numpy contents as ray_tpu arrays and as port tensors; a
    bf16 block is rounded from f32 on both sides (the same bits)."""
    j, t = {}, {}
    for name, a in arrays.items():
        cast = dtype == "bfloat16" and name in ("k", "v")
        j[name] = jnp.asarray(a).astype(jnp.bfloat16) if cast else jnp.asarray(a)
        t[name] = torch.from_numpy(a.copy()).to(torch.bfloat16) if cast else torch.from_numpy(a.copy())
    return j, t


@pytest.mark.parametrize("block_dtype,cache_dtype", DIRECTIONS, ids=[f"{a}_into_{b}" for a, b in DIRECTIONS])
def test_slot_extract_and_scatter_match_ray_tpu(block_dtype, cache_dtype):
    rng = np.random.default_rng(1)
    cache = _arrays(rng, cache_dtype, (L, B, S, KVH, HD), (L, B, KVH, S))
    cache["length"] = np.array([5, 17, 40], np.int32)
    jc, tc = _both(cache, cache_dtype)
    jx, jsc = jscatter.kv_extract_slots, jscatter.kv_scatter_in_slots
    blk = _arrays(rng, block_dtype, (L, T, KVH, HD), (L, KVH, T))
    jb, tb = _both(blk, block_dtype)
    scales = ("k_scale", "v_scale") if block_dtype == "int8" else ()
    jc = jsc(jc, np.int32(1), jb["k"], jb["v"], np.int32(29), *(jb[n] for n in scales))
    out = tscatter.kv_scatter_in_slots(tc, 1, tb["k"], tb["v"], 29, *(tb[n] for n in scales))
    assert out is tc  # in place
    for name in tc:
        same(tc[name], jc[name])
    # extract the block back (and a slot it never touched): ray_tpu's, exactly
    for slot in (1, 2):
        got, want = tscatter.kv_extract_slots(tc, slot, T), jx(jc, np.int32(slot), T)
        assert len(got) == len(want) == (4 if cache_dtype == "int8" else 2)
        for a, b in zip(got, want):
            same(a, b)
    if block_dtype == cache_dtype:  # a same-dtype round trip returns the block's bytes
        for a, name in zip(tscatter.kv_extract_slots(tc, 1, T), ("k", "v") + scales):
            same(a, jb[name])


@pytest.mark.parametrize("block_dtype,cache_dtype", DIRECTIONS, ids=[f"{a}_into_{b}" for a, b in DIRECTIONS])
def test_paged_extract_and_scatter_match_ray_tpu(block_dtype, cache_dtype):
    rng = np.random.default_rng(2)
    pool = _arrays(rng, cache_dtype, (L, P, PAGE, KVH, HD), (L, P, KVH, PAGE))
    jpool, tpool = _both(pool, cache_dtype)
    tables = rng.integers(0, P, size=(B, MAX_PG)).astype(np.int32)
    lengths = np.array([9, 30, 12], np.int32)
    jt, jl = jnp.asarray(tables), jnp.asarray(lengths)
    tt, tl = torch.from_numpy(tables.copy()), torch.from_numpy(lengths.copy())
    row = np.array([3, 7, 1, 5, 0, 0, 0, 0], np.int32)  # 4 pages of 8 = T, trash beyond
    jg, jsp = jscatter.kv_extract_paged, jscatter.kv_scatter_in_paged
    blk = _arrays(rng, block_dtype, (L, T, KVH, HD), (L, KVH, T))
    jb, tb = _both(blk, block_dtype)
    scales = ("k_scale", "v_scale") if block_dtype == "int8" else ()
    jpool, jt, jl = jsp(jpool, jt, jl, np.int32(2), jnp.asarray(row), jb["k"], jb["v"], np.int32(27),
                        *(jb[n] for n in scales))
    out = tscatter.kv_scatter_in_paged(tpool, tt, tl, 2, torch.from_numpy(row), tb["k"], tb["v"], 27,
                                       *(tb[n] for n in scales))
    assert out[0] is tpool and out[1] is tt and out[2] is tl  # in place: the captured addresses hold
    for name in tpool:
        same(tpool[name], jpool[name])
    same(tt, jt)
    same(tl, jl)
    # gather the block back, and pages it never touched (a trash cell included)
    for ids in (row[:4], np.array([2, 0, 8], np.int32)):
        got, want = tscatter.kv_extract_paged(tpool, torch.from_numpy(ids)), jg(jpool, jnp.asarray(ids))
        assert len(got) == len(want) == (4 if cache_dtype == "int8" else 2)
        for a, b in zip(got, want):
            same(a, b)
    if block_dtype == cache_dtype:
        for a, name in zip(tscatter.kv_extract_paged(tpool, torch.from_numpy(row[:4])), ("k", "v") + scales):
            same(a, jb[name])


# ------------------------------------------------------------------- codec
def _payload(rng, quant):
    blk = _arrays(rng, "int8" if quant else "float32", (L, T, KVH, HD), (L, KVH, T))
    kv = dict(blk, n=21, logits=rng.standard_normal(64).astype(np.float32),
              prompt_token_ids=[int(t) for t in rng.integers(1, 500, size=21)],
              trace={"trace_id": "ab12", "parent_id": "cd34"}, submitted_at=123.5)
    return kv, {name: (torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x) for name, x in kv.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ["kv_handoff", "live_state"])
def test_handoff_codec_matches_ray_tpu(quant, kind):
    jkv, tkv = _payload(np.random.default_rng(3), quant)
    jw, tw = jhandoff.encode(jkv, kind=kind), thandoff.encode(tkv, kind=kind)
    assert set(tw) == set(jw)
    for name in jw:
        if isinstance(jw[name], np.ndarray):
            same(tw[name], jw[name])
        else:
            assert tw[name] == jw[name], name
    assert thandoff.meta_of(tw) == jhandoff.meta_of(jw)
    jd, td = jhandoff.decode(jw, kind=kind), thandoff.decode(tw, kind=kind)
    assert set(td) == set(jd)
    for name in jd:
        if isinstance(jd[name], np.ndarray):
            same(td[name], jd[name])
        else:
            assert td[name] == jd[name], name
    # ray_tpu's f32 and int8 wire dicts decode in the port as they are
    for name, x in thandoff.decode(jw, kind=kind).items():
        if isinstance(x, torch.Tensor):
            same(x, jd[name])


def _mutations(quant):
    """The malformed payloads of tests/test_llm_disagg.py (codec refusals,
    fp at :171, int8 scales at :260), as (name, fn(wire, cast)) where
    ``cast`` turns a numpy array into the package's own array type."""
    if not quant:
        return [
            ("n_zero", lambda w, c: w.update(n=0)),
            ("bad_shape", lambda w, c: w.update(shape=(1, 2, 3, 4))),
            ("foreign_kind", lambda w, c: w.clear() or w.update(kind="other")),
            ("truncated", lambda w, c: w.update(k=w["k"][:, :1])),
            ("version", lambda w, c: w.update(version=99)),
            ("dtype_meta", lambda w, c: w.update(dtype="int8")),
            ("prompt_len", lambda w, c: w.update(prompt_token_ids=w["prompt_token_ids"][:-1])),
            ("scales_on_fp", lambda w, c: w.update(k_scale=c(np.ones((L, KVH, T), np.float32)),
                                                   v_scale=c(np.ones((L, KVH, T), np.float32)))),
        ]
    return [
        ("scale_heads_truncated", lambda w, c: w.update(k_scale=w["k_scale"][:, :1])),
        ("scale_f64", lambda w, c: w.update(k_scale=c(np.asarray(w["k_scale"], np.float64)))),
        ("no_scales", lambda w, c: (w.pop("k_scale"), w.pop("v_scale"))),
        ("fp_block_with_scales", lambda w, c: w.update(dtype="float32", k=c(np.asarray(w["k"], np.float32)),
                                                       v=c(np.asarray(w["v"], np.float32)))),
    ]


@pytest.mark.parametrize("quant,name", [(q, n) for q in (False, True) for n, _ in _mutations(q)])
def test_handoff_codec_refuses_what_ray_tpu_refuses(quant, name):
    fn = dict(_mutations(quant))[name]
    jkv, tkv = _payload(np.random.default_rng(4), quant)
    jw, tw = jhandoff.encode(jkv), thandoff.encode(tkv)
    jbad, tbad = dict(jw), dict(tw)
    fn(jbad, lambda a: a)
    fn(tbad, lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    with pytest.raises(jhandoff.HandoffError) as jerr:
        jhandoff.decode(jbad)
    with pytest.raises(thandoff.HandoffError) as terr:
        thandoff.decode(tbad)
    assert (terr.value.status_code, terr.value.retryable) == (jerr.value.status_code, jerr.value.retryable) \
        == (500, False)


@pytest.mark.parametrize("name", ["scale_width", "unpaired_scale", "int8_without_scales", "n_past_block"])
def test_handoff_encode_refuses_what_ray_tpu_refuses(name):
    jkv, tkv = _payload(np.random.default_rng(5), quant=name != "n_past_block")
    for kv in (jkv, tkv):
        if name == "scale_width":
            kv["k_scale"] = kv["k_scale"][:, :, :1]
        elif name == "unpaired_scale":
            del kv["v_scale"]
        elif name == "int8_without_scales":
            del kv["k_scale"], kv["v_scale"]
        else:
            kv["n"] = T + 1
    with pytest.raises(jhandoff.HandoffError):
        jhandoff.encode(jkv)
    with pytest.raises(thandoff.HandoffError):
        thandoff.encode(tkv)


def test_error_taxonomy_matches_ray_tpu():
    from ray_tpu import exceptions as jexc

    for name, spec in texc.SERVING_ERRORS.items():
        assert (spec.status_code, spec.retryable) == (jexc.SERVING_ERRORS[name].status_code,
                                                      jexc.SERVING_ERRORS[name].retryable), name
    assert (thandoff.HandoffLostError.status_code, thandoff.HandoffLostError.retryable) == (503, True)
    with pytest.raises(KeyError):
        texc.serving_error(type("UnregisteredError", (Exception,), {}))


def test_publish_and_fetch_over_the_object_plane():
    """handoff.publish stores the encoded payload as an owned object of
    this process (its bytes in a /dev/shm segment) and returns ray_tpu's
    meta; fetch returns the decoded payload field for field; a freed
    handoff is HandoffLostError after the retries, and its segment is gone."""
    from ray_tpu_torch.core import direct

    rng = np.random.default_rng(3)
    # 256 KiB of bf16 k + v: above the inline threshold, so it lands in shared memory
    kv = {"k": torch.from_numpy(rng.standard_normal((2, 256, 2, 64)).astype(np.float32)).bfloat16(),
          "v": torch.from_numpy(rng.standard_normal((2, 256, 2, 64)).astype(np.float32)).bfloat16(),
          "n": 200, "logits": torch.from_numpy(rng.standard_normal(512).astype(np.float32)),
          "prompt_token_ids": list(range(1, 201))}
    st = direct.attach(b"disagg-test-key")
    try:
        meta, ref = thandoff.publish(kv)
        assert meta == thandoff.meta_of(thandoff.encode(kv)) and meta["nbytes"] == 2 * 2 * 256 * 2 * 64 * 2 + 512 * 4
        seg = st.owned.entry(ref.id.binary()).payload.shm.shm_name
        assert (pathlib.Path("/dev/shm") / seg).exists()
        got = thandoff.fetch(ref, meta)
        want = thandoff.decode(thandoff.encode(kv))
        assert set(got) == set(want)
        for name, v in want.items():
            assert torch.equal(got[name], v) if isinstance(v, torch.Tensor) else got[name] == v, name
        direct.free_owned([ref.id])
        assert not (pathlib.Path("/dev/shm") / seg).exists()
        with pytest.raises(thandoff.HandoffLostError):
            thandoff.fetch(ref, retries=1, retry_wait_s=0.01)
    finally:
        direct.detach()


# --------------------------------------------------------- across packages
@pytest.fixture(scope="module")
def jax_prefill(params):
    return jax_engine(params[0], enable_prefix_caching=False)


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_handoffs_cross_packages_give_ray_tpus_stream(params, jax_prefill, layout):
    """ray_tpu's payloads decoded by the port, and the port's decoded by
    ray_tpu, each equal ray_tpu's own decode of its payloads: a greedy and
    a seeded request (the seeded lane's key from its seed) per run."""
    jp, tp = params
    kw = dict(kv_layout=layout, enable_prefix_caching=False, **({"page_size": 16} if layout == "paged" else {}))
    jpays = [jax_prefill.prefill_handoff(p) for p in PROMPTS]
    tpre = torch_engine(tp, enable_prefix_caching=False)
    tpays = [tpre.prefill_handoff(p) for p in PROMPTS]
    for jpay, tpay in zip(jpays, tpays):  # the two prefills agree
        assert tpay["n"] == jpay["n"] and tuple(tpay["k"].shape) == jpay["k"].shape
        np.testing.assert_allclose(tpay["k"].numpy(), jpay["k"], rtol=1e-4, atol=1e-4)
    jdec = jax_engine(jp, **kw)
    tdec = torch_engine(tp, **kw)

    def run(eng, pays, codec, sampling):
        admits = {0: [(lambda pay=pay, sp=sp: eng.add_prefilled(codec.decode(codec.encode(pay)), sp), i)
                      for i, (pay, sp) in enumerate(zip(pays, sampling))]}
        return drive(eng, admits)[0]

    want = run(jdec, jpays, jhandoff, [JaxParams(**GREEDY), JaxParams(**SEEDED)])
    port = run(tdec, jpays, thandoff, [SamplingParams(**GREEDY), SamplingParams(**SEEDED)])
    rev = run(jdec, [to_numpy(p) for p in tpays], jhandoff, [JaxParams(**GREEDY), JaxParams(**SEEDED)])
    assert port == want and rev == want
    assert all(len(t) == 10 for t in want.values())


# ------------------------------------------------------------ the port alone
@pytest.fixture(scope="module")
def torch_prefill(params):
    return torch_engine(params[1], enable_prefix_caching=False)


@pytest.fixture(scope="module")
def torch_prefill_q8(params):
    return torch_engine(params[1], enable_prefix_caching=False, cache_dtype="int8")


def _schedule(rng, n_req, lens=(4, 90), max_tok=(3, 12)):
    reqs = [([int(t) for t in rng.integers(1, 500, size=int(rng.integers(*lens)))],
             SamplingParams(max_tokens=int(rng.integers(*max_tok))), int(rng.integers(0, 6))) for _ in range(n_req)]
    reqs.append(([7, 7, 7], SamplingParams(max_tokens=8, temperature=1.0, seed=123), 1))
    return reqs


def _oracle(tp, reqs, kw, aborts=None):
    eng = torch_engine(tp, device_resident=False, **kw)
    admits = {}
    for i, (prompt, sp, t) in enumerate(reqs):
        admits.setdefault(t, []).append((lambda p=prompt, s=sp: eng.add_request(p, s), i))
    return drive(eng, admits, aborts)


def _disagg(tp, prefill, reqs, kw, aborts=None, **dec_kw):
    dec = torch_engine(tp, **kw, **dec_kw)
    pays = {i: thandoff.decode(thandoff.encode(prefill.prefill_handoff(p))) for i, (p, _, _) in enumerate(reqs)}
    admits = {}
    for i, (_, sp, t) in enumerate(reqs):
        admits.setdefault(t, []).append((lambda kv=pays[i], s=sp: dec.add_prefilled(kv, s), i))
    return (*drive(dec, admits, aborts), dec)


def test_disagg_slots_equals_the_single_engine_with_an_abort(params, torch_prefill):
    reqs = _schedule(np.random.default_rng(0), 4)
    kw = dict(max_num_seqs=3, enable_prefix_caching=False)
    aborts = {5: 0}
    want, want_r = _oracle(params[1], reqs, kw, aborts)
    got, got_r, dec = _disagg(params[1], torch_prefill, reqs, kw, aborts)
    assert set(got) == set(want) and "aborted" in set(want_r.values())
    for key in want:
        if want_r[key] == "aborted":  # host-timed: the surviving prefix agrees
            n = min(len(want[key]), len(got[key]))
            assert got[key][:n] == want[key][:n]
        else:
            assert (got[key], got_r[key]) == (want[key], want_r[key])
    # telemetry: every extract counted, and every scatter-in (a request
    # aborted while it waited never scattered, and has no token)
    assert _counter(torch_prefill, "rt_llm_handoffs_total", "extracted") >= len(reqs)
    assert _counter(dec, "rt_llm_handoffs_total", "scattered") == sum(1 for t in got.values() if t)


def test_disagg_paged_equals_the_single_engine_under_preemption(params, torch_prefill):
    """Decode-side page growth preempts (recompute re-prefill ON the decode
    engine) and the greedy streams still equal the oracle's; the pool
    drains."""
    rng = np.random.default_rng(1)
    reqs = [([int(t) for t in rng.integers(1, 500, size=int(rng.integers(50, 60)))],
             SamplingParams(max_tokens=int(rng.integers(40, 56))), int(rng.integers(0, 4))) for _ in range(4)]
    kw = dict(max_num_seqs=3, max_seq_len=256, kv_layout="paged", page_size=32, num_pages=8,
              enable_prefix_caching=False)
    want, want_r = _oracle(params[1], reqs, kw)
    got, got_r, dec = _disagg(params[1], torch_prefill, reqs, kw)
    assert got == want and got_r == want_r
    assert dec.preemption_count > 0
    assert dec._page_alloc.free_pages == dec._pcfg.num_pages - 1


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_disagg_spec_on_the_decode_side(params, torch_prefill, layout):
    reqs = [([10 + (i % 8) for i in range(32)], SamplingParams(max_tokens=10), 0),
            ([50 + (i % 8) for i in range(24)], SamplingParams(max_tokens=8), 1)]
    kw = dict(enable_prefix_caching=False, kv_layout=layout, page_size=16)
    plain, plain_r, _ = _disagg(params[1], torch_prefill, reqs, kw)
    spec, spec_r, dec = _disagg(params[1], torch_prefill, reqs, kw, speculative=SpecConfig(drafter="ngram", k=3))
    assert spec == plain and spec_r == plain_r
    assert dec.spec_stats()["rounds"] > 0


@pytest.mark.parametrize("layout", ["slots", "paged"])
def test_disagg_int8_and_cross_dtype_requantization(params, torch_prefill, torch_prefill_q8, layout):
    """int8 -> int8 and fp -> int8 equal the int8 oracle (the quantized
    bytes equal a local prefill's); int8 -> fp dequantizes and decodes,
    its first token from the shipped logits."""
    reqs = [([7, 8, 9, 10] * 4, SamplingParams(max_tokens=6), 0), ([9, 10, 11] * 5, SamplingParams(max_tokens=6), 1)]
    kw = dict(enable_prefix_caching=False, kv_layout=layout, page_size=16)
    want, _ = _oracle(params[1], reqs, {**kw, "cache_dtype": "int8"})
    q8, _, _ = _disagg(params[1], torch_prefill_q8, reqs, {**kw, "cache_dtype": "int8"})
    fp_in, _, _ = _disagg(params[1], torch_prefill, reqs, {**kw, "cache_dtype": "int8"})
    assert q8 == want and fp_in == want
    deq, reasons, _ = _disagg(params[1], torch_prefill_q8, reqs, kw)
    assert all(len(t) == 6 for t in deq.values()) and set(reasons.values()) == {"length"}
    assert [t[0] for t in deq.values()] == [t[0] for t in want.values()]
    pay = torch_prefill_q8.prefill_handoff([3, 4, 5, 6, 7])
    assert pay["k"].dtype == torch.int8 and tuple(pay["k_scale"].shape) == (2, 2, pay["k"].shape[1])


def test_prefill_only_requests_stash_and_release(params):
    """A prefill-only wave runs one batched forward per bucket, never decodes, and
    returns every page; an aborted prefill-only request leaves no stash;
    release_handoffs drops the unclaimed ones; the payload's block is at
    the prompt's bucket width."""
    pre = torch_engine(params[1], kv_layout="paged", page_size=16, enable_prefix_caching=False)
    ids = [pre.add_prefill_request(p) for p in PROMPTS]
    gone = pre.add_prefill_request([1, 2, 3])
    assert pre.abort_request(gone)
    outs = {o.request_id: o for o in pre.step()}
    assert {outs[i].finish_reason for i in ids} == {"handoff"} and outs[gone].finish_reason == "aborted"
    assert pre.prefill_forwards == 2 and pre.decode_steps == 0  # buckets 64 and 128 and not pre.has_unfinished()
    assert pre.kv_cache_stats()["pages_free"] == pre._pcfg.num_pages - 1
    assert pre.pop_handoff(gone) is None
    pay = pre.pop_handoff(ids[0])
    assert (pay["n"], tuple(pay["k"].shape)) == (30, (2, 64, 2, 32)) and pay["logits"].shape == (512,)
    assert pre.pop_handoff(ids[0]) is None and pre.release_handoffs() == 1 and pre.release_handoffs() == 0
    # prefill_remote: the same block and logits outside the scheduler
    remote = pre.prefill_remote(PROMPTS[0])
    torch.testing.assert_close(remote["k"][:, :30], pay["k"][:, :30], rtol=0, atol=0)
    torch.testing.assert_close(remote["logits"], pay["logits"], rtol=0, atol=0)


def _counter(eng, name, event):
    """One engine's count of a telemetry counter's ``event`` series."""
    m = eng._tel.m[name]
    return m._series.get(m._key({**eng._tel.tags, "event": event}), 0.0)
