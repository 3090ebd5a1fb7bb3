"""``serve/llm.py`` on the port (``ray_tpu_torch.serve.llm``) on the CPU,
with tiny f32 engines (``engine_kwargs={"device": "cpu", ...}``) on the
weights of a ray_tpu tiny model converted with ``weights.params_from_jax``.

Through Serve on the port's runtime: ``build_llm_deployment``,
``build_openai_app`` (completions, chat, SSE and ``/v1/models`` behind the
asyncio proxy, with ``torch_serve_defs.ToyTokenizer``),
``build_pd_disagg_deployment`` and ``build_kvplane_deployment``. Greedy
streams, one request at a time, are token-identical to ray_tpu's
in-process engine on the same weights (its programs settled, as
``tests/test_torch_engine.py`` settles them); concurrent requests equal
their solo streams.

In process, as ray_tpu's ``tests/test_llm_chaos.py`` drives
``LLMServer``, each leg beside the same leg on ray_tpu's ``LLMServer``:
drain in abort mode and in migrate mode (through a ``serve.preempt``
drop, the waiter's ``RequestMigratedError`` resumed on a peer with the
same stream), each idempotent; shutdown with work in flight; ``serve.step``
raising (``StepperDiedError`` at the waiter and the health check);
admission shedding by class; the cold-start EMA seed. Both packages'
chaos planes are cleared and seeded around every test."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_serve_defs as defs  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu import chaos as jchaos  # noqa: E402
from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.llm import migrate as jmigrate  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.serve import llm as jllm  # noqa: E402
from ray_tpu.serve import overload as joverload  # noqa: E402
from ray_tpu_torch import chaos as tchaos  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch.llm import SamplingParams as TorchParams  # noqa: E402
from ray_tpu_torch.llm import migrate as tmigrate  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.serve import llm as tllm  # noqa: E402
from ray_tpu_torch.serve import overload as toverload  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

T = 120
KW = dict(dtype="float32", remat=False, max_seq_len=256)
# paged on both sides, prefix caching off unless a test turns it on
EK = dict(kv_layout="paged", max_num_seqs=4, max_seq_len=128, page_size=16, prefill_buckets=(32, 64, 128), num_pages=64,
          enable_prefix_caching=False)
NEW = 8
RNG = np.random.default_rng(11)
PROMPTS = [[int(x) for x in RNG.integers(1, 500, size=n)] for n in (5, 24, 40, 9)]
PREFIX = [int(x) for x in RNG.integers(1, 500, size=48)]  # three 16-token blocks
FOLLOWERS = [PREFIX + [int(x) for x in RNG.integers(1, 500, size=n)] for n in (3, 11, 20)]
# ray_tpu's engine programs, each settled (inputs and outputs ready) on the XLA CPU runtime
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_attn", "_fused_append", "_set_lane",
           "_set_table", "_set_table_cell", "_fused_step", "_extract_paged", "_extract_slots", "_scatter_paged",
           "_scatter_slots")
PKGS = ("jax", "torch")
LLM = {"jax": jllm, "torch": tllm}
OVERLOAD = {"jax": joverload, "torch": toverload}
CHAOS = {"jax": jchaos, "torch": tchaos}
MIGRATE = {"jax": jmigrate, "torch": tmigrate}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side of these tiny models runs on one intra-op thread
    (``tests/test_torch_engine.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _both_chaos_planes():
    for c in CHAOS.values():
        c.clear()
        c.seed(0)
    yield
    for c in CHAOS.values():
        c.clear()


def _settle(engine):
    def synced(fn):
        def run(*args, **kwargs):
            jax.block_until_ready((args, kwargs))
            return jax.block_until_ready(fn(*args, **kwargs))

        return run

    for name in SETTLED:
        if hasattr(engine, name):
            setattr(engine, name, synced(getattr(engine, name)))
    return engine


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**KW), jax.random.PRNGKey(0))
    return {"jax": jp, "torch": params_from_jax(jax.tree.map(np.asarray, jp), "cpu")}


@pytest.fixture(scope="module")
def oracle(params):
    """Greedy streams of ray_tpu's in-process engine, one request at a
    time: caching off for the plain prompts, on (over the leader's
    prefix) for the kvplane's followers."""
    plain = _settle(JaxEngine(jllama.LlamaConfig.tiny(**KW), params["jax"], telemetry=False, **EK))
    cached = _settle(JaxEngine(jllama.LlamaConfig.tiny(**KW), params["jax"], telemetry=False,
                               **{**EK, "enable_prefix_caching": True, "prefix_block": 16}))

    def run(eng, p, n=NEW):
        return list(eng.generate(list(p), JaxParams(max_tokens=n, temperature=0.0)).token_ids)

    chat = defs.ToyTokenizer(500).encode("user: hi\nassistant:")
    return {"prompts": [run(plain, p) for p in PROMPTS], "chat": run(plain, chat),
            "followers": [run(cached, p) for p in [PREFIX + [7]] + FOLLOWERS],
            "run": lambda p, n=NEW: run(plain, p, n)}


@pytest.fixture(scope="module")
def runtimes():
    """The port's runtime for the Serve legs (its driver holds the object
    plane the migrate legs publish on), ray_tpu's for its migrate legs."""
    serve.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    ray_tpu.init(num_cpus=2)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


@pytest.fixture
def apps(runtimes):
    yield
    for name in list(serve.status()["applications"]):
        serve.delete(name)
    deadline = time.time() + 30
    while ray_tpu_torch.available_resources().get("CPU", 0) < 8 and time.time() < deadline:
        time.sleep(0.05)


def _config(params, **engine_kwargs) -> tllm.LLMConfig:
    return tllm.LLMConfig(model_config=tllama.LlamaConfig.tiny(**KW), params=params["torch"],
                          engine_kwargs={"device": "cpu", **EK, **engine_kwargs})


def _solo_and_concurrent(call):
    solo = [call(p).result(timeout_s=T)["token_ids"] for p in PROMPTS]
    conc = [r.result(timeout_s=T)["token_ids"] for r in [call(p) for p in PROMPTS]]
    return solo, conc


# ---------------------------------------------------------------- through Serve
def test_llm_deployment_streams_equal_ray_tpu_engine(apps, params, oracle):
    h = serve.run(tllm.build_llm_deployment(_config(params)), name="llm")
    solo, conc = _solo_and_concurrent(lambda p: h.generate.remote(p, {"max_tokens": NEW}))
    assert solo == oracle["prompts"]
    assert conc == solo
    st = h.overload_stats.remote().result(timeout_s=T)
    assert st["admitted"] == 2 * len(PROMPTS) and st["shed_by_class"] == {}
    assert h.check_health.remote().result(timeout_s=T) is True


def test_openai_app_completions_chat_sse_models(apps, params, oracle):
    tok = defs.ToyTokenizer(500)
    cfg = _config(params)
    cfg.tokenizer = tok
    serve.run(tllm.build_openai_app(cfg), name="openai", route_prefix="/v1")
    serve.start(serve.HTTPOptions(port=0), proxy=True)
    port = serve.api._http_proxy.port

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=T) as resp:
            return resp.read().decode()

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=T) as resp:
        models = json.loads(resp.read())
    assert models["data"][0]["id"] == cfg.model_id
    body = {"prompt": PROMPTS[1], "max_tokens": NEW, "temperature": 0}
    unary = json.loads(post("/v1/completions", body))
    assert unary["choices"][0]["text"] == tok.decode(oracle["prompts"][1])
    assert unary["usage"] == {"prompt_tokens": len(PROMPTS[1]), "completion_tokens": NEW,
                              "total_tokens": len(PROMPTS[1]) + NEW}
    sse = post("/v1/completions", {**body, "stream": True})
    events = [e[len("data: "):] for e in sse.split("\n\n") if e]
    assert events[-1] == "[DONE]" and len(events) == NEW + 1
    assert "".join(json.loads(e)["choices"][0]["text"] for e in events[:-1]) == unary["choices"][0]["text"]
    chat = json.loads(post("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                                    "max_tokens": NEW}))
    assert chat["object"] == "chat.completion"
    assert chat["choices"][0]["message"]["content"] == tok.decode(oracle["chat"])
    serve.api._http_proxy.stop()
    serve.api._http_proxy = None


def test_pd_disagg_deployment(apps, params, oracle):
    h = serve.run(tllm.build_pd_disagg_deployment(_config(params)), name="pd")
    solo, conc = _solo_and_concurrent(lambda p: h.generate.remote(p, {"max_tokens": NEW}))
    assert solo == oracle["prompts"]
    assert conc == solo
    st = h.disagg_stats.remote().result(timeout_s=T)
    assert st["prefills"] == 2 * len(PROMPTS) and st["decode_retries"] == 0 and st["failed"] == 0


def test_kvplane_deployment_reuses_the_leaders_prefix(apps, params, oracle):
    cfg = _config(params, enable_prefix_caching=True, prefix_block=16)
    h = serve.run(tllm.build_kvplane_deployment(cfg), name="kv")
    outs = [h.generate.remote(p, {"max_tokens": NEW}).result(timeout_s=T)["token_ids"]
            for p in [PREFIX + [7]] + FOLLOWERS]
    assert outs == oracle["followers"]
    st = h.kvplane_stats.remote().result(timeout_s=T)
    hits = [serve.get_deployment_handle(f"LLM-r{i}", "kv").kvplane_stats.remote().result(timeout_s=T)
            for i in range(2)]
    # the followers reused the leader's prefix: a local or remote hit each, every block of it saved
    assert sum(x["local"]["hits"] + x["remote"]["hits"] for x in hits) == len(FOLLOWERS)
    assert sum(x["tokens_saved"] for x in hits) == len(FOLLOWERS) * len(PREFIX)
    assert st["failed"] == 0 and st["routed_to_holder"] + st["routed_off_holder"] + st["cold"] == len(FOLLOWERS) + 1


# ---------------------------------------------------------------- in process, beside ray_tpu's LLMServer
def _server(pkg, params, prewarm=False, admission=None, **engine_kwargs):
    m = LLM[pkg]
    kw = {**EK, "max_num_seqs": 2, **engine_kwargs}
    if pkg == "torch":
        kw["device"] = "cpu"
        cfg = tllama.LlamaConfig.tiny(**KW)
    else:
        cfg = jllama.LlamaConfig.tiny(**KW)
    srv = m.LLMServer(m.LLMConfig(model_config=cfg, params=params[pkg], engine_kwargs=kw, prewarm=prewarm,
                                  admission=admission))
    if pkg == "jax":
        _settle(srv.engine)
    return srv


def _in_flight(srv, n_tokens=1, deadline_s=60.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        with srv.engine._lock:
            sts = [s for s in srv.engine._requests.values() if not s.finished]
        if sts and all(len(s.token_ids) >= n_tokens for s in sts):
            return
        time.sleep(0.003)
    raise AssertionError(f"no request reached {n_tokens} tokens in flight")


def _in_background(fn):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # noqa: BLE001 — the leg inspects the error
            box["err"] = e

    th = threading.Thread(target=run)
    th.start()
    return th, box


def both_legs(leg):
    out = {pkg: leg(pkg) for pkg in PKGS}
    assert out["jax"] == out["torch"], out
    return out["torch"]


def test_drain_abort_mode_finishes_inflight_and_is_idempotent(runtimes, params, oracle):
    def leg(pkg):
        srv = _server(pkg, params)
        CHAOS[pkg].inject("serve.step", delay_s=0.05)  # slow decode steps: the request is still in flight
        th, box = _in_background(lambda: srv.generate(PROMPTS[2], {"max_tokens": NEW}, timeout_s=T))
        _in_flight(srv)
        res = srv.drain(timeout_s=60.0)
        th.join(timeout=60)
        again = srv.drain(timeout_s=60.0)
        with pytest.raises(OVERLOAD[pkg].ReplicaDrainingError):
            srv.generate(PROMPTS[0], {"max_tokens": 2})
        st = srv.overload_stats()
        return (box["out"]["token_ids"], res["mode"], res["inflight_finished"], res["aborted"], again["repeated"],
                st["draining"], st["shed_draining"], srv._stepper.is_alive())

    assert both_legs(leg) == (oracle["prompts"][2], "abort", True, 0, True, True, 1, False)


def test_preempt_drop_migrates_to_a_peer_with_the_same_stream(runtimes, params, oracle):
    """A ``serve.preempt`` drop delivers the notice: drain(mode="migrate")
    checkpoints the request mid-decode and its waiter gets the typed
    RequestMigratedError; a peer resumes it with the uninterrupted
    stream. The drain is idempotent in this mode too."""
    sp = {"max_tokens": 16, "temperature": 0.0}

    def leg(pkg):
        src, peer = _server(pkg, params), _server(pkg, params)
        try:
            CHAOS[pkg].inject("serve.step", delay_s=0.05)  # slow decode steps: the notice lands mid-decode
            th, box = _in_background(lambda: src.generate(PROMPTS[1], dict(sp), timeout_s=T))
            _in_flight(src, 4)
            CHAOS[pkg].inject("serve.preempt", drop_prob=1.0, max_hits=1)
            th.join(timeout=60)
            CHAOS[pkg].clear()
            err = box.get("err")
            assert isinstance(err, MIGRATE[pkg].RequestMigratedError), box
            out = peer.resume_from_migration(err.migration_meta, err.migration_ref, dict(sp), timeout_s=T)
            again = src.drain(timeout_s=5.0)
            return (out["token_ids"], err.migration_meta["emitted"] >= 4, again["mode"], again["repeated"],
                    len(again["migrated"]), src._stepper.is_alive())
        finally:
            src.shutdown()
            peer.shutdown()

    assert both_legs(leg) == (oracle["run"](PROMPTS[1], 16), True, "migrate", True, 1, False)


def test_shutdown_with_inflight_fails_waiters_fast(runtimes, params):
    def leg(pkg):
        srv = _server(pkg, params)
        CHAOS[pkg].inject("serve.step", delay_s=0.2)  # keep the request in flight
        th, box = _in_background(lambda: srv.generate(PROMPTS[0], {"max_tokens": 64}, timeout_s=T))
        _in_flight(srv)
        t0 = time.perf_counter()
        srv.shutdown()
        th.join(timeout=10.0)
        CHAOS[pkg].clear()
        fast = not th.is_alive() and time.perf_counter() - t0 < 10.0
        with pytest.raises(OVERLOAD[pkg].ReplicaDrainingError):
            srv.generate(PROMPTS[0], {"max_tokens": 2}, timeout_s=5.0)
        return fast, type(box.get("err")).__name__, isinstance(box.get("err"), RuntimeError)

    assert both_legs(leg) == (True, "StepperDiedError", True)


def test_serve_step_raising_kills_the_stepper_typed(runtimes, params):
    def leg(pkg):
        srv = _server(pkg, params)
        try:
            CHAOS[pkg].inject("serve.step", raises=CHAOS[pkg].ChaosError, max_hits=1)
            with pytest.raises(OVERLOAD[pkg].StepperDiedError) as ei:
                srv.generate(PROMPTS[0], {"max_tokens": NEW}, timeout_s=30.0)
            with pytest.raises(OVERLOAD[pkg].StepperDiedError):
                srv.check_health()
            mapped = OVERLOAD[pkg].http_error_of(ei.value)
            return "ChaosError" in str(ei.value), mapped[0]
        finally:
            srv.shutdown()

    assert both_legs(leg) == (True, 503)


def test_admission_sheds_lowest_class_first(runtimes, params):
    def leg(pkg):
        srv = _server(pkg, params, max_num_seqs=1,
                      admission=OVERLOAD[pkg].AdmissionConfig(max_queue_depth=4, class_fracs=(0.25, 1.0)))
        sp_cls = TorchParams if pkg == "torch" else JaxParams
        try:
            for _ in range(3):  # three waiting requests without waking the stepper: depth 3
                srv.engine.add_request(list(PROMPTS[1]), sp_cls(max_tokens=2))
            with pytest.raises(OVERLOAD[pkg].OverloadedError) as ei:
                srv.generate(PROMPTS[1], {"max_tokens": 2, "priority": 0})
            out = srv.generate(PROMPTS[1], {"max_tokens": 2, "priority": 1}, timeout_s=T)
            st = srv.overload_stats()
            return (ei.value.status_code, ei.value.retry_after_s > 0, ei.value.shed_class, len(out["token_ids"]),
                    st["shed_depth"], st["shed_by_class"], st["admitted"] >= 1)
        finally:
            srv.shutdown()

    assert both_legs(leg) == (429, True, 0, 2, 1, {0: 1}, True)


def test_admission_cold_start_seeded_from_prewarm(runtimes, params):
    def leg(pkg):
        srv = _server(pkg, params, prewarm=True)
        try:
            tel = srv.engine._tel
            seeded = tel.service_ema_s > 0.0 and tel.itl_ema_s > 0.0 and tel.service_ema_s < 2.0
            tel.service_ema_s = 100.0  # a first-call-scale EMA is reset by the seeding path
            srv._seed_admission_emas()
            reseeded = 0.0 < tel.service_ema_s < 2.0
            srv._admission.check(0)  # an idle replica admits
            return seeded, reseeded
        finally:
            srv.shutdown()

    assert both_legs(leg) == (True, True)


def test_serve_llm_tp_replica(apps, params, oracle):
    """test_llm.py's TP replica: tensor_parallel_size=2 shards the replica's
    engine over a tp mesh (``engine_kwargs["mesh"]``: two ranks on the
    host, rank 1 a process the replica's engine starts). Its greedy
    streams equal ray_tpu's in-process engine's; deleting the app stops the
    rank process."""
    from ray_tpu_torch.parallel.mesh import create_mesh

    cfg = _config(params)
    cfg.tensor_parallel_size = 2
    cfg.num_tpus_per_replica = 0.0  # the host's ranks: no card to reserve
    cfg.engine_kwargs.pop("device")
    cfg.engine_kwargs["mesh"] = create_mesh(tp=2, devices=["cpu", "cpu"])
    h = serve.run(tllm.build_llm_deployment(cfg, _cls={tllm.LLMServer: defs.TpLLMServer}), name="llm_tp")
    outs = [h.generate.remote(p, {"max_tokens": NEW, "temperature": 0.0}).result(timeout_s=T)["token_ids"]
            for p in PROMPTS]
    assert outs == oracle["prompts"]
    (pid,) = h.tp_pids.remote().result(timeout_s=T)
    serve.delete("llm_tp")
    deadline = time.time() + 60
    while time.time() < deadline and _runs(pid):
        time.sleep(0.1)
    assert not _runs(pid)


def _runs(pid: int) -> bool:
    """The process exists and is not a zombie (PID 1 here reaps no orphan)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


