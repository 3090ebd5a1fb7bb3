"""Offline batch inference on the port (``ray_tpu_torch.llm.batch``) on the
CPU: ``build_llm_processor`` over ``ray_tpu_torch.data`` on the port's
runtime, with tiny f32 engines on ``device="cpu"`` built in the pool's
actors from ray_tpu's seed-0 weights converted by
``weights.params_from_jax`` (they reach each actor inside the factory's
``functools.partial``).

Every row's greedy tokens must equal ray_tpu's engine's on the same
weights (its programs settled, as ``tests/test_torch_engine.py`` settles
them), one prompt at a time: all 24 rows of ray_tpu's
``test_data_batch_inference``, not only row 0. Also the preprocess and
postprocess hooks, the TypeError for a lambda or closure factory or hook
(they travel by reference), and a failing UDF surfacing as ``TaskError``
at ``take_all``."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_data_defs as defs  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.llm import LLMEngine as JaxEngine  # noqa: E402
from ray_tpu.llm import SamplingParams as JaxParams  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu_torch import data as tdata  # noqa: E402
from ray_tpu_torch import exceptions as texc  # noqa: E402
from ray_tpu_torch.llm import SamplingParams  # noqa: E402
from ray_tpu_torch.llm.batch import build_llm_processor  # noqa: E402
from ray_tpu_torch.weights import params_from_jax  # noqa: E402

NEW = 4
SETTLED = ("_prefill", "_insert", "_decode", "_extend", "_sample", "_fused_attn", "_fused_append", "_set_lane",
           "_set_table", "_set_table_cell", "_fused_step")


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
    jp = jllama.init_params(jllama.LlamaConfig.tiny(**defs.TINY), jax.random.PRNGKey(0))
    return {"jax": jp, "torch": params_from_jax(jax.tree.map(np.asarray, jp), "cpu")}


@pytest.fixture(scope="module")
def oracle(params):
    """ray_tpu's engine (ray_tpu's test's settings), one prompt at a time."""
    eng = _settle(JaxEngine(jllama.LlamaConfig.tiny(**defs.TINY), params["jax"], max_num_seqs=4, max_seq_len=64,
                            telemetry=False))
    return lambda p: list(eng.generate([int(t) for t in p], JaxParams(max_tokens=NEW, temperature=0.0)).token_ids)


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6)
    yield
    ray_tpu_torch.shutdown()


def _factory(params):
    return functools.partial(defs.tiny_engine, params["torch"])


def test_data_batch_inference(runtime, params, oracle):
    """ray_tpu's case: 24 rows, batch_size 8, concurrency 2; every row
    token-identical to ray_tpu's engine, in input order."""
    prompts = [[i % 11 + 1, i % 7 + 1, 5] for i in range(24)]
    ds = tdata.from_items([{"prompt": p} for p in prompts])
    proc = build_llm_processor(_factory(params), sampling=SamplingParams(max_tokens=NEW, temperature=0.0),
                               batch_size=8, concurrency=2)
    rows = proc(ds).take_all()
    assert len(rows) == 24
    assert [r["prompt"] for r in rows] == prompts
    assert all(len(r["generated"]) == NEW and r["generated_finish_reason"] == "length" for r in rows)
    want = [oracle(p) for p in prompts]
    assert [list(r["generated"]) for r in rows] == want


def test_preprocess_and_postprocess_hooks(runtime, params, oracle):
    ds = tdata.from_items([{"i": i} for i in range(10)], parallelism=3)
    proc = build_llm_processor(_factory(params), sampling=SamplingParams(max_tokens=NEW, temperature=0.0),
                               batch_size=4, concurrency=1, preprocess=defs.prompt_of, postprocess=defs.first_token)
    rows = proc(ds).take_all()
    assert [r["i"] for r in rows] == list(range(10))
    assert set(rows[0]) == {"i", "first", "generated", "reason"}
    for r in rows:
        want = oracle(defs.prompt_of({"i": r["i"]})["prompt"])
        assert r["generated"] == want and r["first"] == want[0] and r["reason"] == "length"


def test_lambda_factory_and_hooks_raise_type_error(params):
    """Code travels by reference: a lambda or closure factory, preprocess
    or postprocess raises TypeError naming the difference when the
    processor is built, before any actor starts."""
    def local_factory():
        return None

    sampling = SamplingParams(max_tokens=NEW)
    for kwargs in (dict(engine_factory=lambda: None), dict(engine_factory=local_factory),
                   dict(engine_factory=_factory(params), preprocess=lambda r: r),
                   dict(engine_factory=_factory(params), postprocess=local_factory),
                   dict(engine_factory=functools.partial(local_factory))):
        with pytest.raises(TypeError, match="by reference"):
            build_llm_processor(sampling=sampling, **kwargs)


def test_udf_error_surfaces_as_task_error(runtime, params):
    ds = tdata.from_items([{"prompt": [1, 2, 3]} for _ in range(4)])
    proc = build_llm_processor(_factory(params), sampling=SamplingParams(max_tokens=2), batch_size=4,
                               postprocess=defs.boom_row)
    with pytest.raises(texc.TaskError, match="kaboom in postprocess"):
        proc(ds).take_all()
    with pytest.raises(texc.RayTpuError, match="engine factory failed"):
        build_llm_processor(defs.failing_engine, batch_size=4)(ds).take_all()


def test_engine_actors_ask_only_for_cpus(runtime, params, monkeypatch):
    """The pool's actors take ray_tpu's options, num_cpus alone: no card
    is asked for (their engines find the card themselves on the H100)."""
    from ray_tpu_torch.data import executor

    seen = []
    options = executor._MapActor.options

    def spy(**opts):
        seen.append(opts)
        return options(**opts)

    monkeypatch.setattr(executor._MapActor, "options", spy)
    ds = tdata.from_items([{"prompt": [3, 4, 5]}, {"prompt": [6, 7]}])
    rows = build_llm_processor(_factory(params), sampling=SamplingParams(max_tokens=2), batch_size=1,
                               concurrency=2)(ds).take_all()
    assert [len(r["generated"]) for r in rows] == [2, 2]
    assert seen == [{"num_cpus": 1.0}, {"num_cpus": 1.0}]
